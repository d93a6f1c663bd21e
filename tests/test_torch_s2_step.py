"""One whole s2 train step of the port against the JAX package's
make_train_step (train/s2.py:65) on the CPU.

Small configuration: test_torch_acoustic.TTV_SMALL (full widths, 1 text /
mel / W2V-encoder layer, 2 W2V-decoder layers) and the full
MultiResSpecDiscriminator; B = 2 of 16 and 13 frames (test_torch_s2_modules
.s2_batch); AdamW(1e-4) on both sides, c_mel 1, c_commit 100. Both steps
start from the same weights, codebooks and u / v (a seeded JAX state carried
over by convert.ttv_from_jax / mrsd_from_jax), and the port is fed the JAX
step's own draws: the teacher-force coin uniform(split(rng, 3)[1]) <= 0.5
and the dropout keep masks of the forward under split(rng, 3)[0], recorded
by an interceptor on flax nn.Dropout (test_torch_s2_modules). Two keys,
chosen so that one coin feeds the pitch predictor the ground truth and the
other the prediction, run through one compiled JAX step. The JAX step's
gradients are read where optax receives them.

Tolerances: every metric within 1e-4 relative; G and D gradients, the
updated parameters within 1e-3 relative L2 per tensor. A gradient tensor
whose norm is under 1e-6 of the largest (about 30 of the TTV's 301: the
query / key projections and relative-position tables of near-uniform
random-weight attention, whose softmax gradient cancels, and the clamped
range predictor) is float32 noise on both sides, 1e-5..1e-4 relative to
itself; it is held to 1e-5 of the largest norm in L2 instead, and so are
the key projections' biases, whose exact gradient is zero. Those biases'
updated values are held elementwise within 2e-4 (2 x lr: AdamW's first
step moves an element by about lr whatever the sign of its noise
gradient). The RVQ statistics and the spectral norm's u / v within 1e-5."""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import mrsd_from_jax, ttv_from_jax
from megatts2_hierspeechpp_torch.models.discriminators import (
    MultiResSpecDiscriminator as TorchMRSD,
)
from megatts2_hierspeechpp_torch.models.ttv import TTVModel as TorchTTV
from megatts2_hierspeechpp_torch.train import s2 as ts2
from megatts2_hierspeechpp_tpu.models.ttv import TTVModel as JaxTTV
from megatts2_hierspeechpp_tpu.train import s2 as js2
from megatts2_hierspeechpp_tpu.train.optim import adamw
from tests.test_torch_acoustic import TTV_SMALL, random_ttv_vars
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_s2_modules import (
    FAST,
    jax_train_forward,
    mask_source,
    mrsd_vars,
    s2_batch,
    torch_batch,
)
from tests.test_torch_train_step import recorder


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# The key projection's bias has no gradient in exact arithmetic (softmax is
# invariant to a shift of all of a query's scores): what both frameworks
# compute for it is rounding noise.
ZERO_GRAD = ("conv_k.bias", "w_k.bias")


def check_tensors(got: dict, want: dict, tol: float, floor_frac: float = 0.0,
                  step_atol: float | None = None):
    """Relative L2 per tensor over want's keys within `tol`. Gradients
    (floor_frac > 0): a tensor whose norm is under floor_frac of the
    largest, or whose exact gradient is zero (ZERO_GRAD), within 10 x
    floor_frac of the largest norm in absolute L2. Updated parameters
    (step_atol): a ZERO_GRAD tensor elementwise within step_atol, as AdamW's
    first step moves each element by about lr whatever the sign of its
    noise gradient. Returns the number held relatively."""
    norms = {k: float(np.linalg.norm(v.numpy())) for k, v in want.items()}
    big = max(norms.values())
    relative = 0
    for k, w in want.items():
        assert got[k] is not None, k
        g, w = got[k].detach().numpy(), w.numpy()
        if k.endswith(ZERO_GRAD) and step_atol is not None:
            assert np.abs(g - w).max() <= step_atol, k
        elif k.endswith(ZERO_GRAD) and floor_frac > 0 or norms[k] <= floor_frac * big:
            err = float(np.linalg.norm(g - w))
            assert err <= 10 * floor_frac * big, (k, err, big)
        else:
            err = rel_l2(g, w)
            assert err <= tol, (k, err)
            relative += 1
    assert relative > 0.85 * len(want)
    return relative


def coin_keys():
    """Two step keys whose teacher-force coins differ."""
    keys = {}
    for i in range(64):
        key = jax.random.PRNGKey(100 + i)
        coin = bool(jax.random.uniform(jax.random.split(key, 3)[1]) <= 0.5)
        keys.setdefault(coin, key)
        if len(keys) == 2:
            return keys
    raise AssertionError("no two coins differ")


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX step compiled once, run from one state for both keys:
    {coin: (key, new state, metrics, G gradients, D gradients)}, and the
    start (TTV vars, MRSD vars, batch)."""
    jm = JaxTTV(**TTV_SMALL)
    jvars = random_ttv_vars(jm, 71)
    batch = s2_batch(seed=72)
    y = np.zeros((1, 1024, 16), np.float32)
    jd, dvars = mrsd_vars(73, y)
    grads_g, grads_d = [], []
    tx_g = optax.chain(recorder(grads_g), adamw(1e-4, steps_per_epoch=10))
    tx_d = optax.chain(recorder(grads_d), adamw(1e-4, steps_per_epoch=10))
    state = js2.S2TrainState(
        step=jnp.zeros((), jnp.int32), params_g=jvars["params"], vq=jvars["vq"],
        opt_g=tx_g.init(jvars["params"]), params_d=dvars["params"],
        spectral=dvars["spectral"], opt_d=tx_d.init(dvars["params"]))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = coin_keys()
    step = jax.jit(js2.make_train_step(jm, jd, tx_g, tx_d, c_mel=1.0,
                                       c_commit=100.0))
    compiled = step.lower(state, jbatch, keys[True]).compile(compiler_options=FAST)
    out = {}
    for coin, key in keys.items():
        new, metrics = compiled(state, jbatch, key)
        jax.effects_barrier()
        out[coin] = (key, new, metrics, grads_g[-1], grads_d[-1])
    assert len(grads_g) == len(grads_d) == 2
    return jm, jvars, dvars, batch, out


@pytest.mark.parametrize("coin", [True, False])
def test_s2_step_matches_jax(jax_steps, coin):
    jm, jvars, dvars, batch, out = jax_steps
    key, new, want, grads_g, grads_d = out[coin]
    (_, _), masks = jax_train_forward(jm, jvars, batch, coin,
                                      jax.random.split(key, 3)[0], True)

    ttv = TorchTTV(**TTV_SMALL, device="cpu", train=True)
    ttv.load_state_dict(ttv_from_jax(jvars), strict=True)
    disc = TorchMRSD(device="cpu")
    disc.load_state_dict(mrsd_from_jax(dvars), strict=True)
    state = ts2.create_state(ttv, disc, lr=1e-4, steps_per_epoch=10)
    src = mask_source(masks)
    state, got = ts2.TrainStep(c_mel=1.0, c_commit=100.0).with_draws(
        state, torch_batch(batch), torch.tensor(coin), src)
    assert not src.masks and state.step == 1

    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4, err_msg=k)

    g_names = {k: p for k, p in ttv.named_parameters() if p.requires_grad}
    want_g = {k: v for k, v in ttv_from_jax({"params": grads_g, "vq": jvars["vq"]}).items()
              if k in g_names}
    assert all(".bias_hh_l" in k for k, p in ttv.named_parameters()
               if not p.requires_grad)
    # every JAX parameter but the LSTMs' zero bias_hh trains in the port
    assert want_g.keys() == g_names.keys()
    check_tensors({k: p.grad for k, p in g_names.items()}, want_g, 1e-3, 1e-6)
    d_names = dict(disc.named_parameters())
    want_d = {k: v for k, v in mrsd_from_jax({"params": grads_d,
                                              "spectral": dvars["spectral"]}).items()
              if k in d_names}
    assert want_d.keys() == d_names.keys()
    check_tensors({k: p.grad for k, p in d_names.items()}, want_d, 1e-3, 1e-6)

    # the updated state: parameters, codebooks, u / v
    new_g = ttv_from_jax({"params": new.params_g, "vq": new.vq})
    sd = ttv.state_dict()
    check_tensors({k: sd[k] for k in g_names}, {k: new_g[k] for k in g_names}, 1e-3,
                  step_atol=2e-4)
    for k, v in new_g.items():
        if k.startswith("quantizer."):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
    new_d = mrsd_from_jax({"params": new.params_d, "spectral": new.spectral})
    sd = disc.state_dict()
    check_tensors({k: sd[k] for k in d_names}, {k: new_d[k] for k in d_names}, 1e-3,
                  step_atol=2e-4)
    for k, v in new_d.items():
        if k not in d_names:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
