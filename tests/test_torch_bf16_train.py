"""One vocoder train step in bf16 compute on the CPU: the port's step and
the JAX package's make_train_step with dtype=bf16 models, from the same
weights and the same draws (the JAX step's window starts and z_q noise;
the posterior statistics stay float32 in bf16 compute, so the noise is the
float32 draw), each held against the port's float32 step of the same
weights and draws (which tests/test_torch_train_step.py holds to the JAX
float32 step within 1e-4 / 1e-3).

Small configuration and batch of tests/test_torch_train_step.py. Distances
from float32: the metrics by their largest relative difference, the G and
the D gradients by relative L2. The port's must be at most EXACT_RATIO (2)
x the JAX step's: two bf16 paths that round in other places (JAX's CPU path
keeps bf16 intermediates, the port's kernels compute in float32 inside)
cannot meet float32 tolerances against each other. After the step the
parameters and the AdamW moments are float32 and the gradients finite.

The JAX step is compiled at XLA's lowest backend optimisation level, as in
tests/test_torch_train_step.py."""
import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import mpd_from_jax, vocoder_from_jax
from megatts2_hierspeechpp_torch.models.discriminators import (
    MultiPeriodDiscriminator as TorchMPD,
)
from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder as TorchVocoder
from megatts2_hierspeechpp_torch.train import vocoder as tvt
from megatts2_hierspeechpp_tpu.models.discriminators import (
    MultiPeriodDiscriminator as JaxMPD,
)
from megatts2_hierspeechpp_tpu.models.vocoder import HierVocoder as JaxVocoder
from megatts2_hierspeechpp_tpu.train import vocoder as jvt
from megatts2_hierspeechpp_tpu.train.optim import adamw
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_train_modules import (
    MPD_SMALL,
    SMALL,
    jax_vocoder_params,
    random_tree,
)
from tests.test_torch_train_step import B, SEG, T, recorder, step_batch

EXACT_RATIO = 2.0


def _port_step(params_g, params_d, batch, starts, noise, dtype):
    gen = TorchVocoder(**SMALL, device="cpu", train=True, dtype=dtype)
    gen.load_state_dict(vocoder_from_jax(params_g), strict=True)
    disc = TorchMPD(**MPD_SMALL, device="cpu", dtype=dtype)
    disc.load_state_dict(mpd_from_jax(params_d), strict=True)
    state = tvt.create_state(gen, disc, lr=1e-4, steps_per_epoch=10)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["lengths"] = tb["lengths"].long()
    state, m = tvt.TrainStep(segment_frames=SEG).with_draws(
        state, tb, torch.from_numpy(starts).long(), torch.from_numpy(noise))
    grads = {name: torch.cat([p.grad.flatten() for p in mod.parameters()])
             for name, mod in (("G", gen), ("D", disc))}
    return state, {k: float(v) for k, v in m.items()}, grads


def _flat(tree_grads, from_jax, module):
    """JAX gradients in the port's parameter order, flattened."""
    sd = from_jax(tree_grads)
    return torch.cat([sd[k].flatten() for k, _ in module.named_parameters()])


def _distance(metrics, grads, ref_metrics, ref_grads):
    out = {"metrics": max(abs(metrics[k] - v) / abs(v)
                          for k, v in ref_metrics.items())}
    out.update({k: float((grads[k] - g).norm() / g.norm())
                for k, g in ref_grads.items()})
    return out


def test_bf16_train_step_against_jax():
    jm, params_g = jax_vocoder_params(seed=31)
    jd = JaxMPD(**MPD_SMALL)
    y = np.zeros((1, 2560, 1), np.float32)
    params_d = random_tree(jd.init, 32, y, y)
    batch = step_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)
    rngs = jax.random.split(key, 5)
    starts = np.array(jvt.rand_slice_indices(rngs[3], jbatch["lengths"], SEG))
    noise = np.array(jax.random.normal(rngs[0], (B, T, 192), jnp.float32))

    # JAX, bf16 compute, float32 parameters (as cli/train_vocoder builds it)
    grads_g, grads_d = [], []
    tx_g = optax.chain(recorder(grads_g), adamw(1e-4, steps_per_epoch=10))
    tx_d = optax.chain(recorder(grads_d), adamw(1e-4, steps_per_epoch=10))
    state = jvt.VocTrainState(step=jnp.zeros((), jnp.int32),
                              params_g=params_g, opt_g=tx_g.init(params_g),
                              params_d=params_d, opt_d=tx_d.init(params_d))
    step = jax.jit(jvt.make_train_step(
        JaxVocoder(**SMALL, dtype=jnp.bfloat16),
        JaxMPD(**MPD_SMALL, dtype=jnp.bfloat16), tx_g, tx_d, segment_frames=SEG))
    compiled = step.lower(state, jbatch, key).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    _, jm16 = compiled(state, jbatch, key)
    jax.effects_barrier()
    jm16 = {k: float(v) for k, v in jm16.items()}

    _, m32, g32 = _port_step(params_g, params_d, batch, starts, noise, None)
    st16, m16, g16 = _port_step(params_g, params_d, batch, starts, noise,
                                torch.bfloat16)
    jg16 = {"G": _flat(grads_g[0], vocoder_from_jax, st16.gen),
            "D": _flat(grads_d[0], mpd_from_jax, st16.disc)}

    assert m16.keys() == m32.keys() == jm16.keys()
    port = _distance(m16, g16, m32, g32)
    jax_d = _distance(jm16, jg16, m32, g32)
    for k in port:
        assert port[k] <= EXACT_RATIO * jax_d[k], (k, port, jax_d)
    assert all(np.isfinite(v) for v in m16.values())
    for g in g16.values():
        assert torch.isfinite(g).all()
    for opt in (st16.opt_g, st16.opt_d):
        assert all(p.dtype == torch.float32 for p in opt.params)
        moments = [v for st in opt.opt.state.values() for v in st.values()]
        assert len(moments) >= 2 * len(opt.params)
        assert all(v.dtype == torch.float32 for v in moments)
