"""The s1 trainer in the port against the JAX package on the CPU: the
prosody LM's training loss (JAX ProsodyLM.__call__) without and with
dropout, ProsodyLMNonCausal and its converter, the decode-weight cache
after an optimizer step (the stale-pack hazard), and one whole s1 step
against the JAX make_train_step (train/s1.py:44).

Dropout masks are the JAX forward's, recorded by an interceptor on flax
nn.Dropout and fed to the port's sites in call order
(test_torch_s2_modules). Small configuration: ProsodyLM at 2 layers, d
276, 1024 bins (the frozen TTV is test_torch_acoustic.TTV_SMALL);
ProsodyLMNonCausal at 2 layers, d 64, 128 bins. Tolerances: logits atol
1e-4; losses and accuracy 1e-5 relative; the whole step's metrics 1e-4
relative, its gradients and updated parameters 1e-3 relative L2 per
tensor, with the noise rules of test_torch_s2_step.check_tensors (the key
projections' zero-gradient biases); codes and the packed weights exact."""
import contextlib

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import (
    plm_from_jax,
    plm_noncausal_from_jax,
    ttv_from_jax,
)
from megatts2_hierspeechpp_torch.models import plm as tplm
from megatts2_hierspeechpp_torch.models.ttv import TTVModel as TorchTTV
from megatts2_hierspeechpp_torch.nn.basic import dropout_masks
from megatts2_hierspeechpp_torch.train import s1 as ts1
from megatts2_hierspeechpp_tpu.models import convert as jconvert
from megatts2_hierspeechpp_tpu.models import plm as jplm
from megatts2_hierspeechpp_tpu.models.ttv import TTVModel as JaxTTV
from megatts2_hierspeechpp_tpu.train import s1 as js1
from megatts2_hierspeechpp_tpu.train.optim import adamw
from tests.test_torch_acoustic import TTV_SMALL, random_ttv_vars
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_plm import plm_params
from tests.test_torch_s2_modules import (
    EXTRACT_INPUTS,
    FAST,
    fast_jit,
    mask_source,
    s2_batch,
    torch_batch,
    with_masks,
)
from tests.test_torch_s2_step import check_tensors
from tests.test_torch_train_step import recorder
from tests.test_torch_vocoder import _check, random_params

NC_SMALL = dict(n_layers=2, tc_latent_dim=44, vq_bins=128)


def plm_inputs(seed, b=2, t=24, dim=256, bins=1024, lens=(24, 17)):
    rng = np.random.default_rng(seed)
    tc = rng.standard_normal((b, t, dim)).astype(np.float32)
    codes = rng.integers(0, bins, (b, t)).astype(np.int32)
    return tc, codes, np.asarray(lens, np.int32)


def check_loss(got, want, keys):
    _check(got["logits"], want["logits"])
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.fixture(scope="module")
def plms():
    jm = jplm.ProsodyLM(n_layers=2)
    params = plm_params(jm, 81)
    tm = tplm.ProsodyLM(n_layers=2, device="cpu", train=True)
    tm.load_state_dict(plm_from_jax(params), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("dropout", [False, True])
def test_plm_loss_dict_matches_jax(plms, dropout):
    """loss_dict: logits, the summed NLL, its per-frame value and the
    top-10 accuracy over the valid positions; with dropout, the JAX masks
    (3 sites per layer: attention weights, after out_proj, after relu)."""
    jm, params, tm = plms
    tc, codes, lens = plm_inputs(82)
    fn = with_masks(lambda p, a, c, n, k: jm.apply(
        {"params": p}, a, c, n, deterministic=not dropout, rngs={"dropout": k}))
    args = (params, tc, codes, lens, jax.random.PRNGKey(83))
    want, masks = fast_jit(fn, *args)(*args)
    assert len(masks) == (3 * jm.n_layers if dropout else 0)
    src = mask_source(masks)
    active = dropout_masks(src) if dropout else contextlib.nullcontext()
    with active, torch.no_grad():
        got = tm.loss_dict(*map(torch.from_numpy, (tc, codes, lens)))
    assert not src.masks
    check_loss(got, want, ("loss", "loss_log", "acc"))
    assert 0.0 < float(got["acc"]) < 1.0


@pytest.mark.parametrize("dropout", [False, True])
def test_noncausal_plm_matches_jax(dropout):
    jm = jplm.ProsodyLMNonCausal(**NC_SMALL)
    tc, codes, lens = plm_inputs(84, dim=44, bins=128)
    params = random_params(jm, 85, tc, codes, lens)
    tm = tplm.ProsodyLMNonCausal(**NC_SMALL, device="cpu", train=True)
    tm.load_state_dict(plm_noncausal_from_jax(params), strict=True)
    fn = with_masks(lambda p, a, c, n, k: jm.apply(
        {"params": p}, a, c, n, deterministic=not dropout, rngs={"dropout": k}))
    args = (params, tc, codes, lens, jax.random.PRNGKey(86))
    want, masks = fast_jit(fn, *args)(*args)
    assert len(masks) == (4 * jm.n_layers if dropout else 0)
    src = mask_source(masks)
    active = dropout_masks(src) if dropout else contextlib.nullcontext()
    with active, torch.no_grad():
        got = tm.loss_dict(*map(torch.from_numpy, (tc, codes, lens)))
    assert not src.masks
    check_loss(got, want, ("loss", "loss_log"))


def test_noncausal_weight_roundtrip():
    """Port ProsodyLMNonCausal at reference depth (its state_dict has the
    reference's names) -> the JAX package's convert_plm_noncausal ->
    plm_noncausal_from_jax: the same names and values."""
    tm = tplm.ProsodyLMNonCausal(device="cpu", seed=7)
    sd = tm.state_dict()
    out = plm_noncausal_from_jax(jconvert.convert_plm_noncausal(sd))
    assert out.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(out[k], v), k


def test_packed_weights_follow_optimizer_steps():
    """The stale-pack hazard: after an s1 optimizer step, packed() equals a
    fresh pack of the new weights (not the cached one), and the greedy
    decode equals that of a fresh serving build loaded from the same
    state_dict."""
    tm = tplm.ProsodyLM(n_layers=1, seed=3, device="cpu", train=True)
    before = tm.packed()
    assert tm.packed() is before
    opt = ts1.AdamW(tm.parameters(), lr=1e-2)
    tc, codes, lens = map(torch.from_numpy, plm_inputs(87, t=12, lens=(12, 9)))
    tm.loss_dict(tc, codes, lens)["loss"].backward()
    opt.step()
    after = tm.packed()
    fresh = tm._pack()
    assert after is not before
    stacked = ("wqkv", "bqkv", "wo", "bo", "ln", "ff0", "ff0b", "ff1", "ff1b")
    for name in ("emb", "pos_alpha", "pred") + stacked:
        assert torch.equal(getattr(after, name), getattr(fresh, name)), name
    # the stacked copies were stale (emb, pos_alpha and pred are the
    # parameters themselves)
    for name in stacked:
        assert not torch.equal(getattr(after, name), getattr(before, name)), name
    serving = tplm.ProsodyLM(n_layers=1, seed=9, device="cpu")
    serving.load_state_dict(tm.state_dict())
    tm.eval()
    np.testing.assert_array_equal(tplm.decode(tm, tc[:1]).numpy(),
                                  tplm.decode(serving, tc[:1]).numpy())
    # a build made under inference_mode (inference tensors keep no version
    # counter) packs and decodes as well
    with torch.inference_mode():
        inf = tplm.ProsodyLM(n_layers=1, seed=9, device="cpu")
        inf.load_state_dict(tm.state_dict())
    assert inf.packed() is inf.packed()
    np.testing.assert_array_equal(tplm.decode(inf, tc[:1]).numpy(),
                                  tplm.decode(serving, tc[:1]).numpy())
    # a load into it (an in-place copy that bumps no version) repacks too
    with torch.inference_mode():
        inf.load_state_dict(tplm.ProsodyLM(n_layers=1, seed=11,
                                           device="cpu").state_dict())
    assert torch.equal(inf.packed().wqkv, inf._pack().wqkv)


@pytest.fixture(scope="module")
def jax_s1_step():
    """One JAX s1 step from seeded PLM params beside a seeded frozen TTV."""
    jttv = JaxTTV(**TTV_SMALL)
    ttv_vars = random_ttv_vars(jttv, 91)
    jm = jplm.ProsodyLM(n_layers=2)
    params = plm_params(jm, 92)
    batch = s2_batch(seed=93)
    grads = []
    tx = optax.chain(recorder(grads), adamw(1e-4, steps_per_epoch=10))
    state = js1.S1TrainState(step=jnp.zeros((), jnp.int32), params_plm=params,
                             opt_plm=tx.init(params), ttv_vars=ttv_vars)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(94)
    step = jax.jit(js1.make_train_step(jttv, jm, tx))
    new, metrics = step.lower(state, jbatch, key).compile(
        compiler_options=FAST)(state, jbatch, key)
    jax.effects_barrier()
    assert len(grads) == 1
    return jttv, ttv_vars, jm, params, batch, key, new, metrics, grads[0]


def test_s1_step_matches_jax(jax_s1_step):
    jttv, ttv_vars, jm, params, batch, key, new, want, grads = jax_s1_step
    # the JAX step's dropout masks: its PLM forward on the frozen TTV's output
    x_frame, lr = jttv.apply(ttv_vars, *(batch[k] for k in EXTRACT_INPUTS),
                             method=JaxTTV.extract_tc_latent_code)
    fn = with_masks(lambda p, a, c, n, k: jm.apply(
        {"params": p}, a, c, n, deterministic=False, rngs={"dropout": k}))
    args = (params, x_frame, lr, batch["mel_lengths"], key)
    _, masks = fast_jit(fn, *args)(*args)

    ttv = TorchTTV(**TTV_SMALL, device="cpu")
    ttv.load_state_dict(ttv_from_jax(ttv_vars), strict=True)
    plm = tplm.ProsodyLM(n_layers=2, device="cpu", train=True)
    plm.load_state_dict(plm_from_jax(params), strict=True)
    state = ts1.create_state(plm, ttv, lr=1e-4, steps_per_epoch=10)
    src = mask_source(masks)
    state, got = ts1.TrainStep().with_draws(state, torch_batch(batch), src)
    assert not src.masks and state.step == 1
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4, err_msg=k)
    names = dict(plm.named_parameters())
    want_g = plm_from_jax(grads)
    assert want_g.keys() == names.keys()
    check_tensors({k: p.grad for k, p in names.items()}, want_g, 1e-3, 1e-6)
    new_p = plm_from_jax(new.params_plm)
    sd = plm.state_dict()
    check_tensors({k: sd[k] for k in names}, new_p, 1e-3, step_atol=2e-4)
