"""The s2 and s1 train steps in bf16 compute on the CPU: the port's steps
and the JAX package's make_train_step with dtype=bf16 models (float32
parameters, as cli/train_s2 / cli/train_s1 build them), from the same
weights, codebooks, u / v, teacher-force coin and dropout masks (the JAX
step's own, recorded by the interceptor of tests/test_torch_s2_modules).

Each bf16 step is held against the port's float32 step of the same weights
and draws (which tests/test_torch_s2_step.py and test_torch_s1.py hold to
the JAX float32 steps within 1e-4 / 1e-3). Distances from float32: the
metrics by their largest relative difference, the G, D and PLM gradients by
relative L2. The port's must be at most EXACT_RATIO (2) x the JAX step's:
two bf16 paths that round in other places cannot meet float32 tolerances
against each other. A gradient's distance must also be at least the JAX
step's / EXACT_RATIO, so that a path left in float32 shows: the G and PLM
gradients whole, the D gradient without its biases (XLA on the CPU sums a
bf16 bias cotangent in bf16, which puts the JAX D biases 0.1-0.8 from
float32 against the port's 2e-3; the D weights agree within 10 %). A
metric is one scalar, one rounding sample, and has no lower bound. After
the step the RVQ statistics, the spectral norm's u / v, the parameters and
the AdamW moments are float32 and finite.

Every submodule of the bf16 TTV (training forward and serving latent),
ProsodyLM and MultiResSpecDiscriminator hands on the dtype its JAX
counterpart does (flax capture_intermediates against forward hooks, matched
by name), so a module left in float32 fails by name. The dataflow dtypes
(x_frame bf16; g, w2v_pred, the log-f0 and the losses float32) are checked
on their own, and the TTV's bf16 duration pre-pass is compared before its
ceil (a bf16 rounding may flip a ceil), with the upsampled latent compared
at given durations.

Small configuration and batches of tests/test_torch_s2_step.py and
test_torch_s1.py; the JAX steps are compiled at XLA's lowest backend
optimisation level."""
import re

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from megatts2_hierspeechpp_torch.convert import (
    mrsd_from_jax,
    plm_from_jax,
    ttv_from_jax,
)
from megatts2_hierspeechpp_torch.models import plm as tplm
from megatts2_hierspeechpp_torch.models.discriminators import (
    MultiResSpecDiscriminator as TorchMRSD,
)
from megatts2_hierspeechpp_torch.models.ttv import TTVModel as TorchTTV
from megatts2_hierspeechpp_torch.train import s1 as ts1
from megatts2_hierspeechpp_torch.train import s2 as ts2
from megatts2_hierspeechpp_torch.utils.masking import feature_mask
from megatts2_hierspeechpp_tpu.models import discriminators as jdisc
from megatts2_hierspeechpp_tpu.models import plm as jplm
from megatts2_hierspeechpp_tpu.models.ttv import TTVModel as JaxTTV
from megatts2_hierspeechpp_tpu.train import s1 as js1
from megatts2_hierspeechpp_tpu.train import s2 as js2
from megatts2_hierspeechpp_tpu.train.optim import adamw
from megatts2_hierspeechpp_tpu.utils.masking import feature_mask as jfeature_mask
from tests.test_torch_acoustic import TTV_SMALL, random_ttv_vars
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_plm import plm_params
from tests.test_torch_s2_modules import (
    EXTRACT_INPUTS,
    FAST,
    fast_jit,
    jax_train_forward,
    mask_source,
    mrsd_vars,
    s2_batch,
    torch_batch,
    with_masks,
)
from tests.test_torch_s2_step import coin_keys
from tests.test_torch_train_step import recorder

EXACT_RATIO = 2.0
BF16 = jnp.bfloat16


def _distance(metrics, grads, ref_metrics, ref_grads):
    out = {"metrics": max(abs(metrics[k] - v) / max(abs(v), 1e-30)
                          for k, v in ref_metrics.items())}
    out.update({k: float((grads[k] - g).norm() / g.norm())
                for k, g in ref_grads.items()})
    return out


def _check_distances(port, jax_d, floored):
    """Every distance at most EXACT_RATIO x JAX's; those of `floored` at
    least JAX's / EXACT_RATIO."""
    for k in port:
        assert port[k] <= EXACT_RATIO * jax_d[k], (k, port, jax_d)
    for k in floored:
        assert port[k] >= jax_d[k] / EXACT_RATIO, (k, port, jax_d)


def _flat(sd: dict, module) -> torch.Tensor:
    """A state_dict of gradients in module's trainable-parameter order."""
    return torch.cat([sd[k].flatten() for k, p in module.named_parameters()
                      if p.requires_grad])


def _check_float32_state(opt):
    assert all(p.dtype == torch.float32 for p in opt.params)
    moments = [v for st in opt.opt.state.values() for v in st.values()]
    assert len(moments) >= 2 * len(opt.params)
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
               for v in moments if v.is_floating_point())
    assert all(torch.isfinite(p).all() for p in opt.params)


# ---------------------------------------------------------------- s2


def _port_s2(jvars, dvars, batch, coin, masks, dtype):
    ttv = TorchTTV(**TTV_SMALL, device="cpu", train=True, dtype=dtype)
    ttv.load_state_dict(ttv_from_jax(jvars), strict=True)
    disc = TorchMRSD(device="cpu", dtype=dtype)
    disc.load_state_dict(mrsd_from_jax(dvars), strict=True)
    state = ts2.create_state(ttv, disc, lr=1e-4, steps_per_epoch=10)
    src = mask_source(masks)
    state, m = ts2.TrainStep(c_mel=1.0, c_commit=100.0).with_draws(
        state, torch_batch(batch), torch.tensor(coin), src)
    assert not src.masks and state.step == 1
    grads = {"G": _flat({k: p.grad for k, p in ttv.named_parameters()
                         if p.requires_grad}, ttv),
             "D": torch.cat([p.grad.flatten() for p in disc.parameters()]),
             "D weights": torch.cat([p.grad.flatten() for k, p in
                                     disc.named_parameters()
                                     if not k.endswith("bias")])}
    return state, {k: float(v) for k, v in m.items()}, grads


def test_bf16_s2_step_against_jax():
    jm = JaxTTV(**TTV_SMALL)
    jvars = random_ttv_vars(jm, 71)
    batch = s2_batch(seed=72)
    y = np.zeros((1, 1024, 16), np.float32)
    _, dvars = mrsd_vars(73, y)
    coin = False   # the pitch predictor reads the prediction: every module trains
    key = coin_keys()[coin]

    grads_g, grads_d = [], []
    tx_g = optax.chain(recorder(grads_g), adamw(1e-4, steps_per_epoch=10))
    tx_d = optax.chain(recorder(grads_d), adamw(1e-4, steps_per_epoch=10))
    state = js2.S2TrainState(
        step=jnp.zeros((), jnp.int32), params_g=jvars["params"], vq=jvars["vq"],
        opt_g=tx_g.init(jvars["params"]), params_d=dvars["params"],
        spectral=dvars["spectral"], opt_d=tx_d.init(dvars["params"]))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(js2.make_train_step(
        JaxTTV(**TTV_SMALL, dtype=BF16),
        jdisc.MultiResSpecDiscriminator(dtype=BF16), tx_g, tx_d, c_mel=1.0,
        c_commit=100.0))
    new, jm16 = step.lower(state, jbatch, key).compile(
        compiler_options=FAST)(state, jbatch, key)
    jax.effects_barrier()
    jm16 = {k: float(v) for k, v in jm16.items()}
    # the dropout masks depend on the rng and the shapes only
    (_, _), masks = jax_train_forward(jm, jvars, batch, coin,
                                      jax.random.split(key, 3)[0], True)

    st32, m32, g32 = _port_s2(jvars, dvars, batch, coin, masks, None)
    st16, m16, g16 = _port_s2(jvars, dvars, batch, coin, masks, torch.bfloat16)
    jd = {k: v for k, v in mrsd_from_jax(
        {"params": grads_d[0], "spectral": dvars["spectral"]}).items()
        if k in dict(st16.disc.named_parameters())}
    jg16 = {"G": _flat(ttv_from_jax({"params": grads_g[0], "vq": jvars["vq"]}),
                       st16.ttv),
            "D": torch.cat([v.flatten() for v in jd.values()]),
            "D weights": torch.cat([v.flatten() for k, v in jd.items()
                                    if not k.endswith("bias")])}

    assert m16.keys() == m32.keys() == jm16.keys()
    port, jax_d = _distance(m16, g16, m32, g32), _distance(jm16, jg16, m32, g32)
    _check_distances(port, jax_d, ("G", "D weights"))
    assert all(np.isfinite(v) for v in m16.values())
    for g in g16.values():
        assert torch.isfinite(g).all()
    for opt in (st16.opt_g, st16.opt_d):
        _check_float32_state(opt)
    # the RVQ statistics: float32, their EMA step from the bf16 quantizer
    # input by its distance from float32; u / v (the power iteration on the
    # float32 weight) as JAX's within 1e-5
    want = ttv_from_jax({"params": new.params_g, "vq": new.vq})
    sd16, sd32 = st16.ttv.state_dict(), st32.ttv.state_dict()
    for k, v in sd16.items():
        if k.startswith("quantizer.") and not k.endswith("inited"):
            assert v.dtype == torch.float32 and torch.isfinite(v).all(), k
            port_q = float((v - sd32[k]).norm() / sd32[k].norm())
            jax_q = float((want[k] - sd32[k]).norm() / sd32[k].norm())
            assert jax_q / EXACT_RATIO <= port_q <= EXACT_RATIO * jax_q, (
                k, port_q, jax_q)
    dsd = st16.disc.state_dict()
    want_d = mrsd_from_jax({"params": new.params_d, "spectral": new.spectral})
    for k, v in dsd.items():
        if k.startswith("discriminators.0.") and k.endswith(("weight_u", "weight_v")):
            assert v.dtype == torch.float32, k
            np.testing.assert_allclose(v.numpy(), want_d[k].numpy(), atol=1e-5,
                                       err_msg=k)


def test_bf16_ttv_dataflow_dtypes_match_jax():
    """The training forward's outputs and the serving latent take the
    dtypes of the JAX bf16 TTV's."""
    jvars = random_ttv_vars(JaxTTV(**TTV_SMALL), 71)
    batch = s2_batch(seed=72)
    jm = JaxTTV(**TTV_SMALL, dtype=BF16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tm = TorchTTV(**TTV_SMALL, device="cpu", dtype=torch.bfloat16)
    tm.load_state_dict(ttv_from_jax(jvars), strict=True)
    tb = torch_batch(batch)
    want = jax.eval_shape(lambda v: jm.apply(
        v, *(jb[k] for k in ts2.TTV_INPUTS), teacher_force_w2v=False), jvars)
    with torch.no_grad():
        got = tm(*(tb[k] for k in ts2.TTV_INPUTS), teacher_force_w2v=False)
    for k in ("l_length", "l_pitch", "pred_lf0", "w2v_pred", "commit_loss"):
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    args = ("x_ids", "tone", "language", "x_lengths", "mrte_mel", "mrte_mel_lengths")
    want = jax.eval_shape(lambda v: jm.apply(
        v, *(jb[k] for k in args), 64, method=JaxTTV.inf_extract_tc_latent), jvars)
    with torch.no_grad():
        got = tm.inf_extract_tc_latent(*(tb[k] for k in args), 64)
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32


# the port's module names (the reference's) -> the flax modules' names
RENAMES = {
    "ttv": ((r"attn_layers_", "attn_"), (r"ffn_layers_", "ffn_"),
            (r"norm_layers_1_", "norm1_"), (r"norm_layers_2_", "norm2_"),
            (r"^RangePredictor", "range_predictor"), (r"in_layers_", "in_"),
            (r"res_skip_layers_", "res_skip_"),
            (r"^quantizer\.vq\.layers_", "quantizer.vq_")),
    "plm": ((r"^plm\.layers_(\d+)\.attn\.", r"layer_\1."),
            (r"^plm\.layers_(\d+)", r"layer_\1"), (r"\.ff_1$", ".ff_relu"),
            (r"\.ff_3$", ".ff_1")),
    "mrsd": ((r"^discriminators_(\d+)\.discriminators_", r"disc_\1.convs_"),
             (r"^discriminators_", "disc_")),
}
# modules that must be among the matched ones
MUST_MATCH = {
    "ttv": ("enc_p", "mel_encoder", "mha", "w2v_encoder", "w2v_decoder",
            "emb_g", "duration_predictor", "range_predictor", "pp",
            "plm_conv1", "plm_conv2", "ssl_proj", "cond_g", "dur_downsample",
            "quantizer"),
    "ttv latent": ("enc_p", "mel_encoder", "mha", "emb_g",
                   "duration_predictor"),
    "plm": ("layer_0.w_q", "layer_0.w_k", "layer_0.w_v", "layer_0.out_proj",
            "layer_0.ff_0", "layer_0.ff_1", "layer_1", "predict_layer"),
    "mrsd": ("disc_0.convs_0", "disc_0.convs_3", "disc_0.out",
             "disc_1.convs_0", "disc_1.out"),
}


def _kind(dtype) -> str:
    s = str(dtype).split(".")[-1]
    return "int" if "int" in s else s   # index outputs: int32 in JAX, int64 here


def _jax_output_dtypes(fn, *args) -> dict:
    _, inter = jax.eval_shape(fn, *args)
    return {".".join(k[:-1]): [_kind(x.dtype) for x in jax.tree_util.tree_leaves(v)]
            for k, v in flatten_dict(inter["intermediates"]).items()}


def _port_output_dtypes(module, renames, run) -> dict:
    out, hooks = {}, []
    for name, m in module.named_modules():
        name = re.sub(r"\.(\d+)", r"_\1", name)
        for a, b in renames:
            name = re.sub(a, b, name)
        hooks.append(m.register_forward_hook(
            lambda m, i, o, name=name: out.setdefault(name, []).extend(
                _kind(t.dtype) for t in jax.tree_util.tree_leaves(o)
                if isinstance(t, torch.Tensor))))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return out


@pytest.mark.parametrize("model", ["ttv", "ttv latent", "plm", "mrsd"])
def test_bf16_module_output_dtypes_match_jax(model):
    """Each submodule of the bf16 model hands on the dtypes (one per output,
    per call) that its JAX counterpart does: read off capture_intermediates
    of the JAX bf16 module and forward hooks on the port's, matched by name.
    The root, whose outputs the two packages arrange differently, and the
    dropouts are left out."""
    rng = np.random.default_rng(5)
    if model.startswith("ttv"):
        jvars = random_ttv_vars(JaxTTV(**TTV_SMALL), 71)
        batch = s2_batch(seed=72)
        jm = JaxTTV(**TTV_SMALL, dtype=BF16)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tm = TorchTTV(**TTV_SMALL, device="cpu", dtype=torch.bfloat16)
        tm.load_state_dict(ttv_from_jax(jvars), strict=True)
        tb = torch_batch(batch)
        if model == "ttv":
            want = _jax_output_dtypes(lambda v: jm.apply(
                v, *(jb[k] for k in ts2.TTV_INPUTS), teacher_force_w2v=False,
                capture_intermediates=True, mutable=["intermediates"]), jvars)
            got = _port_output_dtypes(tm, RENAMES["ttv"], lambda: tm(
                *(tb[k] for k in ts2.TTV_INPUTS), teacher_force_w2v=False))
        else:
            args = ("x_ids", "tone", "language", "x_lengths", "mrte_mel",
                    "mrte_mel_lengths")
            want = _jax_output_dtypes(lambda v: jm.apply(
                v, *(jb[k] for k in args), 64, method=JaxTTV.inf_extract_tc_latent,
                capture_intermediates=True, mutable=["intermediates"]), jvars)
            got = _port_output_dtypes(tm, RENAMES["ttv"], lambda: tm.inf_extract_tc_latent(
                *(tb[k] for k in args), 64))
    elif model == "plm":
        params = plm_params(jplm.ProsodyLM(n_layers=2), 92)
        jm = jplm.ProsodyLM(n_layers=2, dtype=BF16)
        tm = tplm.ProsodyLM(n_layers=2, device="cpu", dtype=torch.bfloat16)
        tm.load_state_dict(plm_from_jax(params), strict=True)
        t = 24
        tc = rng.standard_normal((2, t, 256)).astype(np.float32)
        codes = rng.integers(0, 1024, (2, t)).astype(np.int32)
        lens = np.array([t, 17], np.int32)
        want = _jax_output_dtypes(lambda p: jm.apply(
            {"params": p}, tc, codes, lens, capture_intermediates=True,
            mutable=["intermediates"]), params)
        got = _port_output_dtypes(tm, RENAMES["plm"], lambda: tm(
            torch.from_numpy(tc), torch.from_numpy(codes).long(),
            torch.from_numpy(lens)))
    else:
        y = rng.standard_normal((2, 1024, 16)).astype(np.float32)
        y_hat = rng.standard_normal((2, 1024, 16)).astype(np.float32)
        _, dvars = mrsd_vars(73, y)
        jm = jdisc.MultiResSpecDiscriminator(dtype=BF16)
        tm = TorchMRSD(device="cpu", dtype=torch.bfloat16)
        tm.load_state_dict(mrsd_from_jax(dvars), strict=True)
        want = _jax_output_dtypes(lambda v: jm.apply(
            v, y, y_hat, update_u=True, capture_intermediates=True,
            mutable=["intermediates", "spectral"]), dvars)
        got = _port_output_dtypes(tm, RENAMES["mrsd"], lambda: tm(
            torch.from_numpy(y), torch.from_numpy(y_hat), update_u=True))
    both = sorted(k for k in set(want) & set(got) if k)
    assert set(MUST_MATCH[model]) <= set(both), sorted(set(MUST_MATCH[model]) - set(both))
    differ = {k: (got[k], want[k]) for k in both if got[k] != want[k]}
    assert not differ, differ
    assert any("bfloat16" in want[k] for k in both)


def _jax_durations(mod, x_ids, tone, language, x_lengths, mrte, mrte_len):
    """(x, g, x_mask, w): w = exp(logw) * x_mask before the ceil."""
    x_mask = jfeature_mask(x_lengths, x_ids.shape[1])
    mrte_mask = jfeature_mask(mrte_len, mrte.shape[1])
    g = mod.emb_g(mrte, mrte_mask)
    x = mod._text_mrte(x_ids, tone, language, x_mask, mrte, mrte_mask, g)
    w = jnp.exp(mod.duration_predictor(x, x_mask, g)) * x_mask
    return x, g, x_mask, w


def _port_durations(tm, x_ids, tone, language, x_lengths, mrte, mrte_len):
    x_mask = feature_mask(x_lengths, x_ids.shape[1])
    mrte_mask = feature_mask(mrte_len, mrte.shape[1])
    g = tm.emb_g(mrte, mrte_mask)
    x = tm._text_mrte(x_ids, tone, language, x_mask, mrte, mrte_mask, g)
    w = torch.exp(tm.duration_predictor(x, x_mask, g)) * x_mask
    return x, g, x_mask, w


def test_bf16_duration_prepass_and_latent_against_jax():
    """predict_frame_lengths / inf_extract_tc_latent in bf16: the durations
    before the ceil and, at the float32 step's ceil'd durations, the
    upsampled latent, each by its distance from the port's float32."""
    jvars = random_ttv_vars(JaxTTV(**TTV_SMALL), 74)
    batch = s2_batch(seed=75)
    args = ("x_ids", "tone", "language", "x_lengths", "mrte_mel", "mrte_mel_lengths")
    jb = [jnp.asarray(batch[k]) for k in args]
    tb = [torch.from_numpy(batch[k]) for k in args]
    jm = JaxTTV(**TTV_SMALL, dtype=BF16)
    jx, _, _, jw = fast_jit(lambda v, *a: jm.apply(v, *a, method=_jax_durations),
                            jvars, *jb)(jvars, *jb)
    outs = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        tm = TorchTTV(**TTV_SMALL, device="cpu", dtype=dtype)
        tm.load_state_dict(ttv_from_jax(jvars), strict=True)
        with torch.no_grad():
            outs[name] = (tm, *_port_durations(tm, *tb))
    w32 = outs["f32"][4]
    dur = torch.ceil(w32)[..., 0]
    out_len = int(2 * ((dur * outs["f32"][3][..., 0]).sum(1).max() // 2 + 1))

    def dist(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    port_w = dist(outs["bf16"][4], w32)
    jax_w = dist(torch.from_numpy(np.asarray(jw, np.float32)), w32)
    assert 0 < port_w <= EXACT_RATIO * jax_w, (port_w, jax_w)
    # frame lengths: the pre-pass agrees with the durations it ceils
    tm16 = outs["bf16"][0]
    with torch.no_grad():
        frames = tm16.predict_frame_lengths(*tb)
    w16 = outs["bf16"][4]
    want = torch.ceil((torch.ceil(w16)[..., 0] * outs["bf16"][3][..., 0]).sum(1) / 2)
    assert torch.equal(frames, want.int())

    # the latent at the float32 durations (both sides' own bf16 x)
    jdur, jx_len = jnp.asarray(dur.numpy()), jb[3]
    jframe = fast_jit(lambda v, x, d, n: jm.apply(
        v, x, d, n, out_len, method=JaxTTV._upsample_to_frames),
        jvars, jx, jdur, jx_len)(jvars, jx, jdur, jx_len)
    with torch.no_grad():
        f32 = outs["f32"][0]._upsample_to_frames(outs["f32"][1], dur, tb[3], out_len)
        f16 = tm16._upsample_to_frames(outs["bf16"][1], dur, tb[3], out_len)
    assert f16.dtype == torch.bfloat16 and jframe.dtype == BF16
    port_f = dist(f16, f32)
    jax_f = dist(torch.from_numpy(np.asarray(jframe, np.float32)), f32)
    assert 0 < port_f <= EXACT_RATIO * jax_f, (port_f, jax_f)


# ---------------------------------------------------------------- s1


def _port_s1(ttv_vars, params, batch, masks, dtype):
    ttv = TorchTTV(**TTV_SMALL, device="cpu", dtype=dtype)
    ttv.load_state_dict(ttv_from_jax(ttv_vars), strict=True)
    plm = tplm.ProsodyLM(n_layers=2, device="cpu", train=True, dtype=dtype)
    plm.load_state_dict(plm_from_jax(params), strict=True)
    state = ts1.create_state(plm, ttv, lr=1e-4, steps_per_epoch=10)
    src = mask_source(masks)
    state, m = ts1.TrainStep().with_draws(state, torch_batch(batch), src)
    assert not src.masks and state.step == 1
    return state, {k: float(v) for k, v in m.items()}, {
        "PLM": torch.cat([p.grad.flatten() for p in plm.parameters()])}


def test_bf16_s1_step_against_jax():
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
    step = jax.jit(js1.make_train_step(JaxTTV(**TTV_SMALL, dtype=BF16),
                                       jplm.ProsodyLM(n_layers=2, dtype=BF16), tx))
    _, jm16 = step.lower(state, jbatch, key).compile(
        compiler_options=FAST)(state, jbatch, key)
    jax.effects_barrier()
    jm16 = {k: float(v) for k, v in jm16.items()}
    # the JAX step's dropout masks (the rng and the shapes fix them)
    x_frame, lr = jttv.apply(ttv_vars, *(batch[k] for k in EXTRACT_INPUTS),
                             method=JaxTTV.extract_tc_latent_code)
    fn = with_masks(lambda p, a, c, n, k: jm.apply(
        {"params": p}, a, c, n, deterministic=False, rngs={"dropout": k}))
    margs = (params, x_frame, lr, batch["mel_lengths"], key)
    _, masks = fast_jit(fn, *margs)(*margs)

    _, m32, g32 = _port_s1(ttv_vars, params, batch, masks, None)
    st16, m16, g16 = _port_s1(ttv_vars, params, batch, masks, torch.bfloat16)
    jg = plm_from_jax(grads[0])
    jg16 = {"PLM": torch.cat([jg[k].flatten() for k, _ in st16.plm.named_parameters()])}
    # the bf16 latent the PLM reads, and the codes it is trained on
    x16, codes16 = ts1.extract(st16.ttv, torch_batch(batch))
    assert x16.dtype == torch.bfloat16

    assert m16.keys() == m32.keys() == jm16.keys()
    port, jax_d = _distance(m16, g16, m32, g32), _distance(jm16, jg16, m32, g32)
    _check_distances(port, jax_d, ("PLM",))
    assert all(np.isfinite(v) for v in m16.values())
    _check_float32_state(st16.opt)
