"""The s2 trainer's modules in the port against the JAX package on the CPU:
the spectral-norm conv and the multi-resolution spectrogram discriminator
(logits, feature maps, the updated u / v, and the D loss's gradient through
the real pass's power iteration), the RVQ training forward (EMA statistics,
straight-through output, commit loss; independent of the VQ rng), k-means
and init_rvq_state, collate, and the TTVModel training methods (forward
with dropout and teacher_force_w2v True / False, pre_vq_features,
extract_tc_latent_code, pooled_prosody_codes, infer_gt_dur).

Dropout: the JAX forward runs with deterministic=False; an interceptor on
flax nn.Dropout.__call__ records each site's keep mask in call order, and
the port's sites take those masks in their own call order
(nn/basic.MaskSource(masks=...)). A site out of order, or a count that
differs, fails on the masks' shapes or on masks left over.

Small configuration: TTVModel at full width with 1 text / mel / W2V-encoder
layer and 2 W2V-decoder layers (test_torch_acoustic.TTV_SMALL), B = 2 of 16
and 13 frames; the full MRSD on a (2, 1024, 13) w2v map. JAX functions are
compiled at XLA's lowest backend optimisation level, which changes no
arithmetic the tolerances could see. Tolerances: modules atol 1e-4;
gradients 1e-4 relative to each tensor's largest value; EMA state and u / v
1e-5; codes, k-means and collate exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from megatts2_hierspeechpp_torch.convert import mrsd_from_jax, ttv_from_jax
from megatts2_hierspeechpp_torch.data import dataset as tdata
from megatts2_hierspeechpp_torch.data import text as ttext
from megatts2_hierspeechpp_torch.models import discriminators as tdisc
from megatts2_hierspeechpp_torch.models.ttv import TTVModel as TorchTTV
from megatts2_hierspeechpp_torch.nn.basic import MaskSource, dropout_masks
from megatts2_hierspeechpp_torch.nn.quantize import ResidualVectorQuantizer as TorchRVQ
from megatts2_hierspeechpp_torch.ops import kmeans as tkmeans
from megatts2_hierspeechpp_torch.train import losses as tlosses
from megatts2_hierspeechpp_tpu.data import dataset as jdata
from megatts2_hierspeechpp_tpu.models import convert as jconvert
from megatts2_hierspeechpp_tpu.models import discriminators as jdisc
from megatts2_hierspeechpp_tpu.models.ttv import TTVModel as JaxTTV
from megatts2_hierspeechpp_tpu.nn.quantize import ResidualVectorQuantizer as JaxRVQ
from megatts2_hierspeechpp_tpu.ops import kmeans as jkmeans
from megatts2_hierspeechpp_tpu.train import losses as jlosses
from tests.test_torch_acoustic import TTV_SMALL, random_ttv_vars
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_train_modules import random_tree
from tests.test_torch_vocoder import _check

FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
TTV_INPUTS = ("x_ids", "tone", "language", "x_lengths", "w2v", "w2v_lengths",
              "mel", "mel_lengths", "pitch", "pitch_lengths", "dur",
              "mrte_mel", "mrte_mel_lengths")
EXTRACT_INPUTS = ("x_ids", "tone", "language", "x_lengths", "mel",
                  "mel_lengths", "dur", "mrte_mel", "mrte_mel_lengths")


def fast_jit(fn, *args):
    """jax.jit(fn) compiled for `args` at the lowest optimisation level."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)


def dropout_recorder(masks: list):
    """A flax interceptor that records the keep mask of every active
    nn.Dropout call (deterministic=False, rate > 0) and returns what the
    call would: where(keep, x / keep_prob, 0) from the same rng draw."""
    def icpt(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        det = kwargs.get("deterministic", mod.deterministic)
        if det or mod.rate == 0.0:
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = next_fun(jnp.ones_like(x), *args[1:], **kwargs) != 0
        masks.append(keep)
        return jnp.where(keep, x / (1.0 - mod.rate), jnp.zeros_like(x))
    return icpt


def with_masks(fn):
    """fn(*args) -> (fn's outputs, the recorded dropout keep masks)."""
    def wrapped(*args):
        masks = []
        with fnn.intercept_methods(dropout_recorder(masks)):
            out = fn(*args)
        return out, masks
    return wrapped


def mask_source(masks) -> MaskSource:
    return MaskSource(masks=[torch.from_numpy(np.array(m)) for m in masks])


def s2_batch(seed=40, lens=(16, 13), n_ph=(6, 4), mrte=(24, 17)):
    """A collate-shaped s2 batch (numpy, int32 / float32): integer 100 Hz
    durations summing to 2x each mel length, f0 partly unvoiced."""
    rng = np.random.default_rng(seed)
    b, t, n, m = len(lens), max(lens), max(n_ph), max(mrte)
    i32, f32 = np.int32, np.float32
    out = {k: np.zeros((b, n), i32) for k in ("x_ids", "tone", "language")}
    out["dur"] = np.zeros((b, n), f32)
    out["w2v"] = np.zeros((b, t, 1024), f32)
    out["mel"] = np.zeros((b, t, 80), f32)
    out["pitch"] = np.zeros((b, 4 * t), f32)
    out["mrte_mel"] = np.zeros((b, m, 80), f32)
    for i, (ti, ni, mi) in enumerate(zip(lens, n_ph, mrte)):
        out["x_ids"][i, :ni] = rng.integers(1, ttext.N_VOCAB, ni)
        out["tone"][i, :ni] = rng.integers(0, ttext.N_TONE, ni)
        out["language"][i, :ni] = rng.integers(0, ttext.N_LANGUAGE, ni)
        out["dur"][i, :ni] = 1 + rng.multinomial(2 * ti - ni, np.ones(ni) / ni)
        out["w2v"][i, :ti] = rng.standard_normal((ti, 1024))
        out["mel"][i, :ti] = rng.standard_normal((ti, 80))
        out["pitch"][i, :4 * ti] = np.where(rng.uniform(size=4 * ti) < 0.7,
                                            rng.uniform(90, 260, 4 * ti), 0.0)
        out["mrte_mel"][i, :mi] = rng.standard_normal((mi, 80))
    out["x_lengths"] = np.asarray(n_ph, i32)
    out["w2v_lengths"] = out["mel_lengths"] = np.asarray(lens, i32)
    out["pitch_lengths"] = 4 * np.asarray(lens, i32)
    out["mrte_mel_lengths"] = np.asarray(mrte, i32)
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ttvs():
    """(JAX TTVModel, its seeded variables, a port training build with the
    same weights)."""
    jm = JaxTTV(**TTV_SMALL)
    jvars = random_ttv_vars(jm, 51)
    tm = TorchTTV(**TTV_SMALL, device="cpu", train=True)
    tm.load_state_dict(ttv_from_jax(jvars), strict=True)
    return jm, jvars, tm


# ---------------------------------------------------------------- MRSD


def mrsd_vars(seed, y):
    jd = jdisc.MultiResSpecDiscriminator()
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), y, y)
    rng = np.random.default_rng(seed + 1)
    spectral = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        shapes["spectral"])
    return jd, {"params": random_tree(jd.init, seed, y, y), "spectral": spectral}


@pytest.mark.parametrize("t", [13, 16])
def test_mrsd_matches_jax_and_updates_u_v_on_the_real_pass(t):
    """Logits and feature maps of both passes, the u / v after the call
    (updated by the real pass only) and, with update_u=False, u / v kept;
    t = 13 truncates the odd width in the 2x pool."""
    rng = np.random.default_rng(3)
    y = rng.standard_normal((2, 1024, t)).astype(np.float32)
    y_hat = rng.standard_normal((2, 1024, t)).astype(np.float32)
    jd, jvars = mrsd_vars(60, y)
    td = tdisc.MultiResSpecDiscriminator(device="cpu")
    td.load_state_dict(mrsd_from_jax(jvars), strict=True)
    for update in (True, False):
        want, mut = jd.apply(jvars, y, y_hat, update_u=update,
                             mutable=["spectral"])
        before = {k: v.clone() for k, v in td.state_dict().items()}
        with torch.no_grad():
            got = td(torch.from_numpy(y), torch.from_numpy(y_hat), update_u=update)
        for g_list, w_list in zip(got[:2], want[:2]):
            for g, w in zip(g_list, w_list):
                _check(g, w)
        for g_maps, w_maps in zip(got[2:], want[2:]):
            for gd, wd in zip(g_maps, w_maps):
                for g, w in zip(gd, wd):
                    _check(g, w)
        new = mrsd_from_jax({"params": jvars["params"], "spectral": mut["spectral"]})
        sd = td.state_dict()
        n_uv = 0
        for k in sd:
            # the spectral-normalised discriminator's u / v (disc_1's
            # weight_v is its weight norm's direction)
            if k.startswith("discriminators.0.") and k.endswith(("weight_u", "weight_v")):
                np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(), atol=1e-5)
                assert update or torch.equal(sd[k], before[k]), k
                n_uv += 1
        assert n_uv == 10
        td.load_state_dict(mrsd_from_jax(jvars))


def test_mrsd_d_loss_gradient_through_power_iteration():
    """The D loss's gradient with update_u=True: JAX differentiates through
    the real pass's power iteration (its u and v are functions of W), the
    port does the same."""
    rng = np.random.default_rng(4)
    y = rng.standard_normal((2, 1024, 16)).astype(np.float32)
    y_hat = rng.standard_normal((2, 1024, 16)).astype(np.float32)
    jd, jvars = mrsd_vars(61, y)

    def loss_fn(params):
        (dr, dg, _, _), _ = jd.apply({"params": params, "spectral": jvars["spectral"]},
                                     y, y_hat, update_u=True, mutable=["spectral"])
        return jlosses.discriminator_loss(dr, dg)[0]

    want_loss, grads = jax.value_and_grad(loss_fn)(jvars["params"])
    td = tdisc.MultiResSpecDiscriminator(device="cpu")
    td.load_state_dict(mrsd_from_jax(jvars), strict=True)
    dr, dg, _, _ = td(torch.from_numpy(y), torch.from_numpy(y_hat), update_u=True)
    loss = tlosses.discriminator_loss(dr, dg)[0]
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = mrsd_from_jax({"params": grads, "spectral": jvars["spectral"]})
    for k, p in td.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)


def test_mrsd_weight_roundtrip():
    """Port MRSD state_dict (the reference's names) -> the JAX package's
    convert_mrsd -> mrsd_from_jax: the same names and values."""
    td = tdisc.MultiResSpecDiscriminator(seed=5, device="cpu")
    sd = td.state_dict()
    out = mrsd_from_jax(jconvert.convert_mrsd(sd))
    assert out.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(out[k], v), k


# ---------------------------------------------------------------- RVQ


def rvq_init(seed, n_q=2, bins=64, dim=20):
    rng = np.random.default_rng(seed)
    vq = {}
    for i in range(n_q):
        embed = rng.standard_normal((bins, dim)).astype(np.float32)
        vq[f"vq_{i}"] = {"codebook": {
            "embed": embed,
            "embed_avg": embed * rng.uniform(0.5, 2.0, (bins, 1)).astype(np.float32),
            # some counts under the dead-code threshold of 2
            "cluster_size": rng.uniform(0.0, 6.0, bins).astype(np.float32),
            "inited": np.asarray(True)}}
    return vq


def rvq_buffers(vq: dict) -> dict:
    out = {}
    for name, st in vq.items():
        cb, p = st["codebook"], f"vq.layers.{int(name[3:])}._codebook"
        out[f"{p}.inited"] = torch.ones(1)
        for k in ("embed", "embed_avg", "cluster_size"):
            out[f"{p}.{k}"] = torch.from_numpy(np.asarray(cb[k], np.float32))
    return out


def test_rvq_training_forward_matches_jax_and_ignores_the_rng():
    """RVQ(train=True), two stages: codes exact; quantized (straight-through),
    commit loss and the EMA state within 1e-5; x's gradient of
    sum(c * quantized) + commit; the JAX update is the same for two VQ rngs
    and none (the dead-code draw is overwritten in the same update)."""
    jq = JaxRVQ(dimension=20, n_q=2, bins=64)
    vq = rvq_init(7)
    x = np.random.default_rng(8).standard_normal((2, 10, 20)).astype(np.float32)
    c = np.random.default_rng(9).standard_normal((2, 10, 20)).astype(np.float32)

    def run(rng):
        def f(xx):
            (q, codes, commit), mut = jq.apply({"vq": vq}, xx, train=True, rng=rng,
                                               mutable=["vq"])
            return jnp.sum(q * c) + commit, (q, codes, commit, mut["vq"])
        return jax.value_and_grad(f, has_aux=True)(x)

    (_, (q, codes, commit, new)), gx = run(jax.random.PRNGKey(1))
    for key in (jax.random.PRNGKey(2), None):
        (_, (q2, codes2, commit2, new2)), gx2 = run(key)
        assert np.array_equal(np.asarray(codes2), np.asarray(codes))
        for a, b in zip(jax.tree_util.tree_leaves((q2, commit2, new2, gx2)),
                        jax.tree_util.tree_leaves((q, commit, new, gx))):
            assert np.array_equal(np.asarray(a), np.asarray(b))

    tq = TorchRVQ(20, 2, 64)
    tq.load_state_dict(rvq_buffers(vq), strict=True)
    tx = torch.from_numpy(x).requires_grad_()
    tqz, tcodes, tcommit = tq(tx, train=True)
    ((tqz * torch.from_numpy(c)).sum() + tcommit).backward()
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
    _check(tqz, q, atol=1e-5)
    np.testing.assert_allclose(float(tcommit), float(commit), rtol=1e-5)
    _check(tx.grad, gx, atol=1e-5)
    for k, v in rvq_buffers(new).items():
        np.testing.assert_allclose(tq.state_dict()[k].numpy(), v.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    # eval: no update, no commit, the plain codebook lookup
    before = {k: v.clone() for k, v in tq.state_dict().items()}
    q0, _, c0 = tq(tx.detach(), train=False)
    assert float(c0) == 0.0 and all(torch.equal(v, before[k])
                                    for k, v in tq.state_dict().items())
    assert torch.equal(q0, tq.decode(tq.encode(tx.detach())))


def test_kmeans_and_init_rvq_state_match_jax():
    samples = np.random.default_rng(10).standard_normal((300, 20)).astype(np.float32)
    for n_clusters in (64, 400):   # fewer / more clusters than samples
        want = jkmeans.kmeans(samples, n_clusters, seed=3)
        got = tkmeans.kmeans(samples, n_clusters, seed=3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    tq = TorchRVQ(20, 2, 64)
    tkmeans.init_rvq_state(tq, samples, seed=4)
    want = jkmeans.init_rvq_state(rvq_init(0), samples, seed=4)
    for k, v in rvq_buffers(want).items():
        assert torch.equal(tq.state_dict()[k], v), k


# ---------------------------------------------------------------- collate


def test_collate_matches_jax():
    rng = np.random.default_rng(11)
    items = []
    for t, n, m in ((24, 5, 30), (40, 9, 17), (8, 3, 64)):
        items.append({"x_ids": rng.integers(0, 100, n).astype(np.int32),
                      "tone": rng.integers(0, 5, n).astype(np.int32),
                      "language": rng.integers(0, 3, n).astype(np.int32),
                      "w2v": rng.standard_normal((t, 1024)).astype(np.float32),
                      "mel": rng.standard_normal((t, 80)).astype(np.float32),
                      "pitch": rng.uniform(0, 300, 4 * t).astype(np.float32),
                      "dur": rng.uniform(1, 9, n).astype(np.float32),
                      "mrte_mel": rng.standard_normal((m, 80)).astype(np.float32)})
    for kw in ({}, {"pad_multiple": 64}, {"pad_multiple": 64, "text_pad_multiple": 16}):
        got, want = tdata.collate(items, **kw), jdata.collate(items, **kw)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


# ---------------------------------------------------------------- TTVModel


def jax_train_forward(jm, jvars, batch, tf, key, train_vq):
    """The JAX training forward with dropout on: (outputs, new vq, masks)."""
    def f(v, b, k):
        out, mut = jm.apply(v, *(b[n] for n in TTV_INPUTS), teacher_force_w2v=tf,
                            deterministic=False, vq_rng=k, train_vq=train_vq,
                            rngs={"dropout": k}, mutable=["vq"])
        return out, mut["vq"]
    args = (jvars, batch, key)
    return fast_jit(with_masks(f), *args)(*args)


@pytest.mark.parametrize("tf,train_vq", [(True, False), (False, True)])
def test_ttv_training_forward_with_dropout_matches_jax(ttvs, tf, train_vq):
    """forward with the JAX dropout masks: every output, and with train_vq
    the codebooks' EMA step (state 1e-5); codes exact."""
    jm, jvars, tm = ttvs
    batch = s2_batch()
    (want, new_vq), masks = jax_train_forward(jm, jvars, batch, tf,
                                              jax.random.PRNGKey(12), train_vq)
    assert len(masks) > 20
    tm.load_state_dict(ttv_from_jax(jvars), strict=True)
    tm.train()
    src = mask_source(masks)
    with dropout_masks(src), torch.no_grad():
        got = tm(*(torch_batch(batch)[n] for n in TTV_INPUTS),
                 teacher_force_w2v=torch.tensor(tf), train_vq=train_vq)
    assert not src.masks, f"{len(src.masks)} masks left: the port has fewer sites"
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    for k in ("l_length", "l_pitch", "pred_lf0", "w2v_pred", "commit_loss",
              "y_mask", "x_mask"):
        _check(got[k], want[k])
    np.testing.assert_allclose(float(got["commit_loss"]), float(want["commit_loss"]),
                               rtol=1e-5)
    vq_want = ttv_from_jax({"params": jvars["params"], "vq": new_vq})
    sd = tm.state_dict()
    for k, v in vq_want.items():
        if k.startswith("quantizer."):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
            if not train_vq:
                assert torch.equal(sd[k], ttv_from_jax(jvars)[k]), k
    tm.load_state_dict(ttv_from_jax(jvars), strict=True)


def test_ttv_eval_mode_and_no_source_draw_nothing(ttvs):
    """Outside a MaskSource, or in eval(), the dropout sites pass their input
    through: the training forward equals JAX's deterministic one."""
    jm, jvars, tm = ttvs
    batch = s2_batch(seed=41)
    want = fast_jit(lambda v, b: jm.apply(v, *(b[n] for n in TTV_INPUTS)),
                    jvars, batch)(jvars, batch)
    tm.load_state_dict(ttv_from_jax(jvars), strict=True)
    for train in (True, False):
        tm.train(train)
        with torch.no_grad():
            got = tm(*(torch_batch(batch)[n] for n in TTV_INPUTS))
        for k in ("l_length", "l_pitch", "pred_lf0", "w2v_pred"):
            _check(got[k], want[k])
    tm.train()


def test_ttv_extraction_methods_match_jax(ttvs):
    """pre_vq_features (and its mask), extract_tc_latent_code (codes exact),
    pooled_prosody_codes, infer_gt_dur with and without an MRTE mel."""
    jm, jvars, tm = ttvs
    batch = s2_batch(seed=42)
    tb = torch_batch(batch)

    def japply(method, *args, **kw):
        return fast_jit(lambda v, *a: jm.apply(v, *a, method=method, **kw),
                        jvars, *args)(jvars, *args)

    with torch.no_grad():
        feats, pmask = tm.pre_vq_features(tb["mel"], tb["mel_lengths"])
        jf, jmask = japply(JaxTTV.pre_vq_features, batch["mel"], batch["mel_lengths"])
        _check(feats, jf)
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))

        x_frame, lr = tm.extract_tc_latent_code(*(tb[k] for k in EXTRACT_INPUTS))
        jx, jlr = japply(JaxTTV.extract_tc_latent_code,
                         *(batch[k] for k in EXTRACT_INPUTS))
        _check(x_frame, jx)
        assert lr.dtype == torch.int32
        np.testing.assert_array_equal(lr.numpy(), np.asarray(jlr))

        pc = tm.pooled_prosody_codes(tb["mel"], tb["mel_lengths"])
        np.testing.assert_array_equal(pc.numpy(), np.asarray(japply(
            JaxTTV.pooled_prosody_codes, batch["mel"], batch["mel_lengths"])))

        base = [batch[k] for k in EXTRACT_INPUTS[:7]]
        tbase = [tb[k] for k in EXTRACT_INPUTS[:7]]
        for extra in ((), ("mrte_mel", "mrte_mel_lengths")):
            jw, jl = japply(JaxTTV.infer_gt_dur, *base, *(batch[k] for k in extra))
            w, lf0 = tm.infer_gt_dur(*tbase, *(tb[k] for k in extra))
            _check(w, jw)
            _check(lf0, jl)


def test_ttv_builds_share_seeded_weights():
    """The training build and the serving build of one seed have the same
    state_dict; only the serving build is frozen in eval()."""
    kw = dict(TTV_SMALL, seed=3, device="cpu")
    a, b = TorchTTV(**kw), TorchTTV(**kw, train=True)
    assert a.state_dict().keys() == b.state_dict().keys()
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert not a.training and not any(p.requires_grad for p in a.parameters())
    assert b.training
    frozen = [k for k, p in b.named_parameters() if not p.requires_grad]
    # the LSTMs' second bias: JAX has one bias per gate (nn/lstm.py)
    assert frozen and all(".bias_hh_l" in k for k in frozen)
