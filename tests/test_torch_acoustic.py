"""The port's acoustic-stage modules against the JAX package on the CPU: the
text frontend copy, feature_mask, the relative-position Encoder, the LSTMs,
the duration / range predictors and Gaussian upsampling, the RVQ, ResBlock1,
the strided dur_downsample conv, and the TTVModel inference methods. The
prosody LM is in test_torch_plm.py, the whole tts path in test_torch_tts.py.

Small configurations with seeded random params (random_params of
test_torch_vocoder.py, plus a seeded N(0, 1) RVQ codebook), padded batches
and a 3-phone text (shorter than the attention window + 1). Tolerance: atol
1e-4 per module; frame lengths and codes exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import (
    bilstm,
    conv1d,
    conv1x1,
    layer_norm,
    resblock1,
    ttv_from_jax,
    vits_encoder,
)
from megatts2_hierspeechpp_torch.data import text as ttext
from megatts2_hierspeechpp_torch.models.ttv import TTVModel as TorchTTV
from megatts2_hierspeechpp_torch.nn import duration as tdur
from megatts2_hierspeechpp_torch.nn.attention import Encoder as TorchEncoder
from megatts2_hierspeechpp_torch.nn.conv import Conv1d as TorchConv1d
from megatts2_hierspeechpp_torch.nn.lstm import BiLSTM as TorchBiLSTM
from megatts2_hierspeechpp_torch.nn.quantize import ResidualVectorQuantizer as TorchRVQ
from megatts2_hierspeechpp_torch.nn.resblocks import ResBlock1 as TorchResBlock1
from megatts2_hierspeechpp_torch.utils.masking import feature_mask as t_feature_mask
from megatts2_hierspeechpp_tpu.data import text as jtext
from megatts2_hierspeechpp_tpu.models.ttv import TTVModel as JaxTTV
from megatts2_hierspeechpp_tpu.nn import duration as jdur
from megatts2_hierspeechpp_tpu.nn.attention import Encoder as JaxEncoder
from megatts2_hierspeechpp_tpu.nn.conv import Conv1d as JaxConv1d
from megatts2_hierspeechpp_tpu.nn.lstm import BiLSTM as JaxBiLSTM
from megatts2_hierspeechpp_tpu.nn.quantize import ResidualVectorQuantizer as JaxRVQ
from megatts2_hierspeechpp_tpu.nn.resblocks import ResBlock1 as JaxResBlock1
from megatts2_hierspeechpp_tpu.utils.masking import feature_mask as j_feature_mask
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_vocoder import _check, random_params

TEXTS = ("sil zh ang1 sp",
         "sil n i3 h ao3 #1 sp w o3 sh iii4 #2 t e2 s t ii4 #4 sil",
         "sil HH AH0 L OW1 , W ER1 L D . sp")
TTV_SMALL = dict(n_vocab=ttext.N_VOCAB, n_tone=ttext.N_TONE,
                 n_language=ttext.N_LANGUAGE, text_layers=1, mel_enc_layers=1,
                 w2v_enc_layers=1, w2v_dec_layers=2)


def _rng(seed):
    return np.random.default_rng(seed)


def _lens_mask(lens, t):
    return (np.arange(t)[None, :] < np.asarray(lens)[:, None])[..., None].astype(
        np.float32)


def test_text_frontend_copy_matches_jax():
    assert ttext.SYMBOLS == jtext.SYMBOLS
    assert (ttext.N_VOCAB, ttext.N_TONE, ttext.N_LANGUAGE) == (
        jtext.N_VOCAB, jtext.N_TONE, jtext.N_LANGUAGE)
    for text in TEXTS:
        assert ttext.process_text(text) == jtext.process_text(text)


def test_feature_mask_matches_jax():
    lens = np.array([5, 1, 8])
    got = t_feature_mask(torch.from_numpy(lens), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_feature_mask(jnp.asarray(lens), 8)))


@pytest.mark.parametrize("lens,t,c,k", [((3,), 3, 16, 9), ((12, 7), 12, 16, 9),
                                        ((5, 2), 5, 20, 1)])
def test_encoder_matches_jax(lens, t, c, k):
    """Post-norm Encoder with windowed relative attention: lengths below,
    at and above window + 1, padded batches."""
    jm = JaxEncoder(c, 3 * c, 4, 2, k)
    rng = _rng(t)
    x = rng.standard_normal((len(lens), t, c)).astype(np.float32)
    mask = _lens_mask(lens, t)
    params = random_params(jm, 1, x, mask)
    sd = {}
    vits_encoder(sd, "", params)
    tm = TorchEncoder(c, 3 * c, 4, 2, k)
    tm.load_state_dict(sd, strict=True)
    _check(tm(torch.from_numpy(x), torch.from_numpy(mask)),
           jax.jit(jm.apply)({"params": params}, x, mask))


@pytest.mark.parametrize("length_aware", [True, False])
def test_bilstm_padded_batch_matches_jax(length_aware):
    """length_aware (RangePredictor): packed sequences; not length_aware
    (DurationPredictor): the backward direction consumes the padding."""
    jm = JaxBiLSTM(12, length_aware=length_aware)
    rng = _rng(2)
    x = rng.standard_normal((3, 9, 10)).astype(np.float32)
    lens = np.array([9, 4, 1])
    params = random_params(jm, 2, x, lens)
    sd = {}
    bilstm(sd, "", params)
    tm = TorchBiLSTM(10, 12, length_aware=length_aware)
    tm.load_state_dict(sd, strict=True)
    _check(tm(torch.from_numpy(x), torch.from_numpy(lens)),
           jax.jit(jm.apply)({"params": params}, x, lens))


def test_duration_range_and_gaussian_upsample_match_jax():
    rng = _rng(3)
    b, n, c = 2, 7, 16
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    lens = np.array([7, 4])
    mask = _lens_mask(lens, n)
    g = rng.standard_normal((b, 8)).astype(np.float32)

    jdp = jdur.DurationPredictor(filter_channels=12, gin_channels=8)
    p = random_params(jdp, 4, x, mask, g)
    sd = {}
    conv1x1(sd, "cond", p["cond"])
    for i in range(2):
        bilstm(sd, "lstms", p["lstms"][f"layer_{i}"], i)
    layer_norm(sd, "norm_2", p["norm_2"])
    conv1x1(sd, "proj", p["proj"])
    tdp = tdur.DurationPredictor(c, 12, 8)
    tdp.load_state_dict(sd, strict=True)
    want = jax.jit(jdp.apply)({"params": p}, x, mask, g)
    _check(tdp(*map(torch.from_numpy, (x, mask, g))), want)

    dur = np.ceil(np.exp(np.asarray(want))[..., 0] * 3.0).astype(np.float32)
    jrp = jdur.RangePredictor(12)
    p = random_params(jrp, 5, x, dur, lens)
    sd = {}
    bilstm(sd, "lstm", p["lstm"])
    sd["proj.linear_layer.weight"] = torch.from_numpy(np.asarray(p["proj"]["kernel"]).T.copy())
    sd["proj.linear_layer.bias"] = torch.from_numpy(np.asarray(p["proj"]["bias"]))
    trp = tdur.RangePredictor(c, 12)
    trp.load_state_dict(sd, strict=True)
    want = jax.jit(jrp.apply)({"params": p}, x, dur, lens)
    got = trp(*map(torch.from_numpy, (x, dur, lens)))
    _check(got, want)

    ranges = np.maximum(np.asarray(want), 1e-5)
    out_len = int(dur.sum(1).max())
    _check(tdur.gaussian_upsample(*map(torch.from_numpy, (x, dur, ranges, lens)), out_len),
           jdur.gaussian_upsample(x, dur, ranges, lens, out_len))


def test_rvq_encode_decode_match_jax():
    rng = _rng(6)
    x = rng.standard_normal((2, 11, 20)).astype(np.float32)
    embed = [rng.standard_normal((64, 20)).astype(np.float32) for _ in range(2)]
    jm = JaxRVQ(20, n_q=2, bins=64)
    vq = {f"vq_{i}": {"codebook": {"embed": e, "embed_avg": e,
                                   "cluster_size": np.zeros(64, np.float32),
                                   "inited": np.asarray(True)}}
          for i, e in enumerate(embed)}
    tm = TorchRVQ(20, n_q=2, bins=64)
    for i, e in enumerate(embed):
        tm.vq.layers[i]._codebook.embed.copy_(torch.from_numpy(e))
    want = jm.apply({"vq": vq}, x, method=JaxRVQ.encode)
    got = tm.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check(tm.decode(got), jm.apply({"vq": vq}, want, method=JaxRVQ.decode))


def test_resblock1_and_strided_conv_match_jax():
    rng = _rng(7)
    x = rng.standard_normal((2, 13, 16)).astype(np.float32)
    jm = JaxResBlock1(16, 5, (1, 3, 5))
    p = random_params(jm, 8, x)
    sd = {}
    resblock1(sd, "", p)
    tm = TorchResBlock1(16, 5, (1, 3, 5))
    tm.load_state_dict(sd, strict=True)
    _check(tm(torch.from_numpy(x)), jm.apply({"params": p}, x))

    # dur_downsample: k=1, stride 2 -> ceil(13 / 2) = 7 frames
    jc = JaxConv1d(12, 1, stride=2)
    p = random_params(jc, 9, x)
    sd = {}
    conv1d(sd, "", p)
    tc = TorchConv1d(16, 12, 1, stride=2)
    tc.load_state_dict(sd, strict=True)
    got = tc(torch.from_numpy(x))
    assert got.shape == (2, 7, 12)
    _check(got, jc.apply({"params": p}, x))


# ---------------------------------------------------------------- TTVModel


def ttv_init_args(b=1, n=4, t=16):
    return (np.zeros((b, n), np.int32), np.zeros((b, n), np.int32),
            np.zeros((b, n), np.int32), np.full((b,), n, np.int32),
            np.zeros((b, t, 1024), np.float32), np.full((b,), t, np.int32),
            np.zeros((b, t, 80), np.float32), np.full((b,), t, np.int32),
            np.zeros((b, 4 * t), np.float32), np.full((b,), 4 * t, np.int32),
            np.full((b, n), 2 * t / n, np.float32),
            np.zeros((b, 24, 80), np.float32), np.full((b,), 24, np.int32))


def random_ttv_vars(jm, seed):
    """Seeded {"params", "vq"} for a JAX TTVModel: random_params plus an
    N(0, 1) codebook."""
    params = random_params(jm, seed, *ttv_init_args())
    embed = _rng(seed + 100).standard_normal((jm.vq_bins, jm.prosody_size)).astype(
        np.float32)
    vq = {"quantizer": {"vq_0": {"codebook": {
        "embed": embed, "embed_avg": embed,
        "cluster_size": np.zeros(jm.vq_bins, np.float32),
        "inited": np.asarray(True)}}}}
    return {"params": params, "vq": vq}


@pytest.fixture(scope="module")
def ttvs():
    jm = JaxTTV(**TTV_SMALL)
    jvars = random_ttv_vars(jm, 21)
    tm = TorchTTV(**TTV_SMALL, device="cpu")
    tm.load_state_dict(ttv_from_jax(jvars), strict=True)
    return jm, jvars, tm


def _text_batch(texts):
    seqs = [ttext.process_text(t) for t in texts]
    n = max(len(s[0]) for s in seqs)
    out = np.zeros((3, len(texts), n), np.int64)
    for i, s in enumerate(seqs):
        for j in range(3):
            out[j, i, :len(s[j])] = s[j]
    return (*out, np.array([len(s[0]) for s in seqs]))


def _mel_batch(lens, seed):
    mel = _rng(seed).standard_normal((len(lens), max(lens), 80)).astype(np.float32)
    return mel * _lens_mask(lens, max(lens)), np.asarray(lens)


@pytest.mark.parametrize("texts,mel_lens", [((TEXTS[0],), (40,)),
                                            ((TEXTS[1], TEXTS[2]), (40, 27))])
def test_ttv_inference_methods_match_jax(ttvs, texts, mel_lens):
    """predict_frame_lengths, inf_extract_tc_latent, inf_plm_gen and
    prompt_codes; a 3-phone text alone and a padded batch of two."""
    jm, jvars, tm = ttvs
    x_ids, tone, lang, x_len = _text_batch(texts)
    mel, mel_len = _mel_batch(mel_lens, 22)
    ls = 1.3
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    jargs = (x_ids.astype(np.int32), tone.astype(np.int32), lang.astype(np.int32),
             x_len.astype(np.int32), mel, mel_len.astype(np.int32))
    targs = (t(x_ids), t(tone), t(lang), t(x_len), t(mel), t(mel_len))

    def japply(method, *args, **kw):
        return jax.jit(lambda v, *a: jm.apply(v, *a, method=method, **kw))(jvars, *args)

    want_f = np.asarray(japply(JaxTTV.predict_frame_lengths, *jargs, ls))
    got_f = tm.predict_frame_lengths(*targs, ls)
    np.testing.assert_array_equal(got_f.numpy(), want_f)

    budget = 2 * int(want_f.max()) + 3
    jx, jg, jlen, jmask = japply(JaxTTV.inf_extract_tc_latent, *jargs,
                                 out_length=budget, length_scale=ls)
    tx, tg, tlen, tmask = tm.inf_extract_tc_latent(*targs, budget, length_scale=ls)
    assert tx.shape == (len(texts), -(-budget // 2), 256)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    _check(tx, jx)
    _check(tg, jg)
    _check(tmask, jmask)

    codes = _rng(23).integers(0, 1024, (1, len(texts), tx.shape[1]))
    jw, jl = japply(JaxTTV.inf_plm_gen, jx, jg, codes.astype(np.int32), jlen, jmask)
    tw, tl = tm.inf_plm_gen(tx, tg, t(codes), tmask)
    assert tl.shape == (len(texts), 4 * tx.shape[1])
    _check(tw, jw)
    _check(tl, jl)

    want_pc = japply(JaxTTV.prompt_codes, mel, mel_len.astype(np.int32))
    np.testing.assert_array_equal(tm.prompt_codes(t(mel), t(mel_len)).numpy(),
                                  np.asarray(want_pc))
