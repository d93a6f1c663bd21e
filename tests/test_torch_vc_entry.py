"""The port's voice-conversion entry point, TTSPipeline.vc, against the JAX
TTSPipeline.vc on the CPU (the pattern of test_pipeline.py's vc test, with
a small Wav2Vec2), at 16 and 48 kHz, denoise_ratio 0 and 0.8; and the
hazards the JAX package met: the source padded to a 1280 multiple, the w2v
input reflect-padded by 40, the f0 speaker normalisation (only when both
voiced sets are non-empty, clipped at 0, numpy's ddof-0 std), log-f0 cut or
zero-padded to 4 values per frame, and the posterior noise seeded with
`seed` where tts uses seed + 1.

Small models: the test_torch_tts.py vocoder and 8-channel SpeechSR-48k, the
test_torch_denoiser.py MPNet, Wav2Vec2(hidden 1024 for the vocoder's input,
4 heads, FFN 256, conv_dim (32,) x 7, pos kernel 16 / groups 4,
output_layer 1); seeded random params, the same weights on both sides;
noise_scale_vc = 0 (the frameworks draw different noise from a seed); the
denoiser's STFT from the JAX function on both sides (the edge-frame phase
hazard, test_torch_denoiser.py). Tolerances: w2v features atol 1e-4;
log-f0 atol 1e-5; the peak-normalised waveform within 2e-4 of its peak:
on identical w2v and log-f0 the random-weight test vocoder alone differs
from the JAX one by 0.8-1.0e-4 of the peak on these voiced contours, and
the 1e-6 relative w2v and 5e-7 log-f0 differences of the two front ends
reach 1.0-1.5e-4 through it."""
import dataclasses

import numpy as np
import pytest
import torch

from megatts2_hierspeechpp_torch.convert import wav2vec2_from_jax
from megatts2_hierspeechpp_torch.models.wav2vec2 import Wav2Vec2 as TorchW2V
from megatts2_hierspeechpp_tpu.models.wav2vec2 import Wav2Vec2 as JaxW2V
from tests.test_f0 import _harmonic
from tests.test_torch_denoiser import jax_stft, small_denoisers  # noqa: F401
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_pipeline import speechsrs  # noqa: F401  (fixture)
from tests.test_torch_serving import _close
from tests.test_torch_tts import pipelines  # noqa: F401  (fixture)
from tests.test_torch_vocoder import _check, vocoders  # noqa: F401  (fixture)
from tests.test_torch_wav2vec2 import random_vars

W2V = dict(hidden_size=1024, n_heads=4, ffn_dim=256, output_layer=1,
           conv_dim=(32,) * 7, pos_conv_kernel=16, pos_conv_groups=4)
KW = dict(noise_scale_vc=0.0, seed=5)


@pytest.fixture(scope="module")
def vc_pipelines(pipelines):
    """(JAX pipeline, port pipeline, JAX w2v, its params, port w2v, source,
    target): both pipelines with the same small denoiser."""
    jp, tp, _ = pipelines
    jm, dvars, tm = small_denoisers(seed=7)
    jp = dataclasses.replace(jp, denoiser=jm, denoiser_vars=dvars, _jits={})
    tp = dataclasses.replace(tp, denoiser=tm)
    jw = JaxW2V(**W2V)
    wparams = random_vars(jw, 8, np.zeros((1, 3200), np.float32))["params"]
    tw = TorchW2V(**W2V, device="cpu")
    tw.load_state_dict(wav2vec2_from_jax(wparams), strict=True)
    rng = np.random.default_rng(9)
    src = (0.4 * _harmonic([140.0, 190.0], t=1.2)[0]
           + 0.01 * rng.standard_normal(19200)).astype(np.float32)[:19000]
    trg = (0.4 * _harmonic([210.0], t=1.5)[0]
           + 0.01 * rng.standard_normal(24000)).astype(np.float32)[:23000]
    return jp, tp, jw, wparams, tw, src, trg


@pytest.mark.parametrize("output_sr", [16000, 48000])
@pytest.mark.parametrize("denoise_ratio", [0.0, 0.8])
def test_vc_matches_jax(vc_pipelines, jax_stft, output_sr, denoise_ratio):
    jp, tp, jw, wparams, tw, src, trg = vc_pipelines
    kw = dict(KW, denoise_ratio=denoise_ratio, output_sr=output_sr)
    want, winter = jp.vc(src, trg, jw, wparams, return_intermediates=True, **kw)
    got, inter = tp.vc(src, trg, tw, return_intermediates=True, **kw)
    t = winter["t_frames"]
    assert inter["t_frames"] == t == 15 * 1280 // 320  # 19000 -> 19200 samples
    assert got.shape == want.shape == (320 * t * output_sr // 16000,)
    _check(inter["w2v"], winter["w2v"])
    np.testing.assert_allclose(inter["lf0"], winter["lf0"], atol=1e-5, rtol=0)
    assert (inter["lf0"] > 0).mean() > 0.8  # voiced: the normalisation ran
    _close(got, want, tol=2e-4)


def test_vc_with_f0_given_matches_jax(vc_pipelines):
    """src_f0 / trg_f0 replace the tracker; the normalised log-f0 is numpy's
    ddof-0 statistics, not the unbiased estimator (told apart by a target
    of 4 voiced frames against a source of 205)."""
    jp, tp, jw, wparams, tw, src, trg = vc_pipelines
    rng = np.random.default_rng(10)
    src_f0 = rng.uniform(100, 180, 240).astype(np.float32)
    src_f0[::7] = 0.0
    trg_f0 = np.zeros(287, np.float32)
    trg_f0[[3, 90, 150, 260]] = (190.0, 230.0, 250.0, 210.0)
    want, winter = jp.vc(src, trg, jw, wparams, src_f0=src_f0, trg_f0=trg_f0,
                         return_intermediates=True, **KW)
    got, inter = tp.vc(src, trg, tw, src_f0=src_f0, trg_f0=trg_f0,
                       return_intermediates=True, **KW)
    np.testing.assert_allclose(inter["lf0"], winter["lf0"], atol=1e-5, rtol=0)
    _close(got, want, tol=2e-4)

    ii, jj = src_f0 > 0, trg_f0 > 0

    def normalised(ddof):
        f = src_f0.copy()
        z = (f[ii] - f[ii].mean()) / f[ii].std(ddof=ddof)
        f[ii] = np.clip(z * trg_f0[jj].std(ddof=ddof) + trg_f0[jj].mean(), 0, None)
        return np.log(f + 1.0)

    np.testing.assert_allclose(inter["lf0"], normalised(0), atol=1e-5, rtol=0)
    assert np.abs(inter["lf0"] - normalised(1)).max() > 1e-4
    assert (inter["lf0"][~ii] == 0).all()


def test_vc_normalisation_clips_at_zero(vc_pipelines):
    """A few source frames far below the source's mean, mapped onto a
    target of low mean and spread, fall below 0 Hz: clipped to 0 (log-f0
    0), as the JAX vc."""
    jp, tp, jw, wparams, tw, src, trg = vc_pipelines
    src_f0 = np.full(240, 1000.0, np.float32)
    src_f0[:10] = 100.0
    trg_f0 = np.full(287, 60.0, np.float32)
    trg_f0[:3] = 400.0
    _, winter = jp.vc(src, trg, jw, wparams, src_f0=src_f0, trg_f0=trg_f0,
                      return_intermediates=True, **KW)
    _, inter = tp.vc(src, trg, tw, src_f0=src_f0, trg_f0=trg_f0,
                     return_intermediates=True, **KW)
    assert (inter["lf0"] == 0).sum() == 10 and (inter["lf0"][:10] == 0).all()
    np.testing.assert_allclose(inter["lf0"], winter["lf0"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("which", ["source", "target"])
def test_vc_skips_normalisation_without_voiced_frames(vc_pipelines, which):
    """An all-unvoiced source or target: the source f0 passes as it is."""
    jp, tp, jw, wparams, tw, src, trg = vc_pipelines
    src_f0 = np.linspace(90, 170, 240).astype(np.float32)
    trg_f0 = np.linspace(200, 250, 287).astype(np.float32)
    if which == "source":
        src_f0[:] = 0.0
    else:
        trg_f0[:] = 0.0
    _, winter = jp.vc(src, trg, jw, wparams, src_f0=src_f0, trg_f0=trg_f0,
                      return_intermediates=True, **KW)
    _, inter = tp.vc(src, trg, tw, src_f0=src_f0, trg_f0=trg_f0,
                     return_intermediates=True, **KW)
    np.testing.assert_allclose(inter["lf0"], np.log(src_f0 + 1.0), atol=1e-6)
    np.testing.assert_allclose(inter["lf0"], winter["lf0"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_f0", [200, 240, 300])
def test_vc_padding_and_lf0_length(vc_pipelines, monkeypatch, n_f0):
    """The source is zero-padded to the next 1280 multiple (19000 -> 19200:
    60 frames), the w2v model reads it reflect-padded by 40, and the
    vocoder's log-f0 is the given contour cut or zero-padded to 4 x 60."""
    _, tp, _, _, tw, src, trg = vc_pipelines
    seen = {}
    orig_w2v, orig_vc = tw.forward, tp.vocoder.voice_conversion

    def w2v_spy(x):
        seen["w2v_in"] = x.clone()
        return orig_w2v(x)

    def vc_spy(w2v, mask, mel, trg_mask, f0, *args):
        seen["f0"] = f0.clone()
        return orig_vc(w2v, mask, mel, trg_mask, f0, *args)

    monkeypatch.setattr(tw, "forward", w2v_spy)
    monkeypatch.setattr(tp.vocoder, "voice_conversion", vc_spy)
    src_f0 = np.linspace(100, 200, n_f0).astype(np.float32)
    tp.vc(src, trg, tw, src_f0=src_f0, trg_f0=np.zeros(10, np.float32), **KW)
    x = seen["w2v_in"][0].numpy()
    padded = np.pad(src, (0, 200))
    assert x.shape == (19200 + 80,)
    np.testing.assert_array_equal(x[40:-40], padded)
    np.testing.assert_array_equal(x[:40], padded[40:0:-1])
    np.testing.assert_array_equal(x[-40:], padded[-2:-42:-1])
    f0 = seen["f0"][0, :, 0].numpy()
    assert f0.shape == (240,)
    n = min(n_f0, 240)
    np.testing.assert_allclose(f0[:n], np.log(src_f0[:n] + 1.0), atol=1e-6)
    assert (f0[n:] == 0).all()


def test_vc_noise_is_seeded_with_seed_and_tts_with_seed_plus_1(
        pipelines, vc_pipelines, monkeypatch):
    """vc draws its posterior noise from a generator seeded with `seed`;
    tts (unchanged) from seed + 1."""
    _, tp, _, _, tw, src, trg = vc_pipelines
    _, tp_tts, audio = pipelines
    gens = []

    def spy(w2v, mask, mel, trg_mask, f0, noise_scale, gen, *args):
        gens.append(torch.randn(8, generator=gen))
        return torch.zeros(1, 320 * w2v.shape[1], 1)

    for p in (tp, tp_tts):
        monkeypatch.setattr(p.vocoder, "voice_conversion", spy)
    tp.vc(src, trg, tw, seed=11)
    tp_tts.tts("sil n i3 h ao3 sp", audio, seed=11)
    assert torch.equal(gens[0], torch.randn(8, generator=torch.Generator().manual_seed(11)))
    assert torch.equal(gens[1], torch.randn(8, generator=torch.Generator().manual_seed(12)))


def test_vc_checks_output_sr_first(vc_pipelines):
    _, tp, _, _, tw, src, trg = vc_pipelines
    with pytest.raises(ValueError, match="does not match"):
        tp.vc(src, trg, tw, output_sr=24000)
