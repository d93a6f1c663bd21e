"""The port's whole zero-shot path, TTSPipeline.tts(..., exact=True) (text +
prompt audio -> 48 kHz waveform), against the JAX TTSPipeline.tts(...,
exact=True) on the CPU, for use_plm=True (greedy PLM decode) and
use_plm=False (the prompt's own RVQ codes), and with a denoiser at
denoise_ratio 0.5; the log-f0 convention at the vocoder's input. The
bucketed default, exact=False, is held against the JAX default in
test_torch_serving.py.

Small configuration: TTVModel(text_layers=1, mel_enc_layers=1,
w2v_enc_layers=1, w2v_dec_layers=2), ProsodyLM(n_layers=2) at full width
(d = 276), the test_torch_vocoder.py HierVocoder and an 8-channel
SpeechSR-48k, seeded random params; noise_scale_vc = 0 (the frameworks draw
different noise from a seed). Tolerances: frame lengths and codes exact;
x_frame, w2v and log-f0 atol 1e-4; the 48 kHz waveform before
normalisation atol 1e-4 relative to its peak, which is the per-module
float32 agreement carried through the vocoder and SpeechSR (the decode path
alone meets it in test_torch_pipeline.py). With the denoiser
(test_torch_denoiser.py's small MPNet), both sides take the denoiser's STFT
from the JAX function (the edge-frame phase hazard, test_torch_denoiser.py);
the denoised row of the mel pair atol 1e-4 plus rtol 1e-4: its log-mel
values reach 6.3, and the small MPNet's float32 differences leave 2-3 of
its 8480 values 1.2-1.9e-4 apart (4e-5 relative)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import plm_from_jax, ttv_from_jax
from megatts2_hierspeechpp_torch.infer import pipeline as tpipe
from megatts2_hierspeechpp_torch.models.plm import ProsodyLM as TorchPLM
from megatts2_hierspeechpp_torch.models.ttv import TTVModel as TorchTTV
from megatts2_hierspeechpp_tpu.infer.pipeline import TTSPipeline as JaxPipeline
from megatts2_hierspeechpp_tpu.models.plm import ProsodyLM as JaxPLM
from megatts2_hierspeechpp_tpu.models.ttv import TTVModel as JaxTTV
from tests.test_torch_acoustic import TTV_SMALL, random_ttv_vars
from tests.test_torch_denoiser import jax_stft, small_denoisers  # noqa: F401
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_pipeline import speechsrs  # noqa: F401  (fixture)
from tests.test_torch_plm import plm_params
from tests.test_torch_vocoder import _check, vocoders  # noqa: F401  (fixture)

TEXT = "sil n i3 h ao3 #1 sp sh iii4 j ie4 #4 sil"


@pytest.fixture(scope="module")
def pipelines(vocoders, speechsrs):
    jvoc, voc_params, tvoc = vocoders
    jsr, sr_params, tsr = speechsrs[(3, 1)]
    jttv = JaxTTV(**TTV_SMALL)
    ttv_vars = random_ttv_vars(jttv, 41)
    # spread the predicted log-f0 so that part of it lies above the log(55)
    # clip and part below
    pp = ttv_vars["params"]["pp"]
    pp["conv_post"]["kernel"] = pp["conv_post"]["kernel"] * 60.0
    jplm = JaxPLM(n_layers=2, p_dropout=0.0)
    params = plm_params(jplm, 42)
    jp = JaxPipeline(jttv, ttv_vars, jplm, params, jvoc, {"params": voc_params},
                     speechsr=jsr, speechsr_params=sr_params)
    tttv = TorchTTV(**TTV_SMALL, device="cpu")
    tttv.load_state_dict(ttv_from_jax(ttv_vars), strict=True)
    tplm = TorchPLM(n_layers=2, device="cpu")
    tplm.load_state_dict(plm_from_jax(params), strict=True)
    tp = tpipe.TTSPipeline(tvoc, tsr, "cpu", ttv=tttv, plm=tplm)
    audio = (np.random.default_rng(43).standard_normal(17000) * 0.2).astype(np.float32)
    return jp, tp, audio


@pytest.fixture(scope="module")
def denoised_pipelines(pipelines):
    """The pipelines of `pipelines` with one small MPNet attached to both."""
    jp, tp, audio = pipelines
    jm, dvars, tm = small_denoisers(seed=44)
    return (dataclasses.replace(jp, denoiser=jm, denoiser_vars=dvars, _jits={}),
            dataclasses.replace(tp, denoiser=tm), audio)


@pytest.mark.parametrize("use_plm", [True, False])
def test_tts_matches_jax_exact(pipelines, use_plm):
    jp, tp, audio = pipelines
    kw = dict(noise_scale_vc=0.0, output_sr=48000, use_plm=use_plm, seed=5)
    want, inter = jp.tts(TEXT, audio, exact=True, return_intermediates=True, **kw)
    got, ac, raw = tp.tts(TEXT, audio, exact=True, return_intermediates=True,
                          **kw)

    t = inter["frame_lengths"]
    assert ac.frames == t and ac.w2v.shape == (1, t, 1024)
    np.testing.assert_array_equal(ac.codes.numpy(), inter["codes"])
    _check(ac.x_frame, inter["x_frame"])
    _check(ac.w2v, inter["w2v"])
    _check(ac.lf0, inter["lf0"])
    voiced = (ac.lf0 > 0).float().mean()
    assert 0.1 < voiced < 0.9, voiced

    # the JAX waveform before normalisation: its own vocode and sr stages on
    # its own intermediates, as tts(exact=True) runs them
    prompt = jp.prepare_prompt(audio)
    wav = jp._stage("vocode")(
        jp.vocoder_params, jnp.asarray(inter["w2v"]), jnp.ones((1, t, 1)),
        prompt.mel_pair, jnp.asarray(inter["lf0"])[..., None], jnp.float32(0.0),
        jax.random.PRNGKey(6), jnp.float32(0.0))
    jraw = np.asarray(jp._stage("sr")(jp.speechsr_params, wav))[0, :960 * t, 0]
    np.testing.assert_allclose(
        jraw / max(np.abs(jraw).max(), 1e-8) * 0.999, want, atol=1e-6, rtol=0)
    assert raw.shape == (960 * t,) and got.shape == (960 * t,)
    peak = np.abs(jraw).max()
    np.testing.assert_allclose(raw.numpy(), jraw, atol=1e-4 * peak, rtol=0)
    assert abs(np.abs(got).max() - 0.999) < 1e-6


def test_prompt_features_of_tts(pipelines):
    """mel_ttv is the mel of the prompt padded to (T // 1600 + 1) * 1600
    samples (at least one sample added); mel_pair is at the true length."""
    jp, tp, audio = pipelines
    for n in (16000, 17000):
        want = jp.prepare_prompt(audio[:n])
        got = tp.prepare_prompt(audio[:n])
        assert got.t_samples == n
        assert got.mel_ttv.shape[1] == (n // 1600 + 1) * 1600 // 320
        _check(got.mel_ttv, want.mel_ttv)
        _check(got.mel_pair, want.mel_pair)


def test_vocoder_gets_clipped_log_f0_unconverted(pipelines, monkeypatch):
    """tts feeds the vocoder the TTV's log(f0 + 1) after the log(55) clip:
    a value below the clip becomes 0, one above it passes exactly, with no
    exp / log in between (the JAX pipeline's convention)."""
    _, tp, audio = pipelines
    below, above = math.log(55.0) - 0.01, math.log(201.0)
    seen = {}

    def fake_gen(x_frame, g, codes, frame_mask):
        t = x_frame.shape[1]
        lf0 = torch.tensor([below, above]).repeat(2 * t)[None]
        return torch.zeros(1, t, 1024), lf0

    def spy(w2v, mask, mel, trg_mask, f0, *args):
        seen["f0"] = f0.clone()
        return torch.zeros(1, 320 * w2v.shape[1], 1)

    monkeypatch.setattr(tp.ttv, "inf_plm_gen", fake_gen)
    monkeypatch.setattr(tp.vocoder, "voice_conversion", spy)
    tp.tts(TEXT, audio, output_sr=16000)
    f0 = seen["f0"][0, :, 0]
    assert f0.shape[0] % 4 == 0
    assert torch.equal(f0[0::2], torch.zeros_like(f0[0::2]))
    assert torch.equal(f0[1::2], torch.full_like(f0[1::2], above))
    assert tpipe.LF0_FLOOR == math.log(55.0)


def test_tts_refuses_what_is_not_ported(pipelines):
    _, tp, audio = pipelines
    with pytest.raises(ValueError, match="does not match"):
        tp.tts(TEXT, audio, output_sr=24000)


@pytest.mark.parametrize("bucket", [False, True])
def test_prepare_prompt_denoised_pair_matches_jax(denoised_pipelines, jax_stft,
                                                  bucket):
    """denoise_ratio > 0: the second row of the mel pair is the mel of the
    padded prompt denoised and cut to the prompt's length, as the JAX
    prepare_prompt; the first row and mel_ttv are the prompt's own."""
    jp, tp, audio = denoised_pipelines
    want = jp.prepare_prompt(audio, denoise_ratio=0.5, bucket=bucket)
    got = tp.prepare_prompt(audio, denoise_ratio=0.5, bucket=bucket)
    _check(got.mel_ttv, want.mel_ttv)
    _check(got.mel_pair[0], want.mel_pair[0])
    np.testing.assert_allclose(got.mel_pair[1].numpy(), want.mel_pair[1],
                               atol=1e-4, rtol=1e-4)
    plain = tp.prepare_prompt(audio, bucket=bucket)
    assert torch.equal(got.mel_pair[0], plain.mel_pair[0])
    assert (got.mel_pair[1] - got.mel_pair[0]).abs().max() > 0.1


def test_prepare_prompt_without_denoiser_pairs_the_prompt(pipelines):
    """No denoiser attached: denoise_ratio > 0 runs and the pair is [orig;
    orig], as the JAX pipeline does."""
    jp, tp, audio = pipelines
    want = jp.prepare_prompt(audio, denoise_ratio=0.5)
    got = tp.prepare_prompt(audio, denoise_ratio=0.5)
    assert torch.equal(got.mel_pair[0], got.mel_pair[1])
    _check(got.mel_pair, want.mel_pair)


def test_tts_with_denoiser_matches_jax_exact(denoised_pipelines, jax_stft):
    """tts(exact=True, denoise_ratio=0.5) with a denoiser: the style is
    interpolated half way to the denoised prompt's, as in the JAX tts."""
    jp, tp, audio = denoised_pipelines
    kw = dict(noise_scale_vc=0.0, output_sr=48000, seed=5, exact=True,
              denoise_ratio=0.5)
    want = jp.tts(TEXT, audio, **kw)
    got = tp.tts(TEXT, audio, **kw)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4
    plain = tp.tts(TEXT, audio, **dict(kw, denoise_ratio=0.0))
    assert np.abs(got - plain).max() > 1e-3
