"""The port's SpeechSR, exact interpolation table, mel front-end and decode
pipeline (prepare_prompt + synthesize) against the JAX package on the CPU.

Small configurations: SpeechSR(upsample_initial_channel=8) at 48 and 24 kHz,
the test_torch_vocoder.py HierVocoder, 16 frames, seeded random params.
Tolerance: atol 1e-4 per model, 5e-4 for the whole decode path."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import speechsr_from_jax
from megatts2_hierspeechpp_torch.infer.pipeline import TTSPipeline as TorchPipeline
from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR as TorchSR
from megatts2_hierspeechpp_torch.models.speechsr import interp_linear
from megatts2_hierspeechpp_torch.ops.stft import mel_spectrogram_fixed
from megatts2_hierspeechpp_tpu.infer.pipeline import TTSPipeline as JaxPipeline
from megatts2_hierspeechpp_tpu.models import speechsr as jsr
from megatts2_hierspeechpp_tpu.ops import stft as jstft
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_vocoder import (  # noqa: F401  (fixture)
    T,
    _check,
    _inputs,
    random_params,
    vocoders,
)


@pytest.fixture(scope="module")
def speechsrs():
    out = {}
    for num, den in ((3, 1), (3, 2)):
        jm = jsr.SpeechSR(upsample_initial_channel=8, rate_num=num, rate_den=den)
        params = random_params(jm, 3, np.zeros((1, 64, 1), np.float32))
        tm = TorchSR(8, num, den, device="cpu")
        tm.load_state_dict(speechsr_from_jax(params), strict=True)
        out[(num, den)] = (jm, params, tm)
    return out


@pytest.mark.parametrize("rate", [(3, 1), (3, 2)])
def test_speechsr_matches_jax(speechsrs, rate):
    jm, params, tm = speechsrs[rate]
    x = (np.random.default_rng(8).standard_normal((2, 600, 1)) * 0.1).astype(
        np.float32)
    want = jax.jit(jm.apply)({"params": params}, x)
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 600 * rate[0] // rate[1], 1)
    _check(got, want)


def test_interp_linear_exact_index_table():
    """Chunked == whole at an offset of 80 s of 48 kHz output (exactly), and
    both == the JAX interp_linear."""
    n = 80 * 16000 + 64
    x = np.random.default_rng(9).standard_normal((1, n, 2)).astype(np.float32)
    whole = interp_linear(torch.from_numpy(x), 3 * n)
    np.testing.assert_array_equal(
        whole.numpy(), np.asarray(jsr.interp_linear(jnp.asarray(x), 3 * n)))
    s, ln = 80 * 16000 - 32, 64
    chunk = interp_linear(torch.from_numpy(x[:, s:s + ln]), 3 * ln)
    # interior outputs (the edge ones clamp at the chunk boundary)
    assert torch.equal(chunk[:, 3:-3], whole[:, 3 * s + 3:3 * (s + ln) - 3])


def test_mel_spectrogram_fixed_matches_jax():
    rng = np.random.default_rng(10)
    y = (rng.standard_normal((2, 16000)) * 0.3).astype(np.float32)
    got = mel_spectrogram_fixed(torch.from_numpy(y))
    want = jax.jit(jstft.mel_spectrogram_fixed)(jnp.asarray(y))
    assert got.shape == (2, 50, 80)
    _check(got, want)


def test_synthesize_matches_jax_pipeline(vocoders, speechsrs):
    """prepare_prompt + synthesize against the JAX TTSPipeline's mel,
    vocode and sr stages and the peak normalisation of tts(). noise_scale
    is 0: the two frameworks draw different noise from a seed."""
    jm, params, tm = vocoders
    jsr_m, sr_params, tsr = speechsrs[(3, 1)]
    rng = np.random.default_rng(12)
    audio = (rng.standard_normal(19200) * 0.2).astype(np.float32)
    _, w2v, mask, f0 = _inputs(seed=13)
    lf0 = f0[..., 0]

    jp = JaxPipeline(None, None, None, None, jm, {"params": params},
                     speechsr=jsr_m, speechsr_params=sr_params)
    mel_pair = jp._stage("mel")(jnp.asarray(np.stack([audio, audio])))
    wav = jp._stage("vocode")(
        {"params": params}, jnp.asarray(w2v), jnp.asarray(mask), mel_pair,
        jnp.asarray(lf0)[..., None], jnp.float32(0.0), jax.random.PRNGKey(1),
        jnp.float32(0.3))
    up = np.asarray(jp._stage("sr")(sr_params, wav))[0, :960 * T, 0]
    want = (up / max(np.abs(up).max(), 1e-8) * 0.999).astype(np.float32)

    pipe = TorchPipeline(tm, tsr, device="cpu")
    prompt = pipe.prepare_prompt(audio)
    _check(prompt.mel_pair, mel_pair)
    got = pipe.synthesize(prompt, *map(torch.from_numpy, (w2v, mask, lf0)),
                          noise_scale=0.0, seed=0, denoise_ratio=0.3,
                          output_sr=48000)
    assert got.shape == (960 * T,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    with pytest.raises(ValueError, match="does not match"):
        pipe.synthesize(prompt, *map(torch.from_numpy, (w2v, mask, lf0)),
                        output_sr=24000)
