"""The port's MP-SENet denoiser (models/denoiser.py), its STFT pair
(ops/stft.py mag_pha_stft / istft) and TTSPipeline.denoise against the JAX
package on the CPU; the query-chunked attention against the dense form; the
weight carry-over in both directions (the JAX package's convert_denoiser
reads the port's state_dict back into the same variables).

Small configuration: MPNet(dense_channel=16, num_tsblocks=2), seeded random
params with BatchNorm running statistics away from mean 0 / var 1.
Tolerances: MPNet's magnitude within 2e-4, the JAX package's own bound
against the reference (test_speechsr_denoiser.py); its phase within 2e-4
on the circle (|e^ia - e^ib|: atan2 wraps at +-pi); the STFT pair within
1e-5 of the spectrum's peak, the phase compared through the spectrum it
gives (near a zero bin the phase carries no information); the denoised
waveform within 1e-4 of its peak.

Hazard, in the reference too: the first STFT frame of a reflect-padded
signal is symmetric, so its spectrum is real and the phase of each bin
with a negative real part is +pi or -pi by the sign of the rounding noise
in its imaginary part, which differs between FFT libraries. The denoiser
takes the phase as an input feature, and its attention over frames spreads
a 2 pi step in one frame to every frame. So `denoise` is held against the
JAX stage with the JAX front end's magnitude and phase fed to both
(`jax_stft`), and the step itself has its own test."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import denoiser_from_jax
from megatts2_hierspeechpp_torch.infer.pipeline import TTSPipeline as TorchPipeline
from megatts2_hierspeechpp_torch.models.denoiser import MPNet as TorchMPNet
from megatts2_hierspeechpp_torch.ops import stft as tstft
from megatts2_hierspeechpp_tpu.infer.pipeline import TTSPipeline as JaxPipeline
from megatts2_hierspeechpp_tpu.models.convert import convert_denoiser
from megatts2_hierspeechpp_tpu.models.denoiser import MPNet as JaxMPNet
from megatts2_hierspeechpp_tpu.ops import stft as jstft
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_wav2vec2 import random_vars

SMALL = dict(dense_channel=16, num_tsblocks=2)
CFG = dict(n_fft=400, hop=100, win=400, compress=0.3)


def small_denoisers(seed=0):
    """(JAX MPNet, its variables, the port MPNet with the same weights)."""
    jm = JaxMPNet(**SMALL)
    z = np.zeros((1, 4, 201), np.float32)
    variables = random_vars(jm, seed, z, z,
                            collections=("params", "batch_stats"))
    tm = TorchMPNet(**SMALL, device="cpu")
    tm.load_state_dict(denoiser_from_jax(variables), strict=True)
    return jm, variables, tm


@pytest.fixture(scope="module")
def denoisers():
    return small_denoisers()


def _mag_pha(t=10, seed=2):
    rng = np.random.default_rng(seed)
    mag = np.abs(rng.standard_normal((1, t, 201))).astype(np.float32)
    pha = rng.uniform(-np.pi, np.pi, (1, t, 201)).astype(np.float32)
    return mag, pha


def check_phase(got, want, atol=2e-4):
    """Phases compared on the unit circle."""
    d = np.abs(np.exp(1j * np.asarray(got, np.float64))
               - np.exp(1j * np.asarray(want, np.float64)))
    assert d.max() <= atol, d.max()


def test_mpnet_matches_jax(denoisers):
    jm, variables, tm = denoisers
    stats = variables["batch_stats"]["ts_0"]["time"]["ccm"]["bn"]
    assert np.abs(stats["mean"]).max() > 0.05 and np.abs(stats["var"] - 1).max() > 0.05
    mag, pha = _mag_pha()
    jmag, jpha = jax.jit(jm.apply)(variables, mag, pha)
    tmag, tpha = tm(torch.from_numpy(mag), torch.from_numpy(pha))
    assert tmag.shape == tpha.shape == (1, 10, 201)
    np.testing.assert_allclose(tmag.numpy(), np.asarray(jmag), atol=2e-4, rtol=0)
    check_phase(tpha.numpy(), jpha)


@pytest.mark.parametrize("t,chunk", [(40, 3), (40, 8), (10, 3)])
def test_attn_chunk_equals_dense(denoisers, t, chunk):
    """Query chunks (the frequency conformer's attention runs over T frames,
    the time conformer's over 100 bins) against the dense form, and the
    chunked form against the JAX one. The chunks run the dense form's
    products row for row, so the results are equal bit for bit where the
    BLAS picks the same kernel for the chunk's shape and the whole (T = 40
    here); at T = 10 the dense frequency attention takes another kernel
    and they differ by float rounding (7e-7 measured)."""
    jm, variables, tm = denoisers
    mag, pha = (torch.from_numpy(a) for a in _mag_pha(t=t, seed=3))
    dense = tm(mag, pha)
    tm.set_attn_chunk(chunk)
    try:
        chunked = tm(mag, pha)
    finally:
        tm.set_attn_chunk(None)
    if t == 40:
        for a, b in zip(chunked, dense):
            assert torch.equal(a, b)
    np.testing.assert_allclose(chunked[0].numpy(), dense[0].numpy(), atol=1e-5,
                               rtol=0)
    check_phase(chunked[1].numpy(), dense[1].numpy(), atol=1e-4)
    jmag, _ = jax.jit(JaxMPNet(**SMALL, attn_chunk=chunk).apply)(
        variables, mag.numpy(), pha.numpy())
    np.testing.assert_allclose(chunked[0].numpy(), np.asarray(jmag), atol=2e-4,
                               rtol=0)


def test_mpnet_runs_one_waveform_at_a_time(denoisers):
    """At B = 2 the reference's attention would mix the rows: refused."""
    _, _, tm = denoisers
    x = torch.zeros(2, 4, 201)
    with pytest.raises(ValueError, match="B = 1"):
        tm(x, x)


def test_converter_round_trip(denoisers):
    """convert_denoiser (reference names) reads the port's state_dict back
    into the JAX variables it came from, running statistics included."""
    _, variables, tm = denoisers
    back = convert_denoiser(tm.state_dict(), num_tsblocks=2)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a),
                                      err_msg=str(path))


def test_full_width_size():
    """The reference's widths (dense_channel 64, 4 TS blocks): about 2.05 M
    parameters, all read by convert_denoiser."""
    tm = TorchMPNet(device="cpu")
    n = sum(p.numel() for p in tm.parameters())
    back = convert_denoiser(tm.state_dict())
    assert sum(np.asarray(a).size
               for a in jax.tree_util.tree_leaves(back["params"])) == n
    assert 2.0e6 < n < 2.1e6, n


def _polar(mag, pha, compress=0.3):
    """The spectrum that a compressed magnitude and a phase stand for."""
    mag, pha = np.asarray(mag, np.float64), np.asarray(pha, np.float64)
    return mag ** (1 / compress) * np.exp(1j * pha)


@pytest.mark.parametrize("n", [16000, 16100])
def test_stft_pair_matches_jax(n):
    y = (np.random.default_rng(4).standard_normal((2, n)) * 0.3).astype(np.float32)
    spec = np.array(jstft.stft_complex(jnp.asarray(y), 400, 100, 400))
    got = tstft.stft_complex(torch.from_numpy(y), 400, 100, 400).numpy()
    peak = np.abs(spec).max()
    np.testing.assert_allclose(got, spec, atol=1e-5 * peak, rtol=0)
    jmag, jpha = jstft.mag_pha_stft(jnp.asarray(y), 400, 100, 400, 0.3)
    mag, pha = tstft.mag_pha_stft(torch.from_numpy(y), 400, 100, 400, 0.3)
    assert mag.shape == pha.shape == (2, n // 100 + 1, 201)
    np.testing.assert_allclose(_polar(mag, pha), _polar(jmag, jpha),
                               atol=1e-5 * peak, rtol=0)
    want = np.asarray(jstft.istft(jnp.asarray(spec), 400, 100, 400, length=n))
    got = tstft.istft(torch.from_numpy(spec), 400, 100, 400, length=n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), y, atol=1e-5, rtol=0)


def test_first_frame_phase_is_plus_or_minus_pi():
    """Frame 0 of the reflect-padded STFT is real: where its real part is
    negative, the port's and the JAX phase are each near +pi or -pi, the
    same spectrum but (on this signal, with these FFT libraries) 2 pi apart
    at some bins."""
    y = (np.random.default_rng(5).standard_normal((1, 4800)) * 0.3).astype(np.float32)
    jmag, jpha = (np.asarray(a) for a in
                  jstft.mag_pha_stft(jnp.asarray(y), 400, 100, 400, 0.3))
    mag, pha = (a.numpy() for a in
                tstft.mag_pha_stft(torch.from_numpy(y), 400, 100, 400, 0.3))
    spec = tstft.stft_complex(torch.from_numpy(y), 400, 100, 400)[0, 0]
    assert spec.imag.abs().max() <= 1e-5 * spec.real.abs().max()
    jumps = np.abs(pha[0, 0] - jpha[0, 0]) > np.pi
    assert jumps.any() and (jumps <= (spec.real.numpy() < 0)).all()
    np.testing.assert_allclose(_polar(mag, pha), _polar(jmag, jpha),
                               atol=1e-5 * spec.abs().max().item(), rtol=0)


@pytest.fixture()
def jax_stft(monkeypatch):
    """The port's pipeline takes its denoiser STFT from the JAX function
    (the hazard in the module docstring)."""
    from megatts2_hierspeechpp_torch.infer import pipeline as tpipe

    def stft(y, *args):
        mag, pha = jstft.mag_pha_stft(jnp.asarray(y.numpy()), *args)
        return torch.from_numpy(np.array(mag)), torch.from_numpy(np.array(pha))

    monkeypatch.setattr(tpipe, "mag_pha_stft", stft)


def pipelines_with_denoiser(jm, variables, tm, jkw=None, tkw=None):
    """The JAX and the port pipeline around one small denoiser (the other
    models from the keyword arguments, else None)."""
    jkw = dict(ttv=None, ttv_vars=None, plm=None, plm_params=None,
               vocoder=None, vocoder_params=None, **(jkw or {}))
    jp = JaxPipeline(**jkw, denoiser=jm, denoiser_vars=variables)
    tp = TorchPipeline(**dict(dict(vocoder=None), **(tkw or {})),
                       device="cpu", denoiser=tm)
    return jp, tp


def test_pipeline_denoise_matches_jax(denoisers, jax_stft):
    """RMS normalisation over the whole signal, STFT, MPNet, decompression,
    iSTFT, the normalisation undone: as the JAX stage."""
    jp, tp = pipelines_with_denoiser(*denoisers)
    assert tp.denoiser_cfg == jp.denoiser_cfg == CFG
    rng = np.random.default_rng(5)
    audio = (np.sin(np.arange(4800) * 0.05) * 0.3
             + rng.standard_normal(4800) * 0.02).astype(np.float32)
    want = jp.denoise(audio)
    got = tp.denoise(audio)
    assert got.shape == (4800,)
    peak = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * peak, rtol=0)
    # scale-free: the RMS normalisation is undone after the iSTFT
    np.testing.assert_allclose(tp.denoise(audio * 4).numpy(), 4 * got.numpy(),
                               atol=1e-4 * 4 * peak, rtol=0)
