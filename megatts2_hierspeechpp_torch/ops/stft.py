"""STFT, the fixed mel front-end, the training spectra and the denoiser's
STFT / iSTFT.

Counterpart of `megatts2_hierspeechpp_tpu/ops/stft.py`:
  - torchaudio-style MelSpectrogram (center=True, reflect pad, power 2,
    periodic Hann window, HTK mel scale, no filterbank norm), then
    log(mel + 1e-3) with the last frame dropped (reference
    Mels_preprocess.MelSpectrogramFixed): the prompt's mel;
  - the vocoder trainer's spectra (reference mel_processing): the linear
    spectrogram, center=False with a manual (n_fft - hop) / 2 reflect pad,
    magnitude sqrt(power + 1e-6); and its mel through the librosa (slaney)
    filterbank with slaney norm, log(clamp(1e-5));
  - mag_pha_stft / istft (reference denoiser/infer.py): center=True,
    compressed magnitude sqrt(re^2 + im^2 + 1e-12) ** compress, phase
    atan2(im, re); the inverse by overlap-add with window-sum normalisation
    (torch.istft, center=True, cut to `length`).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window, float32."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)).astype(np.float32)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


_F_SP = 200.0 / 3           # slaney scale: linear below 1 kHz, log above
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_log = np.maximum(f, _MIN_LOG_HZ)  # keeps log() off f = 0
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(f_log / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    m * _F_SP)


@lru_cache(maxsize=16)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float | None, htk: bool = True,
                   slaney_norm: bool = False) -> np.ndarray:
    """(n_freqs, n_mels) filterbank: HTK scale without norm (torchaudio
    melscale_fbanks defaults), or slaney scale with slaney norm
    (htk=False, slaney_norm=True: librosa.filters.mel defaults). fmax None
    is sr / 2."""
    fmax = sr / 2 if fmax is None else fmax
    to_mel, to_hz = ((_hz_to_mel_htk, _mel_to_hz_htk) if htk else
                     (_hz_to_mel_slaney, _mel_to_hz_slaney))
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sr / 2, n_freqs)
    m_pts = np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2)
    f_pts = to_hz(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if slaney_norm:
        fb = fb * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


def frame_signal(y, n_fft: int, hop: int):
    """y: (B, T), already padded -> (B, 1 + (T - n_fft) // hop, n_fft)
    frames (a strided view)."""
    return y.unfold(-1, n_fft, hop)


def stft_complex(y, n_fft: int, hop: int, win_length: int | None = None):
    """y: (B, T) -> (B, F, n_freqs) complex spectrum, center=True (reflect
    pad n_fft // 2 on each side), periodic Hann window of n_fft samples."""
    win_length = win_length or n_fft
    window = torch.from_numpy(hann_window(win_length)).to(y.device)
    pad = n_fft // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    return torch.fft.rfft(frame_signal(y, n_fft, hop) * window, dim=-1)


def stft_mag(y, n_fft: int, hop: int, win_length: int | None = None):
    """y: (B, T) -> (B, F, n_freqs) power spectrum, center=True."""
    spec = stft_complex(y, n_fft, hop, win_length)
    return spec.real.square() + spec.imag.square()


def mag_pha_stft(y, n_fft: int, hop: int, win_length: int,
                 compress_factor: float = 1.0):
    """The denoiser's front-end: y (B, T) -> compressed magnitude and phase,
    each (B, F, n_freqs)."""
    spec = stft_complex(y, n_fft, hop, win_length)
    mag = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-12)
    return mag ** compress_factor, torch.atan2(spec.imag, spec.real)


def istft(spec, n_fft: int, hop: int, win_length: int, length: int):
    """spec: (B, F, n_freqs) complex -> (B, length) waveform: the inverse of
    stft_complex by overlap-add, divided by the windows' summed squares
    (torch.istft, center=True)."""
    window = torch.from_numpy(hann_window(win_length)).to(spec.device)
    return torch.istft(spec.transpose(1, 2), n_fft, hop, win_length, window,
                       center=True, length=length)


def mel_spectrogram_fixed(y, sr: int = 16000, n_fft: int = 1280,
                          hop: int = 320, win_length: int = 1280,
                          n_mels: int = 80, fmin: float = 0.0,
                          fmax: float = 8000.0):
    """y: (B, T) -> (B, F - 1, n_mels) log-mel, frames first."""
    p2 = stft_mag(y, n_fft, hop, win_length)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax))
    mel = torch.matmul(p2, fb.to(y.device))
    return torch.log(mel + 0.001)[:, :-1, :]


def linear_spectrogram(y, n_fft: int = 1280, hop: int = 320,
                       win_length: int = 1280):
    """y: (B, T) -> (B, F, n_freqs) magnitude, center=False after a manual
    (n_fft - hop) / 2 reflect pad, sqrt(power + 1e-6) (reference
    spectrogram_torch)."""
    window = torch.from_numpy(hann_window(win_length)).to(y.device)
    pad = (n_fft - hop) // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    spec = torch.fft.rfft(frame_signal(y, n_fft, hop) * window, dim=-1)
    return torch.sqrt(spec.real.square() + spec.imag.square() + 1e-6)


def spec_to_mel(spec, sr: int, n_fft: int, n_mels: int, fmin: float,
                fmax: float | None):
    """(B, F, n_freqs) linear spectrogram -> (B, F, n_mels)
    log(clamp(mel, 1e-5)) through the slaney filterbank with slaney norm
    (reference spec_to_mel_torch)."""
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk=False,
                        slaney_norm=True)
    mel = torch.matmul(spec, torch.from_numpy(fb).to(spec.device, spec.dtype))
    return torch.log(torch.clamp(mel, min=1e-5))
