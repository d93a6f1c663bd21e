"""STFT, the fixed mel front-end and the denoiser's STFT / iSTFT.

Counterpart of `megatts2_hierspeechpp_tpu/ops/stft.py`, as far as the
prompt's mel and the denoiser need it:
  - torchaudio-style MelSpectrogram (center=True, reflect pad, power 2,
    periodic Hann window, HTK mel scale, no filterbank norm), then
    log(mel + 1e-3) with the last frame dropped (reference
    Mels_preprocess.MelSpectrogramFixed);
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


@lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """(n_freqs, n_mels) HTK filterbank, torchaudio melscale_fbanks
    defaults."""
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sr / 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(fmin), _hz_to_mel_htk(fmax), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def stft_complex(y, n_fft: int, hop: int, win_length: int | None = None):
    """y: (B, T) -> (B, F, n_freqs) complex spectrum, center=True (reflect
    pad n_fft // 2 on each side), periodic Hann window of n_fft samples."""
    win_length = win_length or n_fft
    window = torch.from_numpy(hann_window(win_length)).to(y.device)
    pad = n_fft // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    return torch.fft.rfft(y.unfold(-1, n_fft, hop) * window, dim=-1)


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
