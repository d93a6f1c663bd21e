"""STFT and the fixed mel front-end.

Counterpart of `megatts2_hierspeechpp_tpu/ops/stft.py`, as far as the
prompt's mel needs it: torchaudio-style MelSpectrogram (center=True, reflect
pad, power 2, periodic Hann window, HTK mel scale, no filterbank norm),
then log(mel + 1e-3) with the last frame dropped (reference
Mels_preprocess.MelSpectrogramFixed).
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


def stft_mag(y, n_fft: int, hop: int, win_length: int | None = None):
    """y: (B, T) -> (B, F, n_freqs) power spectrum, center=True."""
    win_length = win_length or n_fft
    window = torch.from_numpy(hann_window(win_length)).to(y.device)
    pad = n_fft // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop) * window
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real.square() + spec.imag.square()


def mel_spectrogram_fixed(y, sr: int = 16000, n_fft: int = 1280,
                          hop: int = 320, win_length: int = 1280,
                          n_mels: int = 80, fmin: float = 0.0,
                          fmax: float = 8000.0):
    """y: (B, T) -> (B, F - 1, n_mels) log-mel, frames first."""
    p2 = stft_mag(y, n_fft, hop, win_length)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax))
    mel = torch.matmul(p2, fb.to(y.device))
    return torch.log(mel + 0.001)[:, :-1, :]
