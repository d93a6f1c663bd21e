"""Anti-aliased resampling (kaiser-windowed sinc low-pass), BigVGAN-style.

Counterpart of `megatts2_hierspeechpp_tpu/ops/resample.py`, with its own copy
of the filter design. Public functions take channels-last (B, T, C); the
depthwise convolutions run channels-first inside.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def kaiser_sinc_filter1d(cutoff: float, half_width: float,
                         kernel_size: int) -> np.ndarray:
    """Returns (K,) float32 filter, sum-normalized."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2

    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)

    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros_like(time, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt = filt / filt.sum()
    return filt.astype(np.float32)


def _depthwise(filt: np.ndarray, channels: int, like: torch.Tensor):
    """(K,) -> (C, 1, K) depthwise weight on `like`'s device and dtype."""
    w = torch.from_numpy(filt).to(device=like.device, dtype=like.dtype)
    return w.view(1, 1, -1).expand(channels, 1, -1)


def upsample1d(x, ratio: int = 2, kernel_size: int | None = None):
    """x: (B, T, C) -> (B, T*ratio, C): replicate pad, transposed depthwise
    conv, crop."""
    c = x.shape[-1]
    kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    pad = kernel_size // ratio - 1
    pad_left = pad * ratio + (kernel_size - ratio) // 2
    pad_right = pad * ratio + (kernel_size - ratio + 1) // 2
    filt = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, kernel_size)

    xt = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(xt, _depthwise(filt, c, x), stride=ratio,
                                   groups=c)
    y = y[:, :, pad_left: y.shape[-1] - pad_right]
    return y.transpose(1, 2)


def lowpass1d(x, cutoff: float, half_width: float, stride: int = 1,
              kernel_size: int = 12):
    """Replicate-padded depthwise low-pass; x: (B, T, C)."""
    c = x.shape[-1]
    even = kernel_size % 2 == 0
    pad_left = kernel_size // 2 - int(even)
    pad_right = kernel_size // 2
    filt = kaiser_sinc_filter1d(cutoff, half_width, kernel_size)
    xt = F.pad(x.transpose(1, 2), (pad_left, pad_right), mode="replicate")
    y = F.conv1d(xt, _depthwise(filt, c, x), stride=stride, groups=c)
    return y.transpose(1, 2)


def downsample1d(x, ratio: int = 2, kernel_size: int | None = None):
    kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    return lowpass1d(x, 0.5 / ratio, 0.6 / ratio, stride=ratio,
                     kernel_size=kernel_size)


def activation1d(x, act_fn, up_ratio: int = 2, down_ratio: int = 2):
    """Anti-aliased activation: upsample -> act -> downsample."""
    return downsample1d(act_fn(upsample1d(x, up_ratio)), down_ratio)
