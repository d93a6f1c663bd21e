"""The vocoder trainer's GAN discriminator: multi-resolution STFT
discriminators beside multi-period waveform discriminators.

Counterpart of `megatts2_hierspeechpp_tpu/models/discriminators.py`
(reference hierspeechpp_speechsynthesizer.py DiscriminatorP /
DiscriminatorR / MultiPeriodDiscriminator). Parameter names are the
reference checkpoint's (`discriminators.{i}.convs.{j}`, `conv_post`; the
STFT discriminators first, then the period ones). Activations are
channels-last (B, H, W, C), the JAX layout, so feature maps compare as
they are.

DiscriminatorR reads a window-L2-normalised complex STFT (torchaudio
Spectrogram normalized=True, center=False) with real and imaginary parts
as two channels, frames along H and bins along W.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.nn.basic import leaky_relu
from megatts2_hierspeechpp_torch.nn.conv import WNConv2d, get_padding
from megatts2_hierspeechpp_torch.nn.init import init_weights
from megatts2_hierspeechpp_torch.ops.stft import frame_signal, hann_window

VOCODER_RESOLUTIONS = ((2048, 512, 2048), (1024, 256, 1024), (512, 128, 512),
                       (256, 64, 256), (128, 32, 128))
SPEECHSR48_RESOLUTIONS = ((4096, 1024, 4096),) + VOCODER_RESOLUTIONS
PERIODS = (2, 3, 5, 7, 11)


class DiscriminatorP(nn.Module):
    """Waveform folded into (T / period, period) and convolved along time."""

    chans = (32, 128, 512, 1024)

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (get_padding(kernel_size), 0)
        cin = (1,) + self.chans
        self.convs = nn.ModuleList(
            WNConv2d(cin[i], c, (kernel_size, 1), (stride, 1), pad)
            for i, c in enumerate(self.chans))
        self.convs.append(WNConv2d(self.chans[-1], 1024, (kernel_size, 1),
                                   (1, 1), pad))
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x):
        """x: (B, T, 1) -> (logits (B, N), feature maps (B, H, W, C))."""
        b, t, _ = x.shape
        p = self.period
        if t % p:  # reflect-pad the end to a multiple of the period
            x = F.pad(x.transpose(1, 2), (0, p - t % p),
                      mode="reflect").transpose(1, 2)
            t = x.shape[1]
        y = x.reshape(b, t // p, p, 1)
        fmap = []
        for conv in self.convs:
            y = leaky_relu(conv(y))
            fmap.append(y)
        y = self.conv_post(y)
        fmap.append(y)
        return y.reshape(b, -1), fmap


def normalized_complex_stft(y, n_fft: int, hop: int, win: int):
    """(B, T) -> (B, F, bins) complex, center=False, divided by the
    window's L2 norm."""
    window = torch.from_numpy(hann_window(win)).to(y.device)
    spec = torch.fft.rfft(frame_signal(y, n_fft, hop) * window, dim=-1)
    return spec / window.square().sum().sqrt()


class DiscriminatorR(nn.Module):
    """2-D convs over one STFT resolution (n_fft, hop, win)."""

    # (kernel, stride, dilation, padding) of the five 32-channel convs
    specs = (((3, 9), (1, 1), (1, 1), (1, 4)),
             ((3, 9), (1, 2), (1, 1), (1, 4)),
             ((3, 9), (1, 2), (2, 1), (2, 4)),
             ((3, 9), (1, 2), (4, 1), (4, 4)),
             ((3, 3), (1, 1), (1, 1), (1, 1)))

    def __init__(self, resolution: Sequence[int]):
        super().__init__()
        self.resolution = tuple(resolution)
        self.convs = nn.ModuleList(
            WNConv2d(2 if i == 0 else 32, 32, k, s, p, d)
            for i, (k, s, d, p) in enumerate(self.specs))
        self.conv_post = WNConv2d(32, 1, (3, 3), (1, 1), (1, 1))

    def forward(self, x):
        """x: (B, T, 1) -> (logits (B, N), feature maps (B, F, W, C))."""
        spec = normalized_complex_stft(x[..., 0], *self.resolution)
        y = torch.stack([spec.real, spec.imag], dim=-1)  # (B, F, bins, 2)
        fmap = []
        for conv in self.convs:
            y = leaky_relu(conv(y))
            fmap.append(y)
        y = self.conv_post(y)
        fmap.append(y)
        return y.reshape(y.shape[0], -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """STFT discriminators at `resolutions`, then period discriminators at
    `periods`, each run on the real and the generated waveform.

    Built on the CPU with seeded weights (nn/init.py), then moved to
    `device` ("cuda" by default; raises if CUDA is absent)."""

    def __init__(self, resolutions=VOCODER_RESOLUTIONS, periods=PERIODS,
                 seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.discriminators = nn.ModuleList(
            [DiscriminatorR(r) for r in resolutions]
            + [DiscriminatorP(p) for p in periods])
        init_weights(self, seed)
        self.to(dev)

    def forward(self, y, y_hat):
        """y, y_hat: (B, T, 1) -> (logits real, logits generated, feature
        maps real, feature maps generated), one entry per discriminator."""
        outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
        for d in self.discriminators:
            lr, fr = d(y)
            lg, fg = d(y_hat)
            outs_r.append(lr)
            outs_g.append(lg)
            fmaps_r.append(fr)
            fmaps_g.append(fg)
        return outs_r, outs_g, fmaps_r, fmaps_g
