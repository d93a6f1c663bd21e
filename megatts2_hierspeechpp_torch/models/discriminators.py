"""The GAN discriminators: the vocoder trainer's multi-resolution STFT
discriminators beside multi-period waveform discriminators, and the s2
trainer's multi-resolution spectrogram discriminator over w2v features.

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

MultiResSpecDiscriminator (reference ttv_v1/msd.py) runs two
SpecDiscriminators on a (B, 1024, T) w2v map as a one-channel image, the
second on it average-pooled by 2 along T; the first is spectral-normalised
(nn/conv.SNConv2d), the second weight-normalised. Its names are the
reference's (`discriminators.{0,1}.discriminators.{0-3}`, `.out`).

`dtype` on the vocoder's discriminators is the compute dtype of their convs
(the JAX field): the STFT stays float32, a bf16 D takes bf16 conv operands
and returns bf16 logits and feature maps; the losses read them in float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.nn.basic import leaky_relu
from megatts2_hierspeechpp_torch.nn.conv import SNConv2d, WNConv2d, get_padding
from megatts2_hierspeechpp_torch.nn.init import init_weights
from megatts2_hierspeechpp_torch.ops.stft import frame_signal, hann_window

VOCODER_RESOLUTIONS = ((2048, 512, 2048), (1024, 256, 1024), (512, 128, 512),
                       (256, 64, 256), (128, 32, 128))
SPEECHSR48_RESOLUTIONS = ((4096, 1024, 4096),) + VOCODER_RESOLUTIONS
PERIODS = (2, 3, 5, 7, 11)


class DiscriminatorP(nn.Module):
    """Waveform folded into (T / period, period) and convolved along time."""

    chans = (32, 128, 512, 1024)

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 dtype=None):
        super().__init__()
        self.period = period
        pad = (get_padding(kernel_size), 0)
        cin = (1,) + self.chans
        self.convs = nn.ModuleList(
            WNConv2d(cin[i], c, (kernel_size, 1), (stride, 1), pad, dtype=dtype)
            for i, c in enumerate(self.chans))
        self.convs.append(WNConv2d(self.chans[-1], 1024, (kernel_size, 1),
                                   (1, 1), pad, dtype=dtype))
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0), dtype=dtype)

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

    def __init__(self, resolution: Sequence[int], dtype=None):
        super().__init__()
        self.resolution = tuple(resolution)
        self.convs = nn.ModuleList(
            WNConv2d(2 if i == 0 else 32, 32, k, s, p, d, dtype=dtype)
            for i, (k, s, d, p) in enumerate(self.specs))
        self.conv_post = WNConv2d(32, 1, (3, 3), (1, 1), (1, 1), dtype=dtype)

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
                 seed: int = 0, device: str | torch.device = "cuda",
                 dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self.discriminators = nn.ModuleList(
            [DiscriminatorR(r, dtype) for r in resolutions]
            + [DiscriminatorP(p, dtype=dtype) for p in periods])
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


class SpecDiscriminator(nn.Module):
    """2-D convs over a feature map as a one-channel image (ttv_v1/msd.py);
    input (B, H, W, 1)."""

    specs = (((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)),
             ((3, 9), (1, 2), (1, 4)), ((3, 3), (1, 1), (1, 1)))

    def __init__(self, use_spectral_norm: bool = False):
        super().__init__()
        self.spectral = use_spectral_norm
        conv = SNConv2d if use_spectral_norm else WNConv2d
        self.discriminators = nn.ModuleList(
            conv(1 if i == 0 else 32, 32, k, s, p)
            for i, (k, s, p) in enumerate(self.specs))
        self.out = conv(32, 1, (3, 3), (1, 1), (1, 1))

    def forward(self, y, update_u: bool = False):
        """-> (logits (B, N), feature maps). `update_u` (spectral norm only)
        runs each conv's power iteration, see SNConv2d."""
        kw = {"update_u": update_u} if self.spectral else {}
        fmap = []
        for conv in self.discriminators:
            y = leaky_relu(conv(y, **kw))
            fmap.append(y)
        y = self.out(y, **kw)
        fmap.append(y)
        return y.reshape(y.shape[0], -1), fmap


def avg_pool2d(x, kw: int):
    """AvgPool2d((1, kw)) over (B, H, W, C); W truncated to a multiple of
    kw."""
    b, h, w, c = x.shape
    wk = w // kw * kw
    return x[:, :, :wk].reshape(b, h, wk // kw, kw, c).mean(dim=3)


class MultiResSpecDiscriminator(nn.Module):
    """Two SpecDiscriminators (the first spectral-normalised) over the
    feature map and its 2x average pool along W.

    Built on the CPU with seeded weights (nn/init.py), then moved to
    `device` ("cuda" by default; raises if CUDA is absent)."""

    pools = (None, 2)

    def __init__(self, seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.discriminators = nn.ModuleList(
            SpecDiscriminator(use_spectral_norm=(i == 0))
            for i in range(len(self.pools)))
        init_weights(self, seed)
        self.to(dev)

    def forward(self, y, y_hat, update_u: bool = False):
        """y, y_hat: (B, H, W) maps (w2v (B, 1024, T)) -> (logits real,
        logits generated, feature maps real, feature maps generated). With
        `update_u` the real pass runs the spectral norm's power iteration
        and the generated pass reads the new u / v (the JAX order)."""
        y, y_hat = y[..., None], y_hat[..., None]
        outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
        for d, pool in zip(self.discriminators, self.pools):
            if pool is not None:
                y, y_hat = avg_pool2d(y, pool), avg_pool2d(y_hat, pool)
            lr, fr = d(y, update_u=update_u)
            lg, fg = d(y_hat)
            outs_r.append(lr)
            outs_g.append(lg)
            fmaps_r.append(fr)
            fmaps_g.append(fg)
        return outs_r, outs_g, fmaps_r, fmaps_g
