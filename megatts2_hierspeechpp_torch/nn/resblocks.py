"""HiFiGAN leaky-ReLU blocks and BigVGAN AMP residual blocks.

Counterpart of `megatts2_hierspeechpp_tpu/nn/resblocks.py` (ResBlock1,
AMPBlock and the stage dispatch). The port keeps the JAX package's TPU dispatch: a block
with C <= 128 runs as one `fused_ampblock` call, a wider one layer by layer
with each activation a `fused_aa_snakebeta` call, and a stage with C <= 64
runs as one `fused_amp_triple` call (`fused_triple_enabled`). Each wrapper
takes its plain version for CPU tensors, so the dispatch is the same on
both devices. `dtype` is the convs' compute dtype; the fused wrappers take
their activation's dtype (bf16: the kernels' bf16 configuration) with the
weights of `fused_weights`, which stay float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from megatts2_hierspeechpp_torch.nn.activations import AASnakeBeta
from megatts2_hierspeechpp_torch.nn.basic import leaky_relu
from megatts2_hierspeechpp_torch.nn.conv import WNConv1d, get_padding
from megatts2_hierspeechpp_torch.ops.ampblock import fused_ampblock


def fused_triple_enabled(channels: int) -> bool:
    """Whole-stage fusion gate: the narrow stages (C <= 64)."""
    return channels <= 64


class ResBlock1(nn.Module):
    """HiFiGAN ResBlock1: per dilation, leaky-ReLU -> dilated WN conv ->
    leaky-ReLU -> WN conv, plus the residual."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), dtype=None):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size,
                     padding=get_padding(kernel_size, d), dilation=d,
                     dtype=dtype)
            for d in dilation)
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size,
                     padding=get_padding(kernel_size, 1), dtype=dtype)
            for _ in dilation)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(leaky_relu(c1(leaky_relu(x)))) + x
        return x


class AMPBlock(nn.Module):
    """Anti-aliased Multi-Periodicity block (BigVGAN AMPBlock1 topology)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), dtype=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size,
                     padding=get_padding(kernel_size, d), dilation=d,
                     dtype=dtype)
            for d in self.dilation)
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size,
                     padding=get_padding(kernel_size, 1), dtype=dtype)
            for _ in self.dilation)
        self.activations = nn.ModuleList(
            AASnakeBeta(channels) for _ in range(2 * len(self.dilation)))

    def fused_weights(self):
        """(a1, ib1, w1, b1, a2, ib2, w2, b2) stacked over branches: the
        ops/ampblock weight contract, w* as (n, k, Cout, Cin)."""
        out = [[] for _ in range(8)]
        for i in range(len(self.dilation)):
            for j, (act, conv) in enumerate(
                    ((self.activations[2 * i], self.convs1[i]),
                     (self.activations[2 * i + 1], self.convs2[i]))):
                a, ib = act.fused_params()
                out[4 * j].append(a)
                out[4 * j + 1].append(ib)
                out[4 * j + 2].append(conv.weight().permute(2, 0, 1))
                out[4 * j + 3].append(conv.bias)
        return tuple(torch.stack(v) for v in out)

    def forward(self, x):
        if x.shape[-1] <= 128:
            return fused_ampblock(x, *self.fused_weights(),
                                  kernel_size=self.kernel_size,
                                  dilations=self.dilation)
        for i in range(len(self.dilation)):
            xt = self.activations[2 * i](x)
            xt = self.convs1[i](xt)
            xt = self.activations[2 * i + 1](xt)
            xt = self.convs2[i](xt)
            x = xt + x
        return x
