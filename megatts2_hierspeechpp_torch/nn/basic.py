"""Small shared building blocks on channels-last (B, T, C) tensors.

Counterpart of `megatts2_hierspeechpp_tpu/nn/basic.py`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1

# torch.nn.Linear: weight (Out, In), the reference checkpoint's layout. The
# JAX Dense stores the transpose.
Dense = nn.Linear
# torch.nn.Embedding: weight (N, C), the JAX Embed's table.
Embed = nn.Embedding


class LayerNorm(nn.Module):
    """LayerNorm over the channel (last) axis without affine parameters (the
    DiT blocks' norm)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.channels, self.eps = channels, eps

    def forward(self, x):
        return F.layer_norm(x, (self.channels,), eps=self.eps)


class AffineLayerNorm(nn.Module):
    """LayerNorm over the channel (last) axis with a scale and a bias, named
    gamma / beta as in the reference's VITS modules.LayerNorm (the JAX
    LayerNorm's scale / bias)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.channels, self.eps = channels, eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.layer_norm(x, (self.channels,), self.gamma, self.beta,
                            self.eps)


def leaky_relu(x, slope: float = LRELU_SLOPE):
    return F.leaky_relu(x, slope)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def gelu_tanh(x):
    """torch GELU(approximate='tanh')."""
    return F.gelu(x, approximate="tanh")


def fused_add_tanh_sigmoid_multiply(a, b, n: int):
    """WaveNet gate on channels-last tensors: split 2C into tanh/sigmoid
    halves (reference commons.fused_add_tanh_sigmoid_multiply)."""
    s = a + b
    return torch.tanh(s[..., :n]) * torch.sigmoid(s[..., n:])
