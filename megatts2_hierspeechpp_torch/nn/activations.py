"""Snake-family periodic activations (BigVGAN).

Counterpart of `megatts2_hierspeechpp_tpu/nn/activations.py`. Parameter
names follow the reference checkpoint: `activations.{j}.act.alpha` for the
anti-aliased activation wrapped around a SnakeBeta.
"""
from __future__ import annotations

import torch
from torch import nn

from megatts2_hierspeechpp_torch.ops.snake import EPS, fused_aa_snakebeta


class SnakeBeta(nn.Module):
    """Parameters of x + sin^2(alpha*x) / beta: log-scale alpha/beta (C,).
    The port applies it only anti-aliased, through AASnakeBeta."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def params(self):
        """Post-exp (alpha, beta)."""
        return self.alpha.exp(), self.beta.exp()


class AASnakeBeta(nn.Module):
    """Anti-aliased SnakeBeta: up2 -> snake -> down2 as one op, dispatched to
    the fused kernel wrapper (ops/snake.py) as the JAX module does on TPU."""

    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)

    def fused_params(self):
        """(alpha, 1/(beta + eps)) post-exp, the kernels' contract."""
        a, b = self.act.params()
        return a, 1.0 / (b + EPS)

    def forward(self, x):
        a, b = self.act.params()
        return fused_aa_snakebeta(x, a, b)
