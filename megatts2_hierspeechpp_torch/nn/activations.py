"""Snake-family periodic activations (BigVGAN).

Counterpart of `megatts2_hierspeechpp_tpu/nn/activations.py`. Parameter
names follow the reference checkpoint: `activations.{j}.act.alpha` for the
anti-aliased activation wrapped around a SnakeBeta.
"""
from __future__ import annotations

import torch
from torch import nn

from megatts2_hierspeechpp_torch.ops.snake import (
    fused_aa_snakebeta, inverse_beta)


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
        self._post = None  # (key, alpha, beta, inv_beta) cached for inference

    def fused_params(self):
        """(alpha, 1/(beta + eps)) post-exp, the kernels' contract."""
        a, b = self.act.params()
        return a, inverse_beta(b)

    def _inference_params(self):
        """Post-exp (alpha, beta, inverse_beta(beta)), computed once per
        state of the parameters (their version counters and storage);
        parameters made under inference_mode have no version counter and
        are not cached."""
        al, be = self.act.alpha, self.act.beta
        if al.is_inference() or be.is_inference():
            a, b = self.act.params()
            return a, b, inverse_beta(b)
        key = (al._version, be._version, al.data_ptr(), be.data_ptr())
        if self._post is None or self._post[0] != key:
            a, b = self.act.params()
            self._post = (key, a, b, inverse_beta(b))
        return self._post[1:]

    def forward(self, x):
        if torch.is_grad_enabled() and (self.act.alpha.requires_grad
                                        or self.act.beta.requires_grad):
            a, b = self.act.params()
            return fused_aa_snakebeta(x, a, b)
        return fused_aa_snakebeta(x, *self._inference_params())
