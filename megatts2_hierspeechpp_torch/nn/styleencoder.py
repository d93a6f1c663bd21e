"""Global style/speaker encoder over mel frames.

Counterpart of `megatts2_hierspeechpp_tpu/nn/styleencoder.py` (reference
styleencoder.py:33-91): spectral 1x1 convs with Mish, two Conv1dGLU
temporal blocks, one self-attention layer, 1x1 fc, temporal pool. The
dropouts (p 0.1, training mode; nn/basic.Dropout) sit where the
reference's do, so `spectral.{0,3}` keep their parameter indices.
`dtype`: the compute dtype of its convs and attention.
"""
from __future__ import annotations

import torch
from torch import nn

from megatts2_hierspeechpp_torch.nn.attention import MultiHeadAttention
from megatts2_hierspeechpp_torch.nn.basic import Dropout, mish
from megatts2_hierspeechpp_torch.nn.conv import Conv1d


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


P_DROPOUT = 0.1


class Conv1dGLU(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, dtype=None):
        super().__init__()
        self.out_channels = out_channels
        self.conv1 = Conv1d(in_channels, 2 * out_channels, kernel_size,
                            padding=2, dtype=dtype)
        self.dropout = Dropout(P_DROPOUT)

    def forward(self, x):
        y = self.conv1(x)
        y1, y2 = y[..., :self.out_channels], y[..., self.out_channels:]
        return x + self.dropout(y1 * torch.sigmoid(y2))


class StyleEncoder(nn.Module):
    def __init__(self, in_dim: int = 80, hidden_dim: int = 256,
                 out_dim: int = 256, dtype=None):
        super().__init__()
        self.spectral = nn.Sequential(
            Conv1d(in_dim, hidden_dim, 1, dtype=dtype), Mish(),
            Dropout(P_DROPOUT),
            Conv1d(hidden_dim, hidden_dim, 1, dtype=dtype), Mish(),
            Dropout(P_DROPOUT))
        self.temporal = nn.Sequential(
            Conv1dGLU(hidden_dim, hidden_dim, dtype=dtype),
            Conv1dGLU(hidden_dim, hidden_dim, dtype=dtype))
        self.slf_attn = MultiHeadAttention(hidden_dim, hidden_dim, 2,
                                           p_dropout=P_DROPOUT, dtype=dtype)
        self.dropout = Dropout(P_DROPOUT)
        self.fc = Conv1d(hidden_dim, out_dim, 1, dtype=dtype)

    def forward(self, x, mask):
        """x: (B, T, in_dim) mel; mask: (B, T, 1) float -> (B, out_dim)."""
        y = self.spectral(x) * mask
        y = self.temporal(y) * mask
        attn_mask = (mask[:, None, :, 0:1] * mask[:, None, None, :, 0]).bool()
        y = y + self.dropout(self.slf_attn(y, y, attn_mask))
        y = self.fc(y)
        # the reference pools over ALL frames (padding included) while the
        # denominator is the true length (styleencoder.py:83-91)
        return y.sum(dim=1) / mask.sum(dim=1)
