"""VITS-style multi-head attention, as far as the StyleEncoder uses it.

Counterpart of `megatts2_hierspeechpp_tpu/nn/attention.py`
(MultiHeadAttention without the relative-position tables): 1x1-conv q/k/v/o
projections and additive -1e4 masking. The relative-position variant and the
transformer Encoder come with the acoustic slice.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from megatts2_hierspeechpp_torch.nn.conv import Conv1d

MASK_VALUE = -1e4  # the reference's masked_fill value


class MultiHeadAttention(nn.Module):
    def __init__(self, channels: int, out_channels: int, n_heads: int):
        super().__init__()
        self.channels, self.n_heads = channels, n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)

    def forward(self, x, c, attn_mask=None):
        """x: queries (B, Tq, C); c: keys/values (B, Tk, C); attn_mask:
        (B, 1|H, Tq, Tk) bool or {0, 1}."""
        h = self.n_heads
        k_ch = self.channels // h
        b, tq, _ = x.shape
        tk = c.shape[1]
        q = self.conv_q(x).view(b, tq, h, k_ch).transpose(1, 2)
        k = self.conv_k(c).view(b, tk, h, k_ch).transpose(1, 2)
        v = self.conv_v(c).view(b, tk, h, k_ch).transpose(1, 2)
        scale = 1.0 / math.sqrt(k_ch)
        scores = torch.matmul(q * scale, k.transpose(-1, -2))
        if attn_mask is not None:
            scores = scores.masked_fill(~attn_mask.bool(), MASK_VALUE)
        p = torch.softmax(scores, dim=-1)
        out = torch.matmul(p, v).transpose(1, 2).reshape(b, tq, self.channels)
        return self.conv_o(out)
