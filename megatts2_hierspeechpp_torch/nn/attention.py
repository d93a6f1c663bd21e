"""VITS-style multi-head attention with windowed relative positions, the
conv-FFN and the post-norm transformer Encoder.

Counterpart of `megatts2_hierspeechpp_tpu/nn/attention.py`: 1x1-conv
q/k/v/o projections, an optional windowed relative-position bias (window 4,
heads share one table: `emb_rel_k` / `emb_rel_v`), additive -1e4 masking.
Parameter names are the reference checkpoint's (`attn_layers.{i}`,
`norm_layers_1.{i}`, `ffn_layers.{i}.conv_{1,2}`, `norm_layers_2.{i}`).
Dropout sites (p_dropout, training mode; nn/basic.Dropout) are the JAX
package's, in its call order: the attention weights, the FFN's hidden
activation, and each sublayer's output before its residual add.

`dtype` is the JAX modules' compute dtype: the projections' operands, the
attention products (scores, softmax, the relative-position tables cast to
it) and the Encoder's LayerNorm outputs; the LayerNorms compute in float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from megatts2_hierspeechpp_torch.nn.basic import AffineLayerNorm, Dropout
from megatts2_hierspeechpp_torch.nn.conv import Conv1d

MASK_VALUE = -1e4  # the reference's masked_fill value


def _rel_to_abs(x):
    """(B, H, L, 2L-1) relative logits -> (B, H, L, L) absolute."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def _abs_to_rel(x):
    """(B, H, L, L) absolute weights -> (B, H, L, 2L-1) relative."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * l + l * (l - 1))
    x = F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)
    return x[:, :, :, 1:]


def _slice_rel_emb(emb, length: int, window_size: int):
    """(Hr, 2w+1, D) table -> (Hr, 2L-1, D) centred slice, zero-padded when
    L > w + 1."""
    pad_len = max(length - (window_size + 1), 0)
    start = max((window_size + 1) - length, 0)
    if pad_len > 0:
        emb = F.pad(emb, (0, 0, pad_len, pad_len))
    return emb[:, start:start + 2 * length - 1]


class MultiHeadAttention(nn.Module):
    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: Optional[int] = None, p_dropout: float = 0.0,
                 dtype=None):
        super().__init__()
        self.channels, self.n_heads = channels, n_heads
        self.window_size = window_size
        self.drop = Dropout(p_dropout)
        self.conv_q = Conv1d(channels, channels, 1, dtype=dtype)
        self.conv_k = Conv1d(channels, channels, 1, dtype=dtype)
        self.conv_v = Conv1d(channels, channels, 1, dtype=dtype)
        self.conv_o = Conv1d(channels, out_channels, 1, dtype=dtype)
        if window_size is not None:
            k_ch = channels // n_heads
            self.emb_rel_k = nn.Parameter(torch.zeros(1, 2 * window_size + 1, k_ch))
            self.emb_rel_v = nn.Parameter(torch.zeros(1, 2 * window_size + 1, k_ch))

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
        # the JAX scale: sqrt(k_ch) as an array of q's dtype, then 1 / it
        qs = q * (1.0 / torch.tensor(math.sqrt(k_ch)).to(q.dtype))
        scores = torch.matmul(qs, k.transpose(-1, -2))
        if self.window_size is not None:
            rel_k = _slice_rel_emb(self.emb_rel_k, tk, self.window_size)
            scores = scores + _rel_to_abs(
                torch.matmul(qs, rel_k[0].t().to(qs.dtype)))
        if attn_mask is not None:
            scores = scores.masked_fill(~attn_mask.bool(), MASK_VALUE)
        p = self.drop(torch.softmax(scores, dim=-1))
        out = torch.matmul(p, v)
        if self.window_size is not None:
            rel_v = _slice_rel_emb(self.emb_rel_v, tk, self.window_size)
            out = out + torch.matmul(_abs_to_rel(p), rel_v[0].to(out.dtype))
        out = out.transpose(1, 2).reshape(b, tq, self.channels)
        return self.conv_o(out)


class FFN(nn.Module):
    """Conv-FFN with relu and torch-style 'same' padding
    ((k-1)//2 left, k//2 right)."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0, dtype=None):
        super().__init__()
        self.drop = Dropout(p_dropout)
        pad = ((kernel_size - 1) // 2, kernel_size // 2) if kernel_size > 1 else 0
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size,
                             padding=pad, dtype=dtype)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size,
                             padding=pad, dtype=dtype)

    def forward(self, x, x_mask):
        y = self.drop(torch.relu(self.conv_1(x * x_mask)))
        return self.conv_2(y * x_mask) * x_mask


class Encoder(nn.Module):
    """Post-norm transformer encoder with windowed relative attention."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 window_size: int = 4, p_dropout: float = 0.0, dtype=None):
        super().__init__()
        hc = hidden_channels
        self.drop = Dropout(p_dropout)
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hc, hc, n_heads, window_size, p_dropout, dtype)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(
            AffineLayerNorm(hc, dtype=dtype) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hc, hc, filter_channels, kernel_size, p_dropout, dtype)
            for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(
            AffineLayerNorm(hc, dtype=dtype) for _ in range(n_layers))

    def forward(self, x, x_mask):
        """x: (B, T, C); x_mask: (B, T, 1) float."""
        attn_mask = (x_mask[:, None, :, 0:1] * x_mask[:, None, None, :, 0]).bool()
        x = x * x_mask
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1,
                                     self.ffn_layers, self.norm_layers_2):
            x = n1(x + self.drop(attn(x, x, attn_mask)))
            x = n2(x + self.drop(ffn(x, x_mask)))
        return x * x_mask
