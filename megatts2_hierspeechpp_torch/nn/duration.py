"""Duration / range predictors and Gaussian upsampling.

Counterpart of `megatts2_hierspeechpp_tpu/nn/duration.py`:
  - DurationPredictor: cond(g) add, 2-layer BiLSTM over the padded batch,
    LayerNorm, relu, 1x1 conv, softplus;
  - RangePredictor: concat durations, packed 1-layer BiLSTM, linear,
    softplus;
  - gaussian_upsample: per-phone Gaussian weights, softmax over phones, one
    batched matmul.
Parameter names are the reference checkpoint's (`duration_predictor.{cond,
lstms,norm_2,proj}`, `RangePredictor.{lstm,proj.linear_layer}`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from megatts2_hierspeechpp_torch.nn.basic import AffineLayerNorm
from megatts2_hierspeechpp_torch.nn.conv import Conv1d
from megatts2_hierspeechpp_torch.nn.lstm import BiLSTM, StackedBiLSTM

MASK_SCORE = -1e15


class DurationPredictor(nn.Module):
    def __init__(self, in_channels: int = 256, filter_channels: int = 256,
                 gin_channels: int = 256):
        super().__init__()
        self.cond = Conv1d(gin_channels, in_channels, 1)
        self.lstms = StackedBiLSTM(in_channels, filter_channels, 2,
                                   length_aware=False)
        self.norm_2 = AffineLayerNorm(2 * filter_channels)
        self.proj = Conv1d(2 * filter_channels, 1, 1)

    def forward(self, x, x_mask, g=None):
        """x: (B, N, C); x_mask: (B, N, 1); g: (B, Gin) -> (B, N, 1)."""
        if g is not None:
            x = x + self.cond(g)[:, None, :]
        y = torch.relu(self.norm_2(self.lstms(x * x_mask)))
        return F.softplus(self.proj(y * x_mask)) * x_mask


class _LinearNorm(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_layer = nn.Linear(in_dim, out_dim)

    def forward(self, x):
        return self.linear_layer(x)


class RangePredictor(nn.Module):
    def __init__(self, in_channels: int = 256, out_channel: int = 256):
        super().__init__()
        self.lstm = BiLSTM(in_channels + 1, out_channel, length_aware=True)
        self.proj = _LinearNorm(2 * out_channel, 1)

    def forward(self, x, durations, lengths: Optional[torch.Tensor] = None):
        """x: (B, N, C); durations: (B, N) -> ranges (B, N)."""
        inp = torch.cat([x, durations[:, :, None].to(x.dtype)], dim=-1)
        return F.softplus(self.proj(self.lstm(inp, lengths)))[..., 0]


def gaussian_upsample(x, durations, ranges, input_lengths, out_length: int):
    """x: (B, N, H); durations/ranges: (B, N); input_lengths: (B,) or None
    -> (B, out_length, H).

    w[b, n, t] = softmax_n(-0.5 (log 2 pi + log var + (t - c)^2 / var)),
    c = cumsum(dur) - dur / 2."""
    c = torch.cumsum(durations, dim=1).float() - 0.5 * durations
    t = torch.arange(out_length, dtype=torch.float32, device=x.device)[None, None]
    var = ranges[:, :, None].float()
    diff = t - c[:, :, None]
    w = -0.5 * (math.log(2.0 * math.pi) + torch.log(var) + diff * diff / var)
    if input_lengths is not None:
        n = x.shape[1]
        in_mask = (torch.arange(n, device=x.device)[None, :]
                   < input_lengths.to(x.device)[:, None])
        w = torch.where(in_mask[:, :, None], w, MASK_SCORE)
    w = torch.softmax(w, dim=1)
    return torch.einsum("bnt,bnh->bth", w.to(x.dtype), x)
