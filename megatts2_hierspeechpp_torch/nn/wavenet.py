"""WaveNet (WN) residual gated-conv stack with global conditioning.

Counterpart of `megatts2_hierspeechpp_tpu/nn/wavenet.py` (reference
modules.WN): weight-normalized dilated in-convs to 2C gated channels, one
1x1 cond conv projected per layer, res+skip 1x1 convs (last layer
skip-only). The dropout (p_dropout, training mode) acts on the gated
activations, as the JAX WN's.
"""
from __future__ import annotations

import torch
from torch import nn

from megatts2_hierspeechpp_torch.nn.basic import (
    Dropout,
    fused_add_tanh_sigmoid_multiply,
)
from megatts2_hierspeechpp_torch.nn.conv import WNConv1d


class WN(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 p_dropout: float = 0.0):
        super().__init__()
        hc = hidden_channels
        self.drop = Dropout(p_dropout)
        self.hidden_channels, self.n_layers = hc, n_layers
        self.cond_layer = (WNConv1d(gin_channels, 2 * hc * n_layers, 1)
                           if gin_channels else None)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            d = dilation_rate ** i
            self.in_layers.append(WNConv1d(
                hc, 2 * hc, kernel_size, padding=(kernel_size * d - d) // 2,
                dilation=d))
            self.res_skip_layers.append(
                WNConv1d(hc, 2 * hc if i < n_layers - 1 else hc, 1))

    def forward(self, x, x_mask, g=None):
        """x: (B, T, C); x_mask: (B, T, 1); g: (B, 1, Gin) or None."""
        hc = self.hidden_channels
        output = torch.zeros_like(x)
        if g is not None:
            g_all = self.cond_layer(g)
        for i in range(self.n_layers):
            x_in = self.in_layers[i](x)
            if g is not None:
                g_l = g_all[..., i * 2 * hc:(i + 1) * 2 * hc]
            else:
                g_l = torch.zeros_like(x_in)
            acts = self.drop(fused_add_tanh_sigmoid_multiply(x_in, g_l, hc))
            res_skip = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[..., :hc]) * x_mask
                output = output + res_skip[..., hc:]
            else:
                output = output + res_skip
        return output * x_mask
