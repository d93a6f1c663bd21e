"""1-D convolutions with torch semantics on channels-last (B, T, C) tensors.

Counterpart of `megatts2_hierspeechpp_tpu/nn/conv.py`. Parameters keep the
reference checkpoint's names and torch layouts, so a reference `state_dict`
loads as it is:

  Conv1d             weight (Cout, Cin/groups, K), bias (Cout,)
  WNConv1d           weight_g (Cout, 1, 1), weight_v (Cout, Cin, K), bias
  WNConvTranspose1d  weight_g (Cin, 1, 1), weight_v (Cin, Cout, K), bias

Weight norm is torch's `weight_norm(dim=0)`: w = g * v / ||v||, the norm
taken over every axis but the first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv1d_op(x, weight, bias=None, stride: int = 1,
              padding: int | tuple[int, int] = 0, dilation: int = 1,
              groups: int = 1):
    """x: (B, T, Cin); weight: (Cout, Cin/groups, K) -> (B, T', Cout).
    `padding` is symmetric, or (left, right) zeros. A pointwise conv runs as
    a matmul on the channels-last tensor."""
    if weight.shape[-1] == 1 and stride == 1 and groups == 1 and padding == 0:
        return F.linear(x, weight[:, :, 0], bias)
    xc = x.transpose(1, 2)
    if isinstance(padding, tuple):
        xc, padding = F.pad(xc, padding), 0
    y = F.conv1d(xc, weight, bias, stride, padding, dilation, groups)
    return y.transpose(1, 2)


def conv_transpose1d_op(x, weight, bias=None, stride: int = 1,
                        padding: int = 0):
    """x: (B, T, Cin); weight: (Cin, Cout, K). Output length
    (T - 1) * stride - 2 * padding + K, as torch's ConvTranspose1d."""
    y = F.conv_transpose1d(x.transpose(1, 2), weight, bias, stride, padding)
    return y.transpose(1, 2)


def weight_norm(g, v):
    """w = g * v / ||v||, the norm over every axis but the first."""
    norm = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return g * (v / norm)


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    """'same' padding for odd kernels (reference commons.get_padding)."""
    return (kernel_size * dilation - dilation) // 2


class Conv1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int | tuple[int, int] = 0,
                 dilation: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        return conv1d_op(x, self.weight, self.bias, self.stride, self.padding,
                         self.dilation, self.groups)


class WNConv1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1))
        self.weight_v = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def weight(self):
        """Effective (Cout, Cin, K) weight."""
        return weight_norm(self.weight_g, self.weight_v)

    def forward(self, x):
        return conv1d_op(x, self.weight(), self.bias, self.stride,
                         self.padding, self.dilation)


class WNConvTranspose1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_g = nn.Parameter(torch.ones(in_channels, 1, 1))
        self.weight_v = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        w = weight_norm(self.weight_g, self.weight_v)
        return conv_transpose1d_op(x, w, self.bias, self.stride, self.padding)
