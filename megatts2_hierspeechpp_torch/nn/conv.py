"""Convolutions with torch semantics on channels-last tensors: 1-D on
(B, T, C), 2-D on (B, H, W, C) (the discriminators').

Counterpart of `megatts2_hierspeechpp_tpu/nn/conv.py`. Parameters keep the
reference checkpoint's names and torch layouts, so a reference `state_dict`
loads as it is:

  Conv1d             weight (Cout, Cin/groups, K), bias (Cout,)
  WNConv1d           weight_g (Cout, 1, 1), weight_v (Cout, Cin, K), bias
  WNConvTranspose1d  weight_g (Cin, 1, 1), weight_v (Cin, Cout, K), bias
  WNConv2d           weight_g (Cout, 1, 1, 1), weight_v (Cout, Cin, Kh, Kw),
                     bias

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


def conv2d_op(x, weight, bias=None, stride=(1, 1), padding=(0, 0),
              dilation=(1, 1)):
    """x: (B, H, W, Cin); weight: (Cout, Cin, Kh, Kw) -> (B, H', W', Cout),
    symmetric zero padding (ph, pw). The input goes to F.conv2d as a
    channels_last view of NCHW, which cuDNN convolves without a transpose."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, tuple(stride),
                 tuple(padding), tuple(dilation))
    return y.permute(0, 2, 3, 1)


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


class WNConv2d(nn.Module):
    """Weight-normalized Conv2d on (B, H, W, C): the norm per output channel
    over (Cin, Kh, Kw), the JAX WNConv2d's axes (0, 1, 2) of its
    (Kh, Kw, Cin, Cout) kernel."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: tuple[int, int], stride=(1, 1),
                 padding=(0, 0), dilation=(1, 1), bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1, 1))
        self.weight_v = nn.Parameter(
            torch.empty(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        return conv2d_op(x, weight_norm(self.weight_g, self.weight_v),
                         self.bias, self.stride, self.padding, self.dilation)
