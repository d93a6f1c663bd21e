"""Convolutions with torch semantics on channels-last tensors: 1-D on
(B, T, C), 2-D on (B, H, W, C) (the discriminators').

Counterpart of `megatts2_hierspeechpp_tpu/nn/conv.py`. Parameters keep the
reference checkpoint's names and torch layouts, so a reference `state_dict`
loads as it is:

  Conv1d             weight (Cout, Cin/groups, K), bias (Cout,)
  ConvTranspose1d    weight (Cin, Cout, K), bias (Cout,)
  WNConv1d           weight_g (Cout, 1, 1), weight_v (Cout, Cin, K), bias
  WNConvTranspose1d  weight_g (Cin, 1, 1), weight_v (Cin, Cout, K), bias
  WNConv2d           weight_g (Cout, 1, 1, 1), weight_v (Cout, Cin, Kh, Kw),
                     bias
  SNConv2d           weight_orig (Cout, Cin, Kh, Kw), bias; buffers
                     weight_u (Cout,), weight_v (Cin*Kh*Kw,) (torch
                     spectral_norm's names)

Weight norm is torch's `weight_norm(dim=0)`: w = g * v / ||v||, the norm
taken over every axis but the first.

Compute dtype (`dtype`, the JAX modules' field, None for float32): the
input and the effective weight are cast to it and the bias to the output's
dtype, so a bf16 conv takes bf16 operands and gives a bf16 result, as
`conv1d_op(compute_dtype=)` does. Parameters stay float32; weight norm is
computed in float32 before the cast.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(x, weight, bias, compute_dtype):
    """x, weight and bias in `compute_dtype` (None: as they are)."""
    if compute_dtype is None:
        return x, weight, bias
    return (x.to(compute_dtype), weight.to(compute_dtype),
            None if bias is None else bias.to(compute_dtype))


def conv1d_op(x, weight, bias=None, stride: int = 1,
              padding: int | tuple[int, int] = 0, dilation: int = 1,
              groups: int = 1, compute_dtype=None):
    """x: (B, T, Cin); weight: (Cout, Cin/groups, K) -> (B, T', Cout).
    `padding` is symmetric, or (left, right) zeros. A pointwise conv runs as
    a matmul on the channels-last tensor."""
    x, weight, bias = _cast(x, weight, bias, compute_dtype)
    if weight.shape[-1] == 1 and stride == 1 and groups == 1 and padding == 0:
        return F.linear(x, weight[:, :, 0], bias)
    xc = x.transpose(1, 2)
    if isinstance(padding, tuple):
        xc, padding = F.pad(xc, padding), 0
    y = F.conv1d(xc, weight, bias, stride, padding, dilation, groups)
    return y.transpose(1, 2)


def conv_transpose1d_op(x, weight, bias=None, stride: int = 1,
                        padding: int = 0, compute_dtype=None):
    """x: (B, T, Cin); weight: (Cin, Cout, K). Output length
    (T - 1) * stride - 2 * padding + K, as torch's ConvTranspose1d."""
    x, weight, bias = _cast(x, weight, bias, compute_dtype)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        # PyTorch's CPU bf16 conv_transpose1d returns a wrong input gradient
        # at some shapes (Cout = 8 with k = 2 x stride): float32 sums of the
        # bf16 operands, rounded once, the arithmetic of a bf16 conv
        y = F.conv_transpose1d(x.transpose(1, 2).float(), weight.float(),
                               None if bias is None else bias.float(), stride,
                               padding)
        return y.transpose(1, 2).to(x.dtype)
    y = F.conv_transpose1d(x.transpose(1, 2), weight, bias, stride, padding)
    return y.transpose(1, 2)


def conv2d_op(x, weight, bias=None, stride=(1, 1), padding=(0, 0),
              dilation=(1, 1), compute_dtype=None):
    """x: (B, H, W, Cin); weight: (Cout, Cin, Kh, Kw) -> (B, H', W', Cout),
    symmetric zero padding (ph, pw). The input goes to F.conv2d as a
    channels_last view of NCHW, which cuDNN convolves without a transpose."""
    x, weight, bias = _cast(x, weight, bias, compute_dtype)
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
                 groups: int = 1, bias: bool = True, dtype=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups, self.dtype = dilation, groups, dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        return conv1d_op(x, self.weight, self.bias, self.stride, self.padding,
                         self.dilation, self.groups, self.dtype)


class ConvTranspose1d(nn.Module):
    """torch ConvTranspose1d on (B, T, C), float32: weight (Cin, Cout, K),
    bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        return conv_transpose1d_op(x, self.weight, self.bias, self.stride,
                                   self.padding)


class WNConv1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = True, dtype=None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype = dtype
        self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1))
        self.weight_v = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def weight(self):
        """Effective (Cout, Cin, K) weight."""
        return weight_norm(self.weight_g, self.weight_v)

    def forward(self, x):
        return conv1d_op(x, self.weight(), self.bias, self.stride,
                         self.padding, self.dilation, compute_dtype=self.dtype)


class WNConvTranspose1d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight_g = nn.Parameter(torch.ones(in_channels, 1, 1))
        self.weight_v = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        w = weight_norm(self.weight_g, self.weight_v)
        return conv_transpose1d_op(x, w, self.bias, self.stride, self.padding,
                                   self.dtype)


class WNConv2d(nn.Module):
    """Weight-normalized Conv2d on (B, H, W, C): the norm per output channel
    over (Cin, Kh, Kw), the JAX WNConv2d's axes (0, 1, 2) of its
    (Kh, Kw, Cin, Cout) kernel."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: tuple[int, int], stride=(1, 1),
                 padding=(0, 0), dilation=(1, 1), bias: bool = True,
                 dtype=None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype = dtype
        self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1, 1))
        self.weight_v = nn.Parameter(
            torch.empty(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        return conv2d_op(x, weight_norm(self.weight_g, self.weight_v),
                         self.bias, self.stride, self.padding, self.dilation,
                         self.dtype)


class SNConv2d(nn.Module):
    """Spectral-normalised Conv2d on (B, H, W, C), the JAX SNConv2d: the
    weight is divided by sigma = u . (W v), W the (Cout, Cin*Kh*Kw) matrix.

    `update_u=True` runs one power iteration from the stored u
    (v = W^T u / |W^T u|, u = W v / |W v|, each norm + 1e-12), stores the new
    u and v, and takes sigma from them; as in JAX, that pass's u and v are
    functions of W, so its gradient flows through the iteration. Without
    `update_u` sigma reads the stored u and v as constants. This is not
    torch.nn.utils.spectral_norm, which iterates on every training-mode
    forward and always holds u and v constant: the s2 trainer updates u and
    v on the D step's real pass only (models/discriminators.py). The power
    iteration and sigma are float32 whatever `dtype`, the conv's compute
    dtype, is."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: tuple[int, int], stride=(1, 1), padding=(0, 0),
                 dilation=(1, 1), dtype=None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype = dtype
        self.weight_orig = nn.Parameter(
            torch.empty(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        n_in = in_channels * kernel_size[0] * kernel_size[1]
        self.register_buffer("weight_u", torch.randn(
            out_channels, generator=torch.Generator().manual_seed(0)))
        self.register_buffer("weight_v", torch.randn(
            n_in, generator=torch.Generator().manual_seed(1)))

    def weight(self, update_u: bool = False):
        """The normalised (Cout, Cin, Kh, Kw) weight."""
        w = self.weight_orig
        w_mat = w.reshape(w.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        if update_u:
            v = w_mat.t() @ u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = w_mat @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
            # new buffers, not an in-place write: the old u is saved for
            # this pass's backward
            self.weight_u = u.detach().clone()
            self.weight_v = v.detach().clone()
        sigma = torch.dot(u, w_mat @ v)
        return w / sigma

    def forward(self, x, update_u: bool = False):
        return conv2d_op(x, self.weight(update_u), self.bias, self.stride,
                         self.padding, self.dilation, self.dtype)
