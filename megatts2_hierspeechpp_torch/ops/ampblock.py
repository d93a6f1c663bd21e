"""Whole AMPBlock: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel `megatts2_hierspeechpp_tpu/ops/pallas_ampblock.py`
(`_kernel` behind `fused_ampblock`). One block is three branches (d = 1, 3,
5), each AA-snake -> dilated conv -> AA-snake -> conv -> residual add.

On the H100 the block is bound by its convolutions (6 of 2*K*C flops per
output sample), which the kernel runs on the tensor cores as three split-
TF32 products, as accurate as float32. The TPU kernel held the whole block
in VMEM; its weights alone do not fit a Hopper block's shared memory, so
the design here is one CUDA kernel, `csrc/snake_conv.cu`, that fuses one
anti-aliased snake into the convolution after it. A block is 6 launches of
it: the x2 intermediates of the snakes never reach device memory, the conv
outputs do. The snake edges are the exact clamped ones and
the convs zero-pad per layer, as the composed math does, so the result
matches `composed_ampblock` everywhere with no edge stitching.

Weight contract (as the JAX kernel): a*/ib* (n, C) post-exp alpha and
1/(beta + eps); w* (n, k, Cout, Cin); b* (n, Cout).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from megatts2_hierspeechpp_torch.nn.conv import conv1d_op
from megatts2_hierspeechpp_torch.ops import cuda_lib
from megatts2_hierspeechpp_torch.ops.resample import activation1d


def composed_ampblock(x, a1, ib1, w1, b1, a2, ib2, w2, b2, kernel_size: int,
                      dilations: Sequence[int]):
    """Plain version (the JAX `composed_ampblock`); x: (B, T, C)."""
    half = (kernel_size - 1) // 2
    for i, d in enumerate(dilations):
        xt = activation1d(x, lambda v: v + torch.sin(v * a1[i]).square() * ib1[i])
        xt = conv1d_op(xt, w1[i].permute(1, 2, 0), b1[i], 1, half * d, d)
        xt = activation1d(xt, lambda v: v + torch.sin(v * a2[i]).square() * ib2[i])
        xt = conv1d_op(xt, w2[i].permute(1, 2, 0), b2[i], 1, half, 1)
        x = xt + x
    return x


def snake_conv(x, alpha, inv_beta, w, bias, dilation: int, res=None):
    """One launch of csrc/snake_conv.cu: conv_d(snake(x)) + bias (+ res).

    x: (B, T, Cin); alpha/inv_beta: (Cin,); w: (k, Cout, Cin); bias: (Cout,);
    res: (B, T, Cout) or None. Not counted: callers count their own call."""
    b, t, cin = x.shape
    k, cout, _ = w.shape
    dev = x.device
    cuda_lib.check(x, "x", dev)
    cuda_lib.check(alpha, "alpha", dev, (cin,))
    cuda_lib.check(inv_beta, "inv_beta", dev, (cin,))
    cuda_lib.check(w, "w", dev, (k, cout, cin))
    cuda_lib.check(bias, "bias", dev, (cout,))
    if res is not None:
        cuda_lib.check(res, "res", dev, (b, t, cout))
    y = torch.empty((b, t, cout), device=dev, dtype=x.dtype)
    cuda_lib.call("snake_conv_fwd", cuda_lib.ptr(x), cuda_lib.ptr(alpha),
                  cuda_lib.ptr(inv_beta), cuda_lib.ptr(w), cuda_lib.ptr(bias),
                  cuda_lib.ptr(res), cuda_lib.ptr(y), b, t, cin, cout, k,
                  dilation, cuda_lib.stream(dev))
    return y


def snake_conv_tile(b: int, t: int, cout: int, k: int,
                    dilation: int) -> tuple[int, int]:
    """(time samples, output channels) of one block of the snake_conv launch
    at this shape, as csrc/snake_conv.cu chooses them on the current card."""
    tm, tn = ctypes.c_int(), ctypes.c_int()
    cuda_lib.call("snake_conv_tile", b, t, cout, k, dilation,
                  ctypes.byref(tm), ctypes.byref(tn))
    return tm.value, tn.value


def run_block(x, ws, dilations: Sequence[int]):
    """The 6 snake-conv launches of one AMPBlock (uncounted)."""
    a1, ib1, w1, b1, a2, ib2, w2, b2 = ws
    for i, d in enumerate(dilations):
        c1 = snake_conv(x, a1[i], ib1[i], w1[i], b1[i], d)
        x = snake_conv(c1, a2[i], ib2[i], w2[i], b2[i], 1, res=x)
    return x


class _AMPBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel_size, dilations, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.static = (kernel_size, dilations)
        y = run_block(x, ws, dilations)
        cuda_lib.LAUNCHES["ampblock"] += 1
        return y

    @staticmethod
    def backward(ctx, ct):
        saved = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[3:]
        grads = cuda_lib.plain_vjp(composed_ampblock, saved, needs, ct,
                                   *ctx.static)
        return (grads[0], None, None) + grads[1:]


def fused_ampblock(x, a1, ib1, w1, b1, a2, ib2, w2, b2, kernel_size: int,
                   dilations: Sequence[int]):
    """Whole AMPBlock; x: (B, T, C) float32, weights as the module docstring.

    CUDA tensors run the kernel (any T >= 1); CPU tensors run the plain
    version."""
    ws = (a1, ib1, w1, b1, a2, ib2, w2, b2)
    if x.device.type == "cpu":
        return composed_ampblock(x, *ws, kernel_size, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _AMPBlock.apply(x.contiguous(), kernel_size, tuple(dilations), *ws)
