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

bf16 configuration (a bf16 x, counted as `ampblock_bf16`): what the TPU
kernel computes with a bf16 output. x is read as bf16 and everything is
float32 inside (the snakes, the taps, the biases and residual sums) but the
convs, which run at the MXU's default precision: each rounds its two
operands (the snake output and the float32 weights) to bf16 and sums the
products in float32. snake_conv.cu does that with one bf16 mma.sync pass per
product. The intermediates between a block's launches stay float32; the
block's output is rounded to bf16 once. The weights stay float32.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from megatts2_hierspeechpp_torch.nn.conv import conv1d_op
from megatts2_hierspeechpp_torch.ops import cuda_lib
from megatts2_hierspeechpp_torch.ops.resample import activation1d


def rounded(v):
    """v rounded to bf16, in v's dtype: a conv operand at the MXU's default
    precision (one bf16 pass, float32 sums). The gradient passes straight
    through, unrounded: the backward stays float32, as the JAX custom_vjp's
    composed math is, and two runs of it differ by float32 sums alone (a
    rounded gradient would flip at bf16 boundaries between them)."""
    return v + (v.to(torch.bfloat16).to(v.dtype) - v).detach()


def block_math(x, a1, ib1, w1, b1, a2, ib2, w2, b2, kernel_size: int,
               dilations: Sequence[int], bf16_products: bool = False):
    """One AMPBlock in x's dtype; with `bf16_products` every conv's operands
    rounded to bf16 (the bf16 configuration, on a float32 x)."""
    op = rounded if bf16_products else (lambda v: v)
    half = (kernel_size - 1) // 2
    for i, d in enumerate(dilations):
        xt = activation1d(x, lambda v: v + torch.sin(v * a1[i]).square() * ib1[i])
        xt = conv1d_op(op(xt), op(w1[i].permute(1, 2, 0)), b1[i], 1, half * d, d)
        xt = activation1d(xt, lambda v: v + torch.sin(v * a2[i]).square() * ib2[i])
        xt = conv1d_op(op(xt), op(w2[i].permute(1, 2, 0)), b2[i], 1, half, 1)
        x = xt + x
    return x


def composed_ampblock(x, a1, ib1, w1, b1, a2, ib2, w2, b2, kernel_size: int,
                      dilations: Sequence[int]):
    """Plain version (the JAX `composed_ampblock`); x: (B, T, C). A bf16 x
    takes the bf16 configuration: float32 math with bf16 conv operands, a
    bf16 result."""
    ws = (a1, ib1, w1, b1, a2, ib2, w2, b2)
    if x.dtype == torch.bfloat16:
        return block_math(x.float(), *ws, kernel_size, dilations,
                          bf16_products=True).to(x.dtype)
    return block_math(x, *ws, kernel_size, dilations)


# snake_conv_fwd's io flags (csrc/snake_conv.cu)
IO_BF16_MMA, IO_X_BF16, IO_RES_BF16, IO_Y_BF16 = 1, 2, 4, 8


def snake_conv(x, alpha, inv_beta, w, bias, dilation: int, res=None,
               bf16_mma: bool = False, out_dtype=torch.float32):
    """One launch of csrc/snake_conv.cu: conv_d(snake(x)) + bias (+ res).

    x: (B, T, Cin); alpha/inv_beta: (Cin,); w: (k, Cout, Cin); bias: (Cout,);
    res: (B, T, Cout) or None -> (B, T, Cout) of `out_dtype`. With
    `bf16_mma` the products are one bf16 pass (the bf16 configuration), and
    x, res and the output may each be float32 or bf16; without it all are
    float32 (split TF32). Not counted: callers count their own call."""
    b, t, cin = x.shape
    k, cout, _ = w.shape
    dev = x.device
    io_dtypes = cuda_lib.ACT_DTYPES if bf16_mma else (torch.float32,)
    if out_dtype not in io_dtypes:
        raise TypeError(f"snake_conv output must be one of {io_dtypes}")
    cuda_lib.check(x, "x", dev, dtypes=io_dtypes)
    cuda_lib.check(alpha, "alpha", dev, (cin,))
    cuda_lib.check(inv_beta, "inv_beta", dev, (cin,))
    cuda_lib.check(w, "w", dev, (k, cout, cin))
    cuda_lib.check(bias, "bias", dev, (cout,))
    if res is not None:
        cuda_lib.check(res, "res", dev, (b, t, cout), io_dtypes)
    io = 0
    if bf16_mma:
        bf16 = torch.bfloat16
        io = (IO_BF16_MMA | (IO_X_BF16 if x.dtype == bf16 else 0)
              | (IO_RES_BF16 if res is not None and res.dtype == bf16 else 0)
              | (IO_Y_BF16 if out_dtype == bf16 else 0))
    y = torch.empty((b, t, cout), device=dev, dtype=out_dtype)
    cuda_lib.call("snake_conv_fwd", cuda_lib.ptr(x), cuda_lib.ptr(alpha),
                  cuda_lib.ptr(inv_beta), cuda_lib.ptr(w), cuda_lib.ptr(bias),
                  cuda_lib.ptr(res), cuda_lib.ptr(y), b, t, cin, cout, k,
                  dilation, io, cuda_lib.stream(dev))
    return y


def snake_conv_tile(b: int, t: int, cout: int, k: int, dilation: int,
                    bf16_mma: bool = False) -> tuple[int, int]:
    """(time samples, output channels) of one block of the snake_conv launch
    at this shape, as csrc/snake_conv.cu chooses them on the current card."""
    tm, tn = ctypes.c_int(), ctypes.c_int()
    cuda_lib.call("snake_conv_tile", b, t, cout, k, dilation, int(bf16_mma),
                  ctypes.byref(tm), ctypes.byref(tn))
    return tm.value, tn.value


def run_block(x, ws, dilations: Sequence[int], out_dtype=None):
    """The 6 snake-conv launches of one AMPBlock (uncounted), output in
    `out_dtype` (x's dtype by default). A bf16 x runs the bf16
    configuration: the first launch reads bf16 x, the second adds it as the
    residual, the launches between write and read float32, and the last
    writes `out_dtype`."""
    a1, ib1, w1, b1, a2, ib2, w2, b2 = ws
    mma = x.dtype == torch.bfloat16
    out_dtype = out_dtype or x.dtype
    last = len(dilations) - 1
    for i, d in enumerate(dilations):
        c1 = snake_conv(x, a1[i], ib1[i], w1[i], b1[i], d, bf16_mma=mma)
        x = snake_conv(c1, a2[i], ib2[i], w2[i], b2[i], 1, res=x, bf16_mma=mma,
                       out_dtype=out_dtype if i == last else torch.float32)
    return x


class _AMPBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel_size, dilations, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.static = (kernel_size, dilations)
        y = run_block(x, ws, dilations)
        cuda_lib.LAUNCHES["ampblock_bf16" if x.dtype == torch.bfloat16
                          else "ampblock"] += 1
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
    """Whole AMPBlock; x: (B, T, C) float32 or bf16 (the bf16
    configuration), weights float32 as the module docstring.

    CUDA tensors run the kernel (any T >= 1); CPU tensors run the plain
    version."""
    ws = (a1, ib1, w1, b1, a2, ib2, w2, b2)
    if x.device.type == "cpu":
        return composed_ampblock(x, *ws, kernel_size, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _AMPBlock.apply(x.contiguous(), kernel_size, tuple(dilations), *ws)
