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
products in float32. `csrc/snake_conv_bf16.cu` does that on Hopper's
wgmma, from weights rounded and laid out once (`pack_bf16`; the module
path caches the pack per parameter version, nn/resblocks.AMPBlock). The
intermediates between a block's launches stay float32; the block's output
is rounded to bf16 once. The float32 weights still go to the plain-VJP
backward.
"""
from __future__ import annotations

import ctypes
import functools
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


# snake_conv_bf16_fwd's io flags (csrc/snake_conv_bf16.cu); the first marks
# the bf16 products
IO_BF16_MMA, IO_X_BF16, IO_RES_BF16, IO_Y_BF16 = 1, 2, 4, 8

# csrc/snake_conv_bf16.cu: the streaming weight ring's depths, the card
SC16_RINGS = (4, 2)
H100_SMS = 132
SMEM_LIMIT = 232_448            # shared memory a Hopper block may use


def padded_channels(c: int) -> int:
    """Channels of a bf16 conv operand: Cin to whole wgmma k16 steps, Cout
    to its N, each 16, 32, 64 or 128."""
    return next(p for p in (16, 32, 64, 128) if c <= p)


def pack_bf16(w):
    """float32 conv weights (..., k, Cout, Cin) -> bf16 (..., k, Cout_p / 8,
    Cin_p / 8, 8, 8): rounded to nearest even, zero-padded, each tap's
    (Cout_p x Cin_p) slice as 8 x 8 core matrices of wgmma's K-major B
    operand (element [n, kg, r, e] = w[8 n + r, 8 kg + e]), so a tile of
    output channels is one contiguous run of bytes."""
    *lead, k, cout, cin = w.shape
    op, ip = padded_channels(cout), padded_channels(cin)
    wp = torch.zeros(*lead, k, op, ip, dtype=torch.bfloat16, device=w.device)
    wp[..., :cout, :cin] = w.detach()
    wp = wp.view(*lead, k, op // 8, 8, ip // 8, 8).transpose(-3, -2)
    return wp.contiguous()


def snake_conv_bf16_plan(b: int, t: int, cin: int, cout: int, k: int,
                         dilation: int, sms: int = H100_SMS,
                         smem_max: int = SMEM_LIMIT) -> dict:
    """The launch plan of csrc/snake_conv_bf16.cu (its plan_of, mirrored):
    tiles of `tm` time samples x `tn` output channels, the largest tm of
    128 m (m = MS_max .. 1; MS_max 1 / 2 / 4 / 4 at Cout_p 128 / 64 / 32 /
    16) with b ceil(t / tm) >= sms tiles of all of Cout_p; else tm 64 and
    Cout_p halved (down to 16) while the card is not full. Window rows
    `wr` = tm + (k - 1) d rounded up to 8, + 2; shared memory two bf16
    windows of Cin_p x wr, `ring` weight slices of tn x Cin_p (all k taps,
    loaded once, where they fit and tn = Cout_p; else a ring of 4, else 2)
    and the mbarriers. wgmma: m64 n`tn` k16, Cin_p / 16 steps a tap.
    ValueError where no plan fits. (A new dict of the cached _bf16_plan.)"""
    return dict(_bf16_plan(b, t, cin, cout, k, dilation, sms, smem_max))


@functools.lru_cache(maxsize=None)
def _bf16_plan(b: int, t: int, cin: int, cout: int, k: int, dilation: int,
               sms: int, smem_max: int) -> tuple:
    """snake_conv_bf16_plan's items."""
    if not (b >= 1 and t >= 1 and 1 <= cin <= 128 and 1 <= cout <= 128
            and k >= 1 and dilation >= 1 and (k - 1) * dilation <= 4096):
        raise ValueError(f"snake_conv bf16: no plan for B={b} T={t} "
                         f"Cin={cin} Cout={cout} k={k} d={dilation}")
    cinp, coutp = padded_channels(cin), padded_channels(cout)

    def wr_of(tm):
        return -(-(tm + (k - 1) * dilation) // 8) * 8 + 2

    def smem_of(tm, tn, ring):
        return 4 * cinp * wr_of(tm) + 2 * ring * tn * cinp + 8 * (4 + 2 * ring)

    def ring_of(tm, tn):
        rings = ((k,) if tn == coutp else ()) + SC16_RINGS
        return next((r for r in rings if smem_of(tm, tn, r) <= smem_max), 0)

    def rows(tm):
        return b * -(-t // tm)

    ms_max = {128: 1, 64: 2}.get(coutp, 4)
    tn = coutp
    tm = next((128 * m for m in range(ms_max, 0, -1)
               if ring_of(128 * m, tn) and rows(128 * m) >= sms), 0)
    if not tm:
        tm = 64
        while tn > 16 and (not ring_of(tm, tn) or rows(tm) * (coutp // tn) < sms):
            tn //= 2
    ring = ring_of(tm, tn)
    if not ring or tn > cinp:  # the kernel is built for N <= Cin_p
        raise ValueError(f"snake_conv bf16: no plan at B={b} T={t} Cin={cin} "
                         f"Cout={cout} k={k} d={dilation} (shared memory "
                         f"{smem_max} bytes, output tile {tn} <= {cinp})")
    tiles = rows(tm) * (coutp // tn)
    return (("tm", tm), ("tn", tn), ("cinp", cinp), ("coutp", coutp),
            ("ring", ring), ("wr", wr_of(tm)), ("smem", smem_of(tm, tn, ring)),
            ("tiles", tiles), ("grid", min(tiles, sms)),
            ("wgmma", (64, tn, 16)), ("k16_steps", cinp // 16))


PLAN_KEYS = ("tm", "tn", "cinp", "coutp", "ring", "wr", "smem", "tiles", "grid")


def snake_conv_bf16_plan_card(b: int, t: int, cin: int, cout: int, k: int,
                              dilation: int) -> dict:
    """The plan csrc/snake_conv_bf16.cu runs at this shape on the current
    card (snake_conv_bf16_plan's PLAN_KEYS)."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    cuda_lib.call("snake_conv_bf16_plan", b, t, cin, cout, k, dilation, out)
    return dict(zip(PLAN_KEYS, out))


def snake_conv(x, alpha, inv_beta, w, bias, dilation: int, res=None,
               bf16_mma: bool = False, out_dtype=torch.float32, packed=None,
               stamps=None):
    """One launch of the snake-conv kernel: conv_d(snake(x)) + bias (+ res).

    x: (B, T, Cin); alpha/inv_beta: (Cin,); w: (k, Cout, Cin); bias: (Cout,);
    res: (B, T, Cout) or None -> (B, T, Cout) of `out_dtype`. Without
    `bf16_mma` all are float32 and csrc/snake_conv.cu runs (split TF32).
    With it the products are the bf16 configuration's (csrc/snake_conv_bf16.cu,
    wgmma), x, res and the output may each be float32 or bf16, and the
    weights go as `packed` (pack_bf16(w), packed here when not given), and
    `stamps` (a diagnostic: None, or zeroed int64 (grid, 8) of the plan)
    takes the bf16 kernel's phase split in SM cycles. Not counted: callers
    count their own call."""
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
    y = torch.empty((b, t, cout), device=dev, dtype=out_dtype)
    if not bf16_mma:
        cuda_lib.call("snake_conv_fwd", cuda_lib.ptr(x), cuda_lib.ptr(alpha),
                      cuda_lib.ptr(inv_beta), cuda_lib.ptr(w),
                      cuda_lib.ptr(bias), cuda_lib.ptr(res), cuda_lib.ptr(y),
                      b, t, cin, cout, k, dilation, cuda_lib.stream(dev))
        return y
    plan = snake_conv_bf16_plan(b, t, cin, cout, k, dilation)  # raises with the shape
    if stamps is not None:
        cuda_lib.check(stamps, "stamps", dev, (plan["grid"], 8), (torch.int64,))
    if packed is None:
        packed = pack_bf16(w)
    cuda_lib.check(packed, "packed w", dev, (k, padded_channels(cout) // 8,
                                             padded_channels(cin) // 8, 8, 8),
                   (torch.bfloat16,))
    bf16 = torch.bfloat16
    io = (IO_BF16_MMA | (IO_X_BF16 if x.dtype == bf16 else 0)
          | (IO_RES_BF16 if res is not None and res.dtype == bf16 else 0)
          | (IO_Y_BF16 if out_dtype == bf16 else 0))
    cuda_lib.call("snake_conv_bf16_fwd", cuda_lib.ptr(x), cuda_lib.ptr(alpha),
                  cuda_lib.ptr(inv_beta), cuda_lib.ptr(packed),
                  cuda_lib.ptr(bias), cuda_lib.ptr(res), cuda_lib.ptr(y), b, t,
                  cin, cout, k, dilation, io, cuda_lib.ptr(stamps),
                  cuda_lib.stream(dev))
    return y


def snake_conv_tile(b: int, t: int, cout: int, k: int,
                    dilation: int) -> tuple[int, int]:
    """(time samples, output channels) of one block of the float32
    snake_conv launch at this shape, as csrc/snake_conv.cu chooses them on
    the current card."""
    tm, tn = ctypes.c_int(), ctypes.c_int()
    cuda_lib.call("snake_conv_tile", b, t, cout, k, dilation,
                  ctypes.byref(tm), ctypes.byref(tn))
    return tm.value, tn.value


def run_block(x, ws, dilations: Sequence[int], out_dtype=None, packed=None):
    """The 6 snake-conv launches of one AMPBlock (uncounted), output in
    `out_dtype` (x's dtype by default). A bf16 x runs the bf16
    configuration: the first launch reads bf16 x, the second adds it as the
    residual, the launches between write and read float32, and the last
    writes `out_dtype`; its weights are `packed` = (pack_bf16(w1),
    pack_bf16(w2)), packed here when not given."""
    a1, ib1, w1, b1, a2, ib2, w2, b2 = ws
    mma = x.dtype == torch.bfloat16
    if mma and packed is None:
        packed = (pack_bf16(w1), pack_bf16(w2))
    p1, p2 = packed if mma else ((None,) * len(dilations),) * 2
    out_dtype = out_dtype or x.dtype
    last = len(dilations) - 1
    for i, d in enumerate(dilations):
        c1 = snake_conv(x, a1[i], ib1[i], w1[i], b1[i], d, bf16_mma=mma,
                        packed=p1[i])
        x = snake_conv(c1, a2[i], ib2[i], w2[i], b2[i], 1, res=x, bf16_mma=mma,
                       out_dtype=out_dtype if i == last else torch.float32,
                       packed=p2[i])
    return x


class _AMPBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel_size, dilations, packed, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.static = (kernel_size, dilations)
        y = run_block(x, ws, dilations, packed=packed)
        cuda_lib.LAUNCHES["ampblock_bf16" if x.dtype == torch.bfloat16
                          else "ampblock"] += 1
        return y

    @staticmethod
    def backward(ctx, ct):
        saved = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[4:]
        grads = cuda_lib.plain_vjp(composed_ampblock, saved, needs, ct,
                                   *ctx.static)
        return (grads[0], None, None, None) + grads[1:]


def fused_ampblock(x, a1, ib1, w1, b1, a2, ib2, w2, b2, kernel_size: int,
                   dilations: Sequence[int], packed=None):
    """Whole AMPBlock; x: (B, T, C) float32 or bf16 (the bf16
    configuration), weights float32 as the module docstring; `packed`: the
    bf16 configuration's (pack_bf16(w1), pack_bf16(w2)) where the caller
    keeps them (nn/resblocks.AMPBlock.packed_bf16), else packed in the call.

    CUDA tensors run the kernel (any T >= 1); CPU tensors run the plain
    version."""
    ws = (a1, ib1, w1, b1, a2, ib2, w2, b2)
    if x.device.type == "cpu":
        return composed_ampblock(x, *ws, kernel_size, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _AMPBlock.apply(x.contiguous(), kernel_size, tuple(dilations),
                           packed, *ws)
