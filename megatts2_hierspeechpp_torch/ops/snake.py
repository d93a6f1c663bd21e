"""Anti-aliased SnakeBeta: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel `megatts2_hierspeechpp_tpu/ops/pallas_snake.py`
(`_kernel` / `_kernel_tr` behind `fused_aa_snakebeta`):

  y = down2(s(up2(x))),  s(u) = u + sin^2(alpha*u) / beta

with the x2 kaiser-sinc upsampler as two 6-tap polyphase filters and the 12-tap
kaiser low-pass downsampler (`csrc/aa_snake.cu`).

On the H100 the function is bound by bytes: it reads x once and writes y
once, about 58 flops per element against 8 bytes. On the serving path x has
just been written and sits in L2, so the kernel's time is its arithmetic
and the ramp of a short launch. It keeps the x2 intermediate out of memory
and has no block barrier: a thread owns one channel and `rows` consecutive
outputs, loads the rows + 10 x rows they read, and computes each s(u) once
with the down filter's sums in registers (`snake_plan`).
Sequence edges are exact: the composed op replicate-pads x before the
upsampler and s(u) before the downsampler, so the kernel clamps the x index
to [0, T-1] and the u index to [0, 2T-1]. No edge strip is recomputed from
the composed math, as the TPU wrapper had to.

x and y are float32, or bf16 in the TPU kernel's bf16 configuration: x is
read as bf16 and converted to float32, every tap and the snake run in
float32 with float32 alpha and 1/beta (the Pallas kernel's `ab` operand),
and y is rounded to bf16 once (counted as `aa_snakebeta_bf16`). A bf16 x
runs a kernel of its own, `csrc/aa_snake_bf16.cu`, planned for its own
bound: half the bytes leave the arithmetic as the limit, so a thread
streams a segment of `seg` outputs on two channels (bf16x2 rows),
computes each s(u) once, and takes the hardware sine
(`snake_bf16_plan`).

The plain version, `composed_snakebeta`, is the composed math of the JAX
`_composed_math`, in float32 for a bf16 x; CPU tensors take it, and it is
the kernel's backward.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from megatts2_hierspeechpp_torch.ops import cuda_lib
from megatts2_hierspeechpp_torch.ops.resample import (
    activation1d,
    kaiser_sinc_filter1d,
)

EPS = 1e-9  # reference no_div_by_zero


@functools.lru_cache(maxsize=1)
def _polyphase_taps():
    """(e_taps[6], o_taps[6], ge[6], go[6]) float32 arrays, derived as the
    JAX kernel derives them: by probing the composed x2 upsampler with
    deltas. u[2m] = sum_d e[d] x[m+d], d in -3..2; u[2m+1] = sum_d o[d]
    x[m+d], d in -2..3. ge/go split the 12-tap downsampler by parity.
    `csrc/taps.cuh` holds the same numbers as literals (a test checks)."""
    f_up = kaiser_sinc_filter1d(0.25, 0.3, 12).astype(np.float64)
    f_dn = kaiser_sinc_filter1d(0.25, 0.3, 12).astype(np.float64)

    t = 64
    u_mat = np.zeros((2 * t, t))
    for i in range(t):
        x = np.zeros(t)
        x[i] = 1.0
        xp = np.pad(x, (5, 5), mode="edge")
        full = np.zeros(2 * len(xp) + 10)
        for m, v in enumerate(xp):
            full[2 * m: 2 * m + 12] += 2.0 * v * f_up
        u_mat[:, i] = full[15: 15 + 2 * t]
    j0 = t
    e_taps = [u_mat[j0, t // 2 + d] for d in range(-3, 3)]
    o_taps = [u_mat[j0 + 1, t // 2 + d] for d in range(-2, 4)]
    g = f_dn
    ge = [g[d + 5] for d in (-4, -2, 0, 2, 4, 6)]
    go = [g[d + 5] for d in (-5, -3, -1, 1, 3, 5)]
    return tuple(np.asarray(v, np.float32) for v in (e_taps, o_taps, ge, go))


def composed_snakebeta(x, alpha, beta):
    """Plain version: x (B, T, C); alpha, beta (C,) post-exp. A bf16 x
    takes the kernel's bf16 configuration: float32 math, a bf16 result."""
    if x.dtype == torch.bfloat16:
        return composed_snakebeta(x.float(), alpha, beta).to(x.dtype)
    a = alpha.to(x.dtype)
    b = beta.to(x.dtype)
    return activation1d(x, lambda v: v + torch.sin(v * a).square() / (b + EPS))


def inverse_beta(beta):
    """1 / (beta + EPS), the kernel's form of beta."""
    return 1.0 / (beta + EPS)


THREADS = 128     # per block, csrc/aa_snake.cu kThreads
ROWS = (4, 8)     # outputs per thread the kernel is built for


def snake_plan(b: int, t: int, c: int, rows: int | None = None) -> dict:
    """The float32 kernel's launch plan, as csrc/aa_snake.cu recomputes it:
    a thread owns one channel and `rows` consecutive outputs (a segment); a
    block of THREADS threads is 32 channels (lanes) x 4 consecutive
    segments (warps), blocks running channel chunk fastest, then segment
    group, then batch row. By default 8 rows per thread at C > 64 and 4
    otherwise: the best of chip_smoke's sweep in float32 at the serving
    path's shapes, B = 1, T = 2000, C = 256 and C = 64 (PERF.md); the
    training and eval shapes (B = 32) take the same rule unmeasured."""
    if rows is None:
        rows = 8 if c > 64 else 4
    if rows not in ROWS:
        raise ValueError(f"no aa_snakebeta kernel for rows={rows}")
    segs = -(-t // rows)
    return {"rows": rows, "blocks": b * -(-segs // 4) * -(-c // 32)}


# csrc/aa_snake_bf16.cu: threads per block (4 warps), steps in its loop
# body (a segment is a whole number of them), the longest segment it takes
BF16_THREADS = 128
BF16_PERIOD = 6
BF16_MAX_SEG = 384
BF16_SEGS = (12, 18, 24, 36, 48)   # outputs per thread the plan picks from
# the plan takes the longest segment that still gives this many warps
# (about 8 for each of the H100's 132 SMs), else the shortest: the best
# or within 1 % of it at each of chip_smoke.py's nine bf16 launch shapes
BF16_WARPS = 1024


def snake_bf16_plan(b: int, t: int, c: int, seg: int | None = None,
                    align: int = 16) -> dict:
    """The bf16 kernel's launch plan, as csrc/aa_snake_bf16.cu recomputes
    it: a thread owns `pack` neighbouring channels and `seg` consecutive
    outputs; a warp is 32 x pack channels ("chunks" of them across C) of
    one segment ("segs" across T), warps running chunk fastest, then
    segment, then batch row, 4 to a block of BF16_THREADS. `align` is the
    alignment of x in bytes (y is the allocator's, 256): pack 2 (bf16x2
    rows) where C is even and x 4-byte aligned, else 1. By default the
    longest segment in BF16_SEGS that still gives BF16_WARPS warps, else
    the shortest: a longer segment spends fewer of its s(u) before its
    first output ((seg + 5) / seg pairs an output), a shorter one fills
    more of the card. ValueError for a segment the kernel is not planned
    for."""
    pack = 2 if c % 2 == 0 and align % 4 == 0 else 1
    chunks = -(-c // (32 * pack))
    if seg is None:
        seg = next((s for s in sorted(BF16_SEGS, reverse=True)
                    if b * -(-t // s) * chunks >= BF16_WARPS), min(BF16_SEGS))
    if seg not in BF16_SEGS:
        raise ValueError(f"no aa_snakebeta_bf16 plan for seg={seg}")
    segs = -(-t // seg)
    warps = b * segs * chunks
    return {"seg": seg, "pack": pack, "chunks": chunks, "segs": segs,
            "warps": warps, "blocks": -(-warps // (BF16_THREADS // 32))}


def _launch(x, alpha, beta, inv_beta=None, rows=None, seg=None):
    """One kernel launch: csrc/aa_snake.cu on a float32 x (plan `rows`),
    csrc/aa_snake_bf16.cu on a bf16 x (plan `seg`)."""
    x = x.contiguous()
    b, t, c = x.shape
    cuda_lib.check(x, "x", x.device, dtypes=cuda_lib.ACT_DTYPES)
    cuda_lib.check(alpha, "alpha", x.device, (c,))
    cuda_lib.check(beta, "beta", x.device, (c,))
    if inv_beta is None:
        inv_beta = inverse_beta(beta)
    cuda_lib.check(inv_beta, "inv_beta", x.device, (c,))
    y = torch.empty_like(x)
    if x.dtype == torch.bfloat16:
        if rows is not None:
            raise ValueError("rows is the float32 kernel's plan; a bf16 x "
                             "takes seg")
        ptr = x.data_ptr()
        plan = snake_bf16_plan(b, t, c, seg, min(ptr & -ptr, 16))
        cuda_lib.call("aa_snakebeta_bf16_fwd", cuda_lib.ptr(x),
                      cuda_lib.ptr(alpha), cuda_lib.ptr(inv_beta),
                      cuda_lib.ptr(y), b, t, c, plan["seg"], plan["pack"],
                      plan["blocks"], cuda_lib.stream(x.device))
        cuda_lib.LAUNCHES["aa_snakebeta_bf16"] += 1
        return y
    if seg is not None:
        raise ValueError("seg is the bf16 kernel's plan; a float32 x takes rows")
    plan = snake_plan(b, t, c, rows)
    cuda_lib.call("aa_snakebeta_fwd", cuda_lib.ptr(x), cuda_lib.ptr(alpha),
                  cuda_lib.ptr(inv_beta), cuda_lib.ptr(y), b, t, c,
                  plan["rows"], plan["blocks"], cuda_lib.stream(x.device))
    cuda_lib.LAUNCHES["aa_snakebeta"] += 1
    return y


class _AASnakeBeta(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha, beta, inv_beta):
        ctx.save_for_backward(x, alpha, beta)
        return _launch(x, alpha, beta, inv_beta)

    @staticmethod
    def backward(ctx, ct):
        return cuda_lib.plain_vjp(composed_snakebeta, ctx.saved_tensors,
                                  ctx.needs_input_grad[:3], ct) + (None,)


def fused_aa_snakebeta(x, alpha, beta, inv_beta=None):
    """x: (B, T, C) float32 or bf16; alpha/beta: (C,) float32 post-exp ->
    (B, T, C) in x's dtype.
    `inv_beta`, when given, is inverse_beta(beta) computed once by the
    caller (the per-call division then leaves the serving path).

    CUDA tensors run a kernel (any T >= 1): float32 csrc/aa_snake.cu, bf16
    csrc/aa_snake_bf16.cu; CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return composed_snakebeta(x, alpha, beta)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _AASnakeBeta.apply(x, alpha, beta, inv_beta)
