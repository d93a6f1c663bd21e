"""Anti-aliased SnakeBeta: hand-written CUDA kernel and its plain version.

Replaces the TPU kernel `megatts2_hierspeechpp_tpu/ops/pallas_snake.py`
(`_kernel` / `_kernel_tr` behind `fused_aa_snakebeta`):

  y = down2(s(up2(x))),  s(u) = u + sin^2(alpha*u) / beta

with the x2 kaiser-sinc upsampler as two 6-tap polyphase filters and the 12-tap
kaiser low-pass downsampler (`csrc/aa_snake.cu`).

On the H100 the function is bound by bytes: it reads x once and writes y
once, about 58 flops per element against 8 bytes. The kernel keeps the x2
intermediate out of device memory: a block stages its x tile plus a 6-sample
halo in shared memory, computes s(u) for the tile there, and writes only y.
Sequence edges are exact: the composed op replicate-pads x before the
upsampler and s(u) before the downsampler, so the kernel clamps the x index
to [0, T-1] and the u index to [0, 2T-1]. No edge strip is recomputed from
the composed math, as the TPU wrapper had to.

The plain version, `composed_snakebeta`, is the composed math of the JAX
`_composed_math`; CPU tensors take it, and it is the kernel's backward.
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
    """Plain version: x (B, T, C); alpha, beta (C,) post-exp."""
    a = alpha.to(x.dtype)
    b = beta.to(x.dtype)
    return activation1d(x, lambda v: v + torch.sin(v * a).square() / (b + EPS))


def inverse_beta(beta):
    """1 / (beta + EPS), the kernel's form of beta."""
    return 1.0 / (beta + EPS)


def _launch(x, alpha, beta, inv_beta=None):
    x = x.contiguous()
    b, t, c = x.shape
    cuda_lib.check(x, "x", x.device)
    cuda_lib.check(alpha, "alpha", x.device, (c,))
    cuda_lib.check(beta, "beta", x.device, (c,))
    if inv_beta is None:
        inv_beta = inverse_beta(beta)
    cuda_lib.check(inv_beta, "inv_beta", x.device, (c,))
    y = torch.empty_like(x)
    cuda_lib.call("aa_snakebeta_fwd", cuda_lib.ptr(x), cuda_lib.ptr(alpha),
                  cuda_lib.ptr(inv_beta), cuda_lib.ptr(y), b, t, c,
                  cuda_lib.stream(x.device))
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
    """x: (B, T, C) float32; alpha/beta: (C,) post-exp -> (B, T, C).
    `inv_beta`, when given, is inverse_beta(beta) computed once by the
    caller (the per-call division then leaves the serving path).

    CUDA tensors run the kernel (any T >= 1); CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return composed_snakebeta(x, alpha, beta)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _AASnakeBeta.apply(x, alpha, beta, inv_beta)
