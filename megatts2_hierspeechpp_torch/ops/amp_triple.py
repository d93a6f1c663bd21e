"""AMPBlock triple (one decoder stage, + optional tail): CUDA kernels and the
plain version.

Replaces the TPU kernel `megatts2_hierspeechpp_tpu/ops/pallas_amp_triple.py`
(`_kernel` behind `fused_amp_triple`): three AMPBlocks on one input,
averaged, and with `post` the tail AA-snake -> conv_post (C -> 1, k=7) ->
tanh, giving the (B, T, 1) waveform.

On the H100 a stage is bound by its convolutions, like one AMPBlock. The
TPU kernel ran the whole stage in one VMEM pass. Here each block runs
through the snake-conv kernel (`csrc/snake_conv.cu`, 6 launches per block),
and one epilogue kernel (`csrc/triple_epilogue.cu`) averages the three
block outputs and, with `post`, runs the tail without writing the average
to device memory. Edges are exact, as in ops/ampblock.py, so no strip of
`composed_triple` is stitched in.

bf16 configuration (a bf16 x, counted as `amp_triple_bf16`): each block runs
the AMPBlock's bf16 configuration (ops/ampblock.py, its convs on
`csrc/snake_conv_bf16.cu` from the blocks' packed weights) but writes its
output in float32, and the epilogue averages in float32, runs the tail in
float32 and rounds the stage's output to bf16 once, as the TPU kernel keeps
the whole stage in float32 in VMEM. The average alone is
`csrc/triple_epilogue.cu`'s with a bf16 store; the tail is a kernel of its
own, `csrc/triple_post_bf16.cu`, planned for the bf16 budget (a group of
lanes streams a segment of outputs across the channels, each s(u) computed
once with the hardware sine, conv_post summed across the lanes by shuffles;
`tail_bf16_plan`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from megatts2_hierspeechpp_torch.nn.conv import conv1d_op
from megatts2_hierspeechpp_torch.ops import cuda_lib
from megatts2_hierspeechpp_torch.ops.ampblock import (
    SMEM_LIMIT, block_math, run_block)
from megatts2_hierspeechpp_torch.ops.resample import activation1d


def composed_epilogue(r0, r1, r2, post=None):
    """Plain version of the epilogue: the average of the three block
    outputs (B, T, C) and, with `post` = (alpha, 1/beta, w_post (7, C)),
    the tail tanh(conv_post(AA-snake(avg))) -> (B, T, 1)."""
    y = (r0 + r1 + r2) / 3.0
    if post is None:
        return y
    pa, pib, pw = post
    y = activation1d(y, lambda v: v + torch.sin(v * pa).square() * pib)
    y = conv1d_op(y, pw.t().unsqueeze(0), None, 1, 3, 1)
    return torch.tanh(y)


def triple_math(x, block_ws, ks, dils, post=None, bf16_products=False):
    """One stage in x's dtype; with `bf16_products` every conv's operands
    rounded to bf16 (the bf16 configuration, on a float32 x)."""
    rs = [block_math(x, *bw, k, d, bf16_products=bf16_products)
          for bw, k, d in zip(block_ws, ks, dils)]
    return composed_epilogue(*rs, post=post)


def composed_triple(x, block_ws, ks, dils, post=None):
    """Plain version (the JAX `composed_triple`).

    x: (B, T, C); block_ws: per block (three) the ops/ampblock weight tuple;
    post: optional (alpha, 1/beta, w_post (7, C)) -> (B, T, 1) tanh
    waveform, else the (B, T, C) averaged blocks. A bf16 x takes the bf16
    configuration: the stage in float32 with bf16 conv operands, a bf16
    result."""
    if x.dtype == torch.bfloat16:
        return triple_math(x.float(), block_ws, ks, dils, post,
                           bf16_products=True).to(x.dtype)
    return triple_math(x, block_ws, ks, dils, post)


EPILOGUE_THREADS = 256          # csrc/triple_epilogue.cu kThreads
EPILOGUE_TILES = (248, 120, 56, 24)
EPILOGUE_ROWS_PER_TASK = 16     # kR: AA-snake rows per thread task


def epilogue_smem(c: int, tile: int) -> int:
    """Shared bytes of the tail kernel: conv_post weights C x 8 (padded),
    average (rows + 10) x C, AA-snake C x (rows + 1), rows = tile + 8."""
    return 4 * c * (2 * (tile + 8) + 19)


def epilogue_plan(b: int, t: int, c: int, tile: int | None = None) -> dict:
    """The tail kernel's launch plan, as csrc/triple_epilogue.cu checks it:
    the first of EPILOGUE_TILES whose shared memory fits (or `tile`). Block
    (x, bb) writes outputs x L .. x L + L - 1 of batch row bb; its AA-snake
    covers rows x L - 3 .. x L + L + 4, in (L + 8) / 16 tasks of 16 rows per
    channel."""
    fits = [L for L in EPILOGUE_TILES if epilogue_smem(c, L) <= SMEM_LIMIT]
    if tile is None:
        tile = fits[0] if fits else None
    if tile not in fits:
        raise ValueError(f"triple epilogue: no tile of {EPILOGUE_TILES} "
                         f"fits shared memory at C={c}")
    rows = tile + 8  # the conv's 3 + 3 halo, rounded up to 16 rows
    return {"tile": tile, "rows": rows, "smem": epilogue_smem(c, tile),
            "grid": (-(-t // tile), b),
            "tasks": rows // EPILOGUE_ROWS_PER_TASK * c}


# csrc/triple_post_bf16.cu: threads per block (4 warps), steps in its loop
# body (a segment is a whole number of them), steps before a segment's
# first output (5 pairs, then conv_post's 6 halo rows), the longest segment
TAIL_BF16_THREADS = 128
TAIL_BF16_PERIOD = 6
TAIL_BF16_LEAD = 11
TAIL_BF16_MAX_SEG = 2040
# blocks resident on an SM at the kernel's register budget (its launch
# bounds), by channels a lane; the H100's SMs
TAIL_BF16_BLOCKS_PER_SM = {1: 5, 2: 3}
H100_SMS = 132


def tail_bf16_plan(b: int, t: int, c: int, seg: int | None = None,
                   sms: int = H100_SMS) -> dict:
    """The bf16 tail kernel's launch plan, as csrc/triple_post_bf16.cu
    recomputes it: a group of `lanes` lanes (32 at C > 16, else the power
    of two >= C; 32 / lanes groups a warp) owns one batch row's `seg`
    consecutive outputs, lane l holding channels l + p x lanes, p < `pack`
    (1 at C <= 32, else 2); `chunks` walks of the segment cover C, their
    sums kept in `smem` bytes (4 warps x seg floats) where there is more
    than one. Groups run segment fastest, then batch row, 4 warps to a
    block. By default the shortest segment with which every group is
    resident at once on `sms` SMs (TAIL_BF16_BLOCKS_PER_SM blocks each):
    one wave, one segment a group, so no group waits for a second wave
    and the segments of a row are within 6 rows of each other; at most
    TAIL_BF16_MAX_SEG (more waves past that). ValueError for a segment
    the kernel does not take (a multiple of 6 up to TAIL_BF16_MAX_SEG)."""
    if min(b, t, c) < 1:
        raise ValueError(f"no triple_post_bf16 plan for B={b} T={t} C={c}")
    pack = 2 if c > 32 else 1
    lanes = min(32, 1 << (c - 1).bit_length())
    groups = 32 // lanes
    chunks = -(-c // (lanes * pack))
    per_block = TAIL_BF16_THREADS // 32
    resident = sms * TAIL_BF16_BLOCKS_PER_SM[pack] * per_block * groups
    if seg is None:
        per_row = max(1, resident // b)   # segments a batch row may take
        seg = min(TAIL_BF16_MAX_SEG,
                  TAIL_BF16_PERIOD * -(-t // (TAIL_BF16_PERIOD * per_row)))
    if seg % TAIL_BF16_PERIOD or not TAIL_BF16_PERIOD <= seg <= TAIL_BF16_MAX_SEG:
        raise ValueError(f"no triple_post_bf16 plan for seg={seg}")
    segs = -(-t // seg)
    warps = -(-b * segs // groups)
    return {"seg": seg, "pack": pack, "lanes": lanes, "chunks": chunks,
            "segs": segs, "warps": warps, "blocks": -(-warps // per_block),
            "waves": b * segs / resident,
            "smem": 4 * per_block * seg if chunks > 1 else 0}


def _epilogue(r0, r1, r2, post, tile=None, stamps=None,
              out_dtype=torch.float32, seg=None):
    b, t, c = r0.shape
    dev = r0.device
    for name, r in (("r0", r0), ("r1", r1), ("r2", r2)):
        cuda_lib.check(r, name, dev, (b, t, c))
    if out_dtype not in cuda_lib.ACT_DTYPES:
        raise TypeError(f"triple epilogue output must be one of "
                        f"{cuda_lib.ACT_DTYPES}, got {out_dtype}")
    if post is None:
        y = torch.empty_like(r0, dtype=out_dtype)
        cuda_lib.call("triple_avg_fwd", *map(cuda_lib.ptr, (r0, r1, r2, y)),
                      b * t * c, cuda_lib.act_bytes(y), cuda_lib.stream(dev))
        return y
    pa, pib, pw = post
    cuda_lib.check(pa, "post alpha", dev, (c,))
    cuda_lib.check(pib, "post inv_beta", dev, (c,))
    cuda_lib.check(pw, "post weight", dev, (7, c))
    y = torch.empty((b, t, 1), device=dev, dtype=out_dtype)
    ptrs = map(cuda_lib.ptr, (r0, r1, r2, pa, pib, pw, y))
    if out_dtype == torch.bfloat16:
        if tile is not None or stamps is not None:
            raise ValueError("tile and stamps are the float32 tail's; a bf16 "
                             "tail takes seg")
        plan = tail_bf16_plan(
            b, t, c, seg, torch.cuda.get_device_properties(dev).multi_processor_count)
        cuda_lib.call("triple_post_bf16_fwd", *ptrs, b, t, c, plan["seg"],
                      plan["pack"], plan["blocks"], plan["smem"],
                      cuda_lib.stream(dev))
        return y
    if seg is not None:
        raise ValueError("seg is the bf16 tail's plan; a float32 tail takes tile")
    plan = epilogue_plan(b, t, c, tile)
    cuda_lib.call("triple_post_fwd", *ptrs, b, t, c, plan["tile"], plan["smem"],
                  cuda_lib.ptr(stamps), cuda_lib.stream(dev))
    return y


def tail_stamps(r0, r1, r2, post):
    """One launch of the float32 tail kernel (csrc/triple_epilogue.cu) with
    its phase stamps (a diagnostic): (y, stamps) with stamps (B x tiles, 4)
    int64 SM cycles, per block at its start and after its load + average,
    AA-snake and conv phases."""
    b, t, c = r0.shape
    x, bb = epilogue_plan(b, t, c)["grid"]
    stamps = torch.zeros((bb * x, 4), dtype=torch.int64, device=r0.device)
    return _epilogue(r0, r1, r2, post, stamps=stamps), stamps


def fused_epilogue(r0, r1, r2, post=None, out_dtype=torch.float32):
    """The epilogue alone on given block outputs (B, T, C) float32: the
    average, or with `post` the (B, T, 1) tail, in `out_dtype` (float32, or
    bf16 for the bf16 configuration). CUDA tensors run
    `csrc/triple_epilogue.cu` (the average in either type, the float32
    tail) or `csrc/triple_post_bf16.cu` (the bf16 tail); CPU tensors
    `composed_epilogue`, rounded once to `out_dtype`. Not counted and not
    differentiable: the stage wrapper is the path's entry point; this one
    holds the kernels against their plain version."""
    if r0.device.type == "cpu":
        return composed_epilogue(r0, r1, r2, post).to(out_dtype)
    if r0.device.type != "cuda":
        raise ValueError(f"unsupported device {r0.device}")
    return _epilogue(r0, r1, r2, post, out_dtype=out_dtype)


def _launch(x, block_ws, dils, post, packed=None):
    rs = [run_block(x, bw, d, out_dtype=torch.float32, packed=p)
          for bw, d, p in zip(block_ws, dils, packed or (None,) * len(dils))]
    return _epilogue(*rs, post, out_dtype=x.dtype)


def _unflatten(flat, n_blocks: int, has_post: bool):
    block_ws = [tuple(flat[8 * i: 8 * i + 8]) for i in range(n_blocks)]
    post = tuple(flat[8 * n_blocks:]) if has_post else None
    return block_ws, post


def _composed_flat(x, *flat_and_static):
    *flat, ks, dils, has_post = flat_and_static
    block_ws, post = _unflatten(flat, len(ks), has_post)
    return composed_triple(x, block_ws, ks, dils, post)


class _AMPTriple(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ks, dils, has_post, packed, *flat):
        ctx.save_for_backward(x, *flat)
        ctx.static = (ks, dils, has_post)
        block_ws, post = _unflatten(flat, len(ks), has_post)
        y = _launch(x, block_ws, dils, post, packed)
        cuda_lib.LAUNCHES["amp_triple_bf16" if x.dtype == torch.bfloat16
                          else "amp_triple"] += 1
        return y

    @staticmethod
    def backward(ctx, ct):
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[5:]
        grads = cuda_lib.plain_vjp(_composed_flat, ctx.saved_tensors, needs,
                                   ct, *ctx.static)
        return (grads[0], None, None, None, None) + grads[1:]


def fused_amp_triple(
    x,
    block_ws: Sequence[Tuple[torch.Tensor, ...]],
    ks: Sequence[int],
    dils: Sequence[Sequence[int]],
    post: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    packed=None,
):
    """Whole decoder stage; x: (B, T, C) float32 or bf16 (the bf16
    configuration) -> (B, T, C), or the (B, T, 1) tanh waveform with `post`,
    in x's dtype. `packed`: per block the bf16 configuration's packed conv
    weights (ops/ampblock.run_block), else packed in the call.

    CUDA tensors run the kernels (any T >= 1); CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return composed_triple(x, block_ws, ks, dils, post)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    flat = [w for bw in block_ws for w in bw] + (list(post) if post else [])
    return _AMPTriple.apply(x.contiguous(), tuple(ks),
                            tuple(tuple(d) for d in dils),
                            post is not None, packed, *flat)
