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
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from megatts2_hierspeechpp_torch.nn.conv import conv1d_op
from megatts2_hierspeechpp_torch.ops import cuda_lib
from megatts2_hierspeechpp_torch.ops.ampblock import composed_ampblock, run_block
from megatts2_hierspeechpp_torch.ops.resample import activation1d


def composed_triple(x, block_ws, ks, dils, post=None):
    """Plain version (the JAX `composed_triple`).

    x: (B, T, C); block_ws: per block the ops/ampblock weight tuple; post:
    optional (alpha, 1/beta, w_post (7, C)) -> (B, T, 1) tanh waveform, else
    the (B, T, C) averaged blocks."""
    xs = None
    for bw, k, d in zip(block_ws, ks, dils):
        r = composed_ampblock(x, *bw, k, d)
        xs = r if xs is None else xs + r
    y = xs / float(len(ks))
    if post is None:
        return y
    pa, pib, pw = post
    y = activation1d(y, lambda v: v + torch.sin(v * pa).square() * pib)
    y = conv1d_op(y, pw.t().unsqueeze(0), None, 1, 3, 1)
    return torch.tanh(y)


def _launch(x, block_ws, dils, post):
    b, t, c = x.shape
    dev = x.device
    rs = [run_block(x, bw, d) for bw, d in zip(block_ws, dils)]
    if post is None:
        y = torch.empty_like(x)
        cuda_lib.call("triple_avg_fwd", *map(cuda_lib.ptr, rs), cuda_lib.ptr(y),
                      b * t * c, cuda_lib.stream(dev))
    else:
        pa, pib, pw = post
        cuda_lib.check(pa, "post alpha", dev, (c,))
        cuda_lib.check(pib, "post inv_beta", dev, (c,))
        cuda_lib.check(pw, "post weight", dev, (7, c))
        y = torch.empty((b, t, 1), device=dev, dtype=x.dtype)
        cuda_lib.call("triple_post_fwd", *map(cuda_lib.ptr, rs),
                      cuda_lib.ptr(pa), cuda_lib.ptr(pib), cuda_lib.ptr(pw),
                      cuda_lib.ptr(y), b, t, c, cuda_lib.stream(dev))
    return y


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
    def forward(ctx, x, ks, dils, has_post, *flat):
        ctx.save_for_backward(x, *flat)
        ctx.static = (ks, dils, has_post)
        block_ws, post = _unflatten(flat, len(ks), has_post)
        y = _launch(x, block_ws, dils, post)
        cuda_lib.LAUNCHES["amp_triple"] += 1
        return y

    @staticmethod
    def backward(ctx, ct):
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[4:]
        grads = cuda_lib.plain_vjp(_composed_flat, ctx.saved_tensors, needs,
                                   ct, *ctx.static)
        return (grads[0], None, None, None) + grads[1:]


def fused_amp_triple(
    x,
    block_ws: Sequence[Tuple[torch.Tensor, ...]],
    ks: Sequence[int],
    dils: Sequence[Sequence[int]],
    post: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
):
    """Whole decoder stage; x: (B, T, C) float32 -> (B, T, C), or the
    (B, T, 1) tanh waveform with `post`.

    CUDA tensors run the kernels (any T >= 1); CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return composed_triple(x, block_ws, ks, dils, post)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    flat = [w for bw in block_ws for w in bw] + (list(post) if post else [])
    return _AMPTriple.apply(x.contiguous(), tuple(ks),
                            tuple(tuple(d) for d in dils),
                            post is not None, *flat)
