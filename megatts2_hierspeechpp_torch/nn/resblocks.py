"""HiFiGAN leaky-ReLU blocks and BigVGAN AMP residual blocks.

Counterpart of `megatts2_hierspeechpp_tpu/nn/resblocks.py` (ResBlock1,
AMPBlock and the stage dispatch). The port keeps the JAX package's TPU dispatch: a block
with C <= 128 runs as one `fused_ampblock` call, a wider one layer by layer
with each activation a `fused_aa_snakebeta` call, and a stage with C <= 64
runs as one `fused_amp_triple` call (`fused_triple_enabled`). Each wrapper
takes its plain version for CPU tensors, so the dispatch is the same on
both devices. `dtype` is the convs' compute dtype; the fused wrappers take
their activation's dtype (bf16: the kernels' bf16 configuration) with the
weights of `fused_weights`, which stay float32, and on the card the bf16
configuration's packed conv weights (`AMPBlock.packed_bf16`, packed once
per parameter version). A stage of blocks run one by one (`blocks_mean`)
prepares their weights together, in the span weights.prep.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from megatts2_hierspeechpp_torch.nn.activations import AASnakeBeta
from megatts2_hierspeechpp_torch.nn.basic import leaky_relu
from megatts2_hierspeechpp_torch.nn.conv import WNConv1d, get_padding
from megatts2_hierspeechpp_torch.ops.ampblock import fused_ampblock, pack_bf16
from megatts2_hierspeechpp_torch.utils.profiling import annotate


def fused_triple_enabled(channels: int) -> bool:
    """Whole-stage fusion gate: the narrow stages (C <= 64)."""
    return channels <= 64


def stage_packs(blocks, x):
    """The blocks' packed bf16 conv weights for a fused stage on x: where x
    runs the kernels' bf16 configuration on the card, else None."""
    if x.dtype != torch.bfloat16 or x.device.type != "cuda":
        return None
    return [b.packed_bf16() for b in blocks]


def blocks_mean(blocks, x):
    """The mean of the AMPBlocks' outputs on x (a stage that
    fused_amp_triple does not take); at C <= 128 each block's
    fused_ampblock weights are prepared first, together, in the span
    weights.prep."""
    if x.shape[-1] <= 128:
        with annotate("weights.prep"):
            prep = [b.fused_inputs(x) for b in blocks]
    else:
        prep = [None] * len(blocks)
    xs = None
    for blk, fused in zip(blocks, prep):
        r = blk(x, fused)
        xs = r if xs is None else xs + r
    return xs / len(blocks)


class ResBlock1(nn.Module):
    """HiFiGAN ResBlock1: per dilation, leaky-ReLU -> dilated WN conv ->
    leaky-ReLU -> WN conv, plus the residual."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), dtype=None):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size,
                     padding=get_padding(kernel_size, d), dilation=d,
                     dtype=dtype)
            for d in dilation)
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size,
                     padding=get_padding(kernel_size, 1), dtype=dtype)
            for _ in dilation)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(leaky_relu(c1(leaky_relu(x)))) + x
        return x


class AMPBlock(nn.Module):
    """Anti-aliased Multi-Periodicity block (BigVGAN AMPBlock1 topology)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), dtype=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size,
                     padding=get_padding(kernel_size, d), dilation=d,
                     dtype=dtype)
            for d in self.dilation)
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size,
                     padding=get_padding(kernel_size, 1), dtype=dtype)
            for _ in self.dilation)
        self.activations = nn.ModuleList(
            AASnakeBeta(channels) for _ in range(2 * len(self.dilation)))
        self._packed = None  # (key, (packed w1, packed w2))

    def fused_weights(self):
        """(a1, ib1, w1, b1, a2, ib2, w2, b2) stacked over branches: the
        ops/ampblock weight contract, w* as (n, k, Cout, Cin)."""
        out = [[] for _ in range(8)]
        for i in range(len(self.dilation)):
            for j, (act, conv) in enumerate(
                    ((self.activations[2 * i], self.convs1[i]),
                     (self.activations[2 * i + 1], self.convs2[i]))):
                a, ib = act.fused_params()
                out[4 * j].append(a)
                out[4 * j + 1].append(ib)
                out[4 * j + 2].append(conv.weight().permute(2, 0, 1))
                out[4 * j + 3].append(conv.bias)
        return tuple(torch.stack(v) for v in out)

    def _pack_key(self) -> tuple:
        # the convs' own parameters: replaced (data_ptr) or written in place
        # (_version: an optimizer step, load_state_dict); inference tensors
        # carry no version counter, and no optimizer steps them
        return tuple((p.data_ptr(), 0 if p.is_inference() else p._version)
                     for conv in (*self.convs1, *self.convs2)
                     for p in (conv.weight_g, conv.weight_v))

    def packed_bf16(self):
        """(pack_bf16(w1), pack_bf16(w2)) of the weights `fused_weights`
        stacks: the bf16 configuration's conv operands, built on first use
        and again whenever a conv parameter was replaced or written in place
        since."""
        key = self._pack_key()
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                w1 = torch.stack([c.weight().permute(2, 0, 1) for c in self.convs1])
                w2 = torch.stack([c.weight().permute(2, 0, 1) for c in self.convs2])
                self._packed = (key, (pack_bf16(w1), pack_bf16(w2)))
        return self._packed[1]

    def fused_inputs(self, x):
        """(fused_weights(), packed bf16 weights or None): a fused_ampblock
        call's weights on x (C <= 128)."""
        packed = (self.packed_bf16() if x.dtype == torch.bfloat16
                  and x.device.type == "cuda" else None)
        return self.fused_weights(), packed

    def forward(self, x, fused=None):
        """`fused`: fused_inputs(x), where the caller prepared it."""
        if x.shape[-1] <= 128:
            weights, packed = fused if fused is not None else self.fused_inputs(x)
            return fused_ampblock(x, *weights, kernel_size=self.kernel_size,
                                  dilations=self.dilation, packed=packed)
        for i in range(len(self.dilation)):
            xt = self.activations[2 * i](x)
            xt = self.convs1[i](xt)
            xt = self.activations[2 * i + 1](xt)
            xt = self.convs2[i](xt)
            x = xt + x
        return x
