"""MP-SENet denoiser (MPNet): a magnitude mask and a phase decoder over the
compressed STFT.

Counterpart of `megatts2_hierspeechpp_tpu/models/denoiser.py` (reference
denoiser/{generator.py, conformer.py}): DenseEncoder (dilated dense conv2d
blocks with InstanceNorm + PReLU), TSConformerBlocks (a time conformer,
then a frequency conformer), MaskDecoder (ConvTranspose2d + a learnable
sigmoid, beta 2) and PhaseDecoder (atan2 of two conv heads). Reference
config: dense_channel 64, 4 TS blocks, n_fft 400, hop 100, compress 0.3.

Layout: the 2-D convs run on (B, C, T, F), the conformers on (N, L, C).
Parameter names are the reference checkpoint's.

Quirk kept for checkpoint parity: the reference feeds (N, L, C) tensors to
torch MultiheadAttention with batch_first=False, so attention mixes axis 0:
over batch x freq in the time conformer, over batch x frames in the
frequency conformer. So a serving build runs one waveform at a time
(B = 1). A training build (`train=True`, as the JAX trainer) takes B > 1
and computes exactly that mixing, as JAX does. Its BatchNorm normalises
with the batch's statistics in train() mode and moves the running ones.

`attn_chunk` splits the queries into chunks that each see every key,
which gives the dense result exactly; under autograd each chunk is
checkpointed, so the backward holds one chunk's scores at a time (JAX
`_attn_q_chunked`). `remat` checkpoints each TS block (JAX
`nn.remat(TSConformerBlock)`); the recompute does not move BatchNorm's
running statistics a second time.

In a data-parallel step (parallel/mesh.global_batch, world above 1) a rank
holds its rows of the global batch, and the two couplings across rows run
over the global batch, as under the JAX trainer's GSPMD: each attention
gathers every rank's keys and values along axis 0 (its backward sums their
gradients and keeps the rank's slice), and BatchNorm
(mesh.GlobalBatchNorm1d) normalises with the global batch's statistics.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.nn.init import init_weights
from megatts2_hierspeechpp_torch.parallel import mesh
from megatts2_hierspeechpp_torch.parallel.mesh import GlobalBatchNorm1d


def _norm_act(channels: int):
    """InstanceNorm2d(affine) + PReLU, the blocks' norm and activation."""
    return [nn.InstanceNorm2d(channels, affine=True), nn.PReLU(channels)]


class DenseBlock(nn.Module):
    """4 dilated (3, 3) conv2d stages, each over the concatenated outputs of
    the stages before it and the input; (B, C, T, F) -> (B, C, T, F)."""

    def __init__(self, channels: int, depth: int = 4):
        super().__init__()
        self.dense_block = nn.ModuleList(
            nn.Sequential(
                nn.Conv2d(channels * (i + 1), channels, (3, 3),
                          dilation=(2 ** i, 1), padding=(2 ** i, 1)),
                *_norm_act(channels))
            for i in range(depth))

    def forward(self, x):
        skip = x
        for block in self.dense_block:
            x = block(skip)
            skip = torch.cat([x, skip], dim=1)
        return x


class DenseEncoder(nn.Module):
    def __init__(self, channels: int = 64, in_channels: int = 2):
        super().__init__()
        self.dense_conv_1 = nn.Sequential(
            nn.Conv2d(in_channels, channels, (1, 1)), *_norm_act(channels))
        self.dense_block = DenseBlock(channels)
        self.dense_conv_2 = nn.Sequential(
            nn.Conv2d(channels, channels, (1, 3), (1, 2)), *_norm_act(channels))

    def forward(self, x):
        """(B, 2, T, F) -> (B, C, T, (F - 1) // 2)."""
        return self.dense_conv_2(self.dense_block(self.dense_conv_1(x)))


def _attn_dense(q, k, v):
    """q pre-scaled; q: (Lq, N, H, D), k / v: (L, N, H, D) -> (Lq, N, H, D)."""
    p = torch.softmax(torch.einsum("qnhd,knhd->nhqk", q, k), dim=-1)
    return torch.einsum("nhqk,knhd->qnhd", p, v)


class TorchMHA(nn.Module):
    """torch nn.MultiheadAttention's parameters (packed in_proj, out_proj)
    applied with batch_first=False semantics to (L, N, E): attention runs
    over axis 0. attn_chunk: None, the dense form; else queries in chunks of
    that many rows, each against every key: the same contraction per row,
    with (N, H, chunk, L) scores at a time in place of (N, H, L, L). Under
    autograd each chunk is checkpointed, so its scores are recomputed in
    the backward rather than kept."""

    def __init__(self, dim: int, n_heads: int,
                 attn_chunk: Optional[int] = None):
        super().__init__()
        self.n_heads, self.attn_chunk = n_heads, attn_chunk
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        l, n, e = x.shape
        h = self.n_heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1)
        q = q.reshape(l, n, h, -1) * (e // h) ** -0.5
        k, v = k.reshape(l, n, h, -1), v.reshape(l, n, h, -1)
        if mesh.shard()[1] > 1:
            # a data-parallel step: this rank's queries attend over every
            # rank's rows of axis 0, as one process's over the global batch
            k, v = mesh.gather_rows(torch.cat([k, v], -1)).chunk(2, -1)
        c = self.attn_chunk
        if c is not None and l > c:
            # every chunk c rows (the last zero-padded, as the JAX form), so
            # each runs the dense form's products at one shape
            qp = F.pad(q, (0, 0, 0, 0, 0, 0, 0, (-l) % c))
            ckpt = torch.is_grad_enabled() and q.requires_grad

            def attn(qc):
                if ckpt:
                    return checkpoint(_attn_dense, qc, k, v, use_reentrant=False,
                                      preserve_rng_state=False)
                return _attn_dense(qc, k, v)

            att = torch.cat([attn(qp[i:i + c]) for i in range(0, l, c)])[:l]
        else:
            att = _attn_dense(q, k, v)
        return self.out_proj(att.reshape(l, n, e))


class Transpose(nn.Module):
    """(N, L, C) <-> (N, C, L) inside a Sequential (the reference's
    einops Rearrange slots, which hold no parameters)."""

    def forward(self, x):
        return x.transpose(1, 2)


class FeedForwardModule(nn.Module):
    """LN, Linear to 4 x dim, SiLU, Linear back; the Identity slots are the
    reference's dropouts, which keep its parameter indices."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.ffm = nn.Sequential(
            nn.LayerNorm(dim), nn.Linear(dim, dim * mult), nn.SiLU(),
            nn.Identity(), nn.Linear(dim * mult, dim), nn.Identity())

    def forward(self, x):
        return self.ffm(x)


class ConformerConvModule(nn.Module):
    """LN, pointwise conv to 2 x inner, GLU, depthwise conv k = 31,
    BatchNorm1d (running statistics), SiLU, pointwise conv, on (N, L, C)
    with the convs along axis 1."""

    def __init__(self, dim: int, expansion: int = 2, kernel: int = 31):
        super().__init__()
        inner = dim * expansion
        self.ccm = nn.Sequential(
            nn.LayerNorm(dim), Transpose(), nn.Conv1d(dim, inner * 2, 1),
            nn.GLU(dim=1),
            nn.Conv1d(inner, inner, kernel, padding=(kernel - 1) // 2,
                      groups=inner),
            GlobalBatchNorm1d(inner), nn.SiLU(), nn.Conv1d(inner, dim, 1),
            Transpose())

    def forward(self, x):
        return self.ccm(x)


class AttentionModule(nn.Module):
    def __init__(self, dim: int, n_heads: int, attn_chunk: Optional[int]):
        super().__init__()
        self.layernorm = nn.LayerNorm(dim)
        self.attn = TorchMHA(dim, n_heads, attn_chunk)

    def forward(self, x):
        return self.attn(self.layernorm(x))


class ConformerBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int = 4,
                 attn_chunk: Optional[int] = None):
        super().__init__()
        self.ffm1 = FeedForwardModule(dim)
        self.attn = AttentionModule(dim, n_heads, attn_chunk)
        self.ccm = ConformerConvModule(dim)
        self.ffm2 = FeedForwardModule(dim)
        self.post_norm = nn.LayerNorm(dim)

    def forward(self, x):
        x = x + 0.5 * self.ffm1(x)
        x = x + self.attn(x)
        x = x + self.ccm(x)
        x = x + 0.5 * self.ffm2(x)
        return self.post_norm(x)


@contextmanager
def restored_batch_stats(module: nn.Module):
    """The BatchNorm buffers of `module` (running statistics and
    num_batches_tracked) as they were on entry, once the block is left."""
    bufs = [b for m in module.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in m.buffers()]
    saved = [b.clone() for b in bufs]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in zip(bufs, saved):
                b.copy_(v)


def remat(block: nn.Module, x):
    """block(x) with its activations recomputed in the backward
    (torch.utils.checkpoint). The first run moves the BatchNorm running
    statistics; the recompute runs the same ops (so it saves the same
    tensors) and its update is undone, so one step moves them once, as JAX
    nn.remat applies the batch_stats mutation once."""
    runs = []

    def run(y):
        runs.append(None)
        if len(runs) == 1:
            return block(y)
        with restored_batch_stats(block):
            return block(y)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class TSConformerBlock(nn.Module):
    """The time conformer over (B F, T, C), then the frequency conformer
    over (B T, F, C), each with a residual."""

    def __init__(self, dim: int, attn_chunk: Optional[int] = None):
        super().__init__()
        self.time_conformer = ConformerBlock(dim, attn_chunk=attn_chunk)
        self.freq_conformer = ConformerBlock(dim, attn_chunk=attn_chunk)

    def forward(self, x):
        b, c, t, f = x.shape
        y = x.permute(0, 3, 2, 1).reshape(b * f, t, c)
        y = self.time_conformer(y) + y
        y = y.reshape(b, f, t, c).transpose(1, 2).reshape(b * t, f, c)
        y = self.freq_conformer(y) + y
        return y.reshape(b, t, f, c).permute(0, 3, 1, 2)


class LearnableSigmoid2d(nn.Module):
    def __init__(self, features: int, beta: float = 2.0):
        super().__init__()
        self.beta = beta
        self.slope = nn.Parameter(torch.ones(features, 1))

    def forward(self, x):
        """x: (B, T, F) -> beta * sigmoid(slope_f * x)."""
        return self.beta * torch.sigmoid(self.slope[:, 0] * x)


class MaskDecoder(nn.Module):
    def __init__(self, channels: int = 64, n_freqs: int = 201,
                 beta: float = 2.0):
        super().__init__()
        self.dense_block = DenseBlock(channels)
        self.mask_conv = nn.Sequential(
            nn.ConvTranspose2d(channels, channels, (1, 3), (1, 2)),
            nn.Conv2d(channels, 1, (1, 1)), *_norm_act(1),
            nn.Conv2d(1, 1, (1, 1)))
        self.lsigmoid = LearnableSigmoid2d(n_freqs, beta)

    def forward(self, x):
        """(B, C, T, F') -> mask (B, T, 2 F' + 1)."""
        return self.lsigmoid(self.mask_conv(self.dense_block(x))[:, 0])


class PhaseDecoder(nn.Module):
    def __init__(self, channels: int = 64):
        super().__init__()
        self.dense_block = DenseBlock(channels)
        self.phase_conv = nn.Sequential(
            nn.ConvTranspose2d(channels, channels, (1, 3), (1, 2)),
            *_norm_act(channels))
        self.phase_conv_r = nn.Conv2d(channels, 1, (1, 1))
        self.phase_conv_i = nn.Conv2d(channels, 1, (1, 1))

    def forward(self, x):
        """(B, C, T, F') -> phase (B, T, 2 F' + 1) in [-pi, pi]."""
        y = self.phase_conv(self.dense_block(x))
        return torch.atan2(self.phase_conv_i(y)[:, 0], self.phase_conv_r(y)[:, 0])


class MPNet(nn.Module):
    """Reference widths by default. Built on the CPU with seeded weights
    (nn/init.py), then moved to `device` ("cuda" by default; raises if CUDA
    is absent). attn_chunk as TorchMHA's, in every conformer.

    A serving build (the default) is frozen, in eval() mode, and takes
    B = 1. `train=True` leaves every parameter trainable and the module in
    train() mode, and takes any B (the rows of a batch attend to each
    other, as in the JAX trainer); `remat` then checkpoints each TS block
    under autograd. Both builds hold the same weights for a seed."""

    def __init__(self, dense_channel: int = 64, num_tsblocks: int = 4,
                 n_freqs: int = 201, beta: float = 2.0,
                 attn_chunk: Optional[int] = None, seed: int = 0,
                 device: str | torch.device = "cuda", train: bool = False,
                 remat: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.batched, self.remat = train, remat
        self.dense_encoder = DenseEncoder(dense_channel)
        self.TSConformer = nn.ModuleList(
            TSConformerBlock(dense_channel, attn_chunk)
            for _ in range(num_tsblocks))
        self.mask_decoder = MaskDecoder(dense_channel, n_freqs, beta)
        self.phase_decoder = PhaseDecoder(dense_channel)
        init_weights(self, seed)
        if not train:
            self.eval().requires_grad_(False)
        self.to(dev)

    def set_attn_chunk(self, chunk: Optional[int]) -> None:
        """Query chunk of every conformer's attention (None: dense)."""
        for m in self.modules():
            if isinstance(m, TorchMHA):
                m.attn_chunk = chunk

    def forward(self, noisy_mag, noisy_pha):
        """noisy_mag / noisy_pha: (B, T, F) -> (denoised mag, denoised pha),
        each (B, T, F). A serving build takes B = 1: the attention mixes
        axis 0, which holds the batch with the frequencies or frames."""
        if noisy_mag.shape[0] != 1 and not self.batched:
            raise ValueError(
                f"MPNet runs at B = 1 (got B = {noisy_mag.shape[0]}): its "
                "attention mixes the rows of a batch")
        x = torch.stack([noisy_mag, noisy_pha], dim=1)  # (B, 2, T, F)
        x = self.dense_encoder(x)
        ckpt = self.remat and torch.is_grad_enabled()
        for block in self.TSConformer:
            x = remat(block, x) if ckpt else block(x)
        return noisy_mag * self.mask_decoder(x), self.phase_decoder(x)
