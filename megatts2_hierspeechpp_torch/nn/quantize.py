"""Residual vector quantizer with EMA codebook learning.

Counterpart of `megatts2_hierspeechpp_tpu/nn/quantize.py`
(ResidualVectorQuantizer with a Euclidean codebook; reference EnCodec
`core_vq`). The codebook and its EMA statistics are buffers named as the
reference checkpoint names them
(`vq.layers.{i}._codebook.{embed,embed_avg,cluster_size,inited}`); the JAX
package keeps them in its "vq" variable collection.

Training (`ResidualVectorQuantizer(x, train=True)`) updates the buffers in
place, all in float32: one-hot counts and embedding sums of the batch, EMA
decay 0.99, Laplace smoothing 1e-5, embed = embed_avg / smoothed counts;
the output is straight-through, and the commit loss mean((sg(q) - x)^2).
Under a lower compute dtype the distances, the statistics and the commit
loss's mean stay float32, and the quantized output takes x's dtype (JAX
quantize.py:64-79, :110, :139-143).
The k-means initialisation is ops/kmeans.py. In a data-parallel step
(parallel/mesh.global_batch) the counts and embedding sums are summed over
the ranks before the EMA, so the codebooks stay the same on every rank.

Dead-code expiry draws nothing here. In the JAX package (quantize.py:88-108)
and the reference alike, the expired codewords are replaced in `embed` and
that `embed` is then overwritten by `embed_avg / smoothed` in the same
update, so the replacement (and its rng) changes no state and no output.
"""
from __future__ import annotations

import torch
from torch import nn

from megatts2_hierspeechpp_torch.parallel import mesh

DECAY, EPSILON = 0.99, 1e-5   # EMA decay, Laplace smoothing


class EuclideanCodebook(nn.Module):
    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self.codebook_size = codebook_size
        self.register_buffer("inited", torch.ones(1))
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.register_buffer("embed", torch.zeros(codebook_size, dim))
        self.register_buffer("embed_avg", torch.zeros(codebook_size, dim))

    def encode(self, x):
        """x: (..., D) -> int64 codes (...): the nearest codeword (first on
        ties)."""
        flat = x.reshape(-1, x.shape[-1]).float()
        embed = self.embed.float()
        dists = -(flat.pow(2).sum(1, keepdim=True) - 2 * flat @ embed.t()
                  + embed.pow(2).sum(1)[None, :])
        return dists.argmax(dim=-1).reshape(x.shape[:-1])

    def decode(self, codes):
        return self.embed[codes.long()]

    def forward(self, x, train: bool = False):
        """x (..., D) -> (quantized in x's dtype, codes), both read from the
        codebook as it is; with `train` one EMA step follows (the JAX
        EuclideanCodebook.__call__'s order)."""
        codes = self.encode(x)
        quantized = self.decode(codes).to(x.dtype)
        if train:
            self.ema_update(x, codes)
        return quantized, codes

    @torch.no_grad()
    def ema_update(self, x, codes) -> None:
        """One EMA step of the statistics from the batch x (..., D) and its
        codes (...)."""
        flat = x.reshape(-1, x.shape[-1]).float()
        onehot = nn.functional.one_hot(codes.reshape(-1),
                                       self.codebook_size).float()
        # the global batch's statistics in a data-parallel step, so every
        # rank takes the same EMA step (JAX quantize.py:64-80 under GSPMD)
        counts, embed_sum = mesh.all_sum([onehot.sum(0), onehot.t() @ flat])
        cluster_size = DECAY * self.cluster_size + (1 - DECAY) * counts
        embed_avg = DECAY * self.embed_avg + (1 - DECAY) * embed_sum
        total = cluster_size.sum()
        smoothed = ((cluster_size + EPSILON)
                    / (total + self.codebook_size * EPSILON) * total)
        self.cluster_size.copy_(cluster_size)
        self.embed_avg.copy_(embed_avg)
        self.embed.copy_(embed_avg / smoothed[:, None])


class VectorQuantization(nn.Module):
    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self._codebook = EuclideanCodebook(dim, codebook_size)

    def forward(self, x, train: bool = False):
        """x: (B, T, D) -> (quantized, codes, commit loss). With `train`
        the codebook takes one EMA step (after the codes and the quantized
        output are read from the old codebook), the output is
        straight-through and the commit loss is mean((sg(q) - x)^2)."""
        quantized, codes = self._codebook(x, train=train)
        if not train:
            return quantized, codes, x.new_zeros((), dtype=torch.float32)
        commit = (quantized - x).square().float().mean()
        return x + (quantized - x).detach(), codes, commit


class _Layers(nn.Module):
    def __init__(self, dim: int, bins: int, n_q: int):
        super().__init__()
        self.layers = nn.ModuleList(
            VectorQuantization(dim, bins) for _ in range(n_q))


class ResidualVectorQuantizer(nn.Module):
    def __init__(self, dimension: int = 20, n_q: int = 1, bins: int = 1024):
        super().__init__()
        self.vq = _Layers(dimension, bins, n_q)

    def forward(self, x, train: bool = False):
        """x: (B, T, D) -> (quantized sum (B, T, D), codes (n_q, B, T), the
        mean of the stages' commit losses)."""
        residual, out = x, torch.zeros_like(x)
        all_codes, losses = [], []
        for layer in self.vq.layers:
            quantized, codes, loss = layer(residual, train=train)
            residual = residual - quantized
            out = out + quantized
            all_codes.append(codes)
            losses.append(loss)
        return out, torch.stack(all_codes), torch.stack(losses).mean()

    def encode(self, x):
        """x: (B, T, D) -> codes (n_q, B, T)."""
        residual, out = x, []
        for layer in self.vq.layers:
            codes = layer._codebook.encode(residual)
            residual = residual - layer._codebook.decode(codes)
            out.append(codes)
        return torch.stack(out)

    def decode(self, codes):
        """codes (n_q, B, T) -> (B, T, D)."""
        out = 0.0
        for i in range(codes.shape[0]):
            out = out + self.vq.layers[i]._codebook.decode(codes[i])
        return out
