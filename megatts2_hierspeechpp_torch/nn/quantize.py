"""Residual vector quantizer, inference half (encode / decode).

Counterpart of `megatts2_hierspeechpp_tpu/nn/quantize.py`
(ResidualVectorQuantizer with a Euclidean codebook). The codebook and its
EMA statistics are buffers named as the reference checkpoint names them
(`vq.layers.{i}._codebook.{embed,embed_avg,cluster_size,inited}`); the JAX
package keeps them in its "vq" variable collection. Training (EMA updates,
dead-code expiry, k-means init) is not ported.
"""
from __future__ import annotations

import torch
from torch import nn


class EuclideanCodebook(nn.Module):
    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
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


class VectorQuantization(nn.Module):
    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self._codebook = EuclideanCodebook(dim, codebook_size)


class _Layers(nn.Module):
    def __init__(self, dim: int, bins: int, n_q: int):
        super().__init__()
        self.layers = nn.ModuleList(
            VectorQuantization(dim, bins) for _ in range(n_q))


class ResidualVectorQuantizer(nn.Module):
    def __init__(self, dimension: int = 20, n_q: int = 1, bins: int = 1024):
        super().__init__()
        self.vq = _Layers(dimension, bins, n_q)

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
