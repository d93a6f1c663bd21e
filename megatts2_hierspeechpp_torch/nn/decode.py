"""What the port's two KV-cached decoders share (ar/t2s.t2s_decode and
models/plm_gpt.gpt_generate): multi-head attention over split heads, and the
sampler that draws as jax.random.categorical does, argmax(gumbel + logits),
with the Gumbel noise from an injectable source (`GumbelNoise` of a
torch.Generator by default; the tests feed JAX's draws through
`FedNoise`)."""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

NEG_INF = -1e9


def split_heads(x, n_heads: int):
    """(B, T, C) -> (B, H, T, C / H)."""
    b, t, c = x.shape
    return x.reshape(b, t, n_heads, c // n_heads).transpose(1, 2)


def merge_heads(x):
    """(B, H, T, hd) -> (B, T, H * hd)."""
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def attend(q, k, v, bias=None, dropout: Optional[Callable] = None):
    """softmax(q k^T / sqrt(hd) + bias) v on (B, H, T, hd), `dropout` on
    the probabilities."""
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    return (p if dropout is None else dropout(p)) @ v


class GumbelNoise:
    """Gumbel(0, 1) draws of a given shape from `generator` (on its
    device): -log(-log(U)), U uniform on [tiny, 1), jax.random.gumbel's
    form."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, shape) -> torch.Tensor:
        g = self.generator
        u = torch.rand(shape, generator=g, device=g.device)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


class FedNoise:
    """Noise given from outside, one array per draw, in order (the tests
    feed the JAX decode's Gumbel draws)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, shape) -> torch.Tensor:
        n = torch.from_numpy(np.array(self.draws.pop(0), dtype=np.float32))
        if tuple(n.shape) != tuple(shape):
            raise ValueError(f"noise {tuple(n.shape)} for a draw of {tuple(shape)}")
        return n


def default_noise(device) -> GumbelNoise:
    return GumbelNoise(torch.Generator(device=device).manual_seed(0))


def sample_tokens(logits, noise: Callable, top_k: int = 0, top_p: float = 1.0):
    """jax.random.categorical over the top-k logits (top-p over the top-k
    values first when top_p < 1), or over all of them when top_k is 0:
    argmax(noise(shape) + logits)."""
    if top_k > 0:
        vals, idxs = logits.topk(top_k, dim=-1)
        if top_p < 1.0:
            probs = torch.softmax(vals, dim=-1)
            keep = (probs.cumsum(-1) - probs) <= top_p
            vals = torch.where(keep, vals, NEG_INF)
        choice = (noise(vals.shape).to(vals.device) + vals).argmax(-1)
        return idxs.gather(-1, choice[:, None])[:, 0]
    return (noise(logits.shape).to(logits.device) + logits).argmax(-1)
