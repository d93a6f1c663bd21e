"""Prosody language model (Megatts2PLM1) and its KV-cached decode.

Counterpart of `megatts2_hierspeechpp_tpu/models/plm.py`: a pre-norm causal
transformer over concat(frame-level text latent 256, previous-prosody-code
embedding 20) with sinusoidal positions scaled by a learnt alpha; go token
1024. Parameter names are the reference checkpoint's (`pc_embedding`,
`pos_emb.alpha`, `plm.layers.{i}.{norm1,norm2,attn.w_q,...,attn.out_proj.0,
ff.0,ff.3}`, `predict_layer`); the reference's dropouts are Identity
placeholders that keep those indices.

`decode` dispatches as the JAX `decode` does: a greedy float32 latent goes
to the kernel wrapper (`ops/plm_decode.py`), which launches the hand-written
kernel on a CUDA tensor and takes its plain version on a CPU one; a batch
of B rows is B such calls, one per row (greedy causal decode is independent
per row, as the JAX B > 1 scan computes it); top-k sampling takes the plain
KV-cached loop over the whole batch. Weights and KV cache are float32 unless
the caller asks for bf16 (ops/plm_decode.py says why that is the default).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.nn.init import init_weights
from megatts2_hierspeechpp_torch.ops.plm_decode import (
    PLMWeights,
    plain_decode,
    plm_decode_greedy,
    sine_positions,
)

NEG_INF = -1e9


class PLMAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.w_q = nn.Linear(dim, dim)
        self.w_k = nn.Linear(dim, dim)
        self.w_v = nn.Linear(dim, dim)
        self.out_proj = nn.Sequential(nn.Linear(dim, dim), nn.Identity())

    def forward(self, x, bias):
        b, t, d = x.shape
        h = self.n_heads
        hd = d // h
        q, k, v = (m(x).view(b, t, h, hd).transpose(1, 2)
                   for m in (self.w_q, self.w_k, self.w_v))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd) + bias
        att = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.out_proj(att.transpose(1, 2).reshape(b, t, d))


class PLMLayer(nn.Module):
    """Pre-norm transformer layer (reference transformer_mega.py)."""

    def __init__(self, dim: int, ff_dim: int, n_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = PLMAttention(dim, n_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.ff = nn.Sequential(nn.Linear(dim, ff_dim), nn.ReLU(),
                                nn.Identity(), nn.Linear(ff_dim, dim))

    def forward(self, x, bias):
        x = x + self.attn(self.norm1(x), bias)
        return x + self.ff(self.norm2(x))


class _PosEmb(nn.Module):
    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1))


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class ProsodyLM(nn.Module):
    """Megatts2PLM1: teacher-forced forward and the pieces `decode` needs.

    Built on the CPU with seeded weights (nn/init.py), then moved to
    `device` ("cuda" by default; raises if CUDA is absent). The decode's
    stacked weights are built once and kept until the parameters are loaded
    or moved again."""

    def __init__(self, n_layers: int = 4, n_heads: int = 4, vq_dim: int = 20,
                 tc_latent_dim: int = 256, vq_bins: int = 1024, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.n_heads, self.vq_bins = n_heads, vq_bins
        d = vq_dim + tc_latent_dim
        self.pc_embedding = nn.Embedding(vq_bins + 2, vq_dim)
        self.pos_emb = _PosEmb()
        self.plm = _Layers(PLMLayer(d, 4 * d, n_heads) for _ in range(n_layers))
        self.predict_layer = nn.Linear(d, vq_bins, bias=False)
        self._packed: Optional[PLMWeights] = None
        init_weights(self, seed)
        self.eval().requires_grad_(False).to(dev)

    def _apply(self, fn, *args, **kwargs):
        self._packed = None
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._packed = None
        return super().load_state_dict(*args, **kwargs)

    @property
    def go_id(self) -> int:
        return self.vq_bins

    def forward(self, tc_latent, p_codes, lens=None):
        """Teacher-forced logits: tc_latent (B, T, 256); p_codes (B, T) int
        targets (inputs are [go, p_codes[:, :-1]]); lens (B,) or None ->
        (B, T, bins)."""
        b, t, _ = tc_latent.shape
        go = torch.full((b, 1), self.go_id, dtype=torch.long,
                        device=p_codes.device)
        inputs = torch.cat([go, p_codes[:, :-1].long()], dim=1)
        x = torch.cat([tc_latent, self.pc_embedding(inputs)], dim=-1)
        x = x + self.pos_emb.alpha * sine_positions(t, x.shape[-1], x.device)
        pos = torch.arange(t, device=x.device)
        allowed = (pos[None, :] <= pos[:, None])[None]
        if lens is not None:
            allowed = allowed & (pos[None, :] < lens.to(x.device)[:, None])[:, None]
        bias = torch.where(allowed, 0.0, NEG_INF)[:, None]
        for layer in self.plm.layers:
            x = layer(x, bias)
        return self.predict_layer(x)

    def packed(self) -> PLMWeights:
        """The weights stacked over layers, as ops/plm_decode takes them
        (built on first use, then cached)."""
        if self._packed is None:
            with torch.no_grad():
                self._packed = self._pack()
        return self._packed

    def _pack(self) -> PLMWeights:
        layers = self.plm.layers

        def stack(fn):
            return torch.stack([fn(lyr) for lyr in layers]).contiguous()

        return PLMWeights(
            emb=self.pc_embedding.weight,
            pos_alpha=self.pos_emb.alpha,
            wqkv=stack(lambda l: torch.cat(
                [l.attn.w_q.weight, l.attn.w_k.weight, l.attn.w_v.weight])),
            bqkv=stack(lambda l: torch.cat(
                [l.attn.w_q.bias, l.attn.w_k.bias, l.attn.w_v.bias])),
            wo=stack(lambda l: l.attn.out_proj[0].weight),
            bo=stack(lambda l: l.attn.out_proj[0].bias),
            ln=stack(lambda l: torch.stack([l.norm1.weight, l.norm1.bias,
                                            l.norm2.weight, l.norm2.bias])),
            ff0=stack(lambda l: l.ff[0].weight),
            ff0b=stack(lambda l: l.ff[0].bias),
            ff1=stack(lambda l: l.ff[3].weight),
            ff1b=stack(lambda l: l.ff[3].bias),
            pred=self.predict_layer.weight,
            n_heads=self.n_heads,
        )


@torch.inference_mode()
def teacher_forced_gap(model: ProsodyLM, tc_latent: torch.Tensor,
                       codes: torch.Tensor) -> tuple[float, float]:
    """Greedy-decode check that tolerates near-tie flips, on the
    teacher-forced forward over [go, codes[:-1]]: (the largest row max -
    logit of the chosen code, max|logits|). The gap is 0 for an exact greedy
    decode; a decode that flips a near tie keeps it within its float error
    of the scale."""
    logits = model(tc_latent, codes.long())
    chosen = logits.gather(-1, codes.long()[..., None])[..., 0]
    return (float((logits.amax(-1) - chosen).max()),
            float(logits.abs().max()))


@torch.inference_mode()
def decode(model: ProsodyLM, tc_latent: torch.Tensor, top_k: int = 0,
           temperature: float = 1.0,
           generator: Optional[torch.Generator] = None,
           weight_dtype: torch.dtype = torch.float32,
           cache_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """tc_latent (B, T, 256) -> codes (B, T) int32: greedy when top_k == 0
    (one kernel call per row), else top-k sampling from `generator` (a
    torch.Generator on tc_latent's device)."""
    w = model.packed()
    if top_k == 0 and tc_latent.dtype == torch.float32:
        return torch.cat([
            plm_decode_greedy(w, tc_latent[i:i + 1], model.go_id,
                              weight_dtype, cache_dtype)
            for i in range(tc_latent.shape[0])])
    return plain_decode(w, tc_latent, model.go_id, top_k, temperature,
                        generator, weight_dtype, cache_dtype)
