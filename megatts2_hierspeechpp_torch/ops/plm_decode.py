"""Greedy KV-cached decode of the prosody LM: hand-written CUDA kernel and
its plain version.

Replaces the TPU kernel `megatts2_hierspeechpp_tpu/ops/pallas_plm_decode.py`
(`_kernel` behind `plm_decode_greedy`): the whole B=1 greedy token loop of
`models/plm.py:decode` in one launch (`csrc/plm_decode.cu`). Per token:
x = [tc_t | emb(prev)] + pos_alpha * pe_t, then per layer LayerNorm -> fused
QKV -> causal attention over the cache -> out-proj -> LayerNorm ->
FF(relu) -> residual, then logits and the first argmax, fed back.

On the H100 a token is a chain of small matrix-vector products over 15.9 MB
of float32 weights; launched op by op it is about 70 launches per token.
The kernel is one persistent cooperative launch, one block per SM, with the
token loop inside and a hand-rolled grid barrier between phases (21 per
token); the weights are streamed through L2 by all SMs (see the source for
the phases).

`plain_decode` is the same loop in plain PyTorch (B >= 1, greedy or top-k
sampling); CPU tensors take it, and it is the kernel's yardstick.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from megatts2_hierspeechpp_torch.ops import cuda_lib

# scratch layout of csrc/plm_decode.cu
MAX_GRID = 132
MAX_PARTS = 128
PART_STRIDE = 74
MAX_D, MAX_F, MAX_HD = 512, 2048, 72


@dataclass
class PLMWeights:
    """ProsodyLM weights stacked over layers, in nn.Linear (Out, In) layout:
    the kernel's weight contract (`ProsodyLM.packed()` builds it)."""

    emb: torch.Tensor        # (V, VQ) previous-code embedding
    pos_alpha: torch.Tensor  # (1,)
    wqkv: torch.Tensor       # (L, 3D, D) [w_q; w_k; w_v]
    bqkv: torch.Tensor       # (L, 3D)
    wo: torch.Tensor         # (L, D, D)
    bo: torch.Tensor         # (L, D)
    ln: torch.Tensor         # (L, 4, D) norm1 w, b, norm2 w, b
    ff0: torch.Tensor        # (L, F, D)
    ff0b: torch.Tensor       # (L, F)
    ff1: torch.Tensor        # (L, D, F)
    ff1b: torch.Tensor       # (L, D)
    pred: torch.Tensor       # (BINS, D)
    n_heads: int

    def tensors(self):
        return (self.emb, self.pos_alpha, self.wqkv, self.bqkv, self.wo,
                self.bo, self.ln, self.ff0, self.ff0b, self.ff1, self.ff1b,
                self.pred)


def sine_positions(t_max: int, dim: int, device=None) -> torch.Tensor:
    """(T, D) sinusoidal table (reference SinePositionalEmbedding)."""
    position = torch.arange(t_max, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / dim))
    pe = torch.zeros(t_max, dim, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def _scaled_positions(w: PLMWeights, t: int, d: int, device) -> torch.Tensor:
    return w.pos_alpha * sine_positions(t, d, device)


def plain_decode(w: PLMWeights, tc_latent: torch.Tensor, go_id: int = 1024,
                 top_k: int = 0, temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """KV-cached decode loop: tc_latent (B, T, TC) -> codes (B, T) int32.

    Greedy (first argmax) when top_k == 0; otherwise top-k sampling at
    `temperature`, drawn on tc_latent's device from `generator` (a
    torch.Generator on that device)."""
    b, t, _ = tc_latent.shape
    dev = tc_latent.device
    n_layers, d = w.wo.shape[0], w.wo.shape[1]
    h = w.n_heads
    hd = d // h
    pe = _scaled_positions(w, t, d, dev)
    k_cache = torch.zeros(n_layers, b, h, t, hd, device=dev)
    v_cache = torch.zeros_like(k_cache)
    prev = torch.full((b,), go_id, dtype=torch.long, device=dev)
    codes = torch.empty(b, t, dtype=torch.int32, device=dev)
    for step in range(t):
        x = torch.cat([tc_latent[:, step], w.emb[prev]], dim=-1) + pe[step]
        for i in range(n_layers):
            yn = F.layer_norm(x, (d,), w.ln[i, 0], w.ln[i, 1], 1e-5)
            qkv = F.linear(yn, w.wqkv[i], w.bqkv[i])
            q = qkv[:, :d].reshape(b, h, hd)
            k_cache[i, :, :, step] = qkv[:, d:2 * d].reshape(b, h, hd)
            v_cache[i, :, :, step] = qkv[:, 2 * d:].reshape(b, h, hd)
            kc = k_cache[i, :, :, :step + 1]
            vc = v_cache[i, :, :, :step + 1]
            scores = torch.einsum("bhd,bhkd->bhk", q, kc) / math.sqrt(hd)
            p = torch.softmax(scores, dim=-1)
            att = torch.einsum("bhk,bhkd->bhd", p, vc).reshape(b, d)
            x = x + F.linear(att, w.wo[i], w.bo[i])
            yn = F.layer_norm(x, (d,), w.ln[i, 2], w.ln[i, 3], 1e-5)
            x = x + F.linear(torch.relu(F.linear(yn, w.ff0[i], w.ff0b[i])),
                             w.ff1[i], w.ff1b[i])
        logits = F.linear(x, w.pred)
        if top_k > 0:
            vals, idxs = torch.topk(logits / temperature, top_k, dim=-1)
            probs = torch.softmax(vals, dim=-1)
            choice = torch.multinomial(probs, 1, generator=generator)
            nxt = torch.gather(idxs, 1, choice)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        codes[:, step] = nxt.to(torch.int32)
        prev = nxt
    return codes


def _launch(w: PLMWeights, tc_latent: torch.Tensor, go_id: int) -> torch.Tensor:
    dev = tc_latent.device
    _, t, tc_dim = tc_latent.shape
    n_layers, d = w.wo.shape[0], w.wo.shape[1]
    f, bins = w.ff0.shape[1], w.pred.shape[0]
    h = w.n_heads
    if t < 1:
        raise ValueError("plm_decode needs T >= 1")
    if (d > MAX_D or f > MAX_F or d % 4 or f % 4 or d % h
            or d // h > MAX_HD or tc_dim >= d):
        raise ValueError(f"plm_decode kernel does not take D={d}, F={f}, H={h}")
    cuda_lib.check(tc_latent, "tc_latent", dev)
    shapes = ((w.emb.shape[0], d - tc_dim), (1,), (n_layers, 3 * d, d),
              (n_layers, 3 * d), (n_layers, d, d), (n_layers, d),
              (n_layers, 4, d), (n_layers, f, d), (n_layers, f),
              (n_layers, d, f), (n_layers, d), (bins, d))
    names = ("emb", "pos_alpha", "wqkv", "bqkv", "wo", "bo", "ln", "ff0",
             "ff0b", "ff1", "ff1b", "pred")
    for name, tensor, shape in zip(names, w.tensors(), shapes):
        cuda_lib.check(tensor, name, dev, shape)
        if name in ("wqkv", "wo", "ff0", "ff1", "pred") and tensor.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (read as float4)")
    pe = _scaled_positions(w, t, d, dev).contiguous()
    cache = torch.empty(n_layers, t, 2, d, device=dev)
    scratch = torch.empty(2 * d + f + MAX_PARTS * PART_STRIDE + MAX_GRID,
                          device=dev)
    iscratch = torch.zeros(1 + MAX_GRID, dtype=torch.int32, device=dev)
    codes = torch.empty(t, dtype=torch.int32, device=dev)
    p = cuda_lib.ptr
    cuda_lib.call("plm_decode_fwd", p(tc_latent), p(pe), p(w.emb), p(w.wqkv),
                  p(w.bqkv), p(w.wo), p(w.bo), p(w.ln), p(w.ff0), p(w.ff0b),
                  p(w.ff1), p(w.ff1b), p(w.pred), p(cache), p(scratch),
                  p(iscratch), p(codes), t, n_layers, d, tc_dim, h, f, bins,
                  go_id, cuda_lib.stream(dev))
    cuda_lib.LAUNCHES["plm_decode"] += 1
    return codes[None]


def plm_decode_greedy(w: PLMWeights, tc_latent: torch.Tensor,
                      go_id: int = 1024) -> torch.Tensor:
    """Greedy decode, tc_latent (1, T, TC) float32 -> codes (1, T) int32.

    CUDA tensors run the kernel (B=1, float32, any T >= 1); CPU tensors run
    the plain version."""
    if tc_latent.dim() != 3 or tc_latent.shape[0] != 1:
        raise ValueError(
            f"plm_decode takes tc_latent (1, T, C), got {tuple(tc_latent.shape)}")
    if tc_latent.device.type == "cpu":
        return plain_decode(w, tc_latent, go_id)
    if tc_latent.device.type != "cuda":
        raise ValueError(f"unsupported device {tc_latent.device}")
    return _launch(w, tc_latent.contiguous(), go_id)
