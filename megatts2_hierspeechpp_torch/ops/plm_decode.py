"""Greedy KV-cached decode of the prosody LM: hand-written CUDA kernel and
its plain version.

Replaces the TPU kernel `megatts2_hierspeechpp_tpu/ops/pallas_plm_decode.py`
(`_kernel` behind `plm_decode_greedy`): the whole B=1 greedy token loop of
`models/plm.py:decode` in one launch (`csrc/plm_decode.cu`). Per token:
x = [tc_t | emb(prev)] + pos_alpha * pe_t, then per layer LayerNorm -> fused
QKV -> causal attention over the cache -> out-proj -> LayerNorm ->
FF(relu) -> residual, then logits and the first argmax, fed back.

On the H100 a token is a chain of 21 small dependent matrix-vector phases
over 15.8 MB of float32 matrices: its limit is latency. The kernel is one
persistent cooperative launch, one block per SM. Each block holds its share
of the weights (output rows j = block mod grid) in shared memory for the
whole launch, and the phases hand their outputs on as {value, epoch} pairs
that the readers poll, with no grid barrier (see the source). `smem_plan`
is the per-block shared memory that plan takes; a grid whose share does
not fit raises ValueError, with no fallback.

`plain_decode` is the same loop in plain PyTorch (B >= 1, greedy or top-k
sampling); CPU tensors take it, and it is the kernel's yardstick.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from megatts2_hierspeechpp_torch.ops import cuda_lib

# csrc/plm_decode.cu: its grid, its attention split, and the shared memory
# a block may take on Hopper (227 KB); STATIC_SMEM covers the kernel's static
# shared arrays (mbarrier, reduction slots)
MAX_GRID = 132
MAX_PARTS = 128
KEY_CHUNK = 32
SMEM_LIMIT = 232_448
STATIC_SMEM = 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


def owned(rows: int, block: int, grid: int) -> int:
    """Rows of a matrix of `rows` output rows that `block` owns: the rows
    j = block (mod grid), row j in slot j // grid."""
    return (rows - 1 - block) // grid + 1 if rows > block else 0


@functools.lru_cache(maxsize=16)
def plan(d: int, f: int, n_layers: int, bins: int, grid: int,
         n_heads: int) -> dict:
    """The kernel's layout (`make_plan` in csrc/plm_decode.cu, which checks
    "bytes" and "pairs" against its own): row slots per block of each matrix,
    the block's dynamic shared memory in bytes, and the exchange buffer's
    length in 64-bit pairs."""
    slots = {"wqkv": _cdiv(3 * d, grid), "wo": _cdiv(d, grid),
             "ff0": _cdiv(f, grid), "ff1": _cdiv(d, grid),
             "pred": _cdiv(bins, grid)}
    w_layer = (slots["wqkv"] + slots["wo"] + slots["ff0"]) * d + slots["ff1"] * f
    n_bias = slots["wqkv"] + slots["wo"] + slots["ff0"] + slots["ff1"]
    floats = (n_layers * w_layer + slots["pred"] * d + n_layers * 4 * d
              + _up4(n_layers * n_bias) + 3 * _up4(d))
    hd = d // n_heads
    nsplit_max = max(1, min(MAX_PARTS // n_heads, grid // n_heads))
    work = max(f, 2 * KEY_CHUNK * hd + 2 * KEY_CHUNK + _up4(hd),
               n_heads * nsplit_max * (hd + 3) + n_heads)
    layer_pairs = 3 * d + n_heads * nsplit_max * (hd + 2) + 2 * d + f
    return {"slots": slots, "bytes": 4 * (floats + _up4(work)),
            "pairs": 2 * (n_layers * layer_pairs + 2 * grid)}


def smem_plan(d: int, f: int, n_layers: int, bins: int, grid: int,
              n_heads: int = 4) -> int:
    """Shared memory bytes per block that the kernel takes at this grid."""
    return plan(d, f, n_layers, bins, grid, n_heads)["bytes"] + STATIC_SMEM


def check_plan(d: int, f: int, n_layers: int, bins: int, grid: int,
               n_heads: int) -> dict:
    """plan(...), or ValueError when a block's share of the weights does
    not fit its shared memory at this grid."""
    layout = plan(d, f, n_layers, bins, grid, n_heads)
    need = layout["bytes"] + STATIC_SMEM
    if need > SMEM_LIMIT:
        raise ValueError(
            f"plm_decode: a block needs {need} B of shared memory at grid "
            f"{grid} (D={d}, F={f}, L={n_layers}, bins={bins}), over "
            f"{SMEM_LIMIT}")
    return layout


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


def _launch(w: PLMWeights, tc_latent: torch.Tensor, go_id: int,
            stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    dev = tc_latent.device
    _, t, tc_dim = tc_latent.shape
    n_layers, d = w.wo.shape[0], w.wo.shape[1]
    f, bins = w.ff0.shape[1], w.pred.shape[0]
    h = w.n_heads
    if t < 1:
        raise ValueError("plm_decode needs T >= 1")
    if d % 4 or f % 4 or d % h or d > 512 or tc_dim >= d or h > MAX_PARTS:
        raise ValueError(f"plm_decode kernel does not take D={d}, F={f}, H={h}")
    grid = min(torch.cuda.get_device_properties(dev).multi_processor_count,
               MAX_GRID)
    if grid < h:
        raise ValueError(f"plm_decode needs a grid of >= {h} blocks, got {grid}")
    layout = check_plan(d, f, n_layers, bins, grid, h)
    cuda_lib.check(tc_latent, "tc_latent", dev)
    shapes = ((w.emb.shape[0], d - tc_dim), (1,), (n_layers, 3 * d, d),
              (n_layers, 3 * d), (n_layers, d, d), (n_layers, d),
              (n_layers, 4, d), (n_layers, f, d), (n_layers, f),
              (n_layers, d, f), (n_layers, d), (bins, d))
    names = ("emb", "pos_alpha", "wqkv", "bqkv", "wo", "bo", "ln", "ff0",
             "ff0b", "ff1", "ff1b", "pred")
    for name, tensor, shape in zip(names, w.tensors(), shapes):
        cuda_lib.check(tensor, name, dev, shape)
        if (name in ("wqkv", "wo", "ff0", "ff1", "pred", "ln")
                and tensor.data_ptr() % 16):
            raise ValueError(f"{name} must be 16-byte aligned (bulk copies)")
    pe = _scaled_positions(w, t, d, dev).contiguous()
    cache = torch.empty(n_layers, t, 2, d, device=dev)
    # epochs start at 1: a zeroed buffer holds no stale pair
    xch = torch.zeros(layout["pairs"], dtype=torch.int64, device=dev)
    codes = torch.empty(t, dtype=torch.int32, device=dev)
    p = cuda_lib.ptr
    cuda_lib.call("plm_decode_fwd", p(tc_latent), p(pe), p(w.emb), p(w.wqkv),
                  p(w.bqkv), p(w.wo), p(w.bo), p(w.ln), p(w.ff0), p(w.ff0b),
                  p(w.ff1), p(w.ff1b), p(w.pred), p(cache), p(xch), p(codes),
                  p(stamps), t, n_layers, d, tc_dim, h, f, bins, go_id, grid,
                  layout["bytes"], layout["pairs"], cuda_lib.stream(dev))
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


def phase_stamps(w: PLMWeights, tc_latent: torch.Tensor,
                 go_id: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch that also records block 0's clocks twice per
    phase: (codes (1, T), stamps (T, 5L + 1, 3) int64). Phase k of layer i
    is row 5i + k (A-E), the logits the last row. Column 0: SM cycles when
    block 0 has published the phase's outputs; column 1: SM cycles when it
    holds the outputs of the phase that it reads next; column 2, in the
    logits row only: %globaltimer (ns), for converting cycles to time over
    the launch. Counts as a launch."""
    t, n_layers = tc_latent.shape[1], w.wo.shape[0]
    stamps = torch.zeros(t, 5 * n_layers + 1, 3, dtype=torch.int64,
                         device=tc_latent.device)
    codes = _launch(w, tc_latent.contiguous(), go_id, stamps)
    return codes, stamps


def barrier_probe(n: int, device: torch.device) -> None:
    """n grid barriers of the kernel's earlier single-counter design and no
    work, on the decode kernel's grid (one cooperative launch; not counted
    as a decode)."""
    bar = torch.zeros(1, dtype=torch.int32, device=device)
    cuda_lib.call("plm_barrier_probe", cuda_lib.ptr(bar), n,
                  cuda_lib.stream(device))
