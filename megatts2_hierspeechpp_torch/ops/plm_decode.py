"""Greedy KV-cached decode of the prosody LM: hand-written CUDA kernel and
its plain version, with float32 or bf16 weights and KV cache.

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

`weight_dtype` / `cache_dtype` (float32 or bfloat16, chosen apart) are the
TPU kernel's configuration (`pallas_plm_decode.plm_decode_greedy`): bf16
matrices (wqkv, wo, ff0, ff1, pred) with every product's vector rounded to
bf16 first (the LayerNorm outputs, att, h, and x before the logits), and a
bf16 KV cache for the earlier tokens (this token's k and v stay float32);
biases, LayerNorm, embeddings, positions and all sums in float32. The
plain version rounds at the same points. `plm_decode_greedy` takes the
TPU kernel's defaults, bf16 weights and bf16 cache, its serving
configuration; `plain_decode` and `plain_gap` keep float32, the
counterpart of the JAX package's float32 scan (the CPU, sampling and the
tensor-parallel decode run it).
bf16 weights with a bf16 cache (the JAX default) launch a kernel of their
own, `csrc/plm_decode_bf16.cu`: one thread-block cluster per layer, the
layer's matrices resident in the cluster's shared memory, the handoffs
inside a layer through distributed shared memory and mbarriers, between
layers through L2 (see the source). `cluster_plan` is its per-CTA layout
at a cluster size, `cluster_choice` the size the card can run; a shape
that fits no size raises ValueError, with no fallback to `plm_decode.cu`.
That kernel also decodes up to MAX_ROWS rows of one length in one launch,
row j in column j of every product's B fragment (its multi-row layout:
`cluster_plan(..., columns=MAX_ROWS)` at the one-row launch's cluster
size, `rows_choice`), each row's codes bit for bit its one-row launch's;
`models/plm.decode` sends a bf16 batch in groups of MAX_ROWS.
The mixed configurations stay on `plm_decode.cu`, where bf16 halves a
block's share of the matrices (`plan`). `plain_gap` checks greedy codes
against the plain loop in either dtype;
in bf16 two orders of the same sums round a value near a bf16 boundary
apart, so bf16 codes are held to one bf16 step of the logits' scale
(chip_smoke.py), float32 codes to float error.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field
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
# csrc/plm_decode_bf16.cu: the cluster sizes it takes (largest first, as
# cluster_choice tries them), a warp's head dims (3 per lane), its key
# chunks, its warps, and its stamps' columns per (token, layer) (see
# phase_stamps)
CLUSTER_SIZES = tuple(range(16, 9, -1))
MAX_HEAD_DIM = 96
MAX_KEY_CHUNK = 128
KEY_CHUNK_STEP = 16
WARPS = 16
THREADS = 32 * WARPS
# its multi-row kernel: the columns (rows a launch at most), the keys of a
# warp's four-key softmax steps (the key chunk), and the key stages' ring
MAX_ROWS = 4
GROUP_KEYS = 4 * WARPS
RING_SLOTS = 2
STAMP_COLUMNS = ("ready", "qkv_out", "qkv_in", "part_out", "part_in",
                 "xc_out", "xc_in", "h_out", "h_in", "e_out", "xl_in",
                 "arg_out", "wall", "ln1", "qkv_rows", "ln2", "ff0_rows")
STAMP_COLS = len(STAMP_COLUMNS)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


WEIGHT_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def owned(rows: int, block: int, grid: int) -> int:
    """Rows of a matrix of `rows` output rows that `block` owns: the rows
    j = block (mod grid), row j in slot j // grid."""
    return (rows - 1 - block) // grid + 1 if rows > block else 0


@functools.lru_cache(maxsize=16)
def plan(d: int, f: int, n_layers: int, bins: int, grid: int,
         n_heads: int, wbytes: int = 4) -> dict:
    """The kernel's layout (`make_plan` in csrc/plm_decode.cu, which checks
    "bytes" and "pairs" against its own) for matrices of `wbytes` bytes per
    weight (4 float32, 2 bf16): row slots per block of each matrix, the row
    strides in weights ("rd" for D inputs, "rf" for F inputs: whole 16-byte
    units), the block's dynamic shared memory in bytes, and the exchange
    buffer's length in 64-bit pairs."""
    slots = {"wqkv": _cdiv(3 * d, grid), "wo": _cdiv(d, grid),
             "ff0": _cdiv(f, grid), "ff1": _cdiv(d, grid),
             "pred": _cdiv(bins, grid)}
    rd, rf = _up(d, 16 // wbytes), _up(f, 16 // wbytes)
    w_layer = (slots["wqkv"] + slots["wo"] + slots["ff0"]) * rd + slots["ff1"] * rf
    n_bias = slots["wqkv"] + slots["wo"] + slots["ff0"] + slots["ff1"]
    matrices = n_layers * w_layer + slots["pred"] * rd  # weights
    floats = (_up4(_cdiv(matrices * wbytes, 4)) + n_layers * 4 * d
              + _up4(n_layers * n_bias) + 3 * _up4(d))
    hd = d // n_heads
    nsplit_max = max(1, min(MAX_PARTS // n_heads, grid // n_heads))
    work = max(f, 2 * KEY_CHUNK * hd + 2 * KEY_CHUNK + _up4(hd),
               n_heads * nsplit_max * (hd + 3) + n_heads)
    layer_pairs = 3 * d + n_heads * nsplit_max * (hd + 2) + 2 * d + f
    return {"slots": slots, "rd": rd, "rf": rf,
            "bytes": 4 * (floats + _up4(work)),
            "pairs": 2 * (n_layers * layer_pairs + 2 * grid)}


def smem_plan(d: int, f: int, n_layers: int, bins: int, grid: int,
              n_heads: int = 4, wbytes: int = 4) -> int:
    """Shared memory bytes per block that the kernel takes at this grid."""
    return plan(d, f, n_layers, bins, grid, n_heads, wbytes)["bytes"] + STATIC_SMEM


def check_plan(d: int, f: int, n_layers: int, bins: int, grid: int,
               n_heads: int, wbytes: int = 4) -> dict:
    """plan(...), or ValueError when a block's share of the weights does
    not fit its shared memory at this grid."""
    layout = plan(d, f, n_layers, bins, grid, n_heads, wbytes)
    need = layout["bytes"] + STATIC_SMEM
    if need > SMEM_LIMIT:
        raise ValueError(
            f"plm_decode: a block needs {need} B of shared memory at grid "
            f"{grid} (D={d}, F={f}, L={n_layers}, bins={bins}), over "
            f"{SMEM_LIMIT}")
    return layout


@functools.lru_cache(maxsize=64)
def cluster_plan(d: int, f: int, n_layers: int, bins: int, n_heads: int,
                 cluster: int, weight_dtype: torch.dtype = torch.bfloat16,
                 columns: int = 1) -> dict:
    """The bf16 kernel's per-CTA layout at cluster size `cluster` (`make_plan`
    in csrc/plm_decode_bf16.cu, which checks "bytes" and "pairs" against its
    own), or ValueError when it does not fit: the matrices' row blocks per
    CTA ("blocks": CTA r owns rows [r * blk, r * blk + blk) of each, the
    last ones fewer), row strides in weights ("rd", "rf": whole 16-byte
    units), head rows padded to "hdp", key splits per head ("nsplit"), keys
    per staged chunk ("key_chunk"), the CTA's dynamic shared memory in bytes
    (at most SMEM_LIMIT with the static arrays) and the exchange buffer's
    length in 64-bit pairs. Only bf16 weights have this plan.

    `columns` 1 is the one-row kernel's layout; 2 to MAX_ROWS the multi-row
    kernel's at that many columns (per row: x, which also holds xc and the
    logits' input, qkv, the partials, which h follows, and the products'
    bf16 input; pred passes through a ring of RING_SLOTS stages of
    GROUP_KEYS keys instead of staying resident)."""
    if weight_dtype != torch.bfloat16:
        raise ValueError("plm_decode_bf16: the cluster plan is for bf16 "
                         f"weights only, got {weight_dtype}")
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"plm_decode_bf16: cluster size {cluster} not in "
                         f"{CLUSTER_SIZES}")
    if columns < 1:
        raise ValueError(f"plm_decode_bf16: {columns} columns")
    hd = d // n_heads
    if d % n_heads or d % 4 or f % 4 or hd > MAX_HEAD_DIM or n_heads > cluster:
        raise ValueError(f"plm_decode_bf16 does not take D={d}, F={f}, "
                         f"H={n_heads} at cluster size {cluster}")
    blocks = {"wqkv": _up4(_cdiv(3 * d, cluster)), "wo": _up4(_cdiv(d, cluster)),
              "ff0": _up4(_cdiv(f, cluster)), "ff1": _up4(_cdiv(d, cluster)),
              "pred": _up4(_cdiv(bins, cluster))}
    rd, rf = _up(d, 8), _up(f, 8)
    hdp, nsplit, ps = _up(hd, 8), cluster // n_heads, _up4(hd + 2)
    layer = ((blocks["wqkv"] + blocks["wo"] + blocks["ff0"]) * rd
             + blocks["ff1"] * rf)  # bf16 elements, a multiple of 8
    n_bias = _up4(blocks["wqkv"] + blocks["wo"] + blocks["ff0"] + blocks["ff1"])
    vb = _up(max(rd, rf), 16) // 2   # the products' bf16 input
    if columns == 1:
        floats = ((layer + blocks["pred"] * rd) // 2 + 4 * d + n_bias
                  + 3 * rd + _up4(3 * d) + rf        # x xc xl, qkv, h
                  + vb
                  + n_heads * nsplit * ps + WARPS * ps    # partials, warp states
                  + WARPS * 16)                           # products' split-K sums
        avail = max(0, SMEM_LIMIT - STATIC_SMEM - 4 * floats)
        key_chunk = (min(MAX_KEY_CHUNK, avail // (4 * hdp))
                     // KEY_CHUNK_STEP * KEY_CHUNK_STEP)
        nbytes = 4 * floats + 4 * hdp * key_chunk
        fits = key_chunk >= KEY_CHUNK_STEP
    else:
        outs = _up4(max(blocks["pred"], blocks["wo"], blocks["ff1"]))
        row = rd + _up4(3 * d) + max(n_heads * nsplit * ps, rf) + vb + outs
        floats = (layer // 2 + 4 * d + n_bias + columns * row
                  + max(WARPS * 16 * columns, columns * WARPS * ps))
        stage = max(RING_SLOTS * GROUP_KEYS * hdp, blocks["pred"] * rd // 2)
        key_chunk, nbytes = GROUP_KEYS, 4 * (floats + stage)
        fits = (nbytes + STATIC_SMEM <= SMEM_LIMIT
                and max(blocks["wqkv"], blocks["ff0"], outs) <= THREADS // columns)
    if not fits:
        raise ValueError(
            f"plm_decode_bf16: a CTA's share does not fit its shared memory "
            f"at cluster size {cluster}, {columns} columns (D={d}, F={f}, "
            f"bins={bins}: {4 * floats + STATIC_SMEM} B before the key "
            f"stages, of {SMEM_LIMIT})")
    return {"blocks": blocks, "rd": rd, "rf": rf, "hd": hd, "hdp": hdp,
            "nsplit": nsplit, "key_chunk": key_chunk, "columns": columns,
            "bytes": nbytes,
            "pairs": 2 * columns * ((n_layers - 1) * d + 2 * cluster)}


def cache_shape(n_layers: int, n_heads: int, nsplit: int, t: int,
                hdp: int) -> tuple:
    """A row's KV cache in the bf16 kernel: (L, H, nsplit, cdiv(T, nsplit),
    2, hdp); key k of head h in split k % nsplit at slot k // nsplit. A
    launch of R rows takes (R, *cache_shape)."""
    return (n_layers, n_heads, nsplit, _cdiv(t, nsplit), 2, hdp)


def cache_index(layer: int, token: int, kv: int, head: int, dim: int,
                shape: tuple, row: int = 0) -> int:
    """Flat index of (layer, token, k or v, head, dim) of row `row` in the
    caches of a launch, each of `shape` (cache_shape)."""
    n_layers, n_heads, nsplit, slots, _, hdp = shape
    return ((((((row * n_layers + layer) * n_heads + head) * nsplit
               + token % nsplit) * slots + token // nsplit) * 2 + kv) * hdp
            + dim)


def pick_cluster(d: int, f: int, n_layers: int, bins: int, n_heads: int,
                 max_active) -> tuple[int, dict]:
    """The largest cluster size whose plan fits and at which the card holds
    n_layers clusters at once (max_active(size, bytes) ->
    cudaOccupancyMaxActiveClusters): (size, plan). ValueError, with the
    reason for each size, when none does."""
    why = []
    for n in CLUSTER_SIZES:
        try:
            layout = cluster_plan(d, f, n_layers, bins, n_heads, n)
        except ValueError as e:
            why.append(f"{n}: {e}")
            continue
        active = max_active(n, layout["bytes"])
        if active >= n_layers:
            return n, layout
        why.append(f"{n}: {active} clusters resident at once, "
                   f"{n_layers} needed")
    raise ValueError("plm_decode_bf16: no cluster size runs on this card: "
                     + "; ".join(why))


def pick_rows(d: int, f: int, n_layers: int, bins: int, n_heads: int,
              cluster: int, max_active) -> Optional[dict]:
    """The multi-row kernel's plan (MAX_ROWS columns) at the one-row
    launch's cluster size `cluster`, or None where its rows could not keep
    their one-row launches' codes or it cannot run: the one-row key chunk
    is not a multiple of GROUP_KEYS (its four-key softmax steps would group
    other keys), the plan does not fit, or the card holds fewer than
    n_layers clusters of it (max_active(size, bytes))."""
    if cluster_plan(d, f, n_layers, bins, n_heads, cluster)["key_chunk"] % GROUP_KEYS:
        return None
    try:
        layout = cluster_plan(d, f, n_layers, bins, n_heads, cluster,
                              columns=MAX_ROWS)
    except ValueError:
        return None
    return layout if max_active(cluster, layout["bytes"]) >= n_layers else None


_CHOICE: dict = {}


def _max_active(device: torch.device, columns: int, seen: dict):
    def max_active(n, nbytes):
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            cuda_lib.call("plm_decode_bf16_clusters", n, columns, nbytes,
                          ctypes.byref(out))
        seen[n] = out.value
        return out.value
    return max_active


def cluster_choice(d: int, f: int, n_layers: int, bins: int, n_heads: int,
                   device: torch.device) -> tuple[int, dict, dict]:
    """(cluster size, plan, {size: cudaOccupancyMaxActiveClusters}) of the
    bf16 kernel on `device` (queried once per device and shape)."""
    key = (torch.cuda.get_device_name(device), d, f, n_layers, bins, n_heads)
    if key not in _CHOICE:
        seen = {}
        n, layout = pick_cluster(d, f, n_layers, bins, n_heads,
                                 _max_active(device, 1, seen))
        _CHOICE[key] = (n, layout, seen)
    return _CHOICE[key]


def rows_choice(d: int, f: int, n_layers: int, bins: int, n_heads: int,
                device: torch.device) -> Optional[dict]:
    """pick_rows on `device` at cluster_choice's size (queried once per
    device and shape): the multi-row kernel's plan, or None where a launch
    of several rows goes row by row."""
    key = ("rows", torch.cuda.get_device_name(device), d, f, n_layers, bins,
           n_heads)
    if key not in _CHOICE:
        n = cluster_choice(d, f, n_layers, bins, n_heads, device)[0]
        _CHOICE[key] = pick_rows(d, f, n_layers, bins, n_heads, n,
                                 _max_active(device, MAX_ROWS, {}))
    return _CHOICE[key]


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
    _kernel: dict = field(default_factory=dict, repr=False, compare=False)

    def tensors(self):
        return (self.emb, self.pos_alpha, self.wqkv, self.bqkv, self.wo,
                self.bo, self.ln, self.ff0, self.ff0b, self.ff1, self.ff1b,
                self.pred)

    def matrices(self, dtype: torch.dtype = torch.float32):
        """(wqkv, wo, ff0, ff1, pred) as the kernel takes them in `dtype`:
        float32 as they are; bf16 rounded once (cached), each row padded
        with zeros to a multiple of 8 weights (16 bytes) for the bulk
        copies."""
        mats = (self.wqkv, self.wo, self.ff0, self.ff1, self.pred)
        if dtype == torch.float32:
            return mats
        if dtype not in self._kernel:
            self._kernel[dtype] = tuple(
                F.pad(m.to(dtype), (0, _up(m.shape[-1], 8) - m.shape[-1]))
                .contiguous() for m in mats)
        return self._kernel[dtype]


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


def _check_dtype(name: str, dtype: torch.dtype) -> int:
    if dtype not in WEIGHT_BYTES:
        raise ValueError(f"plm_decode {name} must be float32 or bfloat16, "
                         f"got {dtype}")
    return WEIGHT_BYTES[dtype]


def _rounder(dtype: torch.dtype):
    """Values rounded to `dtype` and back to float32 (float32: unchanged)."""
    if dtype == torch.float32:
        return lambda v: v
    return lambda v: v.to(dtype).float()


def _plain_loop(w: PLMWeights, tc_latent: torch.Tensor, go_id: int, pick,
                weight_dtype: torch.dtype, cache_dtype: torch.dtype,
                row_sum=None):
    """The KV-cached token loop; pick(step, logits) -> the (B,) codes fed
    back. Returns the codes (B, T) int32.

    The attention's width dl is wqkv's rows / 3: D, or a tensor-parallel
    shard's heads' share of it (parallel/tp.py), whose out-proj and ff1
    products are partial sums: row_sum(y) adds them over the ranks, before
    the bias."""
    _check_dtype("weight_dtype", weight_dtype)
    _check_dtype("cache_dtype", cache_dtype)
    rw, rc = _rounder(weight_dtype), _rounder(cache_dtype)
    b, t, _ = tc_latent.shape
    dev = tc_latent.device
    n_layers, d, dl = w.wo.shape[0], w.wo.shape[1], w.wqkv.shape[1] // 3
    h = w.n_heads
    hd = dl // h

    def row_linear(v, wt, bias):
        if row_sum is None:
            return F.linear(v, wt, bias)
        return row_sum(F.linear(v, wt)) + bias
    wqkv, wo, ff0, ff1, pred = (rw(m) for m in (w.wqkv, w.wo, w.ff0, w.ff1,
                                                 w.pred))
    pe = _scaled_positions(w, t, d, dev)
    k_cache = torch.zeros(n_layers, b, h, t, hd, device=dev)
    v_cache = torch.zeros_like(k_cache)
    prev = torch.full((b,), go_id, dtype=torch.long, device=dev)
    codes = torch.empty(b, t, dtype=torch.int32, device=dev)
    for step in range(t):
        x = torch.cat([tc_latent[:, step], w.emb[prev]], dim=-1) + pe[step]
        for i in range(n_layers):
            yn = F.layer_norm(x, (d,), w.ln[i, 0], w.ln[i, 1], 1e-5)
            qkv = F.linear(rw(yn), wqkv[i], w.bqkv[i])
            q = qkv[:, :dl].reshape(b, h, hd)
            k = qkv[:, dl:2 * dl].reshape(b, h, hd)
            v = qkv[:, 2 * dl:].reshape(b, h, hd)
            k_cache[i, :, :, step] = rc(k)
            v_cache[i, :, :, step] = rc(v)
            # the earlier tokens from the cache, this one as computed
            kc = torch.cat([k_cache[i, :, :, :step], k[:, :, None]], dim=2)
            vc = torch.cat([v_cache[i, :, :, :step], v[:, :, None]], dim=2)
            scores = torch.einsum("bhd,bhkd->bhk", q, kc) / math.sqrt(hd)
            p = torch.softmax(scores, dim=-1)
            att = torch.einsum("bhk,bhkd->bhd", p, vc).reshape(b, dl)
            x = x + row_linear(rw(att), wo[i], w.bo[i])
            yn = F.layer_norm(x, (d,), w.ln[i, 2], w.ln[i, 3], 1e-5)
            hid = torch.relu(F.linear(rw(yn), ff0[i], w.ff0b[i]))
            x = x + row_linear(rw(hid), ff1[i], w.ff1b[i])
        nxt = pick(step, F.linear(rw(x), pred))
        codes[:, step] = nxt.to(torch.int32)
        prev = nxt.long()
    return codes


def plain_decode(w: PLMWeights, tc_latent: torch.Tensor, go_id: int = 1024,
                 top_k: int = 0, temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 weight_dtype: torch.dtype = torch.float32,
                 cache_dtype: torch.dtype = torch.float32,
                 row_sum=None) -> torch.Tensor:
    """KV-cached decode loop: tc_latent (B, T, TC) -> codes (B, T) int32.

    Greedy (first argmax) when top_k == 0; otherwise top-k sampling at
    `temperature`, drawn on tc_latent's device from `generator` (a
    torch.Generator on that device). With bf16 weight / cache dtypes, the
    matrices, each product's vector and each cached k, v row are rounded
    to bf16 where the kernel rounds them (module docstring); the math is
    float32. On a tensor-parallel shard's weights, `row_sum` is
    parallel/tp.row_sum (every rank then draws the same codes, the
    generator seeded alike)."""

    def pick(step, logits):
        if top_k == 0:
            return torch.argmax(logits, dim=-1)
        vals, idxs = torch.topk(logits / temperature, top_k, dim=-1)
        choice = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                                   generator=generator)
        return torch.gather(idxs, 1, choice)[:, 0]

    return _plain_loop(w, tc_latent, go_id, pick, weight_dtype, cache_dtype,
                       row_sum)


def plain_gap(w: PLMWeights, tc_latent: torch.Tensor, codes: torch.Tensor,
              go_id: int = 1024, weight_dtype: torch.dtype = torch.float32,
              cache_dtype: torch.dtype = torch.float32) -> tuple[float, float]:
    """Teacher-forced check of greedy codes against the plain loop in the
    same dtypes: with `codes` fed back, (the largest row max - logit of the
    code taken, max|logits|). 0 for codes the plain greedy loop itself
    gives; a decode that flips a near tie keeps it within its float error
    of the scale."""
    gaps, scales = [], []
    codes = codes.to(tc_latent.device).long()

    def pick(step, logits):
        chosen = logits.gather(-1, codes[:, step:step + 1])[:, 0]
        gaps.append((logits.amax(-1) - chosen).max())
        scales.append(logits.abs().max())
        return codes[:, step]

    _plain_loop(w, tc_latent, go_id, pick, weight_dtype, cache_dtype)
    return float(torch.stack(gaps).max()), float(torch.stack(scales).max())


def _kernel_inputs(w: PLMWeights, tc_latent: torch.Tensor, rd: int, rf: int,
                   weight_dtype: torch.dtype):
    """(pe, the weights in the kernels' argument order: emb, wqkv, bqkv, wo,
    bo, ln, ff0, ff0b, ff1, ff1b, pred), each checked against the kernels'
    contract: on tc_latent's device, contiguous, of its shape and dtype (the
    matrices in weight_dtype, rows of rd or rf weights), the bulk-copied
    ones 16-byte aligned."""
    dev = tc_latent.device
    _, t, tc_dim = tc_latent.shape
    n_layers, d = w.wo.shape[0], w.wo.shape[1]
    f, bins = w.ff0.shape[1], w.pred.shape[0]
    cuda_lib.check(tc_latent, "tc_latent", dev)
    wqkv, wo, ff0, ff1, pred = w.matrices(weight_dtype)
    tensors = (w.emb, w.pos_alpha, wqkv, w.bqkv, wo, w.bo, w.ln, ff0, w.ff0b,
               ff1, w.ff1b, pred)
    shapes = ((w.emb.shape[0], d - tc_dim), (1,), (n_layers, 3 * d, rd),
              (n_layers, 3 * d), (n_layers, d, rd), (n_layers, d),
              (n_layers, 4, d), (n_layers, f, rd), (n_layers, f),
              (n_layers, d, rf), (n_layers, d), (bins, rd))
    names = ("emb", "pos_alpha", "wqkv", "bqkv", "wo", "bo", "ln", "ff0",
             "ff0b", "ff1", "ff1b", "pred")
    mats = ("wqkv", "wo", "ff0", "ff1", "pred")
    for name, tensor, shape in zip(names, tensors, shapes):
        cuda_lib.check(tensor, name, dev, shape,
                       (weight_dtype if name in mats else torch.float32,))
        if name in mats + ("ln",) and tensor.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (bulk copies)")
    pe = _scaled_positions(w, t, d, dev).contiguous()
    return pe, tensors[:1] + tensors[2:]


def _launch(w: PLMWeights, tc_latent: torch.Tensor, go_id: int,
            stamps: Optional[torch.Tensor], weight_dtype: torch.dtype,
            cache_dtype: torch.dtype) -> torch.Tensor:
    dev = tc_latent.device
    _, t, tc_dim = tc_latent.shape
    n_layers, d = w.wo.shape[0], w.wo.shape[1]
    f, bins = w.ff0.shape[1], w.pred.shape[0]
    h = w.n_heads
    wbytes = _check_dtype("weight_dtype", weight_dtype)
    cbytes = _check_dtype("cache_dtype", cache_dtype)
    if t < 1:
        raise ValueError("plm_decode needs T >= 1")
    if wbytes == cbytes == 2:
        return _launch_bf16(w, tc_latent, go_id, stamps)
    if tc_latent.shape[0] != 1:
        raise ValueError("plm_decode.cu decodes one row a launch")
    if d % 4 or f % 4 or d % h or d > 512 or tc_dim >= d or h > MAX_PARTS:
        raise ValueError(f"plm_decode kernel does not take D={d}, F={f}, H={h}")
    grid = min(torch.cuda.get_device_properties(dev).multi_processor_count,
               MAX_GRID)
    if grid < h:
        raise ValueError(f"plm_decode needs a grid of >= {h} blocks, got {grid}")
    layout = check_plan(d, f, n_layers, bins, grid, h, wbytes)
    pe, weights = _kernel_inputs(w, tc_latent, layout["rd"], layout["rf"],
                                 weight_dtype)
    cache = torch.empty(n_layers, t, 2, d, dtype=cache_dtype, device=dev)
    # epochs start at 1: a zeroed buffer holds no stale pair
    xch = torch.zeros(layout["pairs"], dtype=torch.int64, device=dev)
    codes = torch.empty(t, dtype=torch.int32, device=dev)
    p = cuda_lib.ptr
    cuda_lib.call("plm_decode_fwd", p(tc_latent), p(pe), *map(p, weights),
                  p(cache), p(xch), p(codes), p(stamps), t, n_layers, d,
                  tc_dim, h, f, bins, go_id, grid, layout["bytes"],
                  layout["pairs"], wbytes, cbytes, cuda_lib.stream(dev))
    cuda_lib.LAUNCHES["plm_decode"] += 1
    return codes[None]


def _launch_bf16(w: PLMWeights, tc_latent: torch.Tensor, go_id: int,
                 stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """csrc/plm_decode_bf16.cu, bf16 weights and cache: the R =
    tc_latent.shape[0] rows (1 to MAX_ROWS) in one token loop, one launch;
    row by row where the multi-row kernel does not run on this card
    (rows_choice)."""
    dev = tc_latent.device
    rows, t, tc_dim = tc_latent.shape
    n_layers, d = w.wo.shape[0], w.wo.shape[1]
    f, bins = w.ff0.shape[1], w.pred.shape[0]
    h = w.n_heads
    if d > 512 or tc_dim >= d:
        raise ValueError(f"plm_decode_bf16 does not take D={d}, TC={tc_dim}")
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"plm_decode_bf16 takes 1 to {MAX_ROWS} rows a "
                         f"launch, got {rows}")
    n, layout = cluster_choice(d, f, n_layers, bins, h, dev)[:2]
    if rows > 1:
        layout = rows_choice(d, f, n_layers, bins, h, dev)
        if layout is None:
            return torch.cat([_launch_bf16(w, tc_latent[i:i + 1], go_id, stamps)
                              for i in range(rows)])
    pe, weights = _kernel_inputs(w, tc_latent, layout["rd"], layout["rf"],
                                 torch.bfloat16)
    cache = torch.empty((rows,) + cache_shape(n_layers, h, layout["nsplit"], t,
                                              layout["hdp"]),
                        dtype=torch.bfloat16, device=dev)
    # epochs start at 1: a zeroed buffer holds no stale pair
    xch = torch.zeros(layout["pairs"], dtype=torch.int64, device=dev)
    codes = torch.empty(rows, t, dtype=torch.int32, device=dev)
    p = cuda_lib.ptr
    cuda_lib.call("plm_decode_bf16_fwd", p(tc_latent), p(pe),
                  *map(p, weights), p(cache), p(xch), p(codes), p(stamps), t,
                  n_layers, d, tc_dim, h, f, bins, go_id, n, rows,
                  layout["bytes"], layout["pairs"], cuda_lib.stream(dev))
    cuda_lib.LAUNCHES["plm_decode_bf16"] += 1
    cuda_lib.ROWS["plm_decode_bf16"] += rows
    return codes


def plm_decode_greedy(w: PLMWeights, tc_latent: torch.Tensor,
                      go_id: int = 1024,
                      weight_dtype: torch.dtype = torch.bfloat16,
                      cache_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Greedy decode, tc_latent (B, T, TC) float32 -> codes (B, T) int32.

    CUDA tensors run a kernel (any T >= 1): bf16 weights and cache
    csrc/plm_decode_bf16.cu, B = 1 to MAX_ROWS rows in one launch, each
    row's codes its own one-row launch's; every other configuration
    csrc/plm_decode.cu, B = 1. CPU tensors run the plain version in the same
    dtypes, row by row. Weights and cache in bf16 (the default, the TPU
    kernel's serving configuration, `pallas_plm_decode.plm_decode_greedy`)
    or float32; a launch counts under its source: `plm_decode_bf16` for
    bf16 weights and cache (its rows in `cuda_lib.ROWS`), `plm_decode` for
    every other pair."""
    bf16 = weight_dtype == cache_dtype == torch.bfloat16
    if (tc_latent.dim() != 3 or not 1 <= tc_latent.shape[0] <= MAX_ROWS
            or (tc_latent.shape[0] > 1 and not bf16)):
        raise ValueError(
            f"plm_decode takes tc_latent (B, T, C), B = 1 (1 to {MAX_ROWS} "
            f"with bf16 weights and cache), got {tuple(tc_latent.shape)}")
    if tc_latent.device.type == "cpu":
        return torch.cat([plain_decode(w, tc_latent[i:i + 1], go_id,
                                       weight_dtype=weight_dtype,
                                       cache_dtype=cache_dtype)
                          for i in range(tc_latent.shape[0])])
    if tc_latent.device.type != "cuda":
        raise ValueError(f"unsupported device {tc_latent.device}")
    return _launch(w, tc_latent.contiguous(), go_id, None, weight_dtype,
                   cache_dtype)


def phase_stamps(w: PLMWeights, tc_latent: torch.Tensor,
                 go_id: int = 1024,
                 weight_dtype: torch.dtype = torch.bfloat16,
                 cache_dtype: torch.dtype = torch.bfloat16
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch that also records clocks: (codes (B, T), stamps
    int64). Counts as a launch. The dtypes and rows as plm_decode_greedy's
    (B > 1: the multi-row kernel, whose stamps are the same columns).

    float32 and the mixed configurations (plm_decode.cu): stamps (T, 5L + 1,
    3), block 0's clocks twice per phase. Phase k of layer i is row 5i + k
    (A-E), the logits the last row. Column 0: SM cycles when block 0 has
    published the phase's outputs; column 1: SM cycles when it holds the
    outputs of the phase that it reads next; column 2, in the logits row
    only: %globaltimer (ns), for converting cycles to time over the launch.

    bf16 weights and cache (plm_decode_bf16.cu): stamps (T, L, STAMP_COLS),
    the SM clock of thread 0 of each layer's cluster's rank-0 CTA at the
    points STAMP_COLUMNS names: x in hand ("ready"); for the qkv, partials,
    xc and h handoffs its part handed on ("_out") and the whole in hand
    ("_in"); E done ("e_out": published, or on the last layer computed);
    the logits' input in hand and the argmax published (last layer only);
    "wall": %globaltimer (ns) at "ready"; LayerNorm1 done, the QKV rows
    done, LayerNorm2 done, the FF0 rows done."""
    t, n_layers = tc_latent.shape[1], w.wo.shape[0]
    shape = ((t, n_layers, STAMP_COLS)
             if weight_dtype == cache_dtype == torch.bfloat16
             else (t, 5 * n_layers + 1, 3))
    stamps = torch.zeros(shape, dtype=torch.int64, device=tc_latent.device)
    codes = _launch(w, tc_latent.contiguous(), go_id, stamps, weight_dtype,
                    cache_dtype)
    return codes, stamps


def barrier_probe(n: int, device: torch.device) -> None:
    """n grid barriers of the kernel's earlier single-counter design and no
    work, on the decode kernel's grid (one cooperative launch; not counted
    as a decode)."""
    bar = torch.zeros(1, dtype=torch.int32, device=device)
    cuda_lib.call("plm_barrier_probe", cuda_lib.ptr(bar), n,
                  cuda_lib.stream(device))
