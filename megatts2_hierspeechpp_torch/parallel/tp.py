"""Tensor-parallel ProsodyLM and Text2Semantic: the rank's shard of a
model, its teacher-forced forward and its KV-cached decodes.

Counterpart of `megatts2_hierspeechpp_tpu/parallel/tp.py`
(`plm_param_shardings`), where the split is a placement rule under GSPMD.
Here it is explicit, on `world` ranks of a process group:

  - column-parallel: w_q / w_k / w_v, ff_0 (ProsodyLM) and the packed
    in_proj, linear1 (Text2Semantic) keep the rows of the rank's heads or
    hidden units;
  - row-parallel: out_proj and ff_1 / linear2 keep the matching columns;
    their partial products are summed over the ranks by one all_reduce
    (`row_sum`), then the (replicated) bias is added (`RowParallelLinear`);
  - embeddings, norms and heads are replicated.

The packed T2S in_proj (3d, d) is cut by heads in each of q, k and v: rank
r holds rows [r d/W, (r+1) d/W) of each third. The JAX rule shards that
axis contiguously (P("model", None)), which under GSPMD is only placement;
a contiguous cut as a head split would give rank 0 all of q and half of k.

Each rank holds its heads' share of the KV cache. The shard's forward and
decodes are the models' own plain math on fewer heads: the module's
forward, `t2s_decode`, and for a ProsodyLM shard
`ops/plm_decode.plain_decode(shard.packed(), ..., row_sum=row_sum)`; the
`plm_decode` kernel is a whole-model B = 1 kernel and is not used here.
Every rank ends a layer with the same residual stream, so every rank draws
the same token; greedy and seeded top-k tokens equal the one-card decode's
up to float-order ties.
"""
from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from megatts2_hierspeechpp_torch.ar.t2s import Text2Semantic
from megatts2_hierspeechpp_torch.models.plm import ProsodyLM


def row_sum(y: torch.Tensor) -> torch.Tensor:
    """The row-parallel sum: every rank's partial product added up in place
    (one all_reduce); the identity without a process group."""
    if dist.is_initialized():
        dist.all_reduce(y)
    return y


class RowParallelLinear(nn.Module):
    """The rank's input columns of a Linear: y = all_reduce(x W_r^T) + b,
    the bias whole on every rank and added once, after the sum."""

    def __init__(self, linear: nn.Linear, cols: slice):
        super().__init__()
        self.weight = nn.Parameter(linear.weight.detach()[:, cols].clone(),
                                   requires_grad=False)
        self.bias = (None if linear.bias is None else nn.Parameter(
            linear.bias.detach().clone(), requires_grad=False))

    def forward(self, x):
        y = row_sum(F.linear(x, self.weight.to(x.dtype)))
        return y if self.bias is None else y + self.bias.to(y.dtype)


def _rows(linear: nn.Linear, rows) -> None:
    """Keep `rows` (a slice) of a Linear's outputs."""
    linear.weight = nn.Parameter(linear.weight.detach()[rows].clone(),
                                 requires_grad=False)
    if linear.bias is not None:
        linear.bias = nn.Parameter(linear.bias.detach()[rows].clone(),
                                   requires_grad=False)
    linear.out_features = linear.weight.shape[0]


def _part(n: int, rank: int, world: int) -> slice:
    if n % world:
        raise ValueError(f"{n} does not split over {world} ranks")
    return slice(rank * n // world, (rank + 1) * n // world)


def shard_module(model: nn.Module, rank: int, world: int) -> nn.Module:
    """The rank's shard of a ProsodyLM or Text2Semantic: a frozen copy in
    eval() mode holding heads [rank H/W, (rank+1) H/W) and the matching
    hidden units of every layer, its row-parallel projections
    RowParallelLinear. The model itself is not changed."""
    if model.n_heads % world:
        raise ValueError(f"{model.n_heads} heads do not split over {world} ranks")
    shard = copy.deepcopy(model).eval().requires_grad_(False)
    if isinstance(shard, ProsodyLM):
        for layer in shard.plm.layers:
            att = layer.attn
            heads = _part(att.w_q.weight.shape[0], rank, world)
            for lin in (att.w_q, att.w_k, att.w_v):
                _rows(lin, heads)
            att.out_proj[0] = RowParallelLinear(att.out_proj[0], heads)
            att.n_heads //= world
            hidden = _part(layer.ff[0].weight.shape[0], rank, world)
            _rows(layer.ff[0], hidden)
            layer.ff[3] = RowParallelLinear(layer.ff[3], hidden)
        shard.n_heads //= world
        shard._packed = None
    elif isinstance(shard, Text2Semantic):
        for layer in shard.h.layers:
            att = layer.self_attn
            d = att.in_proj_weight.shape[1]
            heads = _part(d, rank, world)
            # each of q, k, v cut by heads, not the packed axis contiguously
            idx = torch.cat([torch.arange(d)[heads] + j * d for j in range(3)])
            att.in_proj_weight = nn.Parameter(
                att.in_proj_weight.detach()[idx].clone(), requires_grad=False)
            att.in_proj_bias = nn.Parameter(
                att.in_proj_bias.detach()[idx].clone(), requires_grad=False)
            att.out_proj = RowParallelLinear(att.out_proj, heads)
            att.n_heads //= world
            hidden = _part(layer.linear1.weight.shape[0], rank, world)
            _rows(layer.linear1, hidden)
            layer.linear2 = RowParallelLinear(layer.linear2, hidden)
    else:
        raise TypeError(f"no tensor-parallel split for {type(model).__name__}")
    return shard
