"""Data-parallel training across GPUs: the process group, the global
batch's reductions and the gradient all-reduce.

Counterpart of `megatts2_hierspeechpp_tpu/parallel/mesh.py`. There a 1-D
`data` mesh replicates the parameters, shards each batch on axis 0, and
GSPMD makes every reduction in a step a reduction over the *global* batch
(the gradients, the RVQ EMA statistics, BatchNorm, the masked means, the
denoiser's attention over axis 0). Here each rank is one process holding
one rank's rows, and those reductions are explicit:

  - `init_distributed` starts the process group from torchrun's variables
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL for a
    CUDA device, gloo for the CPU, rank r on cuda:LOCAL_RANK. Without them
    it starts nothing and the world is 1.
  - A train step runs its forward and backward inside `global_batch()`.
    There, and only there, the models' batch reductions (`batch_sum`,
    `gather_rows`, `GlobalBatchNorm1d`, the RVQ statistics) run over every
    rank's rows, and `reduce_grads` sums or averages the stepped module's
    gradients in one coalesced all_reduce after the backward. Outside it
    (serving, eval hooks, a run without a process group) they are the
    identity, so nothing waits for a rank that is not there.
  - Only all_reduce and broadcast are used (a gather is the all_reduce of a
    zero-filled buffer holding the rank's slot), which gloo also runs on
    CUDA tensors.

No module is wrapped in DistributedDataParallel: a GAN step runs D three
times with G's backward through D, the denoiser checkpoints its blocks
and the AR step accumulates micro-steps, each a case where DDP's reducer
breaks or counts twice.

Convention of the steps: each rank's loss is its share of the global loss.
A mean over equal-shaped rank tensors is the mean of the ranks' means, so
those gradients are averaged; a masked mean divides by the global mask
sum; a summed loss (s1, AR) has its gradients summed.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from megatts2_hierspeechpp_torch.device import resolve_device

_SCOPES: list = []   # active global_batch() scopes (read from any thread)


def init_distributed(device: str | torch.device = "cuda",
                     backend: str | None = None) -> torch.device:
    """Start the process group when a launcher set WORLD_SIZE, and return
    this rank's device: cuda:LOCAL_RANK for a CUDA `device`, the CPU for a
    CPU one. `backend` defaults to nccl for CUDA and gloo for the CPU; a
    failure to start raises. Without WORLD_SIZE: `resolve_device(device)`
    and no process group (world 1)."""
    dev = resolve_device(device)
    env = os.environ
    if "WORLD_SIZE" not in env:
        return dev
    world_size, rank_ = int(env["WORLD_SIZE"]), int(env["RANK"])
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank_)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda"
                                            else "gloo"),
                                init_method="env://", world_size=world_size,
                                rank=rank_)
    return dev


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0 writes checkpoints, scalars and eval output."""
    return rank() == 0


@contextlib.contextmanager
def global_batch():
    """Inside, the batch reductions below run over every rank's rows (when a
    process group is up). A step's forward and backward both run inside:
    a checkpointed block recomputes its forward during the backward."""
    _SCOPES.append(None)
    try:
        yield
    finally:
        _SCOPES.pop()


def sharded() -> bool:
    """True inside global_batch() with a process group up."""
    return bool(_SCOPES) and dist.is_initialized()


def shard() -> tuple[int, int]:
    """(rank, world) of the global batch: (0, 1) unless sharded()."""
    return (rank(), world()) if sharded() else (0, 1)


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def all_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sums over the ranks of `tensors` (one dtype), as new tensors,
    in one all_reduce; the tensors themselves when not sharded()."""
    if not sharded():
        return list(tensors)
    flat = _flat([t.detach() for t in tensors])
    dist.all_reduce(flat)
    return _unflat(flat, tensors)


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """The global batch's sum of a rank's statistic (a count, a mask sum);
    no gradient flows through the reduction."""
    return all_sum([t])[0]


def share_denominator(count: torch.Tensor) -> torch.Tensor:
    """The denominator that makes sum_rank / it this rank's share of the
    global masked mean sum_all / count_all: count_all / world."""
    w = shard()[1]
    return count if w == 1 else batch_sum(count) / w


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (axis 0 split evenly in
    rank order); x itself when not sharded()."""
    r, w = shard()
    if w == 1:
        return x
    n = x.shape[0] // w
    if n * w != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows do not split over {w} ranks")
    return x[r * n:(r + 1) * n]


class _AllSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward is the all_reduce of the incoming
    gradients: with every rank's loss a share of one global loss, the
    gradient reaching a rank's statistic is the sum of every rank's
    dL/dstatistic."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def differentiable_sum(x: torch.Tensor) -> torch.Tensor:
    """The global sum of x with its gradient (BatchNorm's statistics)."""
    return _AllSum.apply(x) if shard()[1] > 1 else x


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of x (equal shapes), in rank order, as the
    all_reduce of a zero-filled buffer holding this rank's slot (exact:
    each element is one value plus zeros). Backward: the gradients of
    every rank's use of the gathered rows are summed, and the rank keeps
    its own slot."""

    @staticmethod
    def forward(ctx, x):
        r, w = rank(), world()
        n = x.shape[0]
        out = x.new_zeros((w * n,) + tuple(x.shape[1:]))
        out[r * n:(r + 1) * n] = x
        dist.all_reduce(out)
        ctx.slot = (r * n, (r + 1) * n)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        a, b = ctx.slot
        return g[a:b]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of x along axis 0 (differentiable); x itself
    when not sharded() or at world 1."""
    return _GatherRows.apply(x) if shard()[1] > 1 else x


@torch.no_grad()
def gather_varlen(x: torch.Tensor) -> torch.Tensor:
    """Rows of every rank, in rank order, when the ranks hold different
    numbers of rows (k-means' samples); x itself when not sharded()."""
    r, w = shard()
    if w == 1:
        return x
    counts = torch.zeros(w, dtype=torch.int64, device=x.device)
    counts[r] = x.shape[0]
    counts = batch_sum(counts)
    starts = [0] + torch.cumsum(counts, 0).tolist()
    out = x.new_zeros((starts[-1],) + tuple(x.shape[1:]))
    out[starts[r]:starts[r + 1]] = x
    return batch_sum(out)


def reduce_grads(params: Iterable[torch.nn.Parameter],
                 average: bool = True) -> None:
    """Replace each parameter's .grad by its sum (average=False) or mean
    over the ranks, in one coalesced all_reduce; nothing when not
    sharded(). Parameters without a gradient are left out (every rank runs
    the same graph, so they are the same on every rank) and keep none, as
    the optimizers skip them."""
    if not sharded():
        return
    params = [p for p in params if p.grad is not None]
    flat = _flat([p.grad for p in params])
    dist.all_reduce(flat)
    if average:
        flat /= world()
    for p, g in zip(params, _unflat(flat, params)):
        p.grad.copy_(g)


def reduce_metrics(metrics: Dict[str, torch.Tensor],
                   average: bool = True) -> Dict[str, torch.Tensor]:
    """Each 0-d metric summed (average=False) or averaged over the ranks,
    in one all_reduce; `metrics` itself when not sharded()."""
    if not sharded() or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(flat)
    if average:
        flat /= world()
    return {k: flat[i] for i, k in enumerate(keys)}


@torch.no_grad()
def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` made rank `src`'s (one
    broadcast of each dtype's flattened tensors); nothing without a
    process group."""
    if not dist.is_initialized():
        return
    tensors = list(module.parameters()) + list(module.buffers())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = _flat([t.data for t in group])
        dist.broadcast(flat, src)
        for t, v in zip(group, _unflat(flat, group)):
            t.data.copy_(v)


def pad_to_global(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Each array zero-padded to the largest shape any rank holds for its
    key (one all_reduce(MAX) of the shapes), so that every rank's rows are
    rows of one rectangular global batch; `batch` itself without a process
    group. Call it from the thread that runs the steps."""
    if not dist.is_initialized():
        return batch
    keys = sorted(batch)
    dims = [d for k in keys for d in batch[k].shape]
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    shape = torch.tensor(dims, dtype=torch.int64, device=dev)
    dist.all_reduce(shape, op=dist.ReduceOp.MAX)
    shape, out, i = shape.tolist(), {}, 0
    for k in keys:
        a = batch[k]
        want = shape[i:i + a.ndim]
        i += a.ndim
        out[k] = np.pad(a, [(0, w - s) for s, w in zip(a.shape, want)])
    return out


class GlobalBatchNorm1d(nn.BatchNorm1d):
    """nn.BatchNorm1d (same parameters and buffers) whose training-mode
    statistics are those of the global batch inside global_batch() at a
    world above 1: the mean from the summed rows, the biased variance from
    the summed squared deviations about it, the running variance's
    unbiased factor on the global count (JAX BatchNorm over axes (0, 1) of
    the global batch). Elsewhere it is nn.BatchNorm1d itself."""

    def forward(self, x):
        if not (self.training and shard()[1] > 1):
            return super().forward(x)
        # x: (N, C, L) -> statistics over N and L of every rank
        n = batch_sum(x.new_tensor(float(x.shape[0] * x.shape[2])))
        mean = differentiable_sum(x.sum((0, 2))) / n
        dev = x - mean[None, :, None]
        var = differentiable_sum(dev.square().sum((0, 2))) / n
        if self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                cnt = float(n)
                self.running_mean.mul_(1 - m).add_(m * mean.detach())
                self.running_var.mul_(1 - m).add_(
                    m * var.detach() * cnt / max(cnt - 1, 1))
                self.num_batches_tracked.add_(1)
        y = dev * torch.rsqrt(var + self.eps)[None, :, None]
        return y * self.weight[None, :, None] + self.bias[None, :, None]
