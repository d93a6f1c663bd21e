"""Monotonic alignment search (MAS), batched, in torch.

Counterpart of `megatts2_hierspeechpp_tpu/ops/monotonic_align.py` (the
reference's Cython/OpenMP maximum_path_c): the DP runs batched over B with
a loop over the T_y frames, each frame one shifted max over x, and the
backtrace is a second loop from the last valid frame down. The same
operations in the same order as the JAX scans, so the scores are JAX's
bit for bit. A tie is broken as the reference's Cython kernel and the
native copy (`native/mas.cpp`) break it: the backtrace takes the diagonal
only when it is strictly better (or forced, x == y). The JAX scan takes
it on a tie too, so on tied scores its path may differ from these three,
at the same total. Runs on the tensors' device. `ops/mas_native.py` is the
host C++ kernel.

DP: value[y, x] += max(value[y-1, x], value[y-1, x-1]); the path starts at
(0, 0), ends at (t_y - 1, t_x - 1) and assigns each frame one x.
"""
from __future__ import annotations

import torch

NEG_INF = -1e9


@torch.no_grad()
def maximum_path(value: torch.Tensor, t_ys: torch.Tensor,
                 t_xs: torch.Tensor) -> torch.Tensor:
    """value: (B, T_y, T_x) scores; t_ys / t_xs: (B,) valid lengths ->
    a {0, 1} path (B, T_y, T_x) in value's dtype, zero outside each row's
    valid region."""
    b, t_y, t_x = value.shape
    dev = value.device
    xs = torch.arange(t_x, device=dev)
    neg = torch.full((b, 1), NEG_INF, dtype=value.dtype, device=dev)
    prev = torch.full((b, t_x), NEG_INF, dtype=value.dtype, device=dev)
    diag = torch.empty((t_y, b, t_x), dtype=torch.bool, device=dev)
    for y in range(t_y):
        row = value[:, y]
        shifted = torch.cat([neg, prev[:, :-1]], dim=1)
        diag[y] = shifted > prev   # came from x - 1 (strictly better)
        if y == 0:   # the first frame starts at x == 0
            cur = torch.where(xs[None] == 0, row, NEG_INF)
        else:
            cur = torch.maximum(prev, shifted) + row
        prev = torch.where(xs[None] <= y, cur, NEG_INF)   # x <= y

    t_ys = t_ys.to(dev).long()
    t_xs = t_xs.to(dev).long()
    cur_x = t_xs - 1
    path = torch.zeros((t_y, b, t_x), dtype=torch.bool, device=dev)
    for y in range(t_y - 1, -1, -1):   # frames past t_ys emit nothing
        active = y < t_ys
        path[y] = (xs[None] == cur_x[:, None]) & active[:, None]
        came = diag[y].gather(1, cur_x[:, None])[:, 0]
        new_x = torch.where(came & (y > 0), cur_x - 1, cur_x)
        cur_x = torch.where(active, new_x, cur_x).clamp(0, t_x - 1)
    path = path.transpose(0, 1).to(value.dtype)
    return path * (xs[None, None] < t_xs[:, None, None])
