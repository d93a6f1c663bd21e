"""ScaledAdam (k2/icefall) and the warmup-cosine schedule of the AR trainer.

Counterpart of `megatts2_hierspeechpp_tpu/ar/scaled_adam.py` (reference
AR/modules/optim.py, AR/modules/lr_schedulers.py): Adam moments on the
gradient; each update is m_hat / (sqrt(v_hat) + eps) times -lr times the
parameter's RMS clipped into [param_min_rms, param_max_rms], except for
scalar-ish parameters (ndim <= 1 and numel <= 4096, a rule no layout
transpose changes), which take plain Adam at lr * scalar_lr_scale. The
learning rate is the schedule at the update count, which starts at 1. All
state is float32, the bias corrections computed in float32 as in JAX.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List, Sequence, Union

import torch


def warmup_cosine_schedule(init_lr: float, peak_lr: float, end_lr: float,
                           warmup_steps: int, total_steps: int):
    """step -> linear warmup from init_lr to peak_lr, then cosine decay to
    end_lr at total_steps (WarmupCosineLRSchedule)."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return init_lr + (peak_lr - init_lr) * step / max(warmup_steps, 1)
        progress = min(max((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return end_lr + 0.5 * (peak_lr - end_lr) * (1 + math.cos(math.pi * progress))

    return schedule


def scalar_ish(p: torch.Tensor) -> bool:
    return p.dim() <= 1 and p.numel() <= 4096


class ScaledAdam:
    """ScaledAdam over `params`, stepped with the gradients given to `step`
    (the trainer's accumulated mean)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: Union[float, Callable[[int], float]] = 0.01,
                 betas=(0.9, 0.95), eps: float = 1e-8,
                 param_min_rms: float = 1e-5, param_max_rms: float = 3.0,
                 scalar_lr_scale: float = 0.1):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = lr if callable(lr) else (lambda step: lr)
        self.betas, self.eps = tuple(betas), eps
        self.min_rms, self.max_rms = param_min_rms, param_max_rms
        self.scalar_lr_scale = scalar_lr_scale
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def updates(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Advance the moments by `grads` and return the updates (what
        optax's update_fn returns; `step` adds them)."""
        self.count += 1
        lr = torch.tensor(self.schedule(self.count), dtype=torch.float32,
                          device=self.params[0].device)
        b1, b2 = self.betas
        # the corrections as JAX computes them: b ** count in float32
        bc1, bc2 = (float(1 - torch.tensor(b, dtype=torch.float32) ** self.count)
                    for b in self.betas)
        out = []
        for p, m, v, g in zip(self.params, self.mu, self.nu, grads):
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            upd = (m / bc1) / ((v / bc2).sqrt() + self.eps)
            if scalar_ish(p):
                scale = -lr * self.scalar_lr_scale
            else:
                scale = -lr * p.square().mean().sqrt().clamp(self.min_rms,
                                                             self.max_rms)
            out.append(scale * upd)
        return out

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for p, u in zip(self.params, self.updates(grads)):
            p.add_(u)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            for d, s in zip(dst, state[key]):
                d.copy_(s)
