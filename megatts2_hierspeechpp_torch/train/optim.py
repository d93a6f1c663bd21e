"""AdamW with the reference recipe's per-epoch exponential decay.

Counterpart of `megatts2_hierspeechpp_tpu/train/optim.py`: AdamW(lr,
betas (0.8, 0.99), eps 1e-9, weight decay 0.01) with lr = base * gamma^epoch
(reference train_ms.py ExponentialLR). torch.optim.AdamW computes optax's
adamw update: decoupled decay lr * wd * p, and m_hat / (sqrt(v_hat) + eps).
As optax, the schedule is read at the count of updates made before this
one, and the optional clip scales the gradients by max_norm / norm when
their global L2 norm exceeds max_norm.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch


def exponential_epoch_decay(base_lr: float, gamma: float,
                            steps_per_epoch: int):
    """step -> base_lr * gamma^(step // steps_per_epoch)."""

    def schedule(step: int) -> float:
        return base_lr * gamma ** (step // max(steps_per_epoch, 1))

    return schedule


class AdamW:
    """torch.optim.AdamW driven by an update count, with the learning-rate
    schedule and the optional global-norm clip applied before each
    update."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
                 betas=(0.8, 0.99), eps: float = 1e-9,
                 weight_decay: float = 0.01, lr_decay: Optional[float] = None,
                 steps_per_epoch: int = 1000,
                 max_grad_norm: Optional[float] = None):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = (exponential_epoch_decay(lr, lr_decay, steps_per_epoch)
                         if lr_decay is not None else (lambda step: lr))
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.opt = torch.optim.AdamW(self.params, lr=lr, betas=tuple(betas),
                                     eps=eps, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the parameters' .grad."""
        if self.max_grad_norm is not None:
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.clamp(self.max_grad_norm / norm, max=1.0)
            for g in grads:
                g.mul_(scale)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "opt": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.opt.load_state_dict(state["opt"])
