"""AR-stack trainer: CE training of Text2Semantic with ScaledAdam and the
warmup-cosine schedule, with gradient accumulation.

Counterpart of `megatts2_hierspeechpp_tpu/ar/trainer.py` (reference
s1_train.py / t2s_lightning_module.py, accumulation 4): each micro-step adds
its gradients to the accumulation buffer; every `grad_accum` micro-steps the
optimizer steps on their mean and the buffer is zeroed. `step` counts
micro-steps. The checkpoint holds the buffer and its count, so a run resumed
inside an accumulation equals the run that was never stopped.

Dropout masks (p_dropout > 0; the CLI's default is 0) come from a generator
on the batch's device seeded by one draw from the loop's per-step CPU
generator, as the s1 / s2 trainers'.

Data parallel (parallel/mesh.py): each rank accumulates its own gradients;
the buffer is summed over the ranks only when the update is applied (the
CE is a sum over every position of the global batch, so its gradient is
the ranks' sum, not their mean). The loss is summed and the accuracy
divides by the global count into the metrics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from megatts2_hierspeechpp_torch.ar.scaled_adam import ScaledAdam
from megatts2_hierspeechpp_torch.ar.t2s import Text2Semantic
from megatts2_hierspeechpp_torch.nn.basic import dropout_masks
from megatts2_hierspeechpp_torch.parallel import mesh
from megatts2_hierspeechpp_torch.train.s2 import device_masks

BATCH_KEYS = ("x_ids", "x_lens", "y_ids", "y_lens", "bert_feature")


@dataclass
class ARTrainState:
    """The model (a training build), its optimizer, the accumulation
    buffer (one tensor per optimized parameter), its count and the
    micro-step count."""

    model: Text2Semantic
    opt: ScaledAdam
    accum: List[torch.Tensor]
    accum_count: int = 0
    step: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "opt": self.opt.state_dict(), "accum": self.accum,
                "accum_count": self.accum_count}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.accum_count = int(state["accum_count"])
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["opt"])
        for a, s in zip(self.accum, state["accum"]):
            a.copy_(s)


def create_state(model: Text2Semantic, opt: ScaledAdam) -> ARTrainState:
    return ARTrainState(model, opt, [torch.zeros_like(p) for p in opt.params])


class TrainStep:
    """One micro-step (the JAX make_train_step):
    `step(state, batch, generator)` -> (state, metrics loss/t2s, acc/t2s)."""

    def __init__(self, grad_accum: int = 1):
        self.grad_accum = grad_accum

    def __call__(self, state: ARTrainState, batch: Dict,
                 generator: torch.Generator):
        with mesh.global_batch():
            return self._step(state, batch, generator)

    def _step(self, state: ARTrainState, batch: Dict,
              generator: torch.Generator):
        model, opt = state.model, state.opt
        masks = device_masks(generator, batch["x_ids"].device)
        model.train()
        for p in opt.params:
            p.grad = None
        with dropout_masks(masks):
            out = model(*(batch[k] for k in BATCH_KEYS))
        out["loss"].backward()
        with torch.no_grad():
            for a, p in zip(state.accum, opt.params):
                if p.grad is not None:
                    a.add_(p.grad)
            state.accum_count += 1
            if state.accum_count >= self.grad_accum:
                # the CE is a sum over the batch: the global gradient is the
                # sum of the ranks', reduced once, when the update is made
                accum = mesh.all_sum(state.accum)
                opt.step([a / self.grad_accum for a in accum])
                for a in state.accum:
                    a.zero_()
                state.accum_count = 0
        state.step += 1
        metrics = mesh.reduce_metrics({"loss/t2s": out["loss"],
                                       "acc/t2s": out["acc"]}, average=False)
        return state, {k: v.detach() for k, v in metrics.items()}
