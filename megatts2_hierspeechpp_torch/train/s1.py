"""s1-stage (prosody LM) trainer.

Counterpart of `megatts2_hierspeechpp_tpu/train/s1.py` (reference
train_ms_s1.py:213-295): the frozen s2 acoustic model extracts the
frame-level text latents and the prosody-code targets of each batch
(`TTVModel.extract_tc_latent_code`, no gradient, no dropout), then the PLM
takes one cross-entropy step (summed NLL, go token 1024) with AdamW.

The dropout masks come from a generator on the batch's device seeded by one
draw from the loop's per-step CPU generator (`TrainStep.draw`);
`TrainStep.with_draws` takes a MaskSource from outside (the tests feed the
JAX step's masks). The frozen TTV and the PLM compute in their own `dtype`
(bf16 from cli/train_s1 by default): the TTV hands the PLM a bf16 latent,
the loss is float32, the parameters and AdamW moments float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from megatts2_hierspeechpp_torch.models.plm import ProsodyLM
from megatts2_hierspeechpp_torch.models.ttv import TTVModel
from megatts2_hierspeechpp_torch.nn.basic import MaskSource, dropout_masks
from megatts2_hierspeechpp_torch.train.optim import AdamW
from megatts2_hierspeechpp_torch.train.s2 import device_masks, global_norm

EXTRACT_INPUTS = ("x_ids", "tone", "language", "x_lengths", "mel",
                  "mel_lengths", "dur", "mrte_mel", "mrte_mel_lengths")


@dataclass
class S1TrainState:
    """The PLM (a training build), its optimizer, the frozen s2 model (a
    serving build) and the step count. The checkpoint holds the PLM and its
    optimizer; the frozen TTV is loaded from the s2 run each time (the JAX
    state carries it in its checkpoint too)."""

    plm: ProsodyLM
    opt: AdamW
    ttv: TTVModel
    step: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "plm": self.plm.state_dict(),
                "opt": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.plm.load_state_dict(state["plm"])
        self.opt.load_state_dict(state["opt"])


def create_state(plm: ProsodyLM, ttv: TTVModel, **adamw_kwargs) -> S1TrainState:
    return S1TrainState(plm, AdamW(plm.parameters(), **adamw_kwargs), ttv)


def extract(ttv: TTVModel, batch: Dict):
    """(x_frame (B, T, 256), frame-rate code targets (B, T)) from the
    frozen s2 model."""
    with torch.no_grad():
        return ttv.extract_tc_latent_code(*(batch[k] for k in EXTRACT_INPUTS))


class TrainStep:
    """The s1 train step (the JAX make_train_step);
    `step(state, batch, generator)` -> (state, metrics): loss/plm (NLL per
    valid frame), acc/plm_top10, grad_norm."""

    def __call__(self, state: S1TrainState, batch: Dict,
                 generator: torch.Generator):
        return self.with_draws(state, batch, self.draw(batch, generator))

    def draw(self, batch: Dict, generator: torch.Generator) -> MaskSource:
        return device_masks(generator, batch["mel"].device)

    def with_draws(self, state: S1TrainState, batch: Dict, masks: MaskSource):
        x_frame, lr_codes = extract(state.ttv, batch)
        state.plm.train()
        with dropout_masks(masks):
            out = state.plm.loss_dict(x_frame, lr_codes, batch["mel_lengths"])
        state.opt.zero_grad()
        out["loss"].backward()
        grad_norm = global_norm(state.opt.params)
        state.opt.step()
        state.step += 1
        metrics = {"loss/plm": out["loss_log"], "acc/plm_top10": out["acc"],
                   "grad_norm": grad_norm}
        return state, {k: v.detach() for k, v in metrics.items()}
