"""Periodic-eval hooks of the s2 and s1 training CLIs.

Counterpart of `make_s2_eval_fn` / `make_s1_eval_fn` in
`megatts2_hierspeechpp_tpu/train/evalhooks.py` (reference evaluate() and its
TensorBoard images, train_ms.py:345-405): each hook runs on a fixed
held-out batch and returns scalars, which the loop logs under "eval/"; the
s2 hook also writes w2v and f0 PNGs into <model_dir>/eval/ when `plot`.
"""
from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch

from megatts2_hierspeechpp_torch.train.s1 import EXTRACT_INPUTS, extract


def _masked_l1(pred, target, mask):
    """mean |pred - target| over the mask broadcast to pred's shape."""
    mask = torch.broadcast_to(mask.to(pred.dtype), pred.shape)
    return ((pred - target).abs() * mask).sum() / mask.sum().clamp_min(1.0)


def _on(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def make_s2_eval_fn(eval_batch: Dict[str, np.ndarray],
                    plot: bool = True) -> Callable:
    """Inference from ground-truth durations (TTVModel.infer_gt_dur) on
    the held-out batch: scalars w2v_l1 and lf0_l1 (masked L1 of the w2v
    and of log(f0 + 1)); with `plot`, the predicted and true w2v of the
    first item and its f0 overlay as PNGs."""

    def eval_fn(state, step: int, model_dir: str) -> Dict[str, float]:
        ttv = state.ttv
        b = _on(eval_batch, next(ttv.parameters()).device)
        with torch.no_grad():
            w2v_pred, pred_lf0 = ttv.infer_gt_dur(*(b[k] for k in EXTRACT_INPUTS))
            t = b["w2v"].shape[1]
            w2v_mask = torch.arange(t, device=w2v_pred.device)[None] < \
                b["w2v_lengths"][:, None]
            l1_w2v = _masked_l1(w2v_pred, b["w2v"], w2v_mask[..., None])
            tp = b["pitch"].shape[1]
            p_mask = torch.arange(tp, device=w2v_pred.device)[None] < \
                b["pitch_lengths"][:, None]
            l1_lf0 = _masked_l1(pred_lf0, torch.log(b["pitch"] + 1.0), p_mask)
        if plot:
            from megatts2_hierspeechpp_torch.utils.plotting import (
                save_f0_plot, save_spectrogram_plot)

            out = os.path.join(model_dir, "eval")
            n0 = int(eval_batch["w2v_lengths"][0])
            save_spectrogram_plot(w2v_pred[0, :n0].cpu().numpy(),
                                  os.path.join(out, f"w2v_pred_{step}.png"),
                                  title=f"w2v pred @ step {step}")
            save_spectrogram_plot(eval_batch["w2v"][0, :n0],
                                  os.path.join(out, "w2v_gt.png"),
                                  title="w2v ground truth")
            p0 = int(eval_batch["pitch_lengths"][0])
            f0_p = np.exp(pred_lf0[0, :p0].cpu().numpy()) - 1.0
            save_f0_plot(eval_batch["pitch"][0, :p0], f0_p,
                         os.path.join(out, f"f0_{step}.png"))
        return {"w2v_l1": float(l1_w2v), "lf0_l1": float(l1_lf0)}

    return eval_fn


def make_s1_eval_fn(eval_batch: Dict[str, np.ndarray]) -> Callable:
    """The PLM's held-out NLL per frame and top-10 accuracy, without
    dropout: scalars plm_loss and plm_acc_top10."""
    def eval_fn(state, step: int, model_dir: str) -> Dict[str, float]:
        b = _on(eval_batch, next(state.plm.parameters()).device)
        x_frame, lr_codes = extract(state.ttv, b)
        with torch.no_grad():  # no MaskSource is active: no dropout
            out = state.plm.loss_dict(x_frame, lr_codes, b["mel_lengths"])
        return {"plm_loss": float(out["loss_log"]),
                "plm_acc_top10": float(out["acc"])}

    return eval_fn
