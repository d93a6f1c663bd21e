"""A serving TTSPipeline from the port's own training runs.

Counterpart of `megatts2_hierspeechpp_tpu/infer/from_training.py`. The
port's training CLIs write `<run>/config.json` and torch.save checkpoints
under `<run>/ckpt/step_XXXXXXXX` (train/checkpoints.py); this module takes
the serving models out of the latest ones:

  - an s2 run (cli/train_s2)       -> the TTV       (state["ttv"])
  - an s1 run (cli/train_s1)       -> the PLM       (state["plm"])
  - a vocoder run (cli/train_vocoder) -> the vocoder (state["gen"],
    its training-only members dropped: serving_state_dict)
  - SpeechSR: a cli/train_sr run (state["gen"]) or a reference .pth

The models are rebuilt as the training CLIs build them, from each run's
saved config (the depth keys of the TTV, the PLM and the vocoder), so the
state_dicts line up by construction. Parameters are float32 whatever the
run trained in; `dtype` is the serving compute dtype (None: float32). There
is no AOT directory: the port has no compiled stages yet.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.infer.pipeline import (
    TTSPipeline,
    load_speechsr,
    speechsr_from_state_dict,
)
from megatts2_hierspeechpp_torch.models.plm import ProsodyLM
from megatts2_hierspeechpp_torch.models.ttv import build_ttv
from megatts2_hierspeechpp_torch.models.vocoder import (
    HierVocoder,
    serving_state_dict,
    vocoder_kwargs,
)
from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib
from megatts2_hierspeechpp_torch.utils.config import load_hparams


def _raw(run_dir: str, step: Optional[int] = None) -> dict:
    state = ckpt_lib.restore_raw(os.path.join(run_dir, "ckpt"), step)
    if state is None:
        raise FileNotFoundError(f"no checkpoint under {run_dir}/ckpt")
    return state


def _config(run_dir: str):
    return load_hparams(os.path.join(run_dir, "config.json"))


def build_pipeline_from_train_dirs(
        s2_dir: str, s1_dir: str, voc_dir: str,
        speechsr: Optional[str] = None, speechsr_rate: int = 48000,
        dtype=None, device: str | torch.device = "cuda") -> TTSPipeline:
    """A TTSPipeline from finished training-run directories: the latest
    checkpoint of each, on `device`. `speechsr` may be a cli/train_sr run
    directory or a reference .pth checkpoint; None serves 16 kHz only."""
    dev = resolve_device(device)
    s2_hps = _config(s2_dir)
    ttv = build_ttv(s2_hps, "cpu", s2_hps.train.seed, train=False, dtype=dtype)
    ttv.load_state_dict(_raw(s2_dir)["ttv"], strict=True)

    s1_hps = _config(s1_dir)
    plm = ProsodyLM(n_layers=s1_hps.model.get("plm_layers", 4), device="cpu",
                    dtype=dtype)
    plm.load_state_dict(_raw(s1_dir)["plm"], strict=True)

    voc = HierVocoder(**vocoder_kwargs(_config(voc_dir)), device="cpu",
                      dtype=dtype)
    voc.load_state_dict(serving_state_dict(_raw(voc_dir)["gen"]), strict=True)

    sr = None
    if speechsr and os.path.isdir(speechsr):
        sr = speechsr_from_state_dict(_raw(speechsr)["gen"], speechsr_rate,
                                      dtype, dev)
    elif speechsr:
        sr = load_speechsr(speechsr, speechsr_rate, dtype, dev)
    return TTSPipeline(voc.to(dev), sr, dev, ttv=ttv.to(dev), plm=plm.to(dev))
