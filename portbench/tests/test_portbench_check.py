"""The comparison that decides `correct`, held to its purpose: a clean run
of the harness at small sizes on the CPU is correct, and each fault a
served TTS cell can have, planted in the program underneath the timed
path, makes it false. On the card, the control (the reference in the next
lower precision in the program's place) must fail a limit."""
from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch

import megatts2_hierspeechpp_torch.infer.pipeline as pipeline_mod
import megatts2_hierspeechpp_torch.models.plm as plm_mod
from megatts2_hierspeechpp_torch.models.ttv import TTVModel
from megatts2_hierspeechpp_torch.nn.duration import DurationPredictor
from portbench.harness import cell, check
from portbench.reference.precision import control
from portbench.tests import small

ROOT = Path(__file__).resolve().parents[1]
SEED = 3 * 2 ** 31 + 17


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_clean_run_is_correct():
    res = cell.run(small.workload("open"), SEED, 2.0, False, device="cpu",
                   cfg=small.config(), spec=small.traffic("open"))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 4


def test_clean_run_at_16k_is_correct():
    """A mix at the vocoder's own 16 kHz: no SpeechSR on either side."""
    spec = small.traffic("open")
    spec["output_sr"] = 16000
    res = cell.run(small.workload("open"), SEED + 1, 2.0, False, device="cpu",
                   cfg=small.config(), spec=spec)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["rows"]
    assert all(len(r["wav"]) == 320 * r["call"]["frames"][r["index"]] for r in res["rows"])


def _plant_mixed_batch_duration(monkeypatch) -> dict:
    """The duration predictor's durations scaled by 1.1 (its log output
    plus log 1.1), only inside tts_batch calls whose rows have several
    voices: the rows of the window's mixed-voice calls and nothing else."""
    state = {"on": False, "fired": 0}
    batch, forward = pipeline_mod.TTSPipeline.tts_batch, DurationPredictor.forward

    def tts_batch(self, texts, *a, prompts=None, **kw):
        state["on"] = prompts is not None and len({id(p) for p in prompts}) > 1
        try:
            return batch(self, texts, *a, prompts=prompts, **kw)
        finally:
            state["on"] = False

    def scaled(self, *a, **kw):
        logw = forward(self, *a, **kw)
        if state["on"]:
            state["fired"] += 1
            return logw + math.log(1.1)
        return logw

    monkeypatch.setattr(pipeline_mod.TTSPipeline, "tts_batch", tts_batch)
    monkeypatch.setattr(DurationPredictor, "forward", scaled)
    return state


def test_a_duration_fault_in_mixed_voice_batches_makes_the_run_incorrect(monkeypatch):
    state = _plant_mixed_batch_duration(monkeypatch)
    spec = small.traffic("open")
    # two voices, evenly drawn, of one padded prompt length: the requests
    # queued behind the first call go out as one call of both voices
    spec.update(voice_zipf_s=0, prompt_s=[1.2, 1.6])
    res = cell.run(small.workload("open"), SEED, 2.0, False, device="cpu",
                   cfg=small.config(), spec=spec)
    mixed = [c for c in res["calls"] if len({v for _, v in c.keys}) > 1]
    assert state["fired"] and mixed     # the fault sat on the window's path
    assert res["checks"]["code_gap"]["value"] <= res["checks"]["code_gap"]["limit"]
    assert not res["correct"], res["checks"]
    assert res["checks"]["dur_err"]["value"] > res["checks"]["dur_err"]["limit"]


def _altered_code(fn):
    def wrapped(*a, **kw):
        codes = fn(*a, **kw)
        codes = codes.clone()
        codes[0, 2] = (codes[0, 2] + 1) % 1024
        return codes
    return wrapped


def _altered_duration(fn):
    def wrapped(self, *a, **kw):
        x, g, x_mask, dur = fn(self, *a, **kw)
        dur = dur.clone()
        dur[:, 1] += 1
        return x, g, x_mask, dur
    return wrapped


def _altered_answer(fn):
    def wrapped(wav):
        out = fn(wav)
        out[len(out) // 2:] *= 0.98
        return out
    return wrapped


def _half_batch(fn):
    def wrapped(self, texts, *a, **kw):
        out = fn(self, texts, *a, **kw)
        return out[:max(1, len(out) // 2)]
    return wrapped


@pytest.mark.parametrize("fault", ["code", "duration", "answer", "half_batch"])
def test_each_fault_makes_the_run_incorrect(monkeypatch, fault):
    if fault == "code":
        monkeypatch.setattr(plm_mod, "plm_decode_greedy",
                            _altered_code(plm_mod.plm_decode_greedy))
    elif fault == "duration":
        monkeypatch.setattr(TTVModel, "_durations",
                            _altered_duration(TTVModel._durations))
    elif fault == "answer":
        monkeypatch.setattr(pipeline_mod, "_peak_normalise",
                            _altered_answer(pipeline_mod._peak_normalise))
    else:
        monkeypatch.setattr(pipeline_mod.TTSPipeline, "tts_batch",
                            _half_batch(pipeline_mod.TTSPipeline.tts_batch))
    cfg = small.config()
    spec = small.traffic("open")
    if fault == "half_batch":
        spec["drain_s"] = 20.0
    res = cell.run(small.workload("open"), SEED, 2.0, False, device="cpu",
                   cfg=cfg, spec=spec)
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_name", ["megatts2_hsp_48k_f32", "megatts2_hsp_48k_bf16"])
def test_control_fails_a_limit_on_the_card(cfg_name):
    """A short run of the full-width configuration on the card, its rows
    judged (within the limits), then the reference in the next lower
    precision in the program's place (outside them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = json.loads((ROOT / "configs" / f"{cfg_name}.json").read_text())
    spec = small.traffic("open")
    spec.update(calibration={"texts": 2, "seconds": 10.0, "frames": 500, "tol": 0.02},
                speech_s={"dist": "uniform", "min": 3.0, "max": 6.0},
                prompt_s=[3.0, 5.0], check_rows=2)
    res = cell.run(small.workload("open"), SEED, 2.0, False, device="cuda",
                   cfg=cfg, spec=spec)
    assert res["correct"], res["checks"]
    nums = check.control_numbers(res["ref"], res["dur_rows"], res["rows"], res["prompts"],
                                 res["length_scale"], res["req_seed"],
                                 cfg["dur_err_quantile"], control(cfg))
    assert any(nums[k] > cfg["limits"][k] for k in nums), nums
