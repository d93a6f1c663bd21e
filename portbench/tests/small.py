"""Small sizes for the CPU tests: the configuration files' models cut in
depth and, where the port's constructors take them, in width, and a
traffic mix of a few short requests."""
from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def config(name: str = "megatts2_hsp_48k_f32") -> dict:
    cfg = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["ttv"].update(text_layers=1, mel_enc_layers=1, w2v_enc_layers=1,
                      w2v_dec_layers=2)
    cfg["plm"].update(n_layers=1)
    cfg["vocoder"].update(inter_channels=32, hidden_channels=32,
                          upsample_initial_channel=64, posterior_wn_layers=4,
                          n_flows=1, flow_layers=1)
    cfg["speechsr"].update(upsample_initial_channel=8)
    cfg["max_batch"] = 4
    return cfg


def traffic(kind: str = "open") -> dict:
    spec = {"kind": kind, "rate_rps": 2.0, "clients": 3, "expected_rps": 2.0,
            "speech_s": {"dist": "uniform", "min": 0.6, "max": 1.4},
            "voices": 2, "prompt_s": [1.0, 2.0], "voice_zipf_s": 1.1,
            "syllables_per_s": 5.18, "phrase_syllables": 8, "output_sr": 48000,
            "calibration": {"texts": 2, "seconds": 2.0, "frames": 100, "tol": 0.02},
            "warmup": [[2, 1.0]], "check_rows": 3, "dur_rows": 4,
            "trace_s": 1.0, "drain_s": 300.0}
    return spec


def workload(kind: str = "open") -> dict:
    e2e = [{"name": "setup_s", "unit": "s"},
           ({"name": "latency_p95_ms", "unit": "ms"} if kind == "open"
            else {"name": "audio_s_per_s", "unit": "audio-s/s"})]
    return {"name": "small", "config": "megatts2_hsp_48k_f32", "traffic": "small",
            "chips": 1, "end_to_end": e2e,
            "per_layer": [{"name": "server.rows_per_call.serve", "unit": "rows"},
                          {"name": "mfu.serve", "unit": "%"}]}
