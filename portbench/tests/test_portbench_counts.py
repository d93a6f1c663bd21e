"""The work counts against torch's FlopCounterMode over the reference at a
small size, and against shapes worked by hand."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import work
from portbench.harness import traffic, weights
from portbench.reference.frontend import process_text
from portbench.reference.tts import Reference
from portbench.tests import small

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("frames", [40, 57])
def test_row_flops_match_flop_counter(frames):
    torch.set_num_threads(2)
    cfg = small.config()
    ref = Reference(cfg, weights.draw_all(cfg, 5, "cpu"), "cpu")
    rng = traffic.rng_for(5, 1)
    audio = traffic.prompt_audio(rng, 1.4, 130.0)
    text = traffic.tts_text(rng, 0.9, 5.18, 8)
    n = len(process_text(text)[0])
    ref.prompt(audio)                       # the prompt's mel: set-up, not counted
    dur = np.zeros(n, np.float32)
    dur[:] = (2 * frames) // n
    dur[:(2 * frames) % n] += 1             # sum 2 x frames: `frames` frames
    codes = rng.integers(0, cfg["plm"]["vq_bins"], frames)
    with FlopCounterMode(display=False) as fc:
        out = ref.row(text, audio, 1.0, 3, n, frames, 1, 0, dur, codes)
    assert out.frames == frames
    padded = (len(audio) // 16000 + 1) * 16000
    expect = work.row_flops(cfg, n, padded // 320, len(audio) // 320, frames)
    assert fc.get_total_flops() == expect


def test_decode_work_by_hand():
    plm = json.loads((ROOT / "configs" / "megatts2_hsp_48k_f32.json").read_text())["plm"]
    matrix, attn, nbytes = work.decode_work(plm, 1, 500)
    # d = 276, F = 1104: per layer 4 d^2 + 2 d F = 914,112 weights; the
    # head 276 x 1024 = 282,624; four layers
    weights_ = 4 * 914_112 + 282_624
    assert matrix == 500 * 2 * weights_
    assert attn == 4 * 2 * 276 * 500 * 501
    assert nbytes == 2 * weights_ + 500 * (4 * 256 + 4)
    # the port's table of kernels (PERF.md): 0.0122 ms at T = 500
    assert abs(work.decode_bound_s(plm, 1, 500) - 12.2e-6) < 0.1e-6


def test_one_snake_conv_launch_by_hand():
    first = work._block_launches(1, 1000, 64, 3, (1, 3, 5), 4, 4, 4)[0]
    # reads x (1000 x 64 float32), writes the conv's output, reads the
    # 3 x 64 x 64 float32 weights
    assert first == (2 * 1000 * 64 * 64 * 3, 58 * 1000 * 64,
                     1000 * 64 * 8 + 3 * 64 * 64 * 4)
    assert work.launch_bound_s(first, False) == pytest.approx(
        3 * 2 * 1000 * 64 * 64 * 3 / 495e12 + 58 * 1000 * 64 / 67e12)


def test_launch_count_per_call():
    """19 AA-snakes, 6 AMP blocks (36 launches) and 5 stages (18 + 1 each)
    a call: the port's kernel calls per request."""
    cfg = json.loads((ROOT / "configs" / "megatts2_hsp_48k_f32.json").read_text())
    launches = work.vocoder_launches(cfg, 2, 200, False)
    assert len(launches) == 19 + 6 * 6 + 5 * (18 + 1)
