#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (megatts2_hierspeechpp_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and report seconds;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it, with CUDA-event timings of both and
     two bounds (3xTF32 tensor cores, and float32 CUDA cores only); then
     one snake_conv launch at every distinct (C, T, k, d) of a 500-frame
     request, beside a cuDNN conv1d of the same conv (the conv alone), and
     their sum per request; the PLM decode kernel at full width (d 276, 4
     layers, 1024 bins) at T = 500, 1 and 37, its codes held by the
     teacher-forced check;
  4. the decode half (`synthesize`) at the published HierSpeech++ widths
     with seeded random weights: one 3 s prompt, three requests of
     100/250/500 frames (2/5/10 s) through vocoder + SpeechSR-48k, checking
     each output and the per-request kernel call counts (every shape is
     warmed up first);
  5. the whole zero-shot path (`tts`: text -> TTV -> PLM greedy decode ->
     w2v / f0 -> vocoder -> SpeechSR-48k) at the published widths: the same
     prompt and three Mandarin texts of 2/5/10 s at a read-speech syllable
     rate, whose length_scale is chosen by the duration pre-pass to land
     near 100/250/500 frames; each output, the kernel calls (slice-1 counts
     plus one plm_decode), ms per request, and ms per stage from a second
     run of the public stages one by one under CUDA events;
  6. the 500-frame synthesize and tts requests under torch.profiler: device
     time by kernel group, the device's idle share, peak memory, the top
     kernels;
  7. the 100-frame synthesize and tts requests once more on the CPU (plain
     versions; the tts run takes the card's prosody codes), held against
     the card's waveform before peak normalisation.
Then one JSON line with every kernel's numbers, and last the device line.

Float32 throughout, TF32 off. Without CUDA it exits non-zero before
printing any result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

T_FRAMES = 500          # frames of the longest request; kernel shapes derive from it
REQUEST_FRAMES = (100, 250, 500)
EXPECTED_CALLS = {"aa_snakebeta": 19, "ampblock": 6, "amp_triple": 5,
                  "plm_decode": 0}
TTS_CALLS = dict(EXPECTED_CALLS, plm_decode=1)
PLM_T = (500, 1, 37)    # decode lengths of phase 3; the first is the main path's
TF_MARGIN = 1e-4        # teacher-forced gap, x max|logits|
PLM_REPEATS = 10        # launches at the main path's T that must give the same codes
# Mandarin read speech: 5.18 syllables/s (Pellegrino, Coupe & Marsico 2011,
# "A cross-language perspective on speech information rate", Language
# 87(3), Table 2); a prosodic phrase break ("sp") every 8 syllables
SYLLABLES_PER_S = 5.18
PHRASE_SYLLABLES = 8
CPU_TOL = 1e-3          # card vs CPU, 48 kHz waveform before normalisation
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM data sheet, non-tensor float32
TF32_FLOPS_PER_S = 495e12   # H100 SXM data sheet, dense TF32 tensor cores
TF32_PASSES = 3             # snake_conv's split-TF32 products per product
SNAKE_FLOPS = 58            # per element: 2 x 6-tap up, 2 snakes, 12-tap down
SOURCES = {
    "aa_snakebeta": ("megatts2_hierspeechpp_torch/csrc/aa_snake.cu",
                     "megatts2_hierspeechpp_tpu/ops/pallas_snake.py:93"),
    "ampblock": ("megatts2_hierspeechpp_torch/csrc/snake_conv.cu",
                 "megatts2_hierspeechpp_tpu/ops/pallas_ampblock.py:151"),
    "amp_triple": ("megatts2_hierspeechpp_torch/csrc/triple_epilogue.cu",
                   "megatts2_hierspeechpp_tpu/ops/pallas_amp_triple.py:60"),
    "plm_decode": ("megatts2_hierspeechpp_torch/csrc/plm_decode.cu",
                   "megatts2_hierspeechpp_tpu/ops/pallas_plm_decode.py:59"),
}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps runs, after 2 warm-ups."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(n_bytes: float, flops: float, conv_flops: float = 0.0):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    the operations, float32 flops on the CUDA cores plus conv products as
    TF32_PASSES tensor-core products each (snake_conv's split TF32)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S + TF32_PASSES * conv_flops / TF32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                      "operations")


def bound_ms_f32(n_bytes: float, flops: float, conv_flops: float = 0.0):
    """The same work with every flop on the float32 CUDA cores."""
    return 1e3 * max(n_bytes / HBM_BYTES_PER_S,
                     (flops + conv_flops) / F32_FLOPS_PER_S)


def block_flops(t: int, c: int, k: int):
    """(other flops, conv flops) of one AMPBlock (3 branches) on (1, t, c):
    6 snakes + bias and residual adds, and 6 convs."""
    return (3 * (2 * SNAKE_FLOPS * t * c + t * c),
            3 * 2 * 2.0 * t * c * c * k)


def kernel_phase(torch, dev):
    from megatts2_hierspeechpp_torch.ops.amp_triple import (
        composed_triple, fused_amp_triple)
    from megatts2_hierspeechpp_torch.ops.ampblock import (
        composed_ampblock, fused_ampblock)
    from megatts2_hierspeechpp_torch.ops.snake import (
        composed_snakebeta, fused_aa_snakebeta, inverse_beta)

    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def pos(*shape):
        return torch.exp(randn(*shape, scale=0.2))

    def block_ws(c, k):
        return (pos(3, c), pos(3, c), randn(3, k, c, c, scale=(c * k) ** -0.5),
                randn(3, c, scale=0.05), pos(3, c), pos(3, c),
                randn(3, k, c, c, scale=(c * k) ** -0.5), randn(3, c, scale=0.05))

    T = T_FRAMES
    dil = (1, 3, 5)
    cases = []  # (kernel, label, fused fn, plain fn, tol, bytes, flops, conv flops)
    for c in (256, 64):
        x, a, b = randn(1, 4 * T, c), pos(c), pos(c)
        ib = inverse_beta(b)  # once per weight, as the serving path does
        n = 4 * T * c
        cases.append(("aa_snakebeta", f"C={c} T={4 * T}",
                      lambda x=x, a=a, b=b, ib=ib: fused_aa_snakebeta(x, a, b, ib),
                      lambda x=x, a=a, b=b: composed_snakebeta(x, a, b),
                      1e-5, 4.0 * (2 * n + 2 * c), SNAKE_FLOPS * n, 0.0))
    # Generator stage 1 (C=128, 20T) and SourceNetwork stage 0 (C=128, 2T)
    for c, t, k in [(128, 20 * T, k) for k in (3, 7, 11)] + [
            (128, 2 * T, k) for k in (3, 5, 7)]:
        x, ws = randn(1, t, c), block_ws(c, k)
        cases.append(("ampblock", f"C={c} T={t} k={k}",
                      lambda x=x, ws=ws, k=k: fused_ampblock(x, *ws, k, dil),
                      lambda x=x, ws=ws, k=k: composed_ampblock(x, *ws, k, dil),
                      1e-4, 4.0 * (2 * t * c + 6 * k * c * c + 10 * c),
                      *block_flops(t, c, k)))
    for c, t, ks, tail in ((64, 4 * T, (3, 5, 7), False),
                           (64, 80 * T, (3, 7, 11), False),
                           (32, 160 * T, (3, 7, 11), False),
                           (16, 320 * T, (3, 7, 11), True),
                           (32, 960 * T, (3, 7, 11), True)):
        x = randn(1, t, c)
        bws = [block_ws(c, k) for k in ks]
        dils = (dil,) * 3
        post = (pos(c), pos(c), randn(7, c, scale=0.1 * (7 * c) ** -0.5)) if tail else None
        flops = sum(block_flops(t, c, k)[0] for k in ks) + 3.0 * t * c
        conv_flops = sum(block_flops(t, c, k)[1] for k in ks)
        if tail:
            flops += (SNAKE_FLOPS + 14) * t * c + t
        n_bytes = 4.0 * (t * c + (t if tail else t * c)
                         + sum(6 * k * c * c + 10 * c for k in ks))
        cases.append(("amp_triple",
                      f"C={c} T={t} ks={list(ks)}{' +tail' if tail else ''}",
                      lambda x=x, bws=bws, ks=ks, dils=dils, post=post:
                          fused_amp_triple(x, bws, ks, dils, post),
                      lambda x=x, bws=bws, ks=ks, dils=dils, post=post:
                          composed_triple(x, bws, ks, dils, post),
                      1e-4, n_bytes, flops, conv_flops))

    results = {}
    for name, label, fused, plain, tol, n_bytes, flops, conv_flops in cases:
        with torch.inference_mode():
            y = fused()
            ref = plain()
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            scale = ref.abs().max().item()
            ok = bool(math.isfinite(err) and err <= tol * scale)
            ms = time_ms(torch, fused, 10)
            plain_ms = time_ms(torch, plain, 5)
        b_ms, b_by = bound_ms(n_bytes, flops, conv_flops)
        line = {"phase": "kernel", "name": name, "shape": label,
                "max_abs_err": err, "max_abs_ref": scale,
                "tolerance": f"{tol:g} x max|ref|", "ok": ok, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bound_ms_f32": bound_ms_f32(n_bytes, flops, conv_flops)}
        print(json.dumps(line), flush=True)
        if not ok:
            fail(f"{name} {label}: max abs err {err} > {tol} x {scale}")
        results.setdefault(name, []).append(line)
    return results


# Every AMPBlock stage of a request of T_FRAMES frames: (stage, C, T / frames,
# kernel sizes). Each block is 6 snake_conv launches: d = 1, 3, 5, each
# followed by a d = 1 launch with the residual.
SNAKE_CONV_STAGES = (
    ("Generator stage 1", 128, 20, (3, 7, 11)),
    ("Generator stage 2", 64, 80, (3, 7, 11)),
    ("Generator stage 3", 32, 160, (3, 7, 11)),
    ("Generator stage 4", 16, 320, (3, 7, 11)),
    ("SourceNetwork stage 0", 128, 2, (3, 5, 7)),
    ("SourceNetwork stage 1", 64, 4, (3, 5, 7)),
    ("SpeechSR", 32, 960, (3, 7, 11)),
)


def snake_conv_phase(torch, dev):
    """One snake_conv launch at every distinct (C, T, k, d) of the request
    against its plain version, activation1d + conv1d_op (+ res), held to
    1e-4 x max|ref|; d = 1 with the residual, as the second conv of a branch
    runs. Beside it, one cuDNN conv1d of the same conv (TF32 off), which
    leaves out the snake: a yardstick for the conv alone, never called by
    the port. Per stage also the same launch with a one-tap conv (k = 1, a
    shape the path does not run): the snake, the staging and one tap, so
    the taps' share of each row is what remains. Last, the launches' sum
    per request."""
    import torch.nn.functional as F

    from megatts2_hierspeechpp_torch.nn.conv import conv1d_op
    from megatts2_hierspeechpp_torch.ops.ampblock import (
        snake_conv, snake_conv_tile)
    from megatts2_hierspeechpp_torch.ops.resample import activation1d

    gen = torch.Generator().manual_seed(1)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    tol = 1e-4
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_ms_f32": 0.0,
             "conv_only_library_ms": 0.0, "launches": 0}
    for stage, c, f, ks in SNAKE_CONV_STAGES:
        t = f * T_FRAMES
        x = randn(1, t, c)
        res = randn(1, t, c)
        a, ib = torch.exp(randn(c, scale=0.2)), torch.exp(randn(c, scale=0.2))
        w1, b1 = randn(1, c, c, scale=c ** -0.5), randn(c, scale=0.05)
        with torch.inference_mode():
            k1_ms = time_ms(torch, lambda: snake_conv(x, a, ib, w1, b1, 1), 10)
            s_ct = activation1d(  # the conv-only yardstick's input
                x, lambda v: v + torch.sin(v * a).square() * ib
            ).transpose(1, 2).contiguous()
        print(json.dumps({"phase": "snake_conv_k1", "stage": stage,
                          "shape": f"C={c} T={t} k=1 d=1", "ms": k1_ms}),
              flush=True)
        for k in ks:
            w = randn(k, c, c, scale=(c * k) ** -0.5)
            bias = randn(c, scale=0.05)
            wt = w.permute(1, 2, 0).contiguous()
            for d in (1, 3, 5):
                r = res if d == 1 else None
                pad = (k - 1) // 2 * d

                def fused(d=d, r=r, w=w, bias=bias):
                    return snake_conv(x, a, ib, w, bias, d, res=r)

                def plain(d=d, r=r, wt=wt, bias=bias, pad=pad):
                    y = activation1d(x, lambda v: v + torch.sin(v * a).square() * ib)
                    y = conv1d_op(y, wt, bias, 1, pad, d)
                    return y if r is None else y + r

                with torch.inference_mode():
                    y = fused()
                    ref = plain()
                    torch.cuda.synchronize()
                    err = (y - ref).abs().max().item()
                    scale = ref.abs().max().item()
                    ok = bool(math.isfinite(err) and err <= tol * scale)
                    ms = time_ms(torch, fused, 10)
                    plain_ms = time_ms(torch, plain, 5)
                    conv_ms = time_ms(torch, lambda: F.conv1d(
                        s_ct, wt, bias, 1, pad, d), 5)
                n_io = 3 if r is not None else 2
                n_bytes = 4.0 * (n_io * t * c + k * c * c + 3 * c)
                flops = SNAKE_FLOPS * t * c + (n_io - 1) * t * c
                conv_flops = 2.0 * t * c * c * k
                b_ms, b_by = bound_ms(n_bytes, flops, conv_flops)
                tm, tn = snake_conv_tile(1, t, c, k, d)
                line = {"phase": "snake_conv", "stage": stage,
                        "shape": f"C={c} T={t} k={k} d={d}"
                                 f"{' +res' if r is not None else ''}",
                        "tile": f"{tm}x{tn}", "max_abs_err": err,
                        "max_abs_ref": scale,
                        "tolerance": f"{tol:g} x max|ref|", "ok": ok,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by,
                        "bound_ms_f32": bound_ms_f32(n_bytes, flops, conv_flops),
                        "conv_only_library_ms": conv_ms}
                print(json.dumps(line), flush=True)
                if not ok:
                    fail(f"snake_conv {stage} {line['shape']}: max abs err "
                         f"{err} > {tol} x {scale}")
                # per block: d = 1 (no res) once, d = 1 + res three times,
                # d = 3 and d = 5 once; the row with res stands for the d = 1
                # launches
                n = 4 if d == 1 else 1
                for key in ("ms", "plain_ms", "bound_ms", "bound_ms_f32",
                            "conv_only_library_ms"):
                    total[key] += n * line[key]
                total["launches"] += n
    print(json.dumps({"phase": "snake_conv_per_request", "frames": T_FRAMES,
                      **total}), flush=True)


def plm_work(model, t: int):
    """(bytes, flops) of one greedy decode of t tokens: every weight and the
    input latent read once, the codes written once; 2 flops per weight of
    every matrix per token, plus q.k and p.v over the cache."""
    n_bytes = 4.0 * (sum(p.numel() for p in model.parameters()) + t * 256 + t)
    mats = sum(p.numel() for n, p in model.named_parameters()
               if p.dim() == 2 and not n.startswith("pc_embedding"))
    d, n_layers = model.predict_layer.weight.shape[1], len(model.plm.layers)
    return n_bytes, 2.0 * mats * t + n_layers * 4.0 * d * t * (t + 1) / 2


def plm_split(torch, w, tc, go_id: int) -> dict:
    """Where one decode's time goes, at the main path's T, from block 0's
    stamps in one launch (SM cycles, converted to time by %globaltimer over
    the whole launch): us per token, and per phase letter (A-E, mean over
    the layers, then the logits) the mean us from holding the phase's inputs
    to holding its successor's ("phase_us"), split into block 0's own work
    up to its last publish ("work_us") and its wait for the rest
    ("wait_us"). Beside them the single-counter grid barrier that the
    decode kernel used before its handoffs carried flags, alone: (5L + 1) x
    T barriers in one launch of the same grid, in us per barrier."""
    from megatts2_hierspeechpp_torch.ops.plm_decode import (
        barrier_probe, phase_stamps)

    t = tc.shape[1]
    with torch.inference_mode():
        _, stamps = phase_stamps(w, tc, go_id)
        torch.cuda.synchronize()
    st = stamps.cpu().numpy().astype(np.float64)  # (T, phases, 3)
    per = st.shape[1]
    pub, ready = st[..., 0].reshape(-1), st[..., 1].reshape(-1)
    # %globaltimer at the logits of every token: cycles -> us over the launch
    us_per_cycle = ((st[-1, -1, 2] - st[0, -1, 2])
                    / (st[-1, -1, 1] - st[0, -1, 1]) / 1e3)
    # tokens 1..T-1: phase k runs from ready[k - 1] to ready[k]
    total = (ready[per:] - ready[per - 1:-1]).reshape(t - 1, per) * us_per_cycle
    work = (pub[per:] - ready[per - 1:-1]).reshape(t - 1, per) * us_per_cycle
    n_layers = (per - 1) // 5

    def by_letter(d):
        out = {k: float(d[:, [5 * i + j for i in range(n_layers)]].mean())
               for j, k in enumerate("ABCDE")}
        out["logits"] = float(d[:, -1].mean())
        return out

    n_bar = per * t
    bar_ms = time_ms(torch, lambda: barrier_probe(n_bar, tc.device), 3)
    return {"us_per_token": float(total.sum(1).mean()),
            "sm_clock_mhz": 1.0 / us_per_cycle,
            "phase_us": by_letter(total), "work_us": by_letter(work),
            "wait_us": by_letter(total - work),
            "old_barrier_us": 1e3 * bar_ms / n_bar,
            "old_barriers_per_token": per}


def plm_phase(torch, dev):
    """The decode kernel against the plain greedy loop at the published
    width. A near-tie flip changes every later step, so the fail condition
    is the teacher-forced check: under the plain forward on [go, codes[:-1]],
    each of the kernel's codes has a logit within TF_MARGIN x max|logits| of
    its row's max. Exact agreement with the plain decode is reported."""
    from megatts2_hierspeechpp_torch.models.plm import (
        ProsodyLM, teacher_forced_gap)
    from megatts2_hierspeechpp_torch.ops.plm_decode import (
        plain_decode, plm_decode_greedy)

    model = ProsodyLM(seed=99, device=dev)
    w = model.packed()
    gen = torch.Generator().manual_seed(5)
    lines = []
    for t in PLM_T:
        tc = torch.randn(1, t, 256, generator=gen).to(dev)
        with torch.inference_mode():
            codes = plm_decode_greedy(w, tc, model.go_id)
            ref = plain_decode(w, tc, model.go_id)
            gap, scale = teacher_forced_gap(model, tc, codes)
            agree = (codes == ref).float().mean().item()
            ms = time_ms(torch, lambda: plm_decode_greedy(w, tc, model.go_id), 5)
            plain_ms = time_ms(torch, lambda: plain_decode(w, tc, model.go_id),
                               2 if t > 100 else 5)
        ok = bool(math.isfinite(gap) and gap <= TF_MARGIN * scale
                  and codes.shape == (1, t)
                  and bool(((codes >= 0) & (codes < 1024)).all()))
        b_ms, b_by = bound_ms(*plm_work(model, t))
        line = {"phase": "kernel", "name": "plm_decode",
                "shape": f"T={t} d=276 L=4 H=4 F=1104 bins=1024",
                "max_abs_err": gap, "max_abs_ref": scale,
                "tolerance": f"teacher-forced gap <= {TF_MARGIN:g} x max|logits|",
                "agreement_with_plain": agree, "ok": ok, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bound_ms_weights_per_token": 1e3 * t * 4.0 * sum(
                    p.numel() for p in model.parameters()) / HBM_BYTES_PER_S}
        if t == PLM_T[0]:
            line["split"] = plm_split(torch, w, tc, model.go_id)
            with torch.inference_mode():
                reps = [plm_decode_greedy(w, tc, model.go_id)
                        for _ in range(PLM_REPEATS)]
            same = sum(bool(torch.equal(r, codes)) for r in reps)
            line["repeats_identical"] = f"{same}/{PLM_REPEATS}"
            if same != PLM_REPEATS:
                print(json.dumps(line), flush=True)
                fail(f"plm_decode T={t}: {PLM_REPEATS - same} of {PLM_REPEATS} "
                     "repeated launches gave other codes")
        print(json.dumps(line), flush=True)
        if not ok:
            fail(f"plm_decode T={t}: teacher-forced gap {gap} > {TF_MARGIN} x {scale}")
        lines.append(line)
    return lines


def request_inputs(t: int):
    """w2v ~ N(0, 1) (1, T, 1024) and a 100-250 Hz log-f0 contour at 4T."""
    rng = np.random.default_rng(t)
    w2v = rng.standard_normal((1, t, 1024)).astype(np.float32)
    n = 4 * t
    f0 = 175.0 + 75.0 * np.sin(2 * np.pi * np.arange(n) / n * 3.0)
    lf0 = np.log(f0).astype(np.float32)[None]
    return w2v, np.ones((1, t, 1), np.float32), lf0


def prompt_audio() -> np.ndarray:
    """Synthetic 3 s, 16 kHz prompt: a gliding harmonic tone plus noise."""
    rng = np.random.default_rng(7)
    n = 3 * 16000
    t = np.arange(n) / 16000.0
    f = 120.0 + 40.0 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f) / 16000.0
    y = sum(0.2 / h * np.sin(h * phase) for h in range(1, 6))
    y = y + 0.01 * rng.standard_normal(n)
    return y.astype(np.float32)


def build_pipeline(torch, device):
    from megatts2_hierspeechpp_torch.data import text as frontend
    from megatts2_hierspeechpp_torch.infer.pipeline import TTSPipeline
    from megatts2_hierspeechpp_torch.models.plm import ProsodyLM
    from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR
    from megatts2_hierspeechpp_torch.models.ttv import TTVModel
    from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder

    # configs/hierspeechpp.json widths: HierVocoder defaults; SpeechSR-48k;
    # TTVModel and ProsodyLM defaults (the reference's depths and widths)
    voc = HierVocoder(seed=1234, device=device)
    sr = SpeechSR(upsample_initial_channel=32, rate_num=3, rate_den=1,
                  seed=4321, device=device)
    ttv = TTVModel(n_vocab=frontend.N_VOCAB, n_tone=frontend.N_TONE,
                   n_language=frontend.N_LANGUAGE, seed=2345, device=device)
    plm = ProsodyLM(seed=3456, device=device)
    return TTSPipeline(voc, sr, device, ttv=ttv, plm=plm)


def path_phase(torch, dev):
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    pipe = build_pipeline(torch, dev)
    audio = prompt_audio()
    prompt = pipe.prepare_prompt(audio)
    inputs = {t: request_inputs(t) for t in REQUEST_FRAMES}

    def run(t):
        w2v, mask, lf0 = (torch.from_numpy(a) for a in inputs[t])
        return pipe.synthesize(prompt, w2v, mask, lf0, output_sr=48000)

    for t in REQUEST_FRAMES:  # warm-up of every shape (cuDNN plans, allocator)
        run(t)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    before = dict(cuda_lib.LAUNCHES)
    for t in REQUEST_FRAMES:
        t0 = time.perf_counter()
        out = run(t)  # ends with a device-to-host copy
        ms = 1e3 * (time.perf_counter() - t0)
        counts = {k: cuda_lib.LAUNCHES[k] - before[k] for k in before}
        before = dict(cuda_lib.LAUNCHES)
        peak = float(np.abs(out).max())
        line = {"phase": "request", "frames": t, "samples": int(out.shape[0]),
                "ms": ms, "audio_s_per_s": (out.shape[0] / 48000) / (ms / 1e3),
                "peak": peak, "calls": counts}
        print(json.dumps(line), flush=True)
        if out.shape != (960 * t,):
            fail(f"request T={t}: {out.shape[0]} samples, expected {960 * t}")
        if not np.isfinite(out).all():
            fail(f"request T={t}: non-finite output")
        if abs(peak - 0.999) > 1e-5:
            fail(f"request T={t}: peak {peak}, expected 0.999")
        if counts != EXPECTED_CALLS:
            fail(f"request T={t}: kernel calls {counts}, expected {EXPECTED_CALLS}")
    return dict(cuda_lib.LAUNCHES), pipe, prompt, audio, inputs


def tts_text(rng, seconds: float) -> str:
    """Seeded Mandarin phone string of `seconds` of read speech: syllables
    (initial + toned final) at SYLLABLES_PER_S, two-syllable words ("#1",
    stripped by the frontend), an "sp" phrase break every PHRASE_SYLLABLES
    syllables, "sil" at both ends."""
    from megatts2_hierspeechpp_torch.data.text import FINALS, INITIALS

    n_syl = round(seconds * SYLLABLES_PER_S)
    words = []
    for i in range(n_syl):
        if i and i % PHRASE_SYLLABLES == 0:
            words.append("sp")
        elif i and i % 2 == 0:
            words.append("#1")
        words.append(f"{rng.choice(INITIALS)} {rng.choice(FINALS)}"
                     f"{rng.integers(1, 6)}")
    return "sil " + " ".join(words) + " sil"


def tts_requests(pipe, prompt):
    """Three texts of 2/5/10 s of speech (tts_text), each with the
    length_scale that the duration pre-pass puts within 5 % of its target
    frame count (bisection on a log scale)."""
    rng = np.random.default_rng(11)
    reqs = []
    for f in REQUEST_FRAMES:
        text = tts_text(rng, f / 50)
        lo, hi = 0.02, 50.0
        for _ in range(40):
            ls = math.sqrt(lo * hi)
            n = pipe.duration(text, prompt, ls)
            if abs(n - f) <= 0.05 * f:
                break
            lo, hi = (ls, hi) if n < f else (lo, ls)
        else:
            fail(f"no length_scale gives {f} frames (last {n} at {ls})")
        reqs.append((f, text, ls, n))
    return reqs


def event_ms(torch, fn):
    """(fn(), its ms between CUDA events), the device idle at the start and
    synchronised at the end."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def tts_stages(torch, pipe, prompt, text, ls):
    """ms of each stage of one tts request, the public stages called one by
    one as `tts` calls them: duration pre-pass, acoustic (of which the PLM
    decode, timed alone on the same latent), vocoder (render at 16 kHz) and
    SpeechSR on its output."""
    from megatts2_hierspeechpp_torch.models.plm import decode

    ms = {}
    n, ms["duration_ms"] = event_ms(torch, lambda: pipe.duration(text, prompt, ls))
    ac, ms["acoustic_ms"] = event_ms(torch, lambda: pipe.acoustic(text, prompt, n, ls))
    _, ms["decode_ms"] = event_ms(torch, lambda: decode(pipe.plm, ac.x_frame))
    wav, ms["vocode_ms"] = event_ms(torch, lambda: pipe.render(
        prompt, ac.w2v, ac.frame_mask, ac.lf0, output_sr=16000))
    with torch.inference_mode():
        _, ms["sr_ms"] = event_ms(torch, lambda: pipe.speechsr(wav[None, :, None]))
    return ms


def tts_phase(torch, pipe, prompt):
    """The whole zero-shot path, three requests near 100/250/500 frames, each
    shape warmed up first; then each request's stages timed one by one."""
    from megatts2_hierspeechpp_torch.data.text import process_text
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    reqs = tts_requests(pipe, prompt)
    for _, text, ls, _ in reqs:
        pipe.tts(text, prompt=prompt, length_scale=ls, output_sr=48000)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    before = dict(cuda_lib.LAUNCHES)
    lines = []
    for f, text, ls, n in reqs:
        t0 = time.perf_counter()
        out = pipe.tts(text, prompt=prompt, length_scale=ls, output_sr=48000)
        ms = 1e3 * (time.perf_counter() - t0)  # ends with a device-to-host copy
        counts = {k: cuda_lib.LAUNCHES[k] - before[k] for k in before}
        before = dict(cuda_lib.LAUNCHES)
        peak = float(np.abs(out).max())
        line = {"phase": "tts", "target_frames": f, "frames": n,
                "phones": len(process_text(text)[0]),
                "syllables_per_s": SYLLABLES_PER_S, "length_scale": ls,
                "samples": int(out.shape[0]), "ms": ms,
                "audio_s_per_s": (out.shape[0] / 48000) / (ms / 1e3),
                "peak": peak, "calls": counts}
        lines.append(line)
        problem = (
            f"{n} frames, outside 10 % of {f}" if abs(n - f) > 0.1 * f else
            f"{out.shape[0]} samples, expected {960 * n}"
            if out.shape != (960 * n,) else
            "non-finite output" if not np.isfinite(out).all() else
            f"peak {peak}, expected 0.999" if abs(peak - 0.999) > 1e-5 else
            f"kernel calls {counts}, expected {TTS_CALLS}"
            if counts != TTS_CALLS else None)
        if problem:
            print(json.dumps(line), flush=True)
            fail(f"tts T={n}: {problem}")
    launches = dict(cuda_lib.LAUNCHES)
    for line, (_, text, ls, _) in zip(lines, reqs):
        line["stages_ms"] = tts_stages(torch, pipe, prompt, text, ls)
        print(json.dumps(line), flush=True)
    return launches, reqs


GROUPS = (  # (group, substrings of kernel names), first match wins
    ("plm_decode (ours)", ("plm_decode_kernel",)),
    ("aa_snakebeta (ours)", ("aa_snakebeta_kernel",)),
    ("snake_conv (ours)", ("snake_conv_kernel",)),
    ("triple_epilogue (ours)", ("triple_avg_kernel", "triple_post_kernel")),
    # cuDNN runs a small-batch LSTM as one cell kernel and one gemv per step
    ("LSTM cells + gemv", ("RNN", "rnn", "LSTM", "lstm", "gemv")),
    ("cuDNN/cuBLAS conv+gemm", ("conv", "cudnn", "xmma", "gemm", "sgemm",
                                "cutlass", "implicit")),
    ("fft", ("fft",)),
    ("memcpy/memset", ("memcpy", "memset", "Memcpy", "Memset")),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
)


def profile_phase(torch, label, frames, request):
    """Device time of one request by kernel group (torch.profiler), the
    device's idle share of the request's wall time, peak memory, and the 12
    kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms, n = per_name.get(ev.name, (0.0, 0))
            per_name[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
    groups = {}
    for name, (ms, n) in per_name.items():
        g = next((g for g, keys in GROUPS if any(k in name for k in keys)),
                 "other")
        groups[g] = groups.get(g, 0.0) + ms
    device_ms = sum(groups.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    line = {"phase": "profile", "path": label, "frames": frames,
            "wall_ms": wall_ms,
            "device_kernel_ms": device_ms if device_ms else "not measured",
            "device_idle_share": (1 - device_ms / wall_ms) if device_ms
            else "not measured",
            "kernel_launches": sum(n for _, n in per_name.values()),
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
            "top_kernels": [[name[:100], ms, n] for name, (ms, n) in top]}
    print(json.dumps(line), flush=True)


def cpu_phase(torch, pipe, cpu_pipe, prompt, cpu_prompt, inputs):
    t = REQUEST_FRAMES[0]
    w2v, mask, lf0 = (torch.from_numpy(a) for a in inputs[t])
    card = pipe.render(prompt, w2v, mask, lf0, output_sr=48000).cpu().numpy()
    cpu = cpu_pipe.render(cpu_prompt, w2v, mask, lf0, output_sr=48000).numpy()
    diff = float(np.abs(card - cpu).max())
    line = {"phase": "card_vs_cpu", "path": "synthesize", "frames": t,
            "max_abs_diff": diff,
            "max_abs_cpu": float(np.abs(cpu).max()), "tolerance": CPU_TOL}
    print(json.dumps(line), flush=True)
    if not diff <= CPU_TOL:
        fail(f"card vs CPU waveform differs by {diff} > {CPU_TOL}")


def cpu_tts_phase(torch, pipe, cpu_pipe, prompt, cpu_prompt, reqs):
    """The 100-frame tts request on the CPU with the card's prosody codes
    (a near-tie flip in the decode cannot fail it): the same frame count and
    the same waveform before normalisation. Also the share of the CPU plain
    decode's codes that equal the card kernel's."""
    from megatts2_hierspeechpp_torch.models.plm import decode

    _, text, ls, _ = reqs[0]
    _, ac, raw = pipe.tts(text, prompt=prompt, length_scale=ls,
                          output_sr=48000, return_intermediates=True)
    codes = ac.codes.cpu().numpy()
    _, cac, craw = cpu_pipe.tts(text, prompt=cpu_prompt, length_scale=ls,
                                output_sr=48000, codes=codes,
                                return_intermediates=True)
    agree = float((decode(cpu_pipe.plm, cac.x_frame).numpy() == codes).mean())
    if cac.frames != ac.frames:
        fail(f"tts card vs CPU: {ac.frames} vs {cac.frames} frames")
    card, cpu = raw.cpu().numpy(), craw.numpy()
    diff = float(np.abs(card - cpu).max())
    line = {"phase": "card_vs_cpu", "path": "tts", "frames": ac.frames,
            "max_abs_diff": diff, "max_abs_cpu": float(np.abs(cpu).max()),
            "tolerance": CPU_TOL, "cpu_plain_decode_agreement": agree}
    print(json.dumps(line), flush=True)
    if not diff <= CPU_TOL:
        fail(f"tts card vs CPU waveform differs by {diff} > {CPU_TOL}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from megatts2_hierspeechpp_torch.device import resolve_device
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)

    t0 = time.perf_counter()
    so = cuda_lib.build()
    cuda_lib.lib()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "library": so.name}), flush=True)

    kernels = kernel_phase(torch, dev)
    snake_conv_phase(torch, dev)
    kernels["plm_decode"] = plm_phase(torch, dev)
    _, pipe, prompt, audio, inputs = path_phase(torch, dev)
    launches, reqs = tts_phase(torch, pipe, prompt)
    if min(launches.values()) < 1:
        fail(f"a kernel was not launched on the tts path: {launches}")
    t = REQUEST_FRAMES[-1]
    w2v, mask, lf0 = (torch.from_numpy(a) for a in inputs[t])
    profile_phase(torch, "synthesize", t, lambda: pipe.synthesize(
        prompt, w2v, mask, lf0, output_sr=48000))
    f, text, ls, n = reqs[-1]
    profile_phase(torch, "tts", n, lambda: pipe.tts(
        text, prompt=prompt, length_scale=ls, output_sr=48000))
    with torch.inference_mode():
        cpu_pipe = build_pipeline(torch, "cpu")
        cpu_prompt = cpu_pipe.prepare_prompt(audio)
        cpu_phase(torch, pipe, cpu_pipe, prompt, cpu_prompt, inputs)
    cpu_tts_phase(torch, pipe, cpu_pipe, prompt, cpu_prompt, reqs)

    out = []
    for name, lines in kernels.items():
        slowest = max(lines, key=lambda ln: ln["ms"])
        src, replaces = SOURCES[name]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(ln["max_abs_err"] for ln in lines),
            "ms": slowest["ms"], "plain_ms": slowest["plain_ms"],
            "bound_ms": slowest["bound_ms"], "bound_by": slowest["bound_by"],
            "bound_ms_f32": slowest.get("bound_ms_f32"),
            "library_ms": None, "shape": slowest["shape"],
        })
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
