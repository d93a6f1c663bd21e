#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (megatts2_hierspeechpp_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and report seconds;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it, with CUDA-event timings of both;
  4. the serving path at the published HierSpeech++ widths with seeded
     random weights: one 3 s prompt, three requests of 100/250/500 frames
     (2/5/10 s) through vocoder + SpeechSR-48k, checking each output and the
     per-request kernel call counts (every shape is warmed up first);
  5. one 500-frame request under torch.profiler: device time by kernel
     group, the device's idle share, peak memory, the top kernels;
  6. the 100-frame request once more on the CPU (plain versions), held
     against the card's waveform before peak normalisation.
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
EXPECTED_CALLS = {"aa_snakebeta": 19, "ampblock": 6, "amp_triple": 5}
CPU_TOL = 1e-3          # card vs CPU, 48 kHz waveform before normalisation
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM data sheet, non-tensor float32
SNAKE_FLOPS = 58            # per element: 2 x 6-tap up, 2 snakes, 12-tap down
SOURCES = {
    "aa_snakebeta": ("megatts2_hierspeechpp_torch/csrc/aa_snake.cu",
                     "megatts2_hierspeechpp_tpu/ops/pallas_snake.py:93"),
    "ampblock": ("megatts2_hierspeechpp_torch/csrc/snake_conv.cu",
                 "megatts2_hierspeechpp_tpu/ops/pallas_ampblock.py:151"),
    "amp_triple": ("megatts2_hierspeechpp_torch/csrc/triple_epilogue.cu",
                   "megatts2_hierspeechpp_tpu/ops/pallas_amp_triple.py:60"),
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


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                      "operations")


def block_flops(t: int, c: int, k: int) -> float:
    """One AMPBlock (3 branches) on (1, t, c): 6 convs + 6 snakes + adds."""
    return 3 * (2 * 2.0 * t * c * c * k + 2 * SNAKE_FLOPS * t * c + t * c)


def kernel_phase(torch, dev):
    from megatts2_hierspeechpp_torch.ops.amp_triple import (
        composed_triple, fused_amp_triple)
    from megatts2_hierspeechpp_torch.ops.ampblock import (
        composed_ampblock, fused_ampblock)
    from megatts2_hierspeechpp_torch.ops.snake import (
        composed_snakebeta, fused_aa_snakebeta)

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
    cases = []  # (kernel, label, fused fn, plain fn, tol, bytes, flops)
    for c in (256, 64):
        x, a, b = randn(1, 4 * T, c), pos(c), pos(c)
        n = 4 * T * c
        cases.append(("aa_snakebeta", f"C={c} T={4 * T}",
                      lambda x=x, a=a, b=b: fused_aa_snakebeta(x, a, b),
                      lambda x=x, a=a, b=b: composed_snakebeta(x, a, b),
                      1e-5, 4.0 * (2 * n + 2 * c), SNAKE_FLOPS * n))
    for k in (3, 7, 11):
        c, t = 128, 20 * T
        x, ws = randn(1, t, c), block_ws(c, k)
        cases.append(("ampblock", f"C={c} T={t} k={k}",
                      lambda x=x, ws=ws, k=k: fused_ampblock(x, *ws, k, dil),
                      lambda x=x, ws=ws, k=k: composed_ampblock(x, *ws, k, dil),
                      1e-4, 4.0 * (2 * t * c + 6 * k * c * c + 10 * c),
                      block_flops(t, c, k)))
    for c, t, ks, tail in ((64, 4 * T, (3, 5, 7), False),
                           (64, 80 * T, (3, 7, 11), False),
                           (32, 160 * T, (3, 7, 11), False),
                           (16, 320 * T, (3, 7, 11), True),
                           (32, 960 * T, (3, 7, 11), True)):
        x = randn(1, t, c)
        bws = [block_ws(c, k) for k in ks]
        dils = (dil,) * 3
        post = (pos(c), pos(c), randn(7, c, scale=0.1 * (7 * c) ** -0.5)) if tail else None
        flops = sum(block_flops(t, c, k) for k in ks) + 3.0 * t * c
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
                      1e-4, n_bytes, flops))

    results = {}
    for name, label, fused, plain, tol, n_bytes, flops in cases:
        with torch.inference_mode():
            y = fused()
            ref = plain()
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            scale = ref.abs().max().item()
            ok = bool(math.isfinite(err) and err <= tol * scale)
            ms = time_ms(torch, fused, 10)
            plain_ms = time_ms(torch, plain, 5)
        b_ms, b_by = bound_ms(n_bytes, flops)
        line = {"phase": "kernel", "name": name, "shape": label,
                "max_abs_err": err, "max_abs_ref": scale,
                "tolerance": f"{tol:g} x max|ref|", "ok": ok, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
        print(json.dumps(line), flush=True)
        if not ok:
            fail(f"{name} {label}: max abs err {err} > {tol} x {scale}")
        results.setdefault(name, []).append(line)
    return results


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
    from megatts2_hierspeechpp_torch.infer.pipeline import TTSPipeline
    from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR
    from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder

    # configs/hierspeechpp.json widths: HierVocoder defaults; SpeechSR-48k
    voc = HierVocoder(seed=1234, device=device)
    sr = SpeechSR(upsample_initial_channel=32, rate_num=3, rate_den=1,
                  seed=4321, device=device)
    return TTSPipeline(voc, sr, device)


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


GROUPS = (  # (group, substrings of kernel names), first match wins
    ("aa_snakebeta (ours)", ("aa_snakebeta_kernel",)),
    ("snake_conv (ours)", ("snake_conv_kernel",)),
    ("triple_epilogue (ours)", ("triple_avg_kernel", "triple_post_kernel")),
    ("cuDNN/cuBLAS conv+gemm", ("conv", "cudnn", "xmma", "gemm", "sgemm",
                                "cutlass", "implicit")),
    ("fft", ("fft",)),
    ("memcpy/memset", ("memcpy", "memset", "Memcpy", "Memset")),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
)


def profile_phase(torch, pipe, prompt, inputs):
    """Device time of one 500-frame request by kernel group (torch.profiler),
    the device's idle share of the request's wall time, peak memory, and the
    12 kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = REQUEST_FRAMES[-1]
    w2v, mask, lf0 = (torch.from_numpy(a) for a in inputs[t])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.synthesize(prompt, w2v, mask, lf0, output_sr=48000)
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
    line = {"phase": "profile", "frames": t, "wall_ms": wall_ms,
            "device_kernel_ms": device_ms if device_ms else "not measured",
            "device_idle_share": (1 - device_ms / wall_ms) if device_ms
            else "not measured",
            "kernel_launches": sum(n for _, n in per_name.values()),
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
            "top_kernels": [[name[:100], ms, n] for name, (ms, n) in top]}
    print(json.dumps(line), flush=True)


def cpu_phase(torch, pipe, prompt, audio, inputs):
    t = REQUEST_FRAMES[0]
    w2v, mask, lf0 = (torch.from_numpy(a) for a in inputs[t])
    card = pipe.render(prompt, w2v, mask, lf0, output_sr=48000).cpu().numpy()
    cpu_pipe = build_pipeline(torch, "cpu")
    cpu = cpu_pipe.render(cpu_pipe.prepare_prompt(audio), w2v, mask, lf0,
                          output_sr=48000).numpy()
    diff = float(np.abs(card - cpu).max())
    line = {"phase": "card_vs_cpu", "frames": t, "max_abs_diff": diff,
            "max_abs_cpu": float(np.abs(cpu).max()), "tolerance": CPU_TOL}
    print(json.dumps(line), flush=True)
    if not diff <= CPU_TOL:
        fail(f"card vs CPU waveform differs by {diff} > {CPU_TOL}")


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
    launches, pipe, prompt, audio, inputs = path_phase(torch, dev)
    profile_phase(torch, pipe, prompt, inputs)
    with torch.inference_mode():
        cpu_phase(torch, pipe, prompt, audio, inputs)

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
            "library_ms": None, "shape": slowest["shape"],
        })
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
