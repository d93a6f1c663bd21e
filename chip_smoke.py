#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (megatts2_hierspeechpp_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and report seconds;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it, with CUDA-event timings of both and
     two bounds (3xTF32 tensor cores, and float32 CUDA cores only); the
     AA-snake also with its device time per launch (profiler), a copy of
     the same bytes, and every rows-per-thread it is built for; then the
     triple epilogue alone at each of its five launch shapes against
     composed_epilogue (device ms, wrapper ms, bound, copy floor; for the
     tail also every tile and the phase split from its stamps); then
     one snake_conv launch at every distinct (C, T, k, d) of a 500-frame
     request, beside a cuDNN conv1d of the same conv (the conv alone), and
     their sum per request; the PLM decode kernel at full width (d 276, 4
     layers, 1024 bins) at T = 500, 1 and 37, its codes held by the
     teacher-forced check; its bf16 weight / cache configuration at T = 500
     (ms, teacher-forced gap against the bf16 plain twin, token agreement
     with float32, 10 repeats identical), and the per-row greedy decode of
     a batch of 4 in float32 and bf16 (one launch per row);
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
     run of the public stages one by one under CUDA events; these requests
     pass exact=True (no length buckets), as in earlier runs;
  6. the 500-frame synthesize and tts requests under torch.profiler: device
     time by kernel group, the device's idle share, peak memory, the top
     kernels;
  7. the 100-frame synthesize and tts requests once more on the CPU (plain
     versions; the tts run takes the card's prosody codes), held against
     the card's waveform before peak normalisation;
  8. the serving front end at the same widths, each path with its kernel
     counts zeroed just before it and read just after, and its launch
     shapes recorded: `serve_batch`, tts_batch of 4 texts (one frame bucket,
     401-600 frames) with one prompt, then of 3 with a bucketed speaker
     each, 48 kHz (batch ms, audio-s/s, each row against its own bucketed
     tts call); `serve_stream`, tts_stream of the 10 s request at 16 and 48
     kHz, 200-frame chunks with 32-frame halos (ms to the first and the
     last chunk, against tts); `serve_server`, 8 requests from 4 threads
     for 4 speakers through TTSServer (ms per request, tts_batch calls);
     then every kernel against its plain version at each distinct launch
     shape these paths gave it (`new_shape` lines; the AA-snake and the
     epilogue with their device ms; the shared-prompt batch profiled);
  9. the denoiser and voice conversion at full width: `denoise`, MP-SENet
     (dense_channel 64, 4 TS blocks) on the 3 s prompt (49,600 padded
     samples, 497 STFT frames): ms by CUDA events, peak memory, the
     query-chunked attention against the dense form, card against CPU;
     `tts_denoise`, the 10 s tts request from prompt audio at
     denoise_ratio 0.8 (ms, kernel calls, stage ms with the denoise stage)
     and the 2 s one card against CPU; `vc`, a full-width Wav2Vec2 (7 of
     mms-300m's layers) on a 5 s source and a 3 s target at 16 and 48 kHz,
     denoise_ratio 0 and 0.8 (ms per call, stage ms, kernel calls, launch
     shapes), YIN card against CPU, and one call card against CPU. The
     card-vs-CPU gates feed both sides one STFT for the denoiser and, for
     vc, one f0 (the first STFT frame's phases are +-pi by the FFT's
     rounding, and a YIN frame at its threshold can flip; both are held on
     their own). These paths' launch shapes join the `new_shape` lines,
     which run last;
 10. vocoder training at the published widths (configs/hierspeechpp.json,
     batch 32, 32-frame windows): cli/make_synth_corpus writes 96
     utterances, cli/train_vocoder.main runs in-process for one epoch (3
     steps, a checkpoint at step 2 and at the epoch's end), then again on
     the same directory for a second epoch, resumed from the checkpoint:
     each step's ms (CUDA events) and kernel launches (zeroed before each
     step; each kernel must launch in every step), audio-s per s encoded and
     decoded, peak memory; one step under torch.profiler by group (our
     kernels' forward, their plain-VJP recompute and backward, cuDNN /
     cuBLAS, optimizer, elementwise) with the idle share; one step at B = 2,
     64 frames, card against CPU from the same weights and draws (each loss
     within 1e-4 relative, G and D gradients within 1e-3 relative L2); and
     each kernel's wrapper at every training launch shape, forward and
     backward against autograd of its plain version (`train_shape` lines:
     forward, plain and backward ms, bound). The training launch shapes
     join the `new_shape` lines;
 11. MegaTTS2 training at the published widths and depths
     (configs/config.json: batch 8, lr 1e-4, c_commit 100; TTVModel and
     the MultiResSpecDiscriminator, ProsodyLM 4 layers, d 276): `train_s2`,
     cli/train_s2.main in-process on 24 of phase 10's utterances (one length
     bucket: 3 batches of 8), k-means on the first batch, 3 steps, a
     checkpoint, 3 resumed; each step's ms (CUDA events), audio-s per s,
     peak memory, launches; one step profiled by group (cuDNN / cuBLAS,
     LSTM, elementwise, optimizer) with the idle share; one step of a
     synthetic 10 s batch (B = 8, 512 frames, 128 phones); one step at
     B = 2, 64 frames card against CPU from the same weights, coin and
     dropout masks (drawn on the CPU): each metric within 1e-4 relative,
     G and D gradients within 1e-3 relative L2, the RVQ statistics and the
     spectral norm's u / v within 1e-5 of their largest. `train_s1`,
     cli/train_s1.main from that run's checkpoint: 3 steps + 3 resumed,
     step ms, tokens (frames) per s, peak memory, a profiled step, the
     card-vs-CPU step. `serve_trained`: the s1 run's PLM takes one more
     step after its decode weights were packed, then serves with the
     frozen s2 TTV, the serving vocoder and SpeechSR-48k one 10 s `tts`
     request (exact=True): all four kernels must launch, the decode's
     teacher-forced gap within 1e-4 x max|logit|, its codes equal to a
     fresh build's loaded with the same state_dict.
Then one JSON line with every kernel's numbers (launches: the f32 rows
from the tts requests of phase 5, or one training step of phase 10 where
that count is larger, and the serve_trained request's beside them; the
bf16 row from its batch decode of phase 3), the card's name and power
limit from phase 1 printed first, and last the device line.

Float32 throughout (but for the bf16 decode configuration), TF32 off.
Without CUDA it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np

T_FRAMES = 500          # frames of the longest request; kernel shapes derive from it
REQUEST_FRAMES = (100, 250, 500)
EXPECTED_CALLS = {"aa_snakebeta": 19, "ampblock": 6, "amp_triple": 5,
                  "plm_decode": 0, "plm_decode_bf16": 0}
# the kernels of the serving path (float32 decode, the port's default)
PATH_KERNELS = ("aa_snakebeta", "ampblock", "amp_triple", "plm_decode")
TTS_CALLS = dict(EXPECTED_CALLS, plm_decode=1)
PLM_T = (500, 1, 37)    # decode lengths of phase 3; the first is the main path's
TF_MARGIN = 1e-4        # teacher-forced gap, x max|logits|
# The bf16 configuration's gap against its plain twin: one bf16 step (2^-8)
# of the logits' scale. The same twin run on the CPU and on the card (sum
# order alone differs) already flips near ties by several 1e-4 of it (the
# plm_bf16 line's cpu_twin entries): a value that lands within float
# error of a bf16 rounding boundary rounds one way in one order and the
# other way in another, some 0.5 times per token.
BF16_MARGIN = 2.0 ** -8
BF16_LATENTS = 3        # T=500 latents of the bf16 comparison
PLM_REPEATS = 10        # launches at the main path's T that must give the same codes
BATCH_ROWS = 4          # serve_batch's rows (one shared prompt) and the per-row decode
SPEAKER_ROWS = 3        # serve_batch's rows with one prompt each
SERVE_FRAMES = (401, 600)   # serve_batch's texts: predicted frames in one bucket
SERVE_TOL = 1e-4        # a batch row against its own tts call, x its peak
STREAM_CHUNK, STREAM_HALO = 200, 32
STREAM_TOL = 1e-5       # stream vs tts: 16 kHz after peak normalisation; 48 kHz
                        # interior after the least-squares gain
STREAM_TAIL = 1024      # 48 kHz samples at the end left out of the interior
SERVER_REQUESTS, SERVER_THREADS, SERVER_SPEAKERS = 8, 4, 4
# Mandarin read speech: 5.18 syllables/s (Pellegrino, Coupe & Marsico 2011,
# "A cross-language perspective on speech information rate", Language
# 87(3), Table 2); a prosodic phrase break ("sp") every 8 syllables
SYLLABLES_PER_S = 5.18
PHRASE_SYLLABLES = 8
CPU_TOL = 1e-3          # card vs CPU, 48 kHz waveform before normalisation
DENOISE_TOL = 1e-3      # card vs CPU denoised waveform: relative L2, and max abs
                        # over the peak
CHUNK_TOL = 1e-5        # chunked vs dense denoiser attention on the card, x peak
DENOISE_CHUNK = 128     # the chunked form's query rows
DENOISE_RATIO = 0.8     # the reference CLI's documented setting
VC_SECONDS = (5.0, 3.0)     # vc source, target
VC_CONFIGS = ((16000, 0.0), (16000, DENOISE_RATIO), (48000, 0.0),
              (48000, DENOISE_RATIO))
YIN_AGREE = 0.99        # YIN card vs CPU: voicing agreement, and the share of
                        # frames voiced on both within 1e-4 relative
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM data sheet, non-tensor float32
TF32_FLOPS_PER_S = 495e12   # H100 SXM data sheet, dense TF32 tensor cores
TF32_PASSES = 3             # snake_conv's split-TF32 products per product
SNAKE_FLOPS = 58            # per element: 2 x 6-tap up, 2 snakes, 12-tap down
SOURCES = {  # launch-count key: (kernel, source, TPU kernel it replaces)
    "aa_snakebeta": ("aa_snakebeta", "megatts2_hierspeechpp_torch/csrc/aa_snake.cu",
                     "megatts2_hierspeechpp_tpu/ops/pallas_snake.py:93"),
    "ampblock": ("ampblock", "megatts2_hierspeechpp_torch/csrc/snake_conv.cu",
                 "megatts2_hierspeechpp_tpu/ops/pallas_ampblock.py:151"),
    # one epilogue launch per stage call (the stage's convs are snake_conv)
    "amp_triple": ("triple_epilogue",
                   "megatts2_hierspeechpp_torch/csrc/triple_epilogue.cu",
                   "megatts2_hierspeechpp_tpu/ops/pallas_amp_triple.py:60"),
    "plm_decode": ("plm_decode", "megatts2_hierspeechpp_torch/csrc/plm_decode.cu",
                   "megatts2_hierspeechpp_tpu/ops/pallas_plm_decode.py:59"),
    # the same kernel's bf16 weight / cache configuration
    "plm_decode_bf16": ("plm_decode_bf16",
                        "megatts2_hierspeechpp_torch/csrc/plm_decode.cu",
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


def device_ms(torch, fn, keys, reps: int = 20, attempts: int = 3,
              required: bool = True):
    """Median device time (ms) of the kernels whose names hold one of
    `keys`, over reps back-to-back calls of fn() under torch.profiler, after
    2 warm-ups. This is the kernel's own time on the card; the wrapper's
    host cost (time_ms) is about 10x it at the snake's shapes. The
    profiler's activity records can drop launches (19 of 20 copies seen on
    an H100 in one run, 7 of 20 in another), so the median is over the
    launches it recorded, at least half of them; a window with fewer is
    profiled again, up to `attempts` times, and then fails the run, or
    gives None when not `required`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == DeviceType.CUDA
              and any(k in ev.name for k in keys)]
        if 2 * len(us) >= reps:
            return float(np.median(us)) / 1e3
    if not required:
        return None
    fail(f"profiler saw {len(us)} of {reps} launches of {keys}, "
         f"{attempts} times")


def copy_floor_ms(torch, dev, n_bytes: float) -> float:
    """Device time of one copy_ that reads n_bytes / 2 and writes n_bytes /
    2: a floor yardstick for a kernel that moves n_bytes, not a library
    version of its function."""
    n = max(1, int(n_bytes / 8))
    src = torch.ones(n, device=dev)
    dst = torch.empty_like(src)
    return device_ms(torch, lambda: dst.copy_(src), ("Memcpy", "copy"))


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


def snake_sweep(torch, args, ref, tol: float) -> dict:
    """Device ms per launch and max abs error of every rows-per-thread the
    AA-snake kernel is built for, at one shape; each is held to the plain
    version like the default plan."""
    from megatts2_hierspeechpp_torch.ops import snake

    x, a, b, ib = args
    out = {}
    for rows in snake.ROWS:
        fn = lambda: snake._launch(x, a, b, ib, rows=rows)
        err = (fn() - ref).abs().max().item()
        if not err <= tol * ref.abs().max().item():
            fail(f"aa_snakebeta rows={rows}: max abs err {err}")
        out[f"rows={rows}"] = {"device_ms": device_ms(torch, fn, ("aa_snakebeta",)),
                               "max_abs_err": err}
    return out


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
    snake_args = {}  # label: the AA-snake's inputs, for its sweep
    for c in (256, 64):
        x, a, b = randn(1, 4 * T, c), pos(c), pos(c)
        ib = inverse_beta(b)  # once per weight, as the serving path does
        snake_args[f"C={c} T={4 * T}"] = (x, a, b, ib)
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
        if name == "aa_snakebeta":
            with torch.inference_mode():
                line["device_ms"] = device_ms(torch, fused, ("aa_snakebeta",))
                line["sweep"] = snake_sweep(torch, snake_args[label], ref, tol)
            line["copy_floor_ms"] = copy_floor_ms(torch, dev, n_bytes)
        print(json.dumps(line), flush=True)
        if not ok:
            fail(f"{name} {label}: max abs err {err} > {tol} x {scale}")
        results.setdefault(name, []).append(line)
    return results


# The epilogue launches of a request of T_FRAMES frames: (stage, C, T /
# frames, with the tail). triple_avg runs for the first three, triple_post
# for the two with the tail.
EPILOGUE_STAGES = (
    ("SourceNetwork stage 1", 64, 4, False),
    ("Generator stage 2", 64, 80, False),
    ("Generator stage 3", 32, 160, False),
    ("Generator stage 4 + tail", 16, 320, True),
    ("SpeechSR + tail", 32, 960, True),
)
EPILOGUE_TOL = {False: 1e-5, True: 1e-4}   # x max|ref|: average, tail


def tail_split(torch, rs, post) -> dict:
    """Where a tail block's time goes: from one launch with the kernel's
    phase stamps (SM cycles; each SM has its own counter, so only spans
    within a block are read), the mean cycles per block of its three
    phases (load + average, AA-snake, conv_post + tanh) and their shares."""
    from megatts2_hierspeechpp_torch.ops.amp_triple import tail_stamps

    with torch.inference_mode():
        _, st = tail_stamps(*rs, post)
        torch.cuda.synchronize()
    d = np.diff(st.cpu().numpy().astype(np.float64), axis=1)
    mean = d.mean(axis=0)
    names = ("load_avg", "aa_snake", "conv_post")
    return {"blocks": int(d.shape[0]),
            "cycles_per_block": dict(zip(names, map(float, mean))),
            "share": dict(zip(names, map(float, mean / mean.sum())))}


def epilogue_tile_sweep(torch, rs, post, ref, tol: float) -> dict:
    """Device ms per launch and max abs error of the tail kernel at every
    tile it is built for that fits at this C, each held to the plain
    version."""
    from megatts2_hierspeechpp_torch.ops import amp_triple

    out = {}
    c = rs[0].shape[-1]
    with torch.inference_mode():
        for tile in amp_triple.EPILOGUE_TILES:
            if amp_triple.epilogue_smem(c, tile) > amp_triple.SMEM_LIMIT:
                continue
            fn = lambda: amp_triple._epilogue(*rs, post, tile)
            err = (fn() - ref).abs().max().item()
            if not err <= tol * ref.abs().max().item():
                fail(f"triple_post tile={tile}: max abs err {err}")
            out[f"tile={tile}"] = {
                "smem": amp_triple.epilogue_smem(c, tile),
                "device_ms": device_ms(torch, fn, ("triple_post_kernel",)),
                "max_abs_err": err}
    return out


def epilogue_phase(torch, dev):
    """triple_epilogue.cu alone, at each of its launch shapes of the
    request, on given block outputs, against composed_epilogue: max abs
    error, device ms per launch (profiler), the wrapper's CUDA-event ms, the
    plain version's ms, the bytes bound and a copy of the same bytes. For a
    launch with the tail also the average alone on the same inputs
    (`avg_device_ms`), the share of its time that is loading the three
    inputs and writing one output."""
    from megatts2_hierspeechpp_torch.ops.amp_triple import (
        composed_epilogue, fused_epilogue)

    gen = torch.Generator().manual_seed(2)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    lines = []
    for stage, c, f, tail in EPILOGUE_STAGES:
        t = f * T_FRAMES
        n = t * c
        rs = [randn(1, t, c, scale=3.0) for _ in range(3)]
        post = (torch.exp(randn(c, scale=0.2)), torch.exp(randn(c, scale=0.2)),
                randn(7, c, scale=0.1 * (7 * c) ** -0.5)) if tail else None
        tol = EPILOGUE_TOL[tail]
        kernel = "triple_post_kernel" if tail else "triple_avg_kernel"
        with torch.inference_mode():
            y = fused_epilogue(*rs, post)
            ref = composed_epilogue(*rs, post)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            scale = ref.abs().max().item()
            ok = bool(math.isfinite(err) and err <= tol * scale)
            dev_ms = device_ms(torch, lambda: fused_epilogue(*rs, post), (kernel,))
            avg_ms = (device_ms(torch, lambda: fused_epilogue(*rs),
                                ("triple_avg_kernel",)) if tail else None)
            ms = time_ms(torch, lambda: fused_epilogue(*rs, post), 10)
            plain_ms = time_ms(torch, lambda: composed_epilogue(*rs, post), 5)
        n_bytes = 4.0 * (3 * n + (t + 9 * c if tail else n))
        flops = 3.0 * n + ((SNAKE_FLOPS + 14) * n + t if tail else 0)
        b_ms, b_by = bound_ms(n_bytes, flops)
        line = {"phase": "epilogue", "name": "triple_epilogue",
                "kernel": kernel, "stage": stage,
                "shape": f"C={c} T={t}{' +tail' if tail else ''}",
                "max_abs_err": err, "max_abs_ref": scale,
                "tolerance": f"{tol:g} x max|ref|", "ok": ok,
                "device_ms": dev_ms, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by,
                "copy_floor_ms": copy_floor_ms(torch, dev, n_bytes)}
        if tail:
            line["avg_device_ms"] = avg_ms
            line["tile_sweep"] = epilogue_tile_sweep(torch, rs, post, ref, tol)
            line["split"] = tail_split(torch, rs, post)
        print(json.dumps(line), flush=True)
        if not ok:
            fail(f"triple_epilogue {stage}: max abs err {err} > {tol} x {scale}")
        lines.append(line)
    print(json.dumps({"phase": "epilogue_per_request", "frames": T_FRAMES,
                      "launches": len(lines),
                      **{k: sum(ln[k] for ln in lines) for k in (
                          "device_ms", "ms", "plain_ms", "bound_ms",
                          "copy_floor_ms")}}), flush=True)
    return lines


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


def plm_work(model, t: int, wbytes: int = 4):
    """(bytes, flops) of one greedy decode of t tokens: every weight and the
    input latent read once (the matrices at wbytes per weight), the codes
    written once; 2 flops per weight of every matrix per token, plus q.k and
    p.v over the cache."""
    mats = sum(p.numel() for n, p in model.named_parameters()
               if p.dim() == 2 and not n.startswith("pc_embedding"))
    n_bytes = (4.0 * (sum(p.numel() for p in model.parameters()) + t * 256 + t)
               - (4 - wbytes) * mats)
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


def plm_bf16_phase(torch, dev):
    """The bf16 configuration of the decode kernel (weights and KV cache
    bf16, float32 sums) at the main path's T: its ms, its teacher-forced
    gap against the bf16 plain twin (plain_gap, fails above BF16_MARGIN x
    max|logits|), its token agreement with the float32 kernel (reported
    only), PLM_REPEATS launches identical (fails otherwise); on each of
    BF16_LATENTS latents, beside the kernel's gap and agreement with the
    twin on the card, as a yardstick, the twin on the CPU's (its sums in
    another order). Then the
    per-row greedy decode of a batch of BATCH_ROWS through models/plm.decode
    in float32 and in bf16: one launch per row, the codes held by the
    teacher-forced gap against plain_decode's batch in the same dtypes. The
    bf16 batch is this configuration's path: its counts are zeroed just
    before it and read just after."""
    from megatts2_hierspeechpp_torch.models.plm import ProsodyLM, decode
    from megatts2_hierspeechpp_torch.ops import cuda_lib
    from megatts2_hierspeechpp_torch.ops.plm_decode import (
        plain_decode, plain_gap, plm_decode_greedy)

    bf = torch.bfloat16
    model = ProsodyLM(seed=99, device=dev)
    w = model.packed()
    cpu_w = ProsodyLM(seed=99, device="cpu").packed()
    t = PLM_T[0]
    gen = torch.Generator().manual_seed(5)
    go = model.go_id
    latents = []  # per latent: the kernel and the CPU twin against the card twin
    with torch.inference_mode():
        for i in range(BF16_LATENTS):  # the first is plm_phase's T=500 latent
            tc = torch.randn(1, t, 256, generator=gen).to(dev)
            codes = plm_decode_greedy(w, tc, go, bf, bf)
            twin = plain_decode(w, tc, go, weight_dtype=bf, cache_dtype=bf)
            cpu_twin = plain_decode(cpu_w, tc.cpu(), go, weight_dtype=bf,
                                    cache_dtype=bf)
            gap, scale = plain_gap(w, tc, codes, go, bf, bf)
            latents.append({
                "kernel": {"agreement": (codes == twin).float().mean().item(),
                           "gap": gap},
                "cpu_twin": {"agreement": (cpu_twin == twin.cpu()).float().mean().item(),
                             "gap": plain_gap(w, tc, cpu_twin, go, bf, bf)[0]},
                "max_abs_ref": scale})
            if i == 0:
                first, tc0, f32 = codes, tc, plm_decode_greedy(w, tc, go)
        ms = time_ms(torch, lambda: plm_decode_greedy(w, tc0, go, bf, bf), 5)
        f32_ms = time_ms(torch, lambda: plm_decode_greedy(w, tc0, go), 5)
        plain_ms = time_ms(torch, lambda: plain_decode(
            w, tc0, go, weight_dtype=bf, cache_dtype=bf), 1)
        same = sum(bool(torch.equal(plm_decode_greedy(w, tc0, go, bf, bf), first))
                   for _ in range(PLM_REPEATS))
    b_ms, b_by = bound_ms(*plm_work(model, t, 2))
    worst = max(latents, key=lambda x: x["kernel"]["gap"] / x["max_abs_ref"])
    line = {"phase": "plm_bf16", "name": "plm_decode_bf16",
            "shape": f"T={t} d=276 L=4 H=4 F=1104 bins=1024 bf16 weights+cache",
            "max_abs_err": worst["kernel"]["gap"],
            "max_abs_ref": worst["max_abs_ref"],
            "tolerance": f"teacher-forced gap vs the bf16 plain twin <= "
                         f"{BF16_MARGIN:g} x max|logits|",
            "agreement_with_f32_kernel": (first == f32).float().mean().item(),
            "latents": latents,
            "repeats_identical": f"{same}/{PLM_REPEATS}", "ms": ms,
            "f32_ms": f32_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}
    ok = (all(x["kernel"]["gap"] <= BF16_MARGIN * x["max_abs_ref"]
              for x in latents)
          and bool(((first >= 0) & (first < 1024)).all()))
    print(json.dumps(line), flush=True)
    if not ok:
        fail(f"plm_decode bf16 T={t}: teacher-forced gap over "
             f"{BF16_MARGIN} x max|logits| ({latents})")
    if same != PLM_REPEATS:
        fail(f"plm_decode bf16 T={t}: {PLM_REPEATS - same} of {PLM_REPEATS} "
             "repeated launches gave other codes")

    # per-row greedy batch through the public decode
    tcb = torch.randn(BATCH_ROWS, t, 256, generator=gen).to(dev)
    for dt, key in ((torch.float32, "plm_decode"), (bf, "plm_decode_bf16")):
        with torch.inference_mode():
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            rows = decode(model, tcb, weight_dtype=dt, cache_dtype=dt)
            torch.cuda.synchronize()
            counts = dict(cuda_lib.LAUNCHES)
            gap_b, scale_b = plain_gap(w, tcb, rows, go, dt, dt)
            agree = (rows == plain_decode(w, tcb, go, weight_dtype=dt,
                                          cache_dtype=dt)).float().mean().item()
        ln = {"phase": "plm_batch", "dtype": str(dt), "rows": BATCH_ROWS,
              "T": t, "calls": counts, "max_abs_err": gap_b,
              "max_abs_ref": scale_b, "agreement_with_plain": agree}
        print(json.dumps(ln), flush=True)
        want = dict.fromkeys(counts, 0)
        want[key] = BATCH_ROWS
        if counts != want:
            fail(f"per-row decode {dt}: kernel calls {counts}, expected {want}")
        margin = TF_MARGIN if dt == torch.float32 else BF16_MARGIN
        if not gap_b <= margin * scale_b:
            fail(f"per-row decode {dt}: teacher-forced gap {gap_b} > "
                 f"{margin} x {scale_b}")
        if dt == bf:
            line["launches"] = counts[key]
    return line


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
            n = pipe.duration(text, prompt, ls, exact=True)
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


def tts_stages(torch, pipe, prompt, text, ls, denoise_ratio: float = 0.0):
    """ms of each stage of one tts request, the public stages called one by
    one as `tts` calls them: duration pre-pass, acoustic (of which the PLM
    decode, timed alone on the same latent), vocoder (render at 16 kHz) and
    SpeechSR on its output."""
    from megatts2_hierspeechpp_torch.models.plm import decode

    ms = {}
    n, ms["duration_ms"] = event_ms(
        torch, lambda: pipe.duration(text, prompt, ls, exact=True))
    ac, ms["acoustic_ms"] = event_ms(
        torch, lambda: pipe.acoustic(text, prompt, n, ls, exact=True))
    _, ms["decode_ms"] = event_ms(torch, lambda: decode(pipe.plm, ac.x_frame))
    wav, ms["vocode_ms"] = event_ms(torch, lambda: pipe.render(
        prompt, ac.w2v, ac.frame_mask, ac.lf0, denoise_ratio=denoise_ratio,
        output_sr=16000))
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
        pipe.tts(text, prompt=prompt, length_scale=ls, output_sr=48000,
                 exact=True)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    before = dict(cuda_lib.LAUNCHES)
    lines = []
    for f, text, ls, n in reqs:
        t0 = time.perf_counter()
        out = pipe.tts(text, prompt=prompt, length_scale=ls, output_sr=48000,
                       exact=True)
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


class LaunchShapes:
    """The distinct launch shapes of the port's kernels while recording:
    every kernel launches through cuda_lib.call, so its C arguments give
    the shape. Keys: ("aa_snakebeta", B, T, C), ("snake_conv", B, T, C, k,
    d, with the residual), ("triple_avg" | "triple_post", B, T, C),
    ("plm_decode", T, weight bytes, cache bytes); each with the path that
    first launched it."""

    def __init__(self, cuda_lib):
        self.lib = cuda_lib
        self.seen = {}
        self.path = None
        self._conv = None  # (B, T, C) of the last snake_conv launch
        self._orig = cuda_lib.call

        def call(name, *args):
            if self.path is not None:
                self._note(name, args)
            return self._orig(name, *args)

        cuda_lib.call = call

    def _note(self, name, a):
        if name == "aa_snakebeta_fwd":
            key = ("aa_snakebeta", a[4], a[5], a[6])
        elif name == "snake_conv_fwd":
            b, t, cin, cout, k, d = a[7:13]
            self._conv = (b, t, cout)
            key = ("snake_conv", b, t, cin, k, d, a[5].value is not None)
        elif name == "triple_avg_fwd":  # the average of the stage's last convs
            if self._conv is None or self._conv[0] * self._conv[1] * self._conv[2] != a[4]:
                fail(f"triple_avg of {a[4]} elements after snake_conv {self._conv}")
            key = ("triple_avg", *self._conv)
        elif name == "triple_post_fwd":
            key = ("triple_post", a[7], a[8], a[9])
        elif name == "plm_decode_fwd":
            key = ("plm_decode", a[17], a[28], a[29])
        else:
            return
        self.seen.setdefault(key, self.path)


def run_path(torch, cuda_lib, shapes, label, fn):
    """fn() with the launch counts zeroed just before and read just after,
    its launch shapes recorded under `label`: (fn(), counts)."""
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    shapes.path = label
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        shapes.path = None
    return out, dict(cuda_lib.LAUNCHES)


def speaker_audio(i: int) -> np.ndarray:
    """Synthetic speaker i: a gliding harmonic tone of its own pitch and
    2.1-2.9 s, so that every speaker lands on the same 1 s prompt grid."""
    rng = np.random.default_rng(100 + i)
    n = int((2.1 + 0.25 * i) * 16000)
    t = np.arange(n) / 16000.0
    f = (95.0 + 35.0 * i) * (1.0 + 0.2 * np.sin(2 * np.pi * (0.3 + 0.1 * i) * t))
    phase = 2 * np.pi * np.cumsum(f) / 16000.0
    y = sum((0.25 / h) * np.sin(h * phase + i) for h in range(1, 7))
    return (y + 0.01 * rng.standard_normal(n)).astype(np.float32)


def text_bucket(text: str) -> int:
    from megatts2_hierspeechpp_torch.data.text import process_text
    from megatts2_hierspeechpp_torch.infer.pipeline import _bucket_text

    return _bucket_text(len(process_text(text)[0]))


def serve_texts(pipe, prompt, ls, n: int):
    """n Mandarin texts (tts_text, 8.5-11 s of syllables) in one text bucket
    whose predicted frames at length_scale ls all lie in SERVE_FRAMES, one
    frame bucket (the duration predictor reads the text padding, so a row
    computes what its own tts call does only in its own text bucket)."""
    rng = np.random.default_rng(21)
    texts = []
    for i in range(60):
        text = tts_text(rng, 8.5 + 0.5 * (i % 6))
        if texts and text_bucket(text) != text_bucket(texts[0]):
            continue
        if SERVE_FRAMES[0] <= pipe.duration(text, prompt, ls) <= SERVE_FRAMES[1]:
            texts.append(text)
            if len(texts) == n:
                return texts
    fail(f"no {n} texts predict {SERVE_FRAMES} frames at length_scale {ls}")


def check_rows(label, outs, singles, tol):
    """Each batch row against its own tts call: same length, within tol x
    its peak. Returns the worst error over the peak."""
    worst = 0.0
    for i, (o, s) in enumerate(zip(outs, singles)):
        if o.shape != s.shape or not np.isfinite(o).all():
            fail(f"{label} row {i}: {o.shape} vs its own tts {s.shape}")
        worst = max(worst, float(np.abs(o - s).max() / np.abs(s).max()))
    if not worst <= tol:
        fail(f"{label}: a row differs from its own tts by {worst} x its peak")
    return worst


def serve_batch_phase(torch, pipe, prompt, ls, shapes):
    """tts_batch at full width, output_sr 48000, noise_scale_vc 0: BATCH_ROWS
    texts with one shared prompt, then SPEAKER_ROWS of them with one
    bucketed synthetic speaker each (prepare_prompt(bucket=True)). Each
    batch is warmed up, then run once with its counts zeroed (one tts
    call's, with a plm_decode launch per row) and timed on the host clock;
    each row is held against its own tts(exact=False) call. Last, the
    shared-prompt batch once more under the profiler."""
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    kw = dict(length_scale=ls, output_sr=48000, noise_scale_vc=0.0, seed=3)
    texts = serve_texts(pipe, prompt, ls, BATCH_ROWS)
    speakers = [pipe.prepare_prompt(speaker_audio(i), bucket=True)
                for i in range(SPEAKER_ROWS)]
    lines = []
    for label, args in (
            ("shared prompt", dict(texts=texts, prompt=prompt)),
            ("per-row prompts", dict(texts=texts[:SPEAKER_ROWS],
                                     prompts=speakers))):
        b = len(args["texts"])
        pipe.tts_batch(**args, **kw)  # warm-up
        t0 = time.perf_counter()
        outs, counts = run_path(torch, cuda_lib, shapes, f"serve_batch B={b}",
                                lambda: pipe.tts_batch(**args, **kw))
        ms = 1e3 * (time.perf_counter() - t0)
        singles, _ = run_path(
            torch, cuda_lib, shapes, "tts, bucketed",
            lambda: [pipe.tts(t, prompt=p, **kw) for t, p in zip(
                args["texts"], args.get("prompts") or [prompt] * b)])
        want = dict(TTS_CALLS, plm_decode=b)
        audio_s = sum(len(o) for o in outs) / 48000
        frames = [int(f) for f in pipe.duration(
            args["texts"], args.get("prompts") or prompt, ls)]
        line = {"phase": "serve_batch", "prompts": label, "rows": b,
                "frames": frames, "ms": ms, "audio_s": audio_s,
                "audio_s_per_s": audio_s / (ms / 1e3), "calls": counts,
                "max_err_vs_own_tts": check_rows(label, outs, singles, SERVE_TOL),
                "tolerance": f"{SERVE_TOL:g} x the row's peak"}
        print(json.dumps(line), flush=True)
        if counts != want:
            fail(f"serve_batch {label}: kernel calls {counts}, expected {want}")
        lines.append(line)
    profile_phase(torch, f"tts_batch B={BATCH_ROWS}", lines[0]["frames"],
                  lambda: pipe.tts_batch(texts, prompt=prompt, **kw))


def serve_stream_phase(torch, pipe, prompt, req, shapes):
    """tts_stream of the 10 s request (chunk_frames STREAM_CHUNK, halo
    STREAM_HALO) at 16 and 48 kHz, noise_scale_vc 0: host-clock ms to the
    first chunk and to the last, the chunk count, the kernel counts of the
    run; the chunks joined against tts(exact=False): at 16 kHz within
    STREAM_TOL after peak normalisation, at 48 kHz the interior (all but
    the last STREAM_TAIL samples) within STREAM_TOL after the least-squares
    gain. The whole 48 kHz difference is reported with its distance from
    the end: there the bucketed tts runs SpeechSR over the bucket's padding
    frames and the stream's last piece ends at the sequence edge, as the
    JAX stream does (tests/test_torch_serving.py holds the port's tail to
    the JAX one's)."""
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    _, text, ls, n = req
    for sr in (16000, 48000):
        kw = dict(length_scale=ls, output_sr=sr, noise_scale_vc=0.0, seed=3)
        skw = dict(kw, chunk_frames=STREAM_CHUNK, halo_frames=STREAM_HALO)
        list(pipe.tts_stream(text, prompt=prompt, **skw))  # warm-up

        def stream():
            t0, marks, chunks = time.perf_counter(), [], []
            for c in pipe.tts_stream(text, prompt=prompt, **skw):
                marks.append(1e3 * (time.perf_counter() - t0))
                chunks.append(c)
            return chunks, marks

        (chunks, marks), counts = run_path(
            torch, cuda_lib, shapes, f"serve_stream {sr} Hz", stream)
        full = pipe.tts(text, prompt=prompt, **kw)
        wav = np.concatenate(chunks)
        if wav.shape != full.shape or not np.isfinite(wav).all():
            fail(f"serve_stream {sr} Hz: {wav.shape} vs tts {full.shape}")
        line = {"phase": "serve_stream", "output_sr": sr, "frames": n,
                "chunk_frames": STREAM_CHUNK, "halo_frames": STREAM_HALO,
                "chunks": len(chunks), "chunk_samples": [len(c) for c in chunks],
                "first_chunk_ms": marks[0], "last_chunk_ms": marks[-1],
                "calls": counts}
        if sr == 16000:
            err = float(np.abs(wav / np.abs(wav).max() * 0.999 - full).max())
            line.update(max_err_normalised=err, tolerance=STREAM_TOL)
            ok = err <= STREAM_TOL
        else:
            iw, jf = wav[:-STREAM_TAIL], full[:-STREAM_TAIL]
            gain = float(np.dot(iw, jf) / np.dot(iw, iw))
            err = float(np.abs(gain * iw - jf).max())
            d = np.abs(gain * wav - full)
            line.update(max_err_interior=err, tolerance=STREAM_TOL,
                        interior=f"all but the last {STREAM_TAIL} samples",
                        max_err_whole=float(d.max()),
                        whole_err_samples_from_end=int(len(d) - np.argmax(d)))
            ok = err <= STREAM_TOL
        print(json.dumps(line), flush=True)
        if not ok:
            fail(f"serve_stream {sr} Hz: stream differs from tts ({line})")
        if min(counts[k] for k in PATH_KERNELS) < 1:
            fail(f"serve_stream {sr} Hz: a kernel was not launched: {counts}")


def serve_server_phase(torch, pipe, reqs, shapes):
    """TTSServer(max_batch=SERVER_REQUESTS): SERVER_REQUESTS requests from
    SERVER_THREADS threads for SERVER_SPEAKERS bucketed speakers (3.5-5 s
    texts, 48 kHz). Every future must give a finite waveform of its own tts
    call's length. Prints ms per request and the number of tts_batch and
    tts calls."""
    import threading

    from megatts2_hierspeechpp_torch.infer.server import TTSServer
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    ls = reqs[-1][2]
    kw = dict(length_scale=ls, output_sr=48000, seed=7)
    speakers = [pipe.prepare_prompt(speaker_audio(i), bucket=True)
                for i in range(SERVER_SPEAKERS)]
    # 3.5-5 s texts, all in one text bucket (see serve_texts)
    rng = np.random.default_rng(31)
    texts = []
    while len(texts) < SERVER_REQUESTS:
        text = tts_text(rng, 3.5 + 1.5 * len(texts) / (SERVER_REQUESTS - 1))
        if not texts or text_bucket(text) == text_bucket(texts[0]):
            texts.append(text)
    work = [(t, speakers[i % SERVER_SPEAKERS]) for i, t in enumerate(texts)]
    calls = {"tts_batch": 0, "tts": 0}
    orig = {k: getattr(pipe, k) for k in calls}

    def spy(k):
        def fn(*a, **k2):
            calls[k] += 1
            return orig[k](*a, **k2)
        return fn

    def serve():
        server = TTSServer(pipe, max_batch=SERVER_REQUESTS, max_wait_ms=100)
        futs = [None] * SERVER_REQUESTS
        per = SERVER_REQUESTS // SERVER_THREADS

        def client(j):
            for i in range(j * per, (j + 1) * per):
                futs[i] = server.submit(work[i][0], work[i][1], **kw)

        try:
            threads = [threading.Thread(target=client, args=(j,))
                       for j in range(SERVER_THREADS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            return [f.result(timeout=600) for f in futs]
        finally:
            server.close()

    for k in calls:
        setattr(pipe, k, spy(k))
    try:
        serve()  # warm-up
        calls.update(tts_batch=0, tts=0)
        t0 = time.perf_counter()
        outs, counts = run_path(torch, cuda_lib, shapes, "serve_server", serve)
        ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for k in calls:
            delattr(pipe, k)
    lens = [len(pipe.tts(t, prompt=p, **kw)) for t, p in work]
    line = {"phase": "serve_server", "requests": SERVER_REQUESTS,
            "threads": SERVER_THREADS, "speakers": SERVER_SPEAKERS,
            "ms": ms, "ms_per_request": ms / SERVER_REQUESTS,
            "audio_s": sum(lens) / 48000, "pipeline_calls": dict(calls),
            "calls": counts, "samples": [len(o) for o in outs]}
    print(json.dumps(line), flush=True)
    for i, (o, n) in enumerate(zip(outs, lens)):
        if o.shape != (n,) or not np.isfinite(o).all():
            fail(f"serve_server request {i}: {o.shape}, its own tts gives {n}")
    if min(counts[k] for k in PATH_KERNELS) < 1:
        fail(f"serve_server: a kernel was not launched: {counts}")


SHAPE_TOL = {"aa_snakebeta": 1e-5, "triple_avg": 1e-5, "triple_post": 1e-4,
             "snake_conv": 1e-4}   # x max|ref|, PERF.md section 2


def new_shapes_phase(torch, dev, shapes):
    """Each kernel against its plain version at every distinct launch shape
    that the serving paths gave it (LaunchShapes), on fresh random inputs:
    one launch and one plain call each. The AA-snake and the epilogue (whose
    plans were picked at B=1, T=2000) also with their device ms per launch
    (profiler; "device_ms": null where the profiler recorded too few of
    the launches, which it does late in a long run), and snake_conv at the
    vc path's shapes (summed per B, T, C). One line per kernel and shape
    (snake_conv: per B, T, C), with the worst error over the tolerance, the
    bound and the plain version's ms (CUDA events, a second call after the
    one compared; for snake_conv both summed over the launch shapes)."""
    from megatts2_hierspeechpp_torch.models.plm import ProsodyLM, teacher_forced_gap
    from megatts2_hierspeechpp_torch.nn.conv import conv1d_op
    from megatts2_hierspeechpp_torch.ops.amp_triple import (
        composed_epilogue, fused_epilogue)
    from megatts2_hierspeechpp_torch.ops.ampblock import snake_conv
    from megatts2_hierspeechpp_torch.ops.plm_decode import (
        plain_gap, plm_decode_greedy)
    from megatts2_hierspeechpp_torch.ops.resample import activation1d
    from megatts2_hierspeechpp_torch.ops.snake import (
        composed_snakebeta, fused_aa_snakebeta, inverse_beta)

    gen = torch.Generator().manual_seed(17)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def pos(*shape):
        return torch.exp(randn(*shape, scale=0.2))

    def err_of(y, ref):
        return (y - ref).abs().max().item(), ref.abs().max().item()

    model = None
    convs = {}
    n_checked = 0
    for key, path in sorted(shapes.seen.items(), key=lambda kv: str(kv[0])):
        kind = key[0]
        line = {"phase": "new_shape", "kernel": kind, "path": path}
        with torch.inference_mode():
            if kind == "aa_snakebeta":
                _, b, t, c = key
                x, a, be = randn(b, t, c), pos(c), pos(c)
                ib = inverse_beta(be)
                fn = lambda: fused_aa_snakebeta(x, a, be, ib)  # noqa: E731
                plain = lambda: composed_snakebeta(x, a, be)  # noqa: E731
                err, scale = err_of(fn(), plain())
                n = b * t * c
                line.update(shape=f"B={b} T={t} C={c}",
                            plain_ms=event_ms(torch, plain)[1],
                            device_ms=device_ms(torch, fn, ("aa_snakebeta",), 10,
                                                required=False))
                line["bound_ms"], line["bound_by"] = bound_ms(
                    4.0 * (2 * n + 2 * c), SNAKE_FLOPS * n)
            elif kind in ("triple_avg", "triple_post"):
                _, b, t, c = key
                rs = [randn(b, t, c, scale=3.0) for _ in range(3)]
                post = ((pos(c), pos(c), randn(7, c, scale=0.1 * (7 * c) ** -0.5))
                        if kind == "triple_post" else None)
                fn = lambda: fused_epilogue(*rs, post)  # noqa: E731
                plain = lambda: composed_epilogue(*rs, post)  # noqa: E731
                err, scale = err_of(fn(), plain())
                n = b * t * c
                line.update(shape=f"B={b} T={t} C={c}",
                            plain_ms=event_ms(torch, plain)[1],
                            device_ms=device_ms(torch, fn, (kind + "_kernel",), 10,
                                                required=False))
                line["bound_ms"], line["bound_by"] = bound_ms(
                    *((4.0 * (3 * n + b * t + 9 * c),
                       3.0 * n + (SNAKE_FLOPS + 14) * n + b * t)
                      if post is not None else (16.0 * n, 3.0 * n)))
            elif kind == "snake_conv":
                _, b, t, c, k, d, has_res = key
                x = randn(b, t, c)
                res = randn(b, t, c) if has_res else None
                a, ib = pos(c), pos(c)
                w, bias = randn(k, c, c, scale=(c * k) ** -0.5), randn(c, scale=0.05)
                y = snake_conv(x, a, ib, w, bias, d, res=res)

                def plain():
                    ref = conv1d_op(activation1d(
                        x, lambda v: v + torch.sin(v * a).square() * ib),
                        w.permute(1, 2, 0).contiguous(), bias, 1,
                        (k - 1) // 2 * d, d)
                    return ref if res is None else ref + res

                ref = plain()
                err, scale = err_of(y, ref)
                conv_plain = event_ms(torch, plain)[1]
                n, n_io = b * t * c, 3 if has_res else 2
                conv_bound = bound_ms(4.0 * (n_io * n + k * c * c + 3 * c),
                                      SNAKE_FLOPS * n + (n_io - 1) * n,
                                      2.0 * n * c * k)[0]
                conv_dev = (device_ms(torch, lambda: snake_conv(
                    x, a, ib, w, bias, d, res=res), ("snake_conv",), 10,
                    required=False) if path.startswith("vc") else None)
                del x, res, y, ref
            else:  # plm_decode at a new length
                _, t, wb, cb = key
                if model is None:
                    model = ProsodyLM(seed=99, device=dev)
                dts = {4: torch.float32, 2: torch.bfloat16}
                tc = randn(1, t, 256)
                codes = plm_decode_greedy(model.packed(), tc, model.go_id,
                                          dts[wb], dts[cb])
                err, scale = (teacher_forced_gap(model, tc, codes) if wb == cb == 4
                              else plain_gap(model.packed(), tc, codes,
                                             model.go_id, dts[wb], dts[cb]))
                kind = "plm_gap" if wb == cb == 4 else "plm_gap_bf16"
                line.update(shape=f"T={t} weight bytes {wb} cache bytes {cb}")
        tol = SHAPE_TOL.get(kind, TF_MARGIN if kind == "plm_gap" else BF16_MARGIN)
        if not (math.isfinite(err) and err <= tol * scale):
            print(json.dumps(dict(line, max_abs_err=err, max_abs_ref=scale)),
                  flush=True)
            fail(f"{kind} {key}: max abs err {err} > {tol} x {scale}")
        n_checked += 1
        if kind == "snake_conv":  # one line per (path, B, T, C)
            g = convs.setdefault((path, key[1], key[2], key[3]),
                                 {"phase": "new_shape", "kernel": "snake_conv",
                                  "path": path,
                                  "shape": f"B={key[1]} T={key[2]} C={key[3]}",
                                  "launch_shapes": 0, "worst_err_over_tol": 0.0,
                                  "bound_ms": 0.0, "device_ms": 0.0,
                                  "plain_ms": 0.0})
            g["launch_shapes"] += 1
            g["bound_ms"] += conv_bound
            g["plain_ms"] += conv_plain
            g["device_ms"] = (None if conv_dev is None or g["device_ms"] is None
                              else g["device_ms"] + conv_dev)
            g["worst_err_over_tol"] = max(g["worst_err_over_tol"],
                                          err / (tol * scale))
            continue
        line.update(max_abs_err=err, max_abs_ref=scale,
                    tolerance=f"{tol:g} x max|ref|")
        print(json.dumps(line), flush=True)
    for g in convs.values():
        print(json.dumps(g), flush=True)
    print(json.dumps({"phase": "new_shapes", "checked": n_checked}), flush=True)


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


def cpu_tts_phase(torch, pipe, cpu_pipe, prompt, cpu_prompt, reqs,
                  denoise_ratio: float = 0.0, path: str = "tts"):
    """The 100-frame tts request on the CPU with the card's prosody codes
    (a near-tie flip in the decode cannot fail it): the same frame count and
    the same waveform before normalisation. Also the share of the CPU plain
    decode's codes that equal the card kernel's."""
    from megatts2_hierspeechpp_torch.models.plm import decode

    _, text, ls, _ = reqs[0]
    kw = dict(length_scale=ls, output_sr=48000, exact=True,
              denoise_ratio=denoise_ratio, return_intermediates=True)
    _, ac, raw = pipe.tts(text, prompt=prompt, **kw)
    codes = ac.codes.cpu().numpy()
    _, cac, craw = cpu_pipe.tts(text, prompt=cpu_prompt, codes=codes, **kw)
    agree = float((decode(cpu_pipe.plm, cac.x_frame).numpy() == codes).mean())
    if cac.frames != ac.frames:
        fail(f"tts card vs CPU: {ac.frames} vs {cac.frames} frames")
    card, cpu = raw.cpu().numpy(), craw.numpy()
    diff = float(np.abs(card - cpu).max())
    line = {"phase": "card_vs_cpu", "path": path, "frames": ac.frames,
            "max_abs_diff": diff, "max_abs_cpu": float(np.abs(cpu).max()),
            "tolerance": CPU_TOL, "cpu_plain_decode_agreement": agree}
    print(json.dumps(line), flush=True)
    if not diff <= CPU_TOL:
        fail(f"{path} card vs CPU waveform differs by {diff} > {CPU_TOL}")


def speech_like(seconds: float, f_base: float, seed: int) -> np.ndarray:
    """Synthetic 16 kHz voice: a harmonic tone gliding +-20 % around f_base,
    gated into 2.5 syllables per second with silent gaps (so YIN sees
    voiced and unvoiced frames), plus a little noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    f = f_base * (1.0 + 0.2 * np.sin(2 * np.pi * 0.4 * t))
    phase = 2 * np.pi * np.cumsum(f) / 16000.0
    env = np.clip(1.5 * np.sin(2 * np.pi * 1.25 * t + 0.3), 0.0, 1.0)
    y = env * sum(0.25 / h * np.sin(h * phase) for h in range(1, 7))
    return (y + 0.005 * rng.standard_normal(n)).astype(np.float32)


class one_stft:
    """While active, the pipelines' denoiser STFT is taken once, on the CPU,
    from the first call's input (the CPU pipeline's, which runs first), and
    every later call gets the same magnitude and phase on its own device:
    so a card-vs-CPU comparison of one audio feeds both sides one STFT. The
    first frame of the reflect-padded STFT is real, and each bin with a
    negative real part gets a phase of +pi or -pi by the sign of the
    rounding in its imaginary part, which the denoiser reads as an input
    (tests/test_torch_denoiser.py): a one-ulp change of the input (the
    card's RMS scaling) or another FFT can flip it."""

    def __enter__(self):
        from megatts2_hierspeechpp_torch.infer import pipeline as tpipe

        self.mod, self.orig, self.saved = tpipe, tpipe.mag_pha_stft, None

        def stft(y, *args):
            if self.saved is None:
                self.saved = self.orig(y.cpu(), *args)
            return tuple(a.to(y.device) for a in self.saved)

        tpipe.mag_pha_stft = stft
        return self

    def __exit__(self, *exc):
        self.mod.mag_pha_stft = self.orig


def pad_to(audio: np.ndarray, grid: int) -> np.ndarray:
    """Zero-padded to (T // grid + 1) * grid samples, as the pipeline pads."""
    return np.pad(audio, (0, (len(audio) // grid + 1) * grid - len(audio)))


def denoise_phase(torch, dev, pipe, cpu_pipe, audio):
    """MP-SENet at the reference widths on the 3 s prompt, through the
    pipeline's `denoise` (RMS normalisation, STFT, MPNet, iSTFT): CUDA-event
    ms and peak memory of the dense and the query-chunked attention (the
    chunked form against the dense, on the card); card against CPU with one
    STFT fed to both (gated), and with each side's own STFT (reported: the
    first frame's +-pi phases differ between cuFFT and the CPU's FFT)."""
    from megatts2_hierspeechpp_torch.models.denoiser import MPNet
    from megatts2_hierspeechpp_torch.ops.stft import mag_pha_stft

    cfg = pipe.denoiser_cfg
    pipe.denoiser = MPNet(seed=5678, device=dev)
    cpu_pipe.denoiser = MPNet(seed=5678, device="cpu")
    padded = pad_to(audio, 1600)
    frames = len(padded) // cfg["hop"] + 1

    def measured():
        pipe.denoise(padded)  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = [event_ms(torch, lambda: pipe.denoise(padded))[1] for _ in range(3)]
        extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        return pipe.denoise(padded).cpu().numpy(), ms, extra

    own, ms, extra_mb = measured()
    pipe.denoiser.set_attn_chunk(DENOISE_CHUNK)
    try:
        chunked, chunk_ms, chunk_extra_mb = measured()
    finally:
        pipe.denoiser.set_attn_chunk(None)
    cpu_own = cpu_pipe.denoise(padded).numpy()
    with one_stft():
        cpu = cpu_pipe.denoise(padded).numpy()
        card = pipe.denoise(padded).cpu().numpy()
    with torch.inference_mode():
        x = torch.from_numpy(padded)[None]
        args = (cfg["n_fft"], cfg["hop"], cfg["win"], cfg["compress"])
        p_cpu = mag_pha_stft(x, *args)[1][0]
        p_card = mag_pha_stft(x.to(dev), *args)[1][0].cpu()
    flips = (p_card - p_cpu).abs() > math.pi
    peak = float(np.abs(cpu).max())

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    line = {"phase": "denoise", "samples": len(padded), "stft_frames": frames,
            "dense_ms": ms, "chunked_ms": chunk_ms, "chunk": DENOISE_CHUNK,
            "extra_peak_memory_mb": {"dense": extra_mb, "chunked": chunk_extra_mb},
            "chunked_vs_dense_max_abs": float(np.abs(chunked - own).max()),
            "chunked_equals_dense": bool(np.array_equal(chunked, own)),
            "card_vs_cpu_one_stft": {"rel_l2": rel_l2(card, cpu),
                                     "max_abs": float(np.abs(card - cpu).max()),
                                     "peak": peak},
            "card_vs_cpu_own_stft": {"rel_l2": rel_l2(own, cpu_own),
                                     "max_abs": float(np.abs(own - cpu_own).max()),
                                     "phase_flips": int(flips.sum()),
                                     "phase_flips_first_frame": int(flips[0].sum())},
            "tolerance": f"rel L2 and max abs / peak {DENOISE_TOL:g}; chunked "
                         f"{CHUNK_TOL:g} x peak"}
    print(json.dumps(line), flush=True)
    c = line["card_vs_cpu_one_stft"]
    if own.shape != (len(padded),) or not np.isfinite(own).all():
        fail(f"denoise: {own.shape} output, finite {np.isfinite(own).all()}")
    if not (c["rel_l2"] <= DENOISE_TOL and c["max_abs"] <= DENOISE_TOL * peak):
        fail(f"denoise card vs CPU: {c}")
    if not line["chunked_vs_dense_max_abs"] <= CHUNK_TOL * peak:
        fail(f"denoise: chunked attention differs from dense by "
             f"{line['chunked_vs_dense_max_abs']}")


def tts_denoise_phase(torch, pipe, cpu_pipe, audio, reqs, shapes):
    """The 10 s tts request from prompt audio at denoise_ratio 0.8, 48 kHz,
    exact lengths: ms on the host clock, kernel calls, launch shapes, and
    the stages under CUDA events, the denoise stage beside the others
    (prepare_prompt's ms holds it); then the 2 s request card against CPU
    with the card's codes and one STFT."""
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    if pipe.denoiser is None or cpu_pipe.denoiser is None:
        fail("tts_denoise: no denoiser attached (denoise_phase attaches it)")
    f, text, ls, n = reqs[-1]
    kw = dict(length_scale=ls, output_sr=48000, exact=True,
              denoise_ratio=DENOISE_RATIO)
    pipe.tts(text, audio, **kw)  # warm-up
    t0 = time.perf_counter()
    out, counts = run_path(torch, cuda_lib, shapes, "tts_denoise",
                           lambda: pipe.tts(text, audio, **kw))
    ms = 1e3 * (time.perf_counter() - t0)
    _, den_ms = event_ms(torch, lambda: pipe.denoise(pad_to(audio, 1600)))
    prompt, prep_ms = event_ms(
        torch, lambda: pipe.prepare_prompt(audio, DENOISE_RATIO))
    stages = dict(denoise_ms=den_ms, prepare_prompt_ms=prep_ms,
                  **tts_stages(torch, pipe, prompt, text, ls, DENOISE_RATIO))
    peak = float(np.abs(out).max())
    line = {"phase": "tts_denoise", "denoise_ratio": DENOISE_RATIO,
            "frames": n, "samples": int(out.shape[0]), "ms": ms,
            "audio_s_per_s": (out.shape[0] / 48000) / (ms / 1e3),
            "peak": peak, "calls": counts, "stages_ms": stages}
    print(json.dumps(line), flush=True)
    if out.shape != (960 * n,) or not np.isfinite(out).all():
        fail(f"tts_denoise: {out.shape} samples, expected {960 * n}, finite")
    if abs(peak - 0.999) > 1e-5 or counts != TTS_CALLS:
        fail(f"tts_denoise: peak {peak}, kernel calls {counts}")
    with one_stft():
        cpu_prompt = cpu_pipe.prepare_prompt(audio, DENOISE_RATIO)
        prompt = pipe.prepare_prompt(audio, DENOISE_RATIO)
    cpu_tts_phase(torch, pipe, cpu_pipe, prompt, cpu_prompt, reqs,
                  DENOISE_RATIO, "tts_denoise")


class StageEvents:
    """CUDA events around calls of the pipeline's own stages while active:
    {stage: summed ms}, read after the call and a synchronise."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.spans = torch, targets, []

    def __enter__(self):
        self.saved = []
        for obj, name, key in self.targets:
            fn = getattr(obj, name)
            self.saved.append((obj, name, fn, name in vars(obj)))
            setattr(obj, name, self._timed(key, fn))
        return self

    def _timed(self, key, fn):
        def run(*a, **k):
            ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            self.spans.append((key, *ev))
            return out
        return run

    def __exit__(self, *exc):
        for obj, name, fn, own in reversed(self.saved):
            if own:
                setattr(obj, name, fn)
            else:
                delattr(obj, name)

    def ms(self) -> dict:
        self.torch.cuda.synchronize()
        out = {}
        for key, a, b in self.spans:
            out[key] = out.get(key, 0.0) + a.elapsed_time(b)
        return out


def vc_phase(torch, dev, pipe, cpu_pipe, shapes):
    """TTSPipeline.vc with a full-width Wav2Vec2 (mms-300m widths, its first
    7 layers) on a 5 s source and a 3 s target, at 16 and 48 kHz and
    denoise_ratio 0 and 0.8: ms per call (host clock, after a warm-up),
    stage ms by CUDA events (w2v, f0, denoise, vocode, sr), kernel calls
    and launch shapes; one call profiled; YIN card against CPU on both
    signals; the 48 kHz denoise_ratio 0.8 call card against CPU with the
    f0 and the denoiser's STFT computed once on the CPU (the w2v features
    held on their own, and the rest of the path also on the CPU's
    features)."""
    from megatts2_hierspeechpp_torch.infer import pipeline as tpipe
    from megatts2_hierspeechpp_torch.models.wav2vec2 import Wav2Vec2
    from megatts2_hierspeechpp_torch.ops import cuda_lib
    from megatts2_hierspeechpp_torch.ops.f0 import yin_f0

    if pipe.denoiser is None or cpu_pipe.denoiser is None:
        fail("vc: no denoiser attached (denoise_phase attaches it)")
    w2v = Wav2Vec2(seed=6789, device=dev)
    src = speech_like(VC_SECONDS[0], 130.0, 41)
    trg = speech_like(VC_SECONDS[1], 210.0, 42)
    t_frames = len(pad_to(src, 1280)) // 320
    for sr, ratio in VC_CONFIGS:  # warm-up of every shape
        pipe.vc(src, trg, w2v, ratio, output_sr=sr)
    for sr, ratio in VC_CONFIGS:
        label = f"vc {sr // 1000} kHz denoise {ratio}"
        t0 = time.perf_counter()
        out, counts = run_path(torch, cuda_lib, shapes, label,
                               lambda: pipe.vc(src, trg, w2v, ratio, output_sr=sr))
        ms = 1e3 * (time.perf_counter() - t0)
        stages = StageEvents(torch, [
            (w2v, "forward", "w2v_ms"), (tpipe, "yin_f0", "f0_ms"),
            (pipe, "denoise", "denoise_ms"),
            (pipe.vocoder, "voice_conversion", "vocode_ms"),
            (pipe.speechsr, "forward", "sr_ms")])
        with stages:
            pipe.vc(src, trg, w2v, ratio, output_sr=sr)
        # SpeechSR's one triple launch runs at 48 kHz only
        want_calls = dict(EXPECTED_CALLS, amp_triple=EXPECTED_CALLS["amp_triple"]
                          - (sr != 48000))
        n = 320 * t_frames * sr // 16000
        peak = float(np.abs(out).max())
        line = {"phase": "vc", "output_sr": sr, "denoise_ratio": ratio,
                "source_s": VC_SECONDS[0], "target_s": VC_SECONDS[1],
                "frames": t_frames, "samples": int(out.shape[0]), "ms": ms,
                "audio_s_per_s": (out.shape[0] / sr) / (ms / 1e3),
                "stages_ms": stages.ms(), "peak": peak, "calls": counts}
        print(json.dumps(line), flush=True)
        if out.shape != (n,) or not np.isfinite(out).all():
            fail(f"{label}: {out.shape} samples, expected {n}, finite")
        if abs(peak - 0.999) > 1e-5 or counts != want_calls:
            fail(f"{label}: peak {peak}, kernel calls {counts}, expected "
                 f"{want_calls}")
    profile_phase(torch, f"vc 48 kHz denoise {DENOISE_RATIO}", t_frames,
                  lambda: pipe.vc(src, trg, w2v, DENOISE_RATIO, output_sr=48000))

    f0s = {}
    for name, x in (("source", pad_to(src, 1280)), ("target", trg)):
        with torch.inference_mode():
            xt = torch.from_numpy(x)[None]
            f_cpu = yin_f0(xt)[0].numpy()
            f_card = yin_f0(xt.to(dev))[0].cpu().numpy()
        f0s[name] = f_cpu
        both = (f_cpu > 0) & (f_card > 0)
        rel = np.abs(f_card[both] - f_cpu[both]) / f_cpu[both]
        line = {"phase": "yin_card_vs_cpu", "signal": name,
                "frames": int(f_cpu.shape[0]),
                "voiced_share": float((f_cpu > 0).mean()),
                "voicing_agreement": float(((f_cpu > 0) == (f_card > 0)).mean()),
                "within_1e-4_share": float((rel <= 1e-4).mean()),
                "max_rel_diff": float(rel.max()), "tolerance": YIN_AGREE}
        print(json.dumps(line), flush=True)
        if not (line["voicing_agreement"] >= YIN_AGREE
                and line["within_1e-4_share"] >= YIN_AGREE):
            fail(f"yin_f0 card vs CPU on the {name}: {line}")

    cpu_w2v = Wav2Vec2(seed=6789, device="cpu")
    kw = dict(denoise_ratio=DENOISE_RATIO, output_sr=48000,
              src_f0=f0s["source"], trg_f0=f0s["target"],
              return_intermediates=True)
    with one_stft():
        cpu, cpu_i = cpu_pipe.vc(src, trg, cpu_w2v, **kw)
        card, card_i = pipe.vc(src, trg, w2v, **kw)
        feats = cpu_i["w2v"]
        same, _ = pipe.vc(src, trg, lambda x: feats.to(dev), **kw)
    w2v_err = (card_i["w2v"].cpu() - feats).abs().max().item()
    line = {"phase": "card_vs_cpu", "path": f"vc 48 kHz denoise {DENOISE_RATIO}",
            "frames": t_frames, "max_abs_diff": float(np.abs(card - cpu).max()),
            "max_abs_diff_cpu_w2v": float(np.abs(same - cpu).max()),
            "w2v_max_abs_diff": w2v_err,
            "w2v_max_abs": feats.abs().max().item(),
            "max_abs_cpu": float(np.abs(cpu).max()), "tolerance": CPU_TOL,
            "note": "after peak normalisation; f0 and STFT given"}
    print(json.dumps(line), flush=True)
    if not line["max_abs_diff"] <= CPU_TOL:
        fail(f"vc card vs CPU waveform differs by {line['max_abs_diff']} > "
             f"{CPU_TOL}")


# ---- phase 10: vocoder training through cli/train_vocoder ----

TRAIN_CONFIG = "configs/hierspeechpp.json"  # published widths, batch 32, 32-frame windows
TRAIN_UTTERANCES = 96       # the synthetic corpus: three batches of 32
TRAIN_KERNELS = ("aa_snakebeta", "ampblock", "amp_triple")
TRAIN_CPU_FRAMES = 64       # card vs CPU step: 2 utterances cut to 64 frames
TRAIN_LOSS_TOL = 1e-4       # card vs CPU, each loss, relative
TRAIN_GRAD_TOL = 1e-3       # card vs CPU, relative L2 of all G (all D) gradients
TRAIN_BWD_TOL = 1e-4        # a kernel's gradients against autograd of its
                            # plain version, x max|ref| of each tensor
TRAIN_FWD_TOL = {"aa_snakebeta": 1e-5, "ampblock": 1e-4, "amp_triple": 1e-4}
OURS = ("aa_snakebeta_kernel", "snake_conv_kernel", "triple_avg_kernel",
        "triple_post_kernel")
TRAIN_GROUPS = (  # the rest of a step's kernels, first match wins
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("cuDNN/cuBLAS conv+gemm", ("conv", "cudnn", "xmma", "gemm", "sgemm",
                                "cutlass", "implicit", "wgrad", "dgrad")),
    ("fft", ("fft",)),
    ("memcpy/memset", ("memcpy", "memset", "Memcpy", "Memset")),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
)


class KernelCalls:
    """The distinct calls of the three vocoder kernels' autograd Functions
    while `on`: (kernel, x shape, the static arguments) -> calls. The
    wrappers look the Functions up at call time, so a shim in their place
    sees each call."""

    def __init__(self):
        from megatts2_hierspeechpp_torch.ops import amp_triple, ampblock, snake

        self.seen, self.on = {}, False
        self._orig = [(m, a, getattr(m, a)) for m, a in (
            (snake, "_AASnakeBeta"), (ampblock, "_AMPBlock"),
            (amp_triple, "_AMPTriple"))]
        for (mod, attr, fn), kind in zip(self._orig, TRAIN_KERNELS):
            setattr(mod, attr, self._shim(fn, kind))

    def _shim(self, fn, kind):
        rec = self

        class Shim:
            @staticmethod
            def apply(*args):
                if rec.on:
                    static = (() if kind == "aa_snakebeta" else
                              args[1:3] if kind == "ampblock" else args[1:4])
                    key = (kind, tuple(args[0].shape), static)
                    rec.seen[key] = rec.seen.get(key, 0) + 1
                return fn.apply(*args)

        return Shim

    def close(self):
        for mod, attr, fn in self._orig:
            setattr(mod, attr, fn)


class TimedStep:
    """A CLI's train step with CUDA events around each call and the kernel
    launch counts of each step (zeroed just before it). B and T come from
    batch[frames_key], the true frames from batch[lengths_key]."""

    def __init__(self, torch, step, kernels=TRAIN_KERNELS,
                 frames_key="mask", lengths_key="lengths"):
        self.torch, self.step, self.records = torch, step, []
        self.kernels, self.keys = kernels, (frames_key, lengths_key)

    def __call__(self, state, batch, generator):
        from megatts2_hierspeechpp_torch.ops import cuda_lib

        torch = self.torch
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        out, ms = event_ms(torch, lambda: self.step(state, batch, generator))
        b, t = batch[self.keys[0]].shape[:2]
        self.records.append({
            "step": out[0].step, "ms": ms, "B": b, "T": t,
            "frames": int(batch[self.keys[1]].sum()),
            "launches": {k: cuda_lib.LAUNCHES[k] for k in self.kernels}})
        return out


def train_config(path, hps, corpus_dir, **train):
    """A copy of the config reading `corpus_dir`, with `train` overrides."""
    cfg = hps.to_dict()
    cfg["data"]["training_files"] = f"{corpus_dir}/train_list.txt"
    cfg["train"].update(train)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def train_profile(torch, step, state, batch, seed: int):
    """One train step under torch.profiler: device ms by group, the idle
    share of the step's wall time, launches, the top kernels. The groups
    are exclusive: our kernels (their forward); the kernels' backward, every
    kernel launched by a host op inside a plain_vjp range (the plain
    version's recompute and its autograd backward); then the rest by name
    (cuDNN / cuBLAS, optimizer, elementwise, ...)."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def group_of(name):
        if any(k in name for k in OURS):
            return "our kernels (forward)"
        return next((g for g, keys in TRAIN_GROUPS
                     if any(k in name for k in keys)), "other")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    groups, counts, per_name = {}, {}, {}
    for ev in events:
        if ev.device_type != DeviceType.CUDA or ev.name == "plain_vjp" \
                or getattr(ev, "is_user_annotation", False):
            continue
        ms = ev.time_range.elapsed_us() / 1e3
        g = group_of(ev.name)
        groups[g] = groups.get(g, 0.0) + ms
        counts[g] = counts.get(g, 0) + 1
        a, c = per_name.get(ev.name, (0.0, 0))
        per_name[ev.name] = (a + ms, c + 1)
    # the kernels each host op launched, and whether it ran in plain_vjp
    host = {}
    for ev in events:
        if ev.device_type == DeviceType.CPU and ev.name == "plain_vjp":
            host.setdefault(ev.thread, []).append(
                (ev.time_range.start, ev.time_range.end))
    host = {th: sorted(r) for th, r in host.items()}
    vjp, vjp_n = {}, 0
    for ev in events:
        ranges = host.get(ev.thread) if ev.device_type == DeviceType.CPU else None
        if not ranges or not ev.kernels:
            continue
        i = bisect.bisect_right([a for a, _ in ranges], ev.time_range.start) - 1
        if i < 0 or ev.time_range.start >= ranges[i][1]:
            continue
        for k in ev.kernels:
            g = group_of(k.name)
            vjp[g] = vjp.get(g, 0.0) + k.duration / 1e3
            vjp_n += 1
    split = {"plain-VJP recompute + backward": sum(vjp.values())}
    for g, ms in groups.items():
        split[g] = ms - vjp.get(g, 0.0)
    dev_ms = sum(groups.values())
    spans = [ev.time_range.elapsed_us() / 1e3 for ev in events
             if ev.device_type == DeviceType.CUDA and ev.name == "plain_vjp"]
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    line = {"phase": "train_profile", "wall_ms": wall_ms,
            "device_kernel_ms": dev_ms or "not measured",
            "device_idle_share": (1 - dev_ms / wall_ms) if dev_ms else "not measured",
            "kernel_launches": sum(counts.values()),
            "split_ms": dict(sorted(split.items(), key=lambda kv: -kv[1])),
            "plain_vjp_by_name_ms": vjp, "plain_vjp_launches": vjp_n,
            "plain_vjp_ranges": {"host": sum(map(len, host.values())),
                                 "device": len(spans)},
            "plain_vjp_device_span_ms": sum(spans),
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "groups_launches": counts,
            "top_kernels": [[k[:100], ms, c] for k, (ms, c) in top]}
    print(json.dumps(line), flush=True)


def train_cpu_phase(torch, dev, hps, ds):
    """One step at full width on the card and on the CPU from the same
    weights, batch and draws: every loss, and the G and D gradients."""
    from megatts2_hierspeechpp_torch.cli.train_vocoder import (
        build_state, vocoder_batch)
    from megatts2_hierspeechpp_torch.train import vocoder as vt

    t = TRAIN_CPU_FRAMES
    full = vocoder_batch(ds, [0, 1])
    cut = {"audio": 320 * t, "spec": t, "mel": t, "w2v": t, "f0": 4 * t,
           "mask": t}
    batch = {k: np.ascontiguousarray(full[k][:, :n]) for k, n in cut.items()}
    batch["lengths"] = np.minimum(full["lengths"], t)
    step = vt.TrainStep(segment_frames=hps.train.segment_frames,
                              c_mel=hps.train.c_mel, c_kl=hps.train.c_kl)
    out = []
    for d in (dev, torch.device("cpu")):
        state = build_state(hps, d, hps.train.seed)
        tb = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        draws = step.draw(state, tb, torch.Generator().manual_seed(11))
        t0 = time.perf_counter()
        state, m = step.with_draws(state, tb, *draws)
        m = {k: float(v) for k, v in m.items()}  # waits for the device
        ms = 1e3 * (time.perf_counter() - t0)
        grads = {name: torch.cat([p.grad.detach().flatten().cpu()
                                  for p in mod.parameters()])
                 for name, mod in (("G", state.gen), ("D", state.disc))}
        out.append((m, grads, ms))
        del state
    (mc, gc, ms_c), (mp, gp, ms_p) = out
    loss_err = {k: abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in mp}
    grad_err = {k: ((gc[k] - gp[k]).norm() / gp[k].norm()).item() for k in gp}
    line = {"phase": "train_card_vs_cpu", "B": 2, "frames": t,
            "card_ms": ms_c, "cpu_ms": ms_p, "losses_card": mc,
            "loss_rel_err": loss_err, "grad_rel_l2": grad_err,
            "tolerance": {"loss": TRAIN_LOSS_TOL, "grad": TRAIN_GRAD_TOL}}
    print(json.dumps(line), flush=True)
    if not all(math.isfinite(v) for v in mc.values()):
        fail(f"train card vs CPU: non-finite loss {mc}")
    if not max(loss_err.values()) <= TRAIN_LOSS_TOL:
        fail(f"train card vs CPU: losses differ {loss_err}")
    if not max(grad_err.values()) <= TRAIN_GRAD_TOL:
        fail(f"train card vs CPU: gradients differ {grad_err}")


def train_backward_phase(torch, dev, calls):
    """Each kernel at every training launch shape: its wrapper's forward and
    backward (plain_vjp) against autograd of its plain version on the card,
    the same inputs and cotangent; ms of the kernel's forward, the plain
    forward and the wrapper's backward (CUDA events), and the forward's
    bound."""
    from megatts2_hierspeechpp_torch.ops.amp_triple import (
        composed_triple, fused_amp_triple)
    from megatts2_hierspeechpp_torch.ops.ampblock import (
        composed_ampblock, fused_ampblock)
    from megatts2_hierspeechpp_torch.ops.snake import (
        composed_snakebeta, fused_aa_snakebeta)

    gen = torch.Generator().manual_seed(29)

    def leaf(*shape, scale=1.0, positive=False):
        v = torch.randn(shape, generator=gen) * scale
        return (torch.exp(v) if positive else v).to(dev).requires_grad_()

    def block_ws(c, k):
        return [leaf(3, c, scale=0.2, positive=True),
                leaf(3, c, scale=0.2, positive=True),
                leaf(3, k, c, c, scale=(c * k) ** -0.5), leaf(3, c, scale=0.05),
                leaf(3, c, scale=0.2, positive=True),
                leaf(3, c, scale=0.2, positive=True),
                leaf(3, k, c, c, scale=(c * k) ** -0.5), leaf(3, c, scale=0.05)]

    rows = []
    for (kind, shape, static), n_calls in sorted(calls.items(), key=str):
        b, t, c = shape
        x = leaf(b, t, c)
        if kind == "aa_snakebeta":
            ws = [leaf(c, scale=0.2, positive=True),
                  leaf(c, scale=0.2, positive=True)]
            fused = lambda: fused_aa_snakebeta(x, *ws)  # noqa: E731
            plain = lambda: composed_snakebeta(x, *ws)  # noqa: E731
            n_bytes, flops, conv = 4.0 * (2 * b * t * c + 2 * c), SNAKE_FLOPS * b * t * c, 0.0
            label = f"B={b} T={t} C={c}"
        elif kind == "ampblock":
            k, dil = static
            ws = block_ws(c, k)
            fused = lambda: fused_ampblock(x, *ws, k, dil)  # noqa: E731
            plain = lambda: composed_ampblock(x, *ws, k, dil)  # noqa: E731
            n_bytes = 4.0 * (2 * b * t * c + 6 * k * c * c + 10 * c)
            flops, conv = block_flops(b * t, c, k)
            label = f"B={b} T={t} C={c} k={k}"
        else:
            ks, dils, has_post = static
            bws = [block_ws(c, k) for k in ks]
            post = ([leaf(c, scale=0.2, positive=True),
                     leaf(c, scale=0.2, positive=True),
                     leaf(7, c, scale=0.1 * (7 * c) ** -0.5)] if has_post else None)
            ws = [w for bw in bws for w in bw] + (post or [])
            fused = lambda: fused_amp_triple(x, bws, ks, dils, post)  # noqa: E731
            plain = lambda: composed_triple(x, bws, ks, dils, post)  # noqa: E731
            flops = sum(block_flops(b * t, c, k)[0] for k in ks) + 3.0 * b * t * c
            conv = sum(block_flops(b * t, c, k)[1] for k in ks)
            if has_post:
                flops += (SNAKE_FLOPS + 14) * b * t * c + b * t
            n_bytes = 4.0 * (b * t * c + (b * t if has_post else b * t * c)
                             + sum(6 * k * c * c + 10 * c for k in ks))
            label = f"B={b} T={t} C={c} ks={list(ks)}{' +tail' if has_post else ''}"
        leaves = [x] + ws
        y = fused()
        ct = torch.randn(y.shape, generator=gen).to(dev)
        grads = torch.autograd.grad(y, leaves, ct, retain_graph=True)
        yr = plain()
        refs = torch.autograd.grad(yr, leaves, ct)
        fwd_err = ((y - yr).abs().max() / yr.abs().max()).item()
        grad_err = max(((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
                       for g, r in zip(grads, refs))
        del yr, refs
        with torch.no_grad():
            ms = time_ms(torch, fused, 5)
            plain_ms = time_ms(torch, plain, 3)
        bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            y, leaves, ct, retain_graph=True), 3)
        b_ms, b_by = bound_ms(n_bytes, flops, conv)
        line = {"phase": "train_shape", "kernel": kind, "shape": label,
                "calls_in_first_run": n_calls, "fwd_err_over_ref": fwd_err,
                "grad_err_over_ref": grad_err,
                "tolerance": {"fwd": f"{TRAIN_FWD_TOL[kind]:g} x max|ref|",
                              "grad": f"{TRAIN_BWD_TOL:g} x max|ref| per tensor"},
                "ms": ms, "plain_ms": plain_ms, "bwd_plain_vjp_ms": bwd_ms,
                "bound_ms": b_ms, "bound_by": b_by}
        print(json.dumps(line), flush=True)
        if not (fwd_err <= TRAIN_FWD_TOL[kind] and grad_err <= TRAIN_BWD_TOL):
            fail(f"{kind} {label} under autograd: forward {fwd_err}, "
                 f"gradients {grad_err} of max|ref|")
        rows.append(line)
        del x, ws, leaves, y, grads, ct
    print(json.dumps({"phase": "train_shapes", "checked": len(rows)}), flush=True)
    return rows


def train_vocoder_phase(torch, dev, shapes, tmp):
    """cli/train_vocoder at the published widths on a synthetic corpus
    written into `tmp`: 3 steps, a checkpoint, a resumed run of 3 more; each
    step's ms and kernel launches, audio-s per s, peak memory; one step
    profiled; one step card against CPU; every kernel's backward at its
    training shapes. Returns (per-step launches of the first step, the
    train_shape rows, the corpus directory); the run's checkpoints are
    deleted."""
    import os
    import shutil

    from megatts2_hierspeechpp_torch.cli import make_synth_corpus
    from megatts2_hierspeechpp_torch.cli import train_vocoder as cli
    from megatts2_hierspeechpp_torch.data.dataset import (
        DatasetConfig, DistributedBucketSampler, SidecarDataset)
    from megatts2_hierspeechpp_torch.ops import cuda_lib
    from megatts2_hierspeechpp_torch.train import checkpoints as ckpt
    from megatts2_hierspeechpp_torch.utils.config import load_hparams

    hps = load_hparams(TRAIN_CONFIG)
    corpus = os.path.join(tmp, "corpus")
    t0 = time.perf_counter()
    make_synth_corpus.make_corpus(corpus, n=TRAIN_UTTERANCES, seed=0)
    corpus_s = time.perf_counter() - t0
    logs = os.path.join(tmp, "logs")
    cfg1 = train_config(os.path.join(tmp, "c1.json"), hps, corpus, epochs=1,
                        log_interval=1, save_interval=2)
    cfg2 = train_config(os.path.join(tmp, "c2.json"), hps, corpus, epochs=2,
                        log_interval=1, save_interval=2)
    steps = []
    make_step = cli.vt.TrainStep

    def timed_step(**kw):
        steps.append(TimedStep(torch, make_step(**kw)))
        return steps[-1]

    calls = KernelCalls()
    cli.vt.TrainStep = timed_step
    torch.cuda.reset_peak_memory_stats()
    try:
        calls.on = True
        shapes.path = "train_vocoder"
        t0 = time.perf_counter()
        state = cli.main(["-c", cfg1, "-m", "run", "--logs_dir", logs])
        first_s = time.perf_counter() - t0
        calls.on = False
        shapes.path = None
        peak = torch.cuda.max_memory_allocated()
        after_first = ckpt.latest_step(os.path.join(logs, "run", "ckpt"))
        t0 = time.perf_counter()
        state = cli.main(["-c", cfg2, "-m", "run", "--logs_dir", logs])
        second_s = time.perf_counter() - t0
    finally:
        cli.vt.TrainStep = make_step
        calls.close()
        shapes.path = None
    recs = [r for s in steps for r in s.records]
    with open(os.path.join(logs, "run", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    for r in recs:
        print(json.dumps(dict(r, phase="train_step")), flush=True)
    hop_s = 320 / 16000
    med = float(np.median([r["ms"] for r in recs[1:]]))

    def rate(seconds_of):  # median audio-s per s of the steps after the first
        return float(np.median([seconds_of(r) / (r["ms"] / 1e3)
                                for r in recs[1:]]))

    line = {"phase": "train_vocoder", "config": TRAIN_CONFIG,
            "utterances": TRAIN_UTTERANCES, "corpus_s": corpus_s,
            "steps": [r["step"] for r in recs],
            "first_run_s": first_s, "resumed_run_s": second_s,
            "checkpoint_after_first_run": after_first,
            "step_ms_median_after_first": med,
            "step_ms": [r["ms"] for r in recs],
            "audio_s_per_s_encoded": rate(lambda r: r["frames"] * hop_s),
            "audio_s_per_s_encoded_padded": rate(
                lambda r: r["B"] * r["T"] * hop_s),
            "audio_s_per_s_decoded": rate(
                lambda r: r["B"] * hps.train.segment_frames * hop_s),
            "peak_memory_mb": peak / 2 ** 20,
            "launches_per_step": recs[0]["launches"],
            "losses_last": {k: v for k, v in scalars[-1].items()
                            if k.startswith("loss/")}}
    print(json.dumps(line), flush=True)
    if [r["step"] for r in recs] != [1, 2, 3, 4, 5, 6]:
        fail(f"train_vocoder: steps {[r['step'] for r in recs]}, expected 1-6 "
             "(3, then 3 resumed from the checkpoint)")
    if after_first != 3 or state.step != 6:
        fail(f"train_vocoder: checkpoint {after_first}, final step {state.step}")
    if [s["step"] for s in scalars] != [1, 2, 3, 4, 5, 6]:
        fail(f"train_vocoder: logged steps {[s['step'] for s in scalars]}")
    for s in scalars:
        bad = {k: v for k, v in s.items()
               if k.startswith("loss/") and not math.isfinite(v)}
        if bad:
            fail(f"train_vocoder step {s['step']}: non-finite losses {bad}")
    for r in recs:
        if min(r["launches"].values()) < 1:
            fail(f"train_vocoder step {r['step']}: a kernel was not launched "
                 f"{r['launches']}")

    ds = SidecarDataset(f"{corpus}/train_list.txt", DatasetConfig())
    sampler = DistributedBucketSampler(ds.lengths(), hps.train.batch_size,
                                       list(cli.BOUNDARIES),
                                       seed=hps.train.seed)
    batch = cli.vocoder_batch(ds, sampler.epoch_batches(0)[0])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    step = cli.vt.TrainStep(segment_frames=hps.train.segment_frames,
                                  c_mel=hps.train.c_mel, c_kl=hps.train.c_kl)
    train_profile(torch, step, state, batch, seed=5)
    del state, batch
    torch.cuda.empty_cache()
    shutil.rmtree(logs)   # 3 checkpoints of 1.7 GB
    train_cpu_phase(torch, dev, hps, ds)
    torch.cuda.empty_cache()
    rows = train_backward_phase(torch, dev, calls.seen)
    cuda_lib.reset_launches()
    return recs[0]["launches"], rows, corpus


# ---- phase 11: s2 / s1 training (cli/train_s2, cli/train_s1) and the
# trained models served ----

S_CONFIG = "configs/config.json"  # published: batch 8, lr 1e-4, betas (0.8, 0.99),
                                  # eps 1e-9, c_commit 100; TTV / PLM at full depth
S_UTTERANCES = 24       # phase 10's utterances of one length bucket: 3 batches of 8
S_CPU_FRAMES = 64       # card vs CPU steps: 2 utterances cut to 64 frames
S_LOSS_TOL = 1e-4       # card vs CPU, each metric, relative
S_GRAD_TOL = 1e-3       # card vs CPU, relative L2 of all G (all D) gradients
S_VQ_TOL = 1e-5         # card vs CPU, the RVQ statistics, x max|CPU|
S2_SYNTH = (8, 512, 128, 512)   # the synthetic step: B, frames (10.24 s), phones,
                                # MRTE frames: what a real corpus pads to
S_GROUPS = (  # a step's kernels by name, first match wins
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("LSTM (cuDNN RNN)", ("RNN", "LSTM", "lstm", "rnn")),
    ("cuDNN/cuBLAS conv+gemm", ("conv", "cudnn", "xmma", "gemm", "sgemm", "gemv",
                                "cutlass", "implicit", "wgrad", "dgrad")),
    ("memcpy/memset", ("memcpy", "memset", "Memcpy", "Memset")),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise")),
)


def s_subset(corpus, dst, n: int = S_UTTERANCES):
    """A filelist of n of the corpus's utterances, all in its most common
    length bucket (cli/train_s2.BOUNDARIES), so that an epoch at batch 8 is
    n / 8 steps. Returns dst."""
    import os

    from megatts2_hierspeechpp_torch.cli.train_s2 import BOUNDARIES
    from megatts2_hierspeechpp_torch.data.dataset import (
        DatasetConfig, SidecarDataset)

    ds = SidecarDataset(f"{corpus}/train_list.txt", DatasetConfig())
    bucket = [next(i for i in range(len(BOUNDARIES) - 1)
                   if BOUNDARIES[i] < t <= BOUNDARIES[i + 1]) for t in ds.lengths()]
    common = max(set(bucket), key=bucket.count)
    rows = [ds.items[i][:3] for i, b in enumerate(bucket) if b == common][:n]
    if len(rows) < n:
        fail(f"s2 corpus: {len(rows)} utterances in one bucket, {n} wanted")
    os.makedirs(dst, exist_ok=True)
    with open(f"{dst}/trans.txt", "w", encoding="utf-8") as f:
        f.write("\n".join("|".join(r) for r in rows) + "\n")
    with open(f"{dst}/train_list.txt", "w") as f:
        f.write(f"{dst}/trans.txt\n")
    return dst


def run_cli(cli_mod, step_mod, torch, argv_runs):
    """cli_mod.main(argv) for each argv, step_mod.TrainStep wrapped in
    TimedStep (every serving kernel counted: none may launch): (the last
    run's state, the step records, the runs' s)."""
    steps, secs = [], []
    make_step = step_mod.TrainStep

    def timed(*a, **kw):
        steps.append(TimedStep(torch, make_step(*a, **kw), PATH_KERNELS,
                               "mel", "mel_lengths"))
        return steps[-1]

    step_mod.TrainStep = timed
    try:
        for argv in argv_runs:
            t0 = time.perf_counter()
            state = cli_mod.main(argv)
            secs.append(time.perf_counter() - t0)
    finally:
        step_mod.TrainStep = make_step
    return state, [r for s in steps for r in s.records], secs


def check_run(label, recs, scalars, state, loss_keys):
    """Steps 1-6 (3, then 3 resumed), every logged loss finite, no kernel
    of the serving path launched by a training step."""
    steps = [r["step"] for r in recs]
    if steps != [1, 2, 3, 4, 5, 6] or state.step != 6:
        fail(f"{label}: steps {steps}, final {state.step}, expected 1-6 "
             "(3, then 3 resumed from the checkpoint)")
    logged = [s["step"] for s in scalars if any(k in s for k in loss_keys)]
    if logged != [1, 2, 3, 4, 5, 6]:
        fail(f"{label}: logged steps {logged}")
    for s in scalars:
        bad = {k: v for k, v in s.items() if not math.isfinite(v)}
        if bad:
            fail(f"{label} step {s['step']}: non-finite scalars {bad}")
    launched = [r["launches"] for r in recs if any(r["launches"].values())]
    if launched:
        fail(f"{label}: a training step launched a serving kernel {launched}")


def step_profile(torch, label, fn):
    """fn() (one train step) under torch.profiler: device ms by group,
    the idle share of its wall time, kernel launches, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups, counts, per_name = {}, {}, {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        ms = ev.time_range.elapsed_us() / 1e3
        g = next((g for g, keys in S_GROUPS if any(k in ev.name for k in keys)),
                 "other")
        groups[g] = groups.get(g, 0.0) + ms
        counts[g] = counts.get(g, 0) + 1
        a, c = per_name.get(ev.name, (0.0, 0))
        per_name[ev.name] = (a + ms, c + 1)
    dev_ms = sum(groups.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    line = {"phase": "train_profile", "path": label, "wall_ms": wall_ms,
            "device_kernel_ms": dev_ms or "not measured",
            "device_idle_share": (1 - dev_ms / wall_ms) if dev_ms else "not measured",
            "kernel_launches": sum(counts.values()),
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "groups_launches": counts,
            "top_kernels": [[k[:100], ms, c] for k, (ms, c) in top]}
    print(json.dumps(line), flush=True)
    return line


def cut_batch(batch, t: int, rows=(0, 1)):
    """Rows of a collated s2 batch with the frame axes cut to t frames."""
    rows = list(rows)
    out = {k: np.ascontiguousarray(v[rows]) for k, v in batch.items()}
    for k, n in (("w2v", t), ("mel", t), ("pitch", 4 * t)):
        out[k] = np.ascontiguousarray(out[k][:, :n])
    for k in ("w2v_lengths", "mel_lengths"):
        out[k] = np.minimum(out[k], t).astype(np.int32)
    out["pitch_lengths"] = (4 * out["mel_lengths"]).astype(np.int32)
    return out


def card_vs_cpu(torch, dev, label, build, run, batch):
    """One step on the card and on the CPU from the same weights, batch and
    draws: build(device) -> state; run(state, batch, device) -> (metrics,
    {name: flat gradients}, {name: flat state to compare})."""
    out = []
    for d in (dev, torch.device("cpu")):
        state = build(d)
        tb = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        t0 = time.perf_counter()
        m, grads, extra = run(state, tb, d)
        m = {k: float(v) for k, v in m.items()}  # waits for the device
        ms = 1e3 * (time.perf_counter() - t0)
        out.append((m, {k: v.detach().cpu() for k, v in grads.items()},
                    {k: v.detach().cpu() for k, v in extra.items()}, ms))
        del state
    (mc, gc, xc, ms_c), (mp, gp, xp, ms_p) = out
    loss_err = {k: abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in mp}
    grad_err = {k: ((gc[k] - gp[k]).norm() / gp[k].norm()).item() for k in gp}
    extra_err = {k: ((xc[k] - xp[k]).abs().max() / xp[k].abs().max()).item()
                 for k in xp}
    line = {"phase": "train_card_vs_cpu", "path": label, "B": 2,
            "frames": S_CPU_FRAMES, "card_ms": ms_c, "cpu_ms": ms_p,
            "metrics_card": mc, "metric_rel_err": loss_err,
            "grad_rel_l2": grad_err, "state_err_over_max": extra_err,
            "tolerance": {"metric": S_LOSS_TOL, "grad": S_GRAD_TOL,
                          "state": S_VQ_TOL}}
    print(json.dumps(line), flush=True)
    if not all(math.isfinite(v) for v in mc.values()):
        fail(f"{label} card vs CPU: non-finite metrics {mc}")
    if not max(loss_err.values()) <= S_LOSS_TOL:
        fail(f"{label} card vs CPU: metrics differ {loss_err}")
    if not max(grad_err.values()) <= S_GRAD_TOL:
        fail(f"{label} card vs CPU: gradients differ {grad_err}")
    if extra_err and not max(extra_err.values()) <= S_VQ_TOL:
        fail(f"{label} card vs CPU: state differs {extra_err}")


def flat_grads(torch, params):
    return torch.cat([p.grad.flatten() for p in params if p.grad is not None])


def synthetic_s2_batch(torch, dev, rng):
    """A random s2 batch of S2_SYNTH on the card: integer 100 Hz durations
    summing to twice the frames, f0 70 % voiced."""
    from megatts2_hierspeechpp_torch.data import text as frontend

    b, t, n, m = S2_SYNTH
    dur = np.stack([1 + rng.multinomial(2 * t - n, np.ones(n) / n)
                    for _ in range(b)]).astype(np.float32)
    pitch = np.where(rng.uniform(size=(b, 4 * t)) < 0.7,
                     rng.uniform(90, 260, (b, 4 * t)), 0.0).astype(np.float32)
    i32 = np.int32
    batch = {
        "x_ids": rng.integers(1, frontend.N_VOCAB, (b, n)).astype(i32),
        "tone": rng.integers(0, frontend.N_TONE, (b, n)).astype(i32),
        "language": rng.integers(0, frontend.N_LANGUAGE, (b, n)).astype(i32),
        "x_lengths": np.full(b, n, i32), "dur": dur,
        "w2v": rng.standard_normal((b, t, 1024)).astype(np.float32),
        "w2v_lengths": np.full(b, t, i32),
        "mel": rng.standard_normal((b, t, 80)).astype(np.float32),
        "mel_lengths": np.full(b, t, i32), "pitch": pitch,
        "pitch_lengths": np.full(b, 4 * t, i32),
        "mrte_mel": rng.standard_normal((b, m, 80)).astype(np.float32),
        "mrte_mel_lengths": np.full(b, m, i32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def rate_line(recs, hop_s: float = 320 / 16000):
    """Median ms of the steps after the first, and median audio-s per s of
    the utterances (their true frames) and of the padded batch."""
    after = recs[1:]
    return {"step_ms": [r["ms"] for r in recs],
            "step_ms_median_after_first": float(np.median([r["ms"] for r in after])),
            "audio_s_per_s": float(np.median(
                [r["frames"] * hop_s / (r["ms"] / 1e3) for r in after])),
            "audio_s_per_s_padded": float(np.median(
                [r["B"] * r["T"] * hop_s / (r["ms"] / 1e3) for r in after])),
            "frames_per_s": float(np.median(
                [r["frames"] / (r["ms"] / 1e3) for r in after]))}


def train_s2_phase(torch, dev, tmp, corpus):
    """cli/train_s2 at full width on S_UTTERANCES utterances: 3 steps, a
    checkpoint, 3 resumed; a profiled step; the synthetic 10 s step; the
    card-vs-CPU gate. Returns (the run's directory, the two configs, the
    first batch)."""
    import os

    from megatts2_hierspeechpp_torch.cli import train_s2 as cli
    from megatts2_hierspeechpp_torch.data.dataset import collate
    from megatts2_hierspeechpp_torch.nn.basic import MaskSource
    from megatts2_hierspeechpp_torch.train import s2
    from megatts2_hierspeechpp_torch.utils.config import load_hparams

    sub = s_subset(corpus, os.path.join(tmp, "s2corpus"))
    hps = load_hparams(S_CONFIG)
    logs = os.path.join(tmp, "slogs")
    common = dict(log_interval=1, save_interval=3, eval_interval=3,
                  eval_plots=False)
    cfg1 = train_config(os.path.join(tmp, "epoch1.json"), hps, sub, epochs=1,
                        **common)
    cfg2 = train_config(os.path.join(tmp, "epoch2.json"), hps, sub, epochs=2,
                        **common)
    torch.cuda.reset_peak_memory_stats()
    state, recs, secs = run_cli(cli, s2, torch, [
        ["-c", cfg1, "-m", "s2", "--logs_dir", logs],
        ["-c", cfg2, "-m", "s2", "--logs_dir", logs]])
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(logs, "s2", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    for r in recs:
        print(json.dumps(dict(r, phase="train_s2_step")), flush=True)
    check_run("train_s2", recs, scalars, state, ("loss/g/total",))
    evals = [s for s in scalars if "eval/w2v_l1" in s]
    if [s["step"] for s in evals] != [3, 6]:
        fail(f"train_s2: eval at steps {[s['step'] for s in evals]}, expected 3, 6")

    # one step of the CLI's first batch, profiled
    hps2 = load_hparams(cfg2)
    ds = cli.SidecarDataset(hps2.data.training_files, cli.DatasetConfig())
    sampler = cli.DistributedBucketSampler(ds.lengths(), hps2.train.batch_size,
                                           list(cli.BOUNDARIES), seed=hps2.train.seed)
    first = collate([ds[i] for i in sampler.epoch_batches(0)[0]], pad_multiple=64)
    step = s2.TrainStep(c_mel=hps2.train.c_mel, c_commit=hps2.train.c_commit)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
    prof = step_profile(torch, "train_s2 B=8", lambda: step(
        state, tb, torch.Generator().manual_seed(5)))

    # the synthetic 10 s batch: 1 warm-up, 3 timed
    synth = synthetic_s2_batch(torch, dev, np.random.default_rng(17))
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(4):
        _, ms = event_ms(torch, lambda: step(state, synth,
                                             torch.Generator().manual_seed(30 + i)))
        times.append(ms)
    synth_peak = torch.cuda.max_memory_allocated()
    b, t = S2_SYNTH[:2]
    synth_ms = float(np.median(times[1:]))
    synth_prof = step_profile(torch, f"train_s2 synthetic B={b} T={t}", lambda: step(
        state, synth, torch.Generator().manual_seed(40)))
    line = {"phase": "train_s2", "config": S_CONFIG, "utterances": S_UTTERANCES,
            "steps": [r["step"] for r in recs], "runs_s": secs,
            **rate_line(recs), "peak_memory_mb": peak / 2 ** 20,
            "our_kernel_launches_per_step": recs[0]["launches"],
            "device_kernel_launches_per_step": prof["kernel_launches"],
            "device_idle_share": prof["device_idle_share"],
            "synthetic": {"B": b, "T": t, "phones": S2_SYNTH[2],
                          "step_ms": times, "step_ms_median": synth_ms,
                          "audio_s_per_s": b * t * 320 / 16000 / (synth_ms / 1e3),
                          "peak_memory_mb": synth_peak / 2 ** 20,
                          "device_idle_share": synth_prof["device_idle_share"],
                          "device_kernel_launches": synth_prof["kernel_launches"]},
            "losses_last": {k: v for k, v in scalars[-2].items()
                            if k.startswith("loss/")},
            "eval_last": evals[-1]}
    print(json.dumps(line), flush=True)
    del state, synth, tb
    torch.cuda.empty_cache()

    # card vs CPU: the same weights, batch, coin and dropout masks (drawn on
    # the CPU and moved)
    batch = cut_batch(first, S_CPU_FRAMES)

    def run(st, tb, d):
        coin = (torch.rand((), generator=torch.Generator().manual_seed(3)) <= 0.5)
        masks = MaskSource(torch.Generator().manual_seed(4))
        st, m = step.with_draws(st, tb, coin.to(d), masks)
        vq = {k: v for k, v in st.ttv.quantizer.state_dict().items()
              if not k.endswith("inited")}
        uv = {k: v for k, v in st.disc.state_dict().items()
              if k.startswith("discriminators.0.") and k.endswith(("weight_u", "weight_v"))}
        return m, {"G": flat_grads(torch, st.opt_g.params),
                   "D": flat_grads(torch, st.opt_d.params)}, {**vq, **uv}

    card_vs_cpu(torch, dev, "train_s2", lambda d: cli.build_state(
        hps2, d, hps2.train.seed, 1000), run, batch)
    return os.path.join(logs, "s2"), (cfg1, cfg2), first


def train_s1_phase(torch, dev, tmp, s2_dir, cfgs, first):
    """cli/train_s1 from train_s2's checkpoint: 3 steps + 3 resumed; the
    card-vs-CPU gate. Returns (the last run's state, the first batch on the
    card)."""
    import os

    from megatts2_hierspeechpp_torch.cli import train_s1 as cli
    from megatts2_hierspeechpp_torch.nn.basic import MaskSource
    from megatts2_hierspeechpp_torch.train import s1
    from megatts2_hierspeechpp_torch.utils.config import load_hparams

    logs = os.path.join(tmp, "slogs")
    ckpt = os.path.join(s2_dir, "ckpt")
    cfg1, cfg = cfgs
    torch.cuda.reset_peak_memory_stats()
    state, recs, secs = run_cli(cli, s1, torch, [
        ["-c", cfg1, "-m", "s1", "--logs_dir", logs, "--s2_ckpt", ckpt],
        ["-c", cfg, "-m", "s1", "--logs_dir", logs, "--s2_ckpt", ckpt]])
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(logs, "s1", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    for r in recs:
        print(json.dumps(dict(r, phase="train_s1_step")), flush=True)
    check_run("train_s1", recs, scalars, state, ("loss/plm",))
    rates = rate_line(recs)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
    prof = step_profile(torch, "train_s1 B=8", lambda: s1.TrainStep()(
        state, tb, torch.Generator().manual_seed(6)))
    line = {"phase": "train_s1", "config": S_CONFIG, "steps": [r["step"] for r in recs],
            "runs_s": secs, "step_ms": rates["step_ms"],
            "step_ms_median_after_first": rates["step_ms_median_after_first"],
            "tokens_per_s": rates["frames_per_s"],
            "peak_memory_mb": peak / 2 ** 20,
            "our_kernel_launches_per_step": recs[0]["launches"],
            "device_kernel_launches_per_step": prof["kernel_launches"],
            "device_idle_share": prof["device_idle_share"],
            "metrics_last": {k: v for k, v in scalars[-2].items()
                             if k.startswith(("loss/", "acc/"))}}
    print(json.dumps(line), flush=True)

    hps = load_hparams(cfg)

    def build(d):
        return cli.build_state(hps, d, cli.load_s2_vars(ckpt, hps, d))

    def run(st, tb, d):
        st, m = s1.TrainStep().with_draws(st, tb, MaskSource(
            torch.Generator().manual_seed(8)))
        return m, {"PLM": flat_grads(torch, st.opt.params)}, {}

    card_vs_cpu(torch, dev, "train_s1", build, run, cut_batch(first, S_CPU_FRAMES))
    return state, tb


def serve_trained_phase(torch, dev, shapes, audio, state, batch):
    """The trained models served: the s1 run's PLM takes one more step
    after its decode weights were packed (an optimizer's in-place update),
    then it and the frozen s2 TTV serve a 10 s tts request with the serving
    vocoder and SpeechSR-48k. Gates: all four kernels launch; the decode's
    teacher-forced gap against the plain twin; its codes equal those of a
    fresh build loaded with the same state_dict and packed anew."""
    from megatts2_hierspeechpp_torch.models.plm import (
        ProsodyLM, decode, teacher_forced_gap)
    from megatts2_hierspeechpp_torch.ops import cuda_lib
    from megatts2_hierspeechpp_torch.train import s1

    plm = state.plm
    stale = plm.packed()
    stale_wqkv = stale.wqkv.clone()
    s1.TrainStep()(state, batch, torch.Generator().manual_seed(9))
    plm.eval()
    repacked = plm.packed() is not stale
    moved = not torch.equal(plm.packed().wqkv, stale_wqkv)
    pipe = build_pipeline(torch, dev)
    pipe.ttv, pipe.plm = state.ttv, plm
    prompt = pipe.prepare_prompt(audio)
    (f, text, ls, n) = tts_requests(pipe, prompt)[-1]
    pipe.tts(text, prompt=prompt, length_scale=ls, output_sr=48000, exact=True)
    t0 = time.perf_counter()
    (out, ac, _), counts = run_path(torch, cuda_lib, shapes, "serve_trained", lambda: pipe.tts(
        text, prompt=prompt, length_scale=ls, output_sr=48000, exact=True,
        return_intermediates=True))
    ms = 1e3 * (time.perf_counter() - t0)
    gap, scale = teacher_forced_gap(plm, ac.x_frame, ac.codes)
    fresh = ProsodyLM(n_layers=len(plm.plm.layers), seed=99, device=dev)
    fresh.load_state_dict(plm.state_dict())
    fresh_codes = decode(fresh, ac.x_frame)
    same = bool(torch.equal(fresh_codes.cpu(), ac.codes.cpu()))
    line = {"phase": "serve_trained", "frames": ac.frames, "target_frames": f,
            "length_scale": ls, "ms": ms, "samples": int(out.shape[0]),
            "audio_s_per_s": (out.shape[0] / 48000) / (ms / 1e3), "calls": counts,
            "repacked_after_step": repacked, "weights_moved": moved,
            "tf_gap": gap, "max_abs_logit": scale,
            "tolerance": f"{TF_MARGIN:g} x max|logit|",
            "codes_equal_fresh_pack": same}
    print(json.dumps(line), flush=True)
    if not (repacked and moved):
        fail(f"serve_trained: the decode weights were not packed anew after "
             f"an optimizer step (repacked {repacked}, moved {moved})")
    if min(counts[k] for k in PATH_KERNELS) < 1:
        fail(f"serve_trained: a kernel was not launched: {counts}")
    if out.shape != (960 * ac.frames,) or not np.isfinite(out).all():
        fail(f"serve_trained: output {out.shape}, finite {np.isfinite(out).all()}")
    if not gap <= TF_MARGIN * scale:
        fail(f"serve_trained: teacher-forced gap {gap} > {TF_MARGIN} x {scale}")
    if not same:
        fail("serve_trained: codes differ from a freshly packed PLM's")
    return counts


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
    kernels["amp_triple"] = epilogue_phase(torch, dev)
    snake_conv_phase(torch, dev)
    kernels["plm_decode"] = plm_phase(torch, dev)
    bf16 = plm_bf16_phase(torch, dev)
    kernels["plm_decode_bf16"] = [bf16]
    _, pipe, prompt, audio, inputs = path_phase(torch, dev)
    launches, reqs = tts_phase(torch, pipe, prompt)
    if min(launches[k] for k in PATH_KERNELS) < 1:
        fail(f"a kernel was not launched on the tts path: {launches}")
    launches["plm_decode_bf16"] = bf16["launches"]
    t = REQUEST_FRAMES[-1]
    w2v, mask, lf0 = (torch.from_numpy(a) for a in inputs[t])
    profile_phase(torch, "synthesize", t, lambda: pipe.synthesize(
        prompt, w2v, mask, lf0, output_sr=48000))
    f, text, ls, n = reqs[-1]
    profile_phase(torch, "tts", n, lambda: pipe.tts(
        text, prompt=prompt, length_scale=ls, output_sr=48000, exact=True))
    with torch.inference_mode():
        cpu_pipe = build_pipeline(torch, "cpu")
        cpu_prompt = cpu_pipe.prepare_prompt(audio)
        cpu_phase(torch, pipe, cpu_pipe, prompt, cpu_prompt, inputs)
    cpu_tts_phase(torch, pipe, cpu_pipe, prompt, cpu_prompt, reqs)
    shapes = LaunchShapes(cuda_lib)
    serve_batch_phase(torch, pipe, prompt, reqs[-1][2], shapes)
    serve_stream_phase(torch, pipe, prompt, reqs[-1], shapes)
    serve_server_phase(torch, pipe, reqs, shapes)
    denoise_phase(torch, dev, pipe, cpu_pipe, audio)
    tts_denoise_phase(torch, pipe, cpu_pipe, audio, reqs, shapes)
    vc_phase(torch, dev, pipe, cpu_pipe, shapes)
    del pipe, cpu_pipe
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, _, corpus = train_vocoder_phase(torch, dev, shapes, tmp)
        s2_dir, cfgs, first = train_s2_phase(torch, dev, tmp, corpus)
        s1_state, batch = train_s1_phase(torch, dev, tmp, s2_dir, cfgs, first)
        serve_launches = serve_trained_phase(torch, dev, shapes, audio,
                                             s1_state, batch)
        del s1_state, batch
    torch.cuda.empty_cache()
    new_shapes_phase(torch, dev, shapes)

    # ms: CUDA events around the wrapper on every row, as in earlier runs;
    # device_ms: the kernel's own time (profiler) where the phase took it
    out = []
    for key, lines in kernels.items():
        slowest = max(lines, key=lambda ln: ln["ms"])
        name, src, replaces = SOURCES[key]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": max(ln["max_abs_err"] for ln in lines),
            "ms": slowest["ms"], "device_ms": slowest.get("device_ms"),
            "plain_ms": slowest["plain_ms"],
            "bound_ms": slowest["bound_ms"], "bound_by": slowest["bound_by"],
            "bound_ms_f32": slowest.get("bound_ms_f32"),
            "library_ms": None, "shape": slowest["shape"],
            "launches_from": ("models/plm.decode, bf16, B=4 per row"
                              if key == "plm_decode_bf16" else
                              "tts requests, phase 5"),
        })
        if train_launches.get(key, 0) > out[-1]["launches"]:
            out[-1].update(launches=train_launches[key],
                           launches_from="train_vocoder, one B=32 step, phase 10")
        if key in serve_launches:
            out[-1]["launches_serve_trained"] = serve_launches[key]
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
