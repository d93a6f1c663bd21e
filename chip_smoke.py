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
     teacher-forced check, and a bf16 latent through models/plm.decode (one
     launch, the codes of its float32 cast); its bf16 weight / cache configuration at T = 500
     (ms, teacher-forced gap against the bf16 plain twin, token agreement
     with float32, 10 repeats identical), and the per-row greedy decode of
     a batch of 4 in float32 and bf16 (one launch per row); the three
     vocoder kernels' bf16 configuration (bf16 in and out, float32 inside,
     each conv one bf16 mma pass) at the same serving shapes against their
     bf16 twins (`kernel_bf16` lines: bf16_check, ms, device ms, the twin's
     ms, the bf16 bound beside the 3xTF32 one);
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
     epilogue with their device ms; bf16 snake_conv launches with
     "events_ms", those that write float32 also held by their mean error;
     the shared-prompt batch profiled);
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
     which run last; then `bf16_forward`: the bf16 HierVocoder and
     SpeechSR-48k built as bench.py builds them, at its B = 4, T = 1000
     frames (80 s of audio): ms, audio-s per s, peak memory, launches per
     call (19 / 6 / 4 and 1 under the _bf16 keys), the profiled split, the
     float32 forward of the same weights beside it and the distance
     between them; at B = 1, 100 frames the card's bf16-to-float32
     distance within EXACT_RATIO x the CPU's; the bf16 launch shapes join
     the `new_shape` lines (dtype bf16);
 10. vocoder training at the published widths (configs/hierspeechpp.json,
     batch 32, 32-frame windows) at the CLI's default, bf16 compute (the
     config sets no train.dtype): cli/make_synth_corpus writes 96
     utterances, cli/train_vocoder.main runs in-process for one epoch (3
     steps, a checkpoint at step 2 and at the epoch's end), then again on
     the same directory for a second epoch, resumed from the checkpoint:
     each step's ms (CUDA events) and kernel launches (zeroed before each
     step; each bf16 kernel must launch in every step, no float32 one),
     audio-s per s encoded and decoded, peak memory; then train.dtype
     "fp32" on 32 of the utterances, 1 step and 1 resumed, its float32
     kernels in every step, the eval hook after each (its B = 32 launch
     shapes join the float32 `new_shape` lines); one step of each under
     torch.profiler on the same batch, by group (our kernels' forward,
     their plain-VJP recompute and backward, cuDNN / cuBLAS, optimizer,
     elementwise) with the idle share; one step at B = 2, 64 frames, card against CPU from the same
     weights and draws, in float32 (each loss within 1e-4 relative, G and D
     gradients within 1e-3 relative L2) and in bf16 (each side's distance
     from its own float32 step, the card's within EXACT_RATIO x the
     CPU's); and each kernel's wrapper at every training launch shape of
     both runs, forward and backward against autograd of its plain version
     (`train_shape` lines: forward, plain and backward ms, bound; the
     gradients within 1e-4 x max|ref| per tensor with cuDNN deterministic;
     the bf16 ones against autograd of the twin, with bf16_check, the bf16
     bound and what a float32 backward would read). The eval hook
     (make_vocoder_eval_fn: B = 32 inference of epoch 0's first batch,
     eval/mel_l1) runs at steps 3 and 6 of the bf16 run and 1 and 2 of the
     float32 one, its ms and launches recorded. The training and eval
     launch shapes join the `new_shape` lines;
 11. MegaTTS2 training at the published widths and depths
     (configs/config.json: batch 8, lr 1e-4, c_commit 100; TTVModel and
     the MultiResSpecDiscriminator, ProsodyLM 4 layers, d 276) at the CLIs'
     default, bf16 compute with float32 parameters (the config sets no
     train.dtype, as the JAX CLIs): `train_s2`, cli/train_s2.main in-process
     on 24 of phase 10's utterances (one length bucket: 3 batches of 8),
     k-means on the first batch, 3 steps, a checkpoint, 3 resumed; then
     train.dtype "fp32" on 8 of them, 1 step and 1 resumed. For each run:
     each step's ms (CUDA events), audio-s per s, peak memory, launches;
     one B = 8 step profiled by group (cuDNN / cuBLAS, LSTM, elementwise,
     optimizer) with the idle share; the synthetic 10 s batch (B = 8, 512
     frames, 128 phones), its steps timed and one profiled. One step at
     B = 2, 64 frames card against CPU from the same weights, coin and
     dropout masks (drawn on the CPU), in float32 (each metric within 1e-4
     relative, G and D gradients within 1e-3 relative L2, the RVQ
     statistics and the spectral norm's u / v within 1e-5 of their largest)
     and in bf16 (each side's distance from its own float32 step, the
     card's within EXACT_RATIO x the CPU's, a gradient's also at least the
     CPU's / EXACT_RATIO). `train_s1`, cli/train_s1.main
     from the bf16 s2 run's checkpoint: 3 steps + 3 resumed in bf16, 1 + 1
     in "fp32", step ms, tokens (frames) per s, peak memory, a profiled
     step of each, the card-vs-CPU steps in both dtypes;
 12. SpeechSR training: cli/train_sr.main in-process at its defaults (48
     kHz, B = 16, seg_in 3200, ch 32, the 6-resolution + 5-period bank) on
     phase 10's corpus, 3 steps, a checkpoint, 3 resumed, the eval hook at
     steps 3 and 6 (eval/mel_l1, eval/snr_db finite): step ms, output
     audio-s per s, peak memory, amp_triple launched in every step; one
     step at 24 kHz; one step profiled by group (the triple's forward, the
     plain_vjp range, cuDNN / cuBLAS, elementwise, optimizer) with the idle
     share; one step at B = 2, seg_in 1600, full width, card against CPU
     from the same weights (losses 1e-4 relative, G / D gradients 1e-3
     relative L2); the triple's forward and backward at its SR training
     launch shapes (`train_shape`); `serve_trained_sr`, the trained
     generator in a serving SpeechSR on a 10 s input (one triple launch,
     within 1e-4 x max of the plain stage). Then `serve_trained`: the s1
     run's in-memory PLM takes one more step after its decode weights were
     packed (they must be packed anew); infer/from_training builds the
     pipeline of phase 11's bf16 s2 and s1 runs, phase 10's bf16 vocoder
     run and this SpeechSR-48k run, whose state_dicts must equal the runs'
     checkpoints, and serves one 10 s `tts` request (exact=True) at 48 kHz:
     all four kernels must launch, the decode's teacher-forced gap within
     1e-4 x max|logit|, the trained PLM loaded with its checkpoint decodes
     the same codes; then the same pipeline at dtype=bfloat16 serves the
     request once more (the vocoder kernels' bf16 configuration, and one
     float32 plm_decode launch on the bf16 latent, its gap against the
     float32 twin; its launch shapes join the `new_shape` lines);
 13. MP-SENet denoiser training: cli/train_denoiser.main at its defaults
     (B = 8, 2 s, dense_channel 64, 4 TS blocks, remat, attn_chunk 64), 3
     steps, a checkpoint, 3 resumed, the eval hook at steps 3 and 6: step
     ms, audio-s per s, peak memory, one step profiled, one step with remat
     off (peak memory, or that it does not fit); one step at B = 2, 0.5 s,
     full width, card against CPU fed one STFT (metrics 1e-4 relative,
     gradients 1e-3 relative L2, running statistics 1e-5 x max); remat on
     against off on the card (loss and running statistics within 1e-6);
     `serve_trained_dn`, the trained model in a serving MPNet denoising the
     3 s prompt through TTSPipeline.denoise at B = 1;
 14. `cli_serving`: reference-layout checkpoints of seeded weights at the
     published widths (TTV, PLM and a vocoder training build as {"model":
     sd}, SpeechSR-48k under `dec.`, the denoiser as {"generator": sd}, the
     mms-300m wav2vec2 in HF names with the `wav2vec2.` prefix), and the
     inference CLIs' main() in-process on the card: infer_tts on texts of
     5 / 7 / 10 s with the 3 s prompt at 48 kHz with --denoise_ratio 0.8, at 16 kHz with --batch 2 and at 48 kHz with --stream; infer_sr;
     infer_vc of a 5 s source; extract_features on 8 of phase 10's
     utterances. Every wav equals, as int16, the in-process call of
     build_pipeline_from_reference_ckpts's pipeline, the launches equal the
     API calls' (and the main path's per-request counts), the sidecars the
     port's feature calls; ms per line and per call; cuDNN deterministic
     throughout (its default algorithms give two calls of one request
     waveforms up to 2e-7 apart, which can flip an int16 step);
 15. `ar_prep`: the AR data front end on phase 10's corpus: prepare_text on
     a 4 / 5-column filelist the phase writes (the corpus's 3-column lines
     beside it are skipped), its --bert_ckpt branch with a seeded
     BertForMaskedLM at chinese-roberta-wwm-ext-large's widths where
     `transformers` is installed (on the card, its sidecars within 1e-4 x
     max of a --device cpu run), else its ImportError; prepare_hubert on
     six 2-10 s wavs at 16 / 32 / 64 kHz with seeded chinese-hubert-base
     weights (an HF-named .bin, `hubert.` prefix, --n_heads 12): ms per
     wav, the 5-wav32k files within 1 LSB of the CPU's, one wav's features
     card against CPU (1e-3 x max);
     prepare_semantic on eight .hmel.npy sidecars with cli_serving's TTV
     .pth, each code the CPU's or a near tie (two nearest codewords within
     1e-5 relative);
 16. `ar_decode`: t2s_decode of the CLI's Text2Semantic (seeded, full width)
     on the tts phase's 10 s text as phoneme ids, BERT ~ N(0, 1), a
     75-token prompt, max_new 250, greedy and top_k 3 from seeded host
     Gumbel draws: ms per step, tokens/s, prefill, launches per step,
     device ms and idle share, peak memory; every token within TF_MARGIN of
     a full-prefix recompute on the card and on the CPU; B = 4 rows against
     their own B = 1 decodes;
 17. `train_ar`: cli/train_ar.main at its defaults on 64 utterances of the
     corpus's joined tables, 8 micro-steps (2 updates), a checkpoint, 8
     resumed, the eval hook at 8 and 16: micro-step ms, tokens/s, peak
     memory, one micro-step profiled; `train_ar_synthetic`, the longest
     bucket a real corpus admits (B = 8, 54 s = 1350 tokens padded to 1408,
     400 phones padded to 448); one micro-step at B = 2 card against CPU
     (metrics 1e-4 relative, gradients 1e-3 relative L2) and the
     ScaledAdam update of each side's own gradients within 1e-3 relative
     L2 over the elements whose gradient stands above 2 x its tensor's
     card-CPU difference (the rest reported: their count and their share
     of the difference);
 18. `gpt_stack`: GPTProsody at its defaults, forward and backward at B = 8
     (3 s prompt mel, 100 text, 300 mel tokens) and card against CPU at
     B = 2; gpt_generate of 300 tokens at top_k 50 from seeded draws (gap
     against a recompute on the card and the CPU); DiscreteVAE on a 10 s
     mel: encode / decode card against CPU (near ties allowed), one
     training forward with its EMA step within 1e-4. Phases 15-18 launch
     none of the port's kernels (checked).
Then the run's seconds, and one JSON line with every kernel's numbers (launches: the f32 rows
from the tts requests of phase 5, or one float32 training step of phase 10
where that count is larger, and the serve_trained request's beside them;
the decode's float32 row also with its launches on the bf16-served
request and in the 48 kHz infer_tts run;
the decode's bf16 row from its batch decode of phase 3; the three _bf16
rows from one bf16_forward vocoder call, with their launches per bf16
training step beside it; the triple's row also with its launches per SR
training step and its SR training shapes), the card's name and power limit
from phase 1 printed first, and last the device line.

Float32 (TF32 off) but for the bf16 decode configuration, the bf16 kernel
lines, bf16_forward, the bf16 training runs of phases 10-11 and the bf16
serve_trained request.
Without CUDA it exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
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
                  "plm_decode": 0, "plm_decode_bf16": 0,
                  "aa_snakebeta_bf16": 0, "ampblock_bf16": 0,
                  "amp_triple_bf16": 0}
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
# A bf16-product snake_conv launch that writes float32 (c1, x' between a
# block's launches): its mean |error| over the mean |ref| of the plain
# version on the same rounded operands. Its largest error is a rounding
# flip of one operand, as large as a bf16 step of the output at C = 16; a
# flip is rare, so the mean stays near float32 sums, while a kernel that
# rounded the output to bf16 reads a step's mean (both reported per line).
MMA_F32_MEAN_TOL = 1e-4
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
BF16_FLOPS_PER_S = 989e12   # H100 SXM data sheet, dense bf16 tensor cores
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
    # the vocoder kernels' bf16 configuration (bf16 in and out, float32
    # inside, each conv one bf16 product pass)
    "aa_snakebeta_bf16": ("aa_snakebeta_bf16",
                          "megatts2_hierspeechpp_torch/csrc/aa_snake.cu",
                          "megatts2_hierspeechpp_tpu/ops/pallas_snake.py:93"),
    "ampblock_bf16": ("ampblock_bf16",
                      "megatts2_hierspeechpp_torch/csrc/snake_conv.cu",
                      "megatts2_hierspeechpp_tpu/ops/pallas_ampblock.py:151"),
    "amp_triple_bf16": ("triple_epilogue_bf16",
                        "megatts2_hierspeechpp_torch/csrc/triple_epilogue.cu",
                        "megatts2_hierspeechpp_tpu/ops/pallas_amp_triple.py:60"),
}
BF16_KERNELS = ("aa_snakebeta_bf16", "ampblock_bf16", "amp_triple_bf16")


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
              required: bool = True, launches: int | None = None):
    """Device time (ms) of the kernels whose names hold one of `keys`, over
    reps back-to-back calls of fn() under torch.profiler, after 2 warm-ups:
    the median launch, or with `launches` (that many a call) their sum per
    call. This is the kernel's own time on the card; the wrapper's host
    cost (time_ms) is about 10x it at the snake's shapes. The profiler's
    activity records can drop launches (19 of 20 copies seen on an H100 in
    one run, 7 of 20 in another), so the median takes a window that
    recorded at least half of them, the sum one that recorded every one; a
    window with fewer is profiled again, up to `attempts` times, and then
    fails the run, or gives None when not `required`."""
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
        if launches is None and 2 * len(us) >= reps:
            return float(np.median(us)) / 1e3
        if launches is not None and len(us) == reps * launches:
            return float(sum(us)) / 1e3 / reps
    if not required:
        return None
    fail(f"profiler saw {len(us)} of {reps * (launches or 1)} launches of "
         f"{keys}, {attempts} times")


def back_to_back_ms(torch, fn, reps: int = 10) -> float:
    """ms per call of fn() from CUDA events around reps calls issued back
    to back, after 2 warm-ups: the larger of the host's time to issue a
    call and the device's time to run it, so at least the device time, and
    equal to it only where a launch outlasts its issue. Reported as
    "events_ms", never as device time."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def copy_floor_ms(torch, dev, n_bytes: float):
    """Device time of one copy_ that reads n_bytes / 2 and writes n_bytes /
    2: a floor yardstick for a kernel that moves n_bytes, not a library
    version of its function. None where the profiler recorded too few of
    the copies (it saw none of 60 in one run): a yardstick, not a gate."""
    n = max(1, int(n_bytes / 8))
    src = torch.ones(n, device=dev)
    dst = torch.empty_like(src)
    return device_ms(torch, lambda: dst.copy_(src), ("Memcpy", "copy"),
                     required=False)


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


def bound_ms_bf16(n_bytes: float, flops: float, conv_flops: float = 0.0):
    """(ms, what bounds it) of the bf16 configuration's work: the conv
    products one bf16 tensor-core pass each, the rest float32 on the CUDA
    cores; n_bytes counts bf16 activations at 2 bytes."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S + conv_flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                      "operations")


def bf16_twin(torch, kind, x, ws):
    """The bf16 twin of a vocoder kernel on bf16 x, as float32 values:
    (its float32 result before the final rounding, the float32 plain
    version on the same input, whether the kernel is a chain of rounded
    convs). kind: "aa_snakebeta" (ws = alpha, beta), "ampblock" (ws =
    weights, k, dilations), "amp_triple" (block weights, ks, dilations,
    post)."""
    from megatts2_hierspeechpp_torch.ops import amp_triple, ampblock, snake

    x32 = x.float()
    if kind == "aa_snakebeta":
        y = snake.composed_snakebeta(x32, *ws)
        return y, y, False
    if kind == "ampblock":
        *w, k, dils = ws
        return (ampblock.block_math(x32, *w, k, dils, bf16_products=True),
                ampblock.block_math(x32, *w, k, dils), True)
    bws, ks, dils, post = ws
    return (amp_triple.triple_math(x32, bws, ks, dils, post, bf16_products=True),
            amp_triple.triple_math(x32, bws, ks, dils, post), True)


def bf16_check(y, twin32, f32, chain: bool) -> dict:
    """A bf16 kernel output against its twin (bf16_twin). One rounding
    (the AA-snake): within BF16_MARGIN x max|ref| of the twin before its
    final rounding, half a bf16 step. A chain of rounded convs (an AMPBlock,
    a stage): its distance from the float32 plain version at most
    EXACT_RATIO x the twin's (rounded as the kernel rounds it). The two
    round the same operands, but a value within float error of a bf16
    boundary rounds either way and the chain carries the flip on, so the
    kernel reaches just past one half step of the twin at C = 128, k = 11
    (tests/test_torch_cuda.py). Returns the numbers and "ok"."""
    y = y.float()  # the kernel's bf16 output
    scale = twin32.abs().max().item()
    err = (y - twin32).abs().max().item()
    out = {"max_abs_err": err, "max_abs_ref": scale,
           "err_over_ref": err / max(scale, 1e-30)}
    if not chain:
        out.update(tolerance=f"{BF16_MARGIN:g} x max|ref| (the twin before "
                   "its final rounding)",
                   ok=bool(math.isfinite(err) and err <= BF16_MARGIN * scale))
        return out
    d_kernel = (y - f32).abs().max().item()
    d_twin = (twin32.bfloat16().float() - f32).abs().max().item()
    out.update(dist_to_f32_kernel=d_kernel, dist_to_f32_twin=d_twin,
               tolerance=f"distance to float32 <= {EXACT_RATIO:g} x the "
               "twin's",
               ok=bool(math.isfinite(d_kernel)
                       and d_kernel <= EXACT_RATIO * d_twin))
    return out


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


def kernel_bf16_phase(torch, dev):
    """The three vocoder kernels' bf16 configuration at the serving path's
    shapes (B = 1, T_FRAMES frames, the shapes of kernel_phase), bf16 x,
    against their bf16 twins (bf16_check): error, ms (CUDA events around
    the wrapper), device ms per call (profiler, the wrapper's launches
    summed), the twin's ms, the bf16 bound and the 3xTF32 configuration's
    bound of the same shape."""
    from megatts2_hierspeechpp_torch.ops.amp_triple import (
        composed_triple, fused_amp_triple)
    from megatts2_hierspeechpp_torch.ops.ampblock import (
        composed_ampblock, fused_ampblock)
    from megatts2_hierspeechpp_torch.ops.snake import (
        composed_snakebeta, fused_aa_snakebeta)

    gen = torch.Generator().manual_seed(3)

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
    bf = torch.bfloat16
    # (kind, label, x, twin args, fused fn, plain fn, launches a call, f32
    # bytes, bf16 bytes, flops, conv flops, device kernel names)
    cases = []
    for c in (256, 64):
        x, a, b = randn(1, 4 * T, c).to(bf), pos(c), pos(c)
        n = 4 * T * c
        cases.append(("aa_snakebeta", f"C={c} T={4 * T}", x, (a, b),
                      lambda x=x, a=a, b=b: fused_aa_snakebeta(x, a, b),
                      lambda x=x, a=a, b=b: composed_snakebeta(x, a, b), 1,
                      4.0 * (2 * n + 2 * c), 2.0 * 2 * n + 8.0 * c,
                      SNAKE_FLOPS * n, 0.0, ("aa_snakebeta_kernel",)))
    for c, t, k in [(128, 20 * T, k) for k in (3, 7, 11)] + [
            (128, 2 * T, k) for k in (3, 5, 7)]:
        x, ws = randn(1, t, c).to(bf), block_ws(c, k)
        w_bytes = 4.0 * (6 * k * c * c + 10 * c)
        cases.append(("ampblock", f"C={c} T={t} k={k}", x, (*ws, k, dil),
                      lambda x=x, ws=ws, k=k: fused_ampblock(x, *ws, k, dil),
                      lambda x=x, ws=ws, k=k: composed_ampblock(x, *ws, k, dil),
                      6, 4.0 * 2 * t * c + w_bytes, 2.0 * 2 * t * c + w_bytes,
                      *block_flops(t, c, k), ("snake_conv_kernel",)))
    for c, t, ks, tail in ((64, 4 * T, (3, 5, 7), False),
                           (64, 80 * T, (3, 7, 11), False),
                           (32, 160 * T, (3, 7, 11), False),
                           (16, 320 * T, (3, 7, 11), True),
                           (32, 960 * T, (3, 7, 11), True)):
        x = randn(1, t, c).to(bf)
        bws = [block_ws(c, k) for k in ks]
        dils = (dil,) * 3
        post = (pos(c), pos(c), randn(7, c, scale=0.1 * (7 * c) ** -0.5)) if tail else None
        flops = sum(block_flops(t, c, k)[0] for k in ks) + 3.0 * t * c
        conv_flops = sum(block_flops(t, c, k)[1] for k in ks)
        if tail:
            flops += (SNAKE_FLOPS + 14) * t * c + t
        w_bytes = 4.0 * sum(6 * k * c * c + 10 * c for k in ks)
        out_n = t if tail else t * c
        cases.append(("amp_triple",
                      f"C={c} T={t} ks={list(ks)}{' +tail' if tail else ''}",
                      x, (bws, ks, dils, post),
                      lambda x=x, bws=bws, ks=ks, dils=dils, post=post:
                          fused_amp_triple(x, bws, ks, dils, post),
                      lambda x=x, bws=bws, ks=ks, dils=dils, post=post:
                          composed_triple(x, bws, ks, dils, post),
                      19, 4.0 * (t * c + out_n) + w_bytes,
                      2.0 * (t * c + out_n) + w_bytes, flops, conv_flops,
                      ("snake_conv_kernel", "triple_avg_kernel",
                       "triple_post_kernel")))

    results = {}
    for (kind, label, x, twin_args, fused, plain, launches, bytes_f32,
         bytes_bf16, flops, conv_flops, names) in cases:
        name = kind + "_bf16"
        with torch.inference_mode():
            y = fused()
            twin32, f32, chain = bf16_twin(torch, kind, x, twin_args)
            torch.cuda.synchronize()
            check = bf16_check(y, twin32, f32, chain)
            del twin32, f32
            ms = time_ms(torch, fused, 10)
            dev_ms = device_ms(torch, fused, names, 10, required=False,
                               launches=launches)
            plain_ms = time_ms(torch, plain, 3)
        b_ms, b_by = bound_ms_bf16(bytes_bf16, flops, conv_flops)
        line = {"phase": "kernel_bf16", "name": name, "shape": label,
                "dtype": "bf16", **check, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bound_ms_3xtf32": bound_ms(bytes_f32, flops, conv_flops)[0]}
        print(json.dumps(line), flush=True)
        if not check["ok"]:
            fail(f"{name} {label}: {check}")
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
                      **{k: (None if any(ln[k] is None for ln in lines)
                             else sum(ln[k] for ln in lines)) for k in (
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
    plm_bf16_latent_gate(torch, model, tc)
    return lines


def plm_bf16_latent_gate(torch, model, tc):
    """models/plm.decode of a bf16 latent (a bf16 TTV's) launches the
    kernel once, on the latent taken to float32, as the JAX kernel takes it:
    one plm_decode launch, the codes of the float32 cast's decode."""
    from megatts2_hierspeechpp_torch.models.plm import decode
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    low = tc.bfloat16()
    with torch.inference_mode():
        want = decode(model, low.float())
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        got = decode(model, low)
        torch.cuda.synchronize()
    counts = dict(cuda_lib.LAUNCHES)
    same = bool(torch.equal(got, want))
    print(json.dumps({"phase": "plm_bf16_latent", "T": tc.shape[1],
                      "calls": counts, "codes_equal_float32_cast": same}),
          flush=True)
    if counts["plm_decode"] != 1 or sum(counts.values()) != 1 or not same:
        fail(f"plm_decode of a bf16 latent: launches {counts}, codes equal "
             f"the float32 cast's {same}")


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
    the shape. Keys: ("aa_snakebeta", B, T, C, activation bytes),
    ("snake_conv", B, T, C, k, d, with the residual, io flags),
    ("triple_avg" | "triple_post", B, T, C, output bytes), ("plm_decode", T,
    weight bytes, cache bytes); each with the path that first launched it.
    Activation bytes 2 and io flags > 0 are the bf16 configuration."""

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
            key = ("aa_snakebeta", a[4], a[5], a[6], a[9])
        elif name == "snake_conv_fwd":
            b, t, cin, cout, k, d, io = a[7:14]
            self._conv = (b, t, cout)
            key = ("snake_conv", b, t, cin, k, d, a[5].value is not None, io)
        elif name == "triple_avg_fwd":  # the average of the stage's last convs
            if self._conv is None or self._conv[0] * self._conv[1] * self._conv[2] != a[4]:
                fail(f"triple_avg of {a[4]} elements after snake_conv {self._conv}")
            key = ("triple_avg", *self._conv, a[5])
        elif name == "triple_post_fwd":
            key = ("triple_post", a[7], a[8], a[9], a[13])
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


# the float32 paths whose snake_conv launch shapes also get their device ms
# from the profiler; every bf16 launch shape gets "events_ms" instead, CUDA
# events around back-to-back launches (back_to_back_ms), a tenth of the
# profiler's cost
DEVICE_MS_PATHS = ("vc", "train_vocoder fp32 eval", "train_sr")
SHAPE_TOL = {"aa_snakebeta": 1e-5, "triple_avg": 1e-5, "triple_post": 1e-4,
             "snake_conv": 1e-4}   # x max|ref|, PERF.md section 2


def new_shapes_phase(torch, dev, shapes):
    """Each kernel against its plain version at every distinct launch shape
    that the serving paths gave it (LaunchShapes), on fresh random inputs:
    one launch and one plain call each. The AA-snake and the epilogue (whose
    plans were picked at B=1, T=2000) also with their device ms per launch
    (profiler; "device_ms": null where the profiler recorded too few of
    the launches, which it does late in a long run), and snake_conv at the
    shapes of DEVICE_MS_PATHS (profiler, summed per B, T, C; null unless it
    recorded every launch shape) and at every bf16 shape ("events_ms",
    back_to_back_ms summed per B, T, C). One line per kernel, shape and dtype
    (snake_conv: per B, T, C), with the worst error over the tolerance, the
    bound and the plain version's ms (CUDA events, a second call after the
    one compared; for snake_conv both summed over the launch shapes). A
    bf16 launch (the bf16 configuration) is held as bf16_check holds one
    rounding: within BF16_MARGIN x max|ref| of the bf16 twin before its
    final rounding; a bf16 snake_conv launch that writes float32 also by its
    mean error (MMA_F32_MEAN_TOL), with what a bf16-rounded output would
    read beside it."""
    from megatts2_hierspeechpp_torch.models.plm import ProsodyLM, teacher_forced_gap
    from megatts2_hierspeechpp_torch.nn.conv import conv1d_op
    from megatts2_hierspeechpp_torch.ops.amp_triple import (
        composed_epilogue, fused_epilogue)
    from megatts2_hierspeechpp_torch.ops.ampblock import (
        IO_BF16_MMA, IO_RES_BF16, IO_X_BF16, IO_Y_BF16, rounded, snake_conv)
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
        return (y.float() - ref).abs().max().item(), ref.abs().max().item()

    bf = torch.bfloat16

    model = None
    convs = {}
    n_checked = 0
    for key, path in sorted(shapes.seen.items(), key=lambda kv: str(kv[0])):
        kind = key[0]
        line = {"phase": "new_shape", "kernel": kind, "path": path}
        mean_err = rounded_mean = None  # a float32-output bf16 snake_conv's
        with torch.inference_mode():
            if kind == "aa_snakebeta":
                _, b, t, c, ab = key
                dt = bf if ab == 2 else torch.float32
                x, a, be = randn(b, t, c).to(dt), pos(c), pos(c)
                ib = inverse_beta(be)
                fn = lambda: fused_aa_snakebeta(x, a, be, ib)  # noqa: E731
                plain = lambda: composed_snakebeta(x, a, be)  # noqa: E731
                # the twin before its final rounding (bf16_check)
                err, scale = err_of(fn(), composed_snakebeta(x.float(), a, be))
                n = b * t * c
                line.update(shape=f"B={b} T={t} C={c}",
                            plain_ms=event_ms(torch, plain)[1],
                            device_ms=device_ms(torch, fn, ("aa_snakebeta",), 10,
                                                required=False))
                line["bound_ms"], line["bound_by"] = (bound_ms if ab == 4 else bound_ms_bf16)(
                    ab * (2.0 * n) + 8.0 * c, SNAKE_FLOPS * n)
            elif kind in ("triple_avg", "triple_post"):
                _, b, t, c, yb = key
                dt = bf if yb == 2 else torch.float32
                rs = [randn(b, t, c, scale=3.0) for _ in range(3)]
                post = ((pos(c), pos(c), randn(7, c, scale=0.1 * (7 * c) ** -0.5))
                        if kind == "triple_post" else None)
                fn = lambda: fused_epilogue(*rs, post, dt)  # noqa: E731
                plain = lambda: composed_epilogue(*rs, post)  # noqa: E731
                err, scale = err_of(fn(), plain())
                n = b * t * c
                line.update(shape=f"B={b} T={t} C={c}",
                            plain_ms=event_ms(torch, plain)[1],
                            device_ms=device_ms(torch, fn, (kind + "_kernel",), 10,
                                                required=False))
                line["bound_ms"], line["bound_by"] = (bound_ms if yb == 4 else bound_ms_bf16)(
                    *((12.0 * n + yb * b * t + 36.0 * c,
                       3.0 * n + (SNAKE_FLOPS + 14) * n + b * t)
                      if post is not None else (12.0 * n + yb * n, 3.0 * n)))
            elif kind == "snake_conv":
                _, b, t, c, k, d, has_res, io = key
                mma = bool(io & IO_BF16_MMA)
                x = randn(b, t, c).to(bf if io & IO_X_BF16 else torch.float32)
                res = (randn(b, t, c).to(bf if io & IO_RES_BF16 else torch.float32)
                       if has_res else None)
                out_dt = bf if io & IO_Y_BF16 else torch.float32
                a, ib = pos(c), pos(c)
                w, bias = randn(k, c, c, scale=(c * k) ** -0.5), randn(c, scale=0.05)
                y = snake_conv(x, a, ib, w, bias, d, res=res, bf16_mma=mma,
                               out_dtype=out_dt)
                op = rounded if mma else (lambda v: v)

                def plain():
                    ref = conv1d_op(op(activation1d(
                        x.float(), lambda v: v + torch.sin(v * a).square() * ib)),
                        op(w.permute(1, 2, 0).contiguous()), bias, 1,
                        (k - 1) // 2 * d, d)
                    return ref if res is None else ref + res.float()

                ref = plain()
                err, scale = err_of(y, ref)
                if mma and out_dt == torch.float32:
                    m = ref.abs().mean().item()
                    mean_err = (y - ref).abs().mean().item() / m
                    rounded_mean = (ref.to(bf).float() - ref).abs().mean().item() / m
                conv_plain = event_ms(torch, plain)[1]
                n = b * t * c
                io_bytes = (x.element_size() + y.element_size()
                            + (res.element_size() if has_res else 0)) * n
                conv_bound = (bound_ms_bf16 if mma else bound_ms)(
                    io_bytes + 4.0 * (k * c * c + 3 * c),
                    SNAKE_FLOPS * n + (2 if has_res else 1) * n,
                    2.0 * n * c * k)[0]

                def run():
                    return snake_conv(x, a, ib, w, bias, d, res=res,
                                      bf16_mma=mma, out_dtype=out_dt)

                conv_dev = conv_ev = None
                if path.startswith(DEVICE_MS_PATHS) and not mma:
                    conv_dev = device_ms(torch, run, ("snake_conv",), 10,
                                         required=False)
                if mma:
                    conv_ev = back_to_back_ms(torch, run)
                kind = "snake_conv_bf16" if mma else "snake_conv"
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
        bf16_io = kind == "snake_conv_bf16" or (
            kind in ("aa_snakebeta", "triple_avg", "triple_post") and key[-1] == 2)
        if bf16_io:  # the bf16 configuration: bf16_check's single rounding
            line["dtype"] = "bf16"
        tol = (BF16_MARGIN if bf16_io else
               SHAPE_TOL.get(kind, TF_MARGIN if kind == "plm_gap" else BF16_MARGIN))
        mean_ok = mean_err is None or mean_err <= MMA_F32_MEAN_TOL < rounded_mean
        if not (math.isfinite(err) and err <= tol * scale and mean_ok):
            print(json.dumps(dict(line, max_abs_err=err, max_abs_ref=scale,
                                  mean_err_over_mean_ref=mean_err,
                                  rounded_output_mean_err=rounded_mean)),
                  flush=True)
            fail(f"{kind} {key}: max abs err {err} > {tol} x {scale}, or the "
                 f"float32 output's mean error {mean_err} > {MMA_F32_MEAN_TOL} "
                 f"(a bf16-rounded output: {rounded_mean})")
        n_checked += 1
        if kind.startswith("snake_conv"):  # one line per (path, B, T, C, dtype)
            g = convs.setdefault((path, key[1], key[2], key[3], kind),
                                 {"phase": "new_shape", "kernel": "snake_conv",
                                  "path": path,
                                  "shape": f"B={key[1]} T={key[2]} C={key[3]}",
                                  **({"dtype": "bf16"} if bf16_io else {}),
                                  "launch_shapes": 0, "worst_err_over_tol": 0.0,
                                  **({"f32_out_worst_mean_err": 0.0,
                                      "f32_out_rounded_least_mean_err": 1.0}
                                     if bf16_io else {}),
                                  "bound_ms": 0.0, "device_ms": 0.0,
                                  **({"events_ms": 0.0} if bf16_io else {}),
                                  "plain_ms": 0.0})
            g["launch_shapes"] += 1
            g["bound_ms"] += conv_bound
            g["plain_ms"] += conv_plain
            g["device_ms"] = (None if conv_dev is None or g["device_ms"] is None
                              else g["device_ms"] + conv_dev)
            if bf16_io:
                g["events_ms"] += conv_ev
            if mean_err is not None:
                g["f32_out_worst_mean_err"] = max(g["f32_out_worst_mean_err"],
                                                  mean_err)
                g["f32_out_rounded_least_mean_err"] = min(
                    g["f32_out_rounded_least_mean_err"], rounded_mean)
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


# ---- the bf16 forward: bench.py's vocoder and SpeechSR-48k in bf16 ----

BF16_FORWARD = (4, 1000)     # bench.py's shape: B, frames (80 s of 16 kHz audio)
BF16_CPU_FRAMES = 100        # the card-vs-CPU gate: B = 1, 100 frames
BF16_VOC_CALLS = {"aa_snakebeta_bf16": 19, "ampblock_bf16": 6,
                  "amp_triple_bf16": 4}
BF16_SR_CALLS = {"amp_triple_bf16": 1}


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def bf16_forward_phase(torch, dev, shapes):
    """The bf16 HierVocoder and SpeechSR-48k built as bench.py builds them
    (HierVocoder(dtype=bf16), SpeechSR(rate 3 / 1, dtype=bf16)) on its
    inputs, B = 4, T = 1000 frames: ms (CUDA events, median of 5 after 2
    warm-ups), audio-s per s, peak memory, launches per call (each kernel
    under its _bf16 key, none under the float32 keys; the bf16 launch shapes
    join the new_shape lines) and the profiled device split with the idle
    share; the float32 forward of the same weights beside it, and the bf16
    output's distance from it (relative L2, max abs over the peak). Gate:
    at B = 1, BF16_CPU_FRAMES frames that distance on the card within
    EXACT_RATIO x the same distance on the CPU. Returns the launches per
    vocoder call."""
    from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR
    from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    b, t = BF16_FORWARD
    rng = np.random.default_rng(0)   # bench.py's inputs, in its order
    mel = rng.standard_normal((b, t, 80)).astype(np.float32)
    w2v = rng.standard_normal((b, t, 1024)).astype(np.float32)
    mask = np.ones((b, t, 1), np.float32)
    f0 = np.abs(rng.standard_normal((b, 4 * t, 1))).astype(np.float32)
    wav16 = (rng.standard_normal((b, t * 320, 1)) * 0.1).astype(np.float32)
    tc = BF16_CPU_FRAMES
    models = (
        ("vocoder", lambda dt, d: HierVocoder(seed=1234, device=d, dtype=dt),
         (mel, w2v, mask, f0), lambda m, *a: m(*a)[0], BF16_VOC_CALLS,
         (mel[:1, :tc], w2v[:1, :tc], mask[:1, :tc], f0[:1, :4 * tc])),
        ("speechsr48", lambda dt, d: SpeechSR(32, 3, 1, seed=4321, device=d,
                                             dtype=dt),
         (wav16,), lambda m, x: m(x), BF16_SR_CALLS, (wav16[:1, :320 * tc],)))
    total = dict.fromkeys(BF16_KERNELS, 0)
    voc_calls = None
    for name, build, args, call, want, small in models:
        xs = [torch.from_numpy(a).to(dev) for a in args]
        line = {"phase": "bf16_forward", "model": name, "B": b, "frames": t,
                "audio_s": b * t / 50.0}
        outs = {}
        for dt, tag in ((torch.bfloat16, "bf16"), (None, "f32")):
            model = build(dt, dev)
            fn = lambda: call(model, *xs)  # noqa: E731
            with torch.no_grad():
                fn()
                fn()
                torch.cuda.reset_peak_memory_stats()
                y, counts = run_path(torch, cuda_lib, shapes,
                                     f"bf16_forward {name}" if dt else None, fn)
                peak = torch.cuda.max_memory_allocated()
                ms = time_ms(torch, fn, 5)
                profile_phase(torch, f"bf16_forward {name} {tag} B={b}", t,
                              lambda: (fn(), torch.cuda.synchronize()))
            outs[tag] = y
            line.update({f"ms_{tag}": ms,
                         f"audio_s_per_s_{tag}": line["audio_s"] / (ms / 1e3),
                         f"peak_memory_mb_{tag}": peak / 2 ** 20,
                         f"launches_per_call_{tag}": counts})
            if dt is not None:
                if {k: counts[k] for k in want} != want or any(
                        counts[k] for k in counts if k not in want):
                    print(json.dumps(line), flush=True)
                    fail(f"bf16_forward {name}: launches {counts}, expected {want}")
                for k in want:
                    total[k] += counts[k]
                if name == "vocoder":
                    voc_calls = dict(counts)
            del model
            torch.cuda.empty_cache()
        y16, y32 = outs["bf16"], outs["f32"]
        line["dist_bf16_to_f32"] = {
            "rel_l2": rel_l2(y16, y32),
            "max_abs_over_peak": ((y16.float() - y32).abs().max()
                                  / y32.abs().max()).item()}
        if not (torch.isfinite(y16).all() and y16.shape == y32.shape):
            fail(f"bf16_forward {name}: output {tuple(y16.shape)}, finite "
                 f"{bool(torch.isfinite(y16).all())}")
        del xs, outs, y16, y32
        # the gate: card and CPU, each bf16 against its own float32
        dist = {}
        for d in (dev, torch.device("cpu")):
            xs = [torch.from_numpy(np.ascontiguousarray(a)).to(d) for a in small]
            with torch.no_grad():
                o16 = call(build(torch.bfloat16, d), *xs)
                o32 = call(build(None, d), *xs)
            dist[d.type] = rel_l2(o16, o32)
            del xs, o16, o32
        line["card_vs_cpu"] = {"B": 1, "frames": tc,
                               "rel_l2_bf16_to_f32_card": dist["cuda"],
                               "rel_l2_bf16_to_f32_cpu": dist["cpu"],
                               "tolerance": f"card <= {EXACT_RATIO:g} x cpu"}
        print(json.dumps(line), flush=True)
        if not dist["cuda"] <= EXACT_RATIO * dist["cpu"]:
            fail(f"bf16_forward {name}: card {dist['cuda']} from float32, CPU "
                 f"{dist['cpu']}")
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "bf16_forward_calls",
                      "vocoder_plus_speechsr": total}), flush=True)
    if total != {"aa_snakebeta_bf16": 19, "ampblock_bf16": 6, "amp_triple_bf16": 5}:
        fail(f"bf16_forward: launches {total}")
    return voc_calls


# ---- phase 10: vocoder training through cli/train_vocoder ----

TRAIN_CONFIG = "configs/hierspeechpp.json"  # published widths, batch 32, 32-frame windows
TRAIN_UTTERANCES = 96       # the synthetic corpus: three batches of 32
TRAIN_FP32_UTTERANCES = 32  # the float32 run: one batch an epoch, 1 + 1 steps
TRAIN_KERNELS = ("aa_snakebeta", "ampblock", "amp_triple")
TRAIN_CPU_FRAMES = 64       # card vs CPU step: 2 utterances cut to 64 frames
TRAIN_EVAL_INTERVAL = 3     # the eval hook's steps: 3 and 6 (the end of each run)
TRAIN_LOSS_TOL = 1e-4       # card vs CPU, each loss, relative
TRAIN_GRAD_TOL = 1e-3       # card vs CPU, relative L2 of all G (all D) gradients
TRAIN_BWD_TOL = 1e-4        # a kernel's gradients against autograd of its
                            # plain version (the bf16 twin for bf16 x), x
                            # max|ref| of each tensor, cuDNN deterministic
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
    while `on`: (kernel, x shape, the static arguments, x dtype) -> calls.
    The wrappers look the Functions up at call time, so a shim in their
    place sees each call."""

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
                    key = (kind, tuple(args[0].shape), static,
                           str(args[0].dtype).replace("torch.", ""))
                    rec.seen[key] = rec.seen.get(key, 0) + 1
                return fn.apply(*args)

        return Shim

    def close(self):
        for mod, attr, fn in self._orig:
            setattr(mod, attr, fn)


class TimedStep:
    """A CLI's train step with CUDA events around each call and the kernel
    launch counts of each step (zeroed just before it). B and T come from
    batch[frames_key], the true frames from batch[lengths_key] (B x T
    without one)."""

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
            "frames": int(batch[self.keys[1]].sum()) if self.keys[1] else b * t,
            "launches": {k: cuda_lib.LAUNCHES[k] for k in self.kernels}})
        return out


class EvalProbe:
    """A CLI's eval-hook factory (`mod.attr`) replaced while active by one
    whose hooks run with the kernel launch counts zeroed just before and
    read just after, CUDA-event timed, their launch shapes recorded under
    `label`, and the KernelCalls record (if any) paused: one record per
    eval call."""

    def __init__(self, torch, mod, attr, shapes, label, calls=None):
        self.torch, self.mod, self.attr = torch, mod, attr
        self.shapes, self.label, self.calls = shapes, label, calls
        self.records = []

    def __enter__(self):
        self.make = getattr(self.mod, self.attr)

        def factory(*a, **kw):
            fn = self.make(*a, **kw)
            return lambda state, step, model_dir: self._run(fn, state, step, model_dir)

        setattr(self.mod, self.attr, factory)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.make)

    def _run(self, fn, state, step, model_dir):
        from megatts2_hierspeechpp_torch.ops import cuda_lib

        torch = self.torch
        on = self.calls.on if self.calls else False
        path = self.shapes.path
        if self.calls:
            self.calls.on = False
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        self.shapes.path = self.label
        try:
            out, ms = event_ms(torch, lambda: fn(state, step, model_dir))
        finally:
            self.shapes.path = path
            if self.calls:
                self.calls.on = on
        self.records.append({"step": step, "ms": ms, "scalars": out,
                             "launches": dict(cuda_lib.LAUNCHES)})
        return out


def check_evals(label, probe, scalars, keys, steps):
    """The eval hook ran at `steps`, and each of `keys` landed finite in
    scalars.jsonl at each of them."""
    logged = [s for s in scalars if f"eval/{keys[0]}" in s]
    if [s["step"] for s in logged] != list(steps) or \
            [r["step"] for r in probe.records] != list(steps):
        fail(f"{label}: evals at {[s['step'] for s in logged]}, expected {list(steps)}")
    for s in logged:
        if not all(math.isfinite(s.get(f"eval/{k}", math.nan)) for k in keys):
            fail(f"{label}: eval scalars {s}")


def train_config(path, hps, corpus_dir, **train):
    """A copy of the config reading `corpus_dir`, with `train` overrides."""
    cfg = hps.to_dict()
    cfg["data"]["training_files"] = f"{corpus_dir}/train_list.txt"
    cfg["train"].update(train)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def train_profile(torch, step, state, batch, seed: int, label=None):
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
    line = {"phase": "train_profile", "path": label or "train_vocoder B=32",
            "wall_ms": wall_ms, "device_kernel_ms": dev_ms or "not measured",
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
    return line


def train_cpu_phase(torch, dev, hps, ds):
    """One step at full width on the card and on the CPU from the same
    weights, batch and draws, in float32 and in bf16 compute: the float32
    steps' losses and G and D gradients against each other; each bf16
    step judged by its distance from its own device's float32 step (each
    loss relative, each gradient relative L2), the card's within
    EXACT_RATIO x the CPU's (two bf16 paths that sum in other orders cannot
    meet TRAIN_LOSS_TOL against each other)."""
    from megatts2_hierspeechpp_torch.cli.train_vocoder import (
        build_state, vocoder_batch)
    from megatts2_hierspeechpp_torch.train import vocoder as vt
    from megatts2_hierspeechpp_torch.utils.config import HParams

    t = TRAIN_CPU_FRAMES
    full = vocoder_batch(ds, [0, 1])
    cut = {"audio": 320 * t, "spec": t, "mel": t, "w2v": t, "f0": 4 * t,
           "mask": t}
    batch = {k: np.ascontiguousarray(full[k][:, :n]) for k, n in cut.items()}
    batch["lengths"] = np.minimum(full["lengths"], t)
    step = vt.TrainStep(segment_frames=hps.train.segment_frames,
                              c_mel=hps.train.c_mel, c_kl=hps.train.c_kl)
    out = {}
    for dtype in ("fp32", "bf16"):
        h = HParams(**hps.to_dict())
        h.train.dtype = dtype
        for d in (dev, torch.device("cpu")):
            state = build_state(h, d, hps.train.seed)
            tb = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
            draws = step.draw(state, tb, torch.Generator().manual_seed(11))
            t0 = time.perf_counter()
            state, m = step.with_draws(state, tb, *draws)
            m = {k: float(v) for k, v in m.items()}  # waits for the device
            ms = 1e3 * (time.perf_counter() - t0)
            grads = {name: torch.cat([p.grad.detach().flatten().cpu()
                                      for p in mod.parameters()])
                     for name, mod in (("G", state.gen), ("D", state.disc))}
            out[dtype, d.type] = (m, grads, ms)
            del state
    (mc, gc, ms_c), (mp, gp, ms_p) = out["fp32", "cuda"], out["fp32", "cpu"]
    loss_err = {k: abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in mp}
    grad_err = {k: ((gc[k] - gp[k]).norm() / gp[k].norm()).item() for k in gp}
    line = {"phase": "train_card_vs_cpu", "B": 2, "frames": t, "dtype": "fp32",
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

    dist, per_loss = {}, {}  # side -> distance of bf16 from float32
    for side in ("cuda", "cpu"):
        (m16, g16, _), (m32, g32, _) = out["bf16", side], out["fp32", side]
        per_loss[side] = {k: abs(m16[k] - m32[k]) / max(abs(m32[k]), 1e-30)
                          for k in m32}
        dist[side] = {"losses": max(per_loss[side].values()),
                      **{k: ((g16[k] - g32[k]).norm() / g32[k].norm()).item()
                         for k in g32}}
    bad = {k: (dist["cuda"][k], dist["cpu"][k]) for k in dist["cpu"]
           if not dist["cuda"][k] <= EXACT_RATIO * dist["cpu"][k]}
    m16 = out["bf16", "cuda"][0]
    line = {"phase": "train_card_vs_cpu", "B": 2, "frames": t, "dtype": "bf16",
            "card_ms": out["bf16", "cuda"][2], "cpu_ms": out["bf16", "cpu"][2],
            "losses_card": m16, "bf16_to_fp32_card": dist["cuda"],
            "bf16_to_fp32_cpu": dist["cpu"], "per_loss": per_loss,
            "tolerance": f"card <= {EXACT_RATIO:g} x cpu: the largest loss "
                         "distance (relative), G and D (relative L2)"}
    print(json.dumps(line), flush=True)
    if not all(math.isfinite(v) for v in m16.values()):
        fail(f"train card vs CPU bf16: non-finite loss {m16}")
    if bad:
        fail(f"train card vs CPU bf16: farther from float32 than the CPU {bad}")


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN restricted to deterministic algorithms while active. Its
    default backward sums in an order that varies between calls, which
    flips the bf16 rounding of a bf16 x's gradient (and, in the bf16 twin,
    roundings downstream of it): two autograd runs of one twin then differ
    by a bf16 step. Deterministic, they agree to the bit."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def train_backward_phase(torch, dev, calls):
    """Each kernel at every training launch shape: its wrapper's forward and
    backward (plain_vjp) against autograd of its plain version on the card
    (the bf16 twin on a bf16 x), the same inputs and cotangent, both under
    deterministic_cudnn: each gradient within TRAIN_BWD_TOL x max|ref| of
    its tensor. ms of the kernel's forward, the plain forward and the
    wrapper's backward (CUDA events), and the forward's bound. A bf16 shape
    (the bf16 configuration) holds the forward with bf16_check and takes the
    bf16 bound; where the twin rounds (the AMPBlock, the stage), autograd of
    the float32 plain version must be farther than TRAIN_BWD_TOL from the
    twin's gradient in some tensor, so that a backward which skipped the
    twin would fail the gate."""
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
    for (kind, shape, static, dtype), n_calls in sorted(calls.items(), key=str):
        b, t, c = shape
        half = dtype == "bfloat16"
        x = leaf(b, t, c)
        if half:
            x = x.detach().bfloat16().requires_grad_()
        if kind == "aa_snakebeta":
            ws = [leaf(c, scale=0.2, positive=True),
                  leaf(c, scale=0.2, positive=True)]
            fused = lambda: fused_aa_snakebeta(x, *ws)  # noqa: E731
            plain = lambda: composed_snakebeta(x, *ws)  # noqa: E731
            twin_args = ws
            n_bytes, flops, conv = 4.0 * (2 * b * t * c + 2 * c), SNAKE_FLOPS * b * t * c, 0.0
            act_bytes = 4.0 * 2 * b * t * c
            label = f"B={b} T={t} C={c}"
        elif kind == "ampblock":
            k, dil = static
            ws = block_ws(c, k)
            fused = lambda: fused_ampblock(x, *ws, k, dil)  # noqa: E731
            plain = lambda: composed_ampblock(x, *ws, k, dil)  # noqa: E731
            plain32 = lambda xf: composed_ampblock(xf, *ws, k, dil)  # noqa: E731
            twin_args = (*ws, k, dil)
            n_bytes = 4.0 * (2 * b * t * c + 6 * k * c * c + 10 * c)
            act_bytes = 4.0 * 2 * b * t * c
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
            plain32 = lambda xf: composed_triple(xf, bws, ks, dils, post)  # noqa: E731
            twin_args = (bws, ks, dils, post)
            flops = sum(block_flops(b * t, c, k)[0] for k in ks) + 3.0 * b * t * c
            conv = sum(block_flops(b * t, c, k)[1] for k in ks)
            if has_post:
                flops += (SNAKE_FLOPS + 14) * b * t * c + b * t
            n_bytes = 4.0 * (b * t * c + (b * t if has_post else b * t * c)
                             + sum(6 * k * c * c + 10 * c for k in ks))
            act_bytes = 4.0 * (b * t * c + (b * t if has_post else b * t * c))
            label = f"B={b} T={t} C={c} ks={list(ks)}{' +tail' if has_post else ''}"
        leaves = [x] + ws
        y = fused()
        ct = torch.randn(y.shape, generator=gen).to(dev, y.dtype)
        with deterministic_cudnn(torch):
            grads = torch.autograd.grad(y, leaves, ct, retain_graph=True)
            yr = plain()
            refs = torch.autograd.grad(yr, leaves, ct)
        if half:
            with torch.no_grad():
                check = bf16_check(y.detach(), *bf16_twin(torch, kind, x.detach(),
                                                           twin_args))
            fwd_err, fwd_ok = check["err_over_ref"], check["ok"]
        else:
            fwd_err = ((y - yr).abs().max() / yr.abs().max()).item()
            fwd_ok = fwd_err <= TRAIN_FWD_TOL[kind]
        def rel(gs, rs):  # per tensor, max abs difference over max|ref|
            return [((g.float() - r.float()).abs().max()
                     / r.float().abs().max().clamp_min(1e-30)).item()
                    for g, r in zip(gs, rs)]

        grad_err = max(rel(grads, refs))
        f32_err = None
        if half and kind != "aa_snakebeta":  # the AA-snake's twin rounds nothing
            xf = x.detach().float().requires_grad_()
            with deterministic_cudnn(torch):
                refs32 = torch.autograd.grad(plain32(xf), [xf] + ws, ct.float())
            f32_err = max(rel([refs32[0].to(x.dtype), *refs32[1:]], refs))
            del refs32, xf
        del yr, refs
        with torch.no_grad():
            ms = time_ms(torch, fused, 5)
            plain_ms = time_ms(torch, plain, 3)
        bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            y, leaves, ct, retain_graph=True), 3)
        if half:  # bf16 activations, the products one bf16 pass
            b_ms, b_by = bound_ms_bf16(n_bytes - act_bytes / 2, flops, conv)
        else:
            b_ms, b_by = bound_ms(n_bytes, flops, conv)
        line = {"phase": "train_shape", "kernel": kind, "shape": label,
                **({"dtype": "bf16", "fwd_check": check} if half else {}),
                "calls_in_first_run": n_calls, "fwd_err_over_ref": fwd_err,
                "grad_err_over_ref": grad_err,
                **({"grad_f32_backward_over_ref": f32_err} if half else {}),
                "tolerance": {"fwd": (check["tolerance"] if half else
                                      f"{TRAIN_FWD_TOL[kind]:g} x max|ref|"),
                              "grad": f"{TRAIN_BWD_TOL:g} x max|ref| per tensor, "
                                      "cuDNN deterministic"},
                "ms": ms, "plain_ms": plain_ms, "bwd_plain_vjp_ms": bwd_ms,
                "bound_ms": b_ms, "bound_by": b_by}
        print(json.dumps(line), flush=True)
        if f32_err is not None and f32_err <= TRAIN_BWD_TOL:
            fail(f"{kind} {label} {dtype}: the float32 backward is within "
                 f"{f32_err} of the twin's, the gate cannot tell them apart")
        if not (fwd_ok and grad_err <= TRAIN_BWD_TOL):
            fail(f"{kind} {label} {dtype} under autograd: forward {fwd_err}, "
                 f"gradients {grad_err} of max|ref|")
        rows.append(line)
        del x, ws, leaves, y, grads, ct
    print(json.dumps({"phase": "train_shapes", "checked": len(rows)}), flush=True)
    return rows


def train_run(torch, cli, shapes, calls, logs, cfgs, label, kernels):
    """cli/train_vocoder.main on each config path of `cfgs` in turn, on one
    run directory (each later run resumes): TrainStep timed (TimedStep,
    counting `kernels`), the eval hook probed, the first run's kernel calls
    recorded in `calls` and its launch shapes under `label`. Returns (the
    last state, the step records, scalars.jsonl, the EvalProbe, seconds per
    run, peak memory of the first run, the checkpoint after it)."""
    import os

    from megatts2_hierspeechpp_torch.train import checkpoints as ckpt

    steps, secs = [], []
    make_step = cli.vt.TrainStep

    def timed_step(**kw):
        steps.append(TimedStep(torch, make_step(**kw), kernels))
        return steps[-1]

    cli.vt.TrainStep = timed_step
    torch.cuda.reset_peak_memory_stats()
    try:
        with EvalProbe(torch, cli, "make_vocoder_eval_fn", shapes,
                       f"{label} eval", calls) as probe:
            for i, cfg in enumerate(cfgs):
                calls.on = i == 0
                shapes.path = label if i == 0 else None
                t0 = time.perf_counter()
                state = cli.main(["-c", cfg, "-m", "run", "--logs_dir", logs])
                secs.append(time.perf_counter() - t0)
                calls.on, shapes.path = False, None
                if i == 0:
                    peak = torch.cuda.max_memory_allocated()
                    after_first = ckpt.latest_step(os.path.join(logs, "run", "ckpt"))
    finally:
        cli.vt.TrainStep = make_step
        calls.on, shapes.path = False, None
    with open(os.path.join(logs, "run", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    return (state, [r for s in steps for r in s.records], scalars, probe,
            secs, peak, after_first)


def train_line(label, dtype, hps, recs, scalars, evals, secs, peak, after_first,
               corpus_s=None):
    """The train_vocoder line of one run, and its checks: the steps 1..n
    logged with finite losses, the checkpoint after the first run, and every
    kernel of `dtype`'s configuration launched in every step, none of the
    other's."""
    hop_s = 320 / 16000
    n = len(recs)
    med = float(np.median([r["ms"] for r in recs[1:]]))

    def rate(seconds_of):  # median audio-s per s of the steps after the first
        return float(np.median([seconds_of(r) / (r["ms"] / 1e3)
                                for r in recs[1:]]))

    losses = [s for s in scalars if "loss/g/total" in s]
    line = {"phase": "train_vocoder", "config": TRAIN_CONFIG, "dtype": dtype,
            "run": label, "corpus_s": corpus_s,
            "steps": [r["step"] for r in recs],
            "runs_s": secs, "checkpoint_after_first_run": after_first,
            "step_ms_median_after_first": med,
            "step_ms": [r["ms"] for r in recs],
            "audio_s_per_s_encoded": rate(lambda r: r["frames"] * hop_s),
            "audio_s_per_s_encoded_padded": rate(
                lambda r: r["B"] * r["T"] * hop_s),
            "audio_s_per_s_decoded": rate(
                lambda r: r["B"] * hps.train.segment_frames * hop_s),
            "peak_memory_mb": peak / 2 ** 20,
            "launches_per_step": recs[0]["launches"],
            "losses_last": {k: v for k, v in losses[-1].items()
                            if k.startswith("loss/")},
            "eval": evals}
    print(json.dumps(line), flush=True)
    if [r["step"] for r in recs] != list(range(1, n + 1)):
        fail(f"{label}: steps {[r['step'] for r in recs]}, expected 1-{n}")
    if after_first != n // 2:
        fail(f"{label}: checkpoint {after_first} after the first run")
    if [s["step"] for s in losses] != list(range(1, n + 1)):
        fail(f"{label}: logged steps {[s['step'] for s in losses]}")
    for s in losses:
        bad = {k: v for k, v in s.items()
               if k.startswith("loss/") and not math.isfinite(v)}
        if bad:
            fail(f"{label} step {s['step']}: non-finite losses {bad}")
    want = BF16_KERNELS if dtype == "bf16" else TRAIN_KERNELS
    for r in recs:
        if min(r["launches"][k] for k in want) < 1 or any(
                v for k, v in r["launches"].items() if k not in want):
            fail(f"{label} step {r['step']}: launches {r['launches']}, each "
                 f"of {want} expected")


def train_vocoder_phase(torch, dev, shapes, tmp):
    """cli/train_vocoder at the published widths on a synthetic corpus
    written into `tmp`, at its default compute (bf16: the config sets no
    train.dtype, as the JAX CLI): 3 steps, a checkpoint, a resumed run of 3
    more, the eval hook at steps 3 and 6; then "fp32" on 32 of the
    utterances (one batch an epoch): 1 step, a checkpoint, 1 resumed, the
    eval hook after each (its B = 32 float32 launch shapes). Each
    step's ms and kernel launches, audio-s per s, peak memory; one step of
    each profiled on the same batch; one step card against CPU in each
    dtype; every kernel's backward at its training shapes of both runs.
    Returns (launches of a bf16 step, launches of a float32 step, the
    train_shape rows, the corpus directory, the bf16 run's directory with
    its latest checkpoint, which serve_trained serves); the other
    checkpoints are deleted."""
    import os
    import shutil

    from megatts2_hierspeechpp_torch.cli import make_synth_corpus
    from megatts2_hierspeechpp_torch.cli import train_vocoder as cli
    from megatts2_hierspeechpp_torch.data.dataset import (
        DatasetConfig, DistributedBucketSampler, SidecarDataset)
    from megatts2_hierspeechpp_torch.ops import cuda_lib
    from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib
    from megatts2_hierspeechpp_torch.utils.config import load_hparams

    hps = load_hparams(TRAIN_CONFIG)
    if "dtype" in hps.train:
        fail(f"{TRAIN_CONFIG} sets train.dtype: the default is not exercised")
    corpus = os.path.join(tmp, "corpus")
    t0 = time.perf_counter()
    make_synth_corpus.make_corpus(corpus, n=TRAIN_UTTERANCES, seed=0)
    corpus_s = time.perf_counter() - t0
    ds = SidecarDataset(f"{corpus}/train_list.txt", DatasetConfig())
    sampler = DistributedBucketSampler(ds.lengths(), hps.train.batch_size,
                                       list(cli.BOUNDARIES),
                                       seed=hps.train.seed)
    batch = cli.vocoder_batch(ds, sampler.epoch_batches(0)[0])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    step = cli.vt.TrainStep(segment_frames=hps.train.segment_frames,
                            c_mel=hps.train.c_mel, c_kl=hps.train.c_kl)
    kernels = TRAIN_KERNELS + BF16_KERNELS
    calls = KernelCalls()
    try:
        logs = os.path.join(tmp, "logs")
        evals = dict(eval_interval=TRAIN_EVAL_INTERVAL, eval_plots=False)
        cfgs = [train_config(os.path.join(tmp, f"c{e}.json"), hps, corpus,
                             epochs=e, log_interval=1, save_interval=2, **evals)
                for e in (1, 2)]
        state, recs, scalars, probe, secs, peak, first = train_run(
            torch, cli, shapes, calls, logs, cfgs, "train_vocoder", kernels)
        train_line("train_vocoder", "bf16", hps, recs, scalars, probe.records,
                   secs, peak, first, corpus_s)
        check_evals("train_vocoder", probe, scalars, ("mel_l1",), (3, 6))
        train_profile(torch, step, state, batch, seed=5,
                      label="train_vocoder bf16 B=32")
        del state
        torch.cuda.empty_cache()
        # the run with its latest checkpoint (1.7 GB) for serve_trained
        voc_run = os.path.join(tmp, "voc_run")
        shutil.move(os.path.join(logs, "run"), voc_run)
        ckpts = os.path.join(voc_run, "ckpt")
        latest = ckpt_lib.latest_step(ckpts)
        for name in os.listdir(ckpts):
            if name != f"step_{latest:08d}":
                os.remove(os.path.join(ckpts, name))
        shutil.rmtree(logs)

        sub = s_subset(corpus, os.path.join(tmp, "corpus32"),
                       TRAIN_FP32_UTTERANCES, cli.BOUNDARIES)
        cfgs = [train_config(os.path.join(tmp, f"f{e}.json"), hps, sub,
                             epochs=e, log_interval=1, save_interval=2,
                             dtype="fp32", eval_interval=1, eval_plots=False)
                for e in (1, 2)]
        state, recs32, scalars, probe, secs, peak, first = train_run(
            torch, cli, shapes, calls, logs, cfgs, "train_vocoder fp32", kernels)
        train_line("train_vocoder fp32", "fp32", hps, recs32, scalars,
                   probe.records, secs, peak, first)
        check_evals("train_vocoder fp32", probe, scalars, ("mel_l1",), (1, 2))
        train_profile(torch, step, state, batch, seed=5,
                      label="train_vocoder fp32 B=32")
        del state, batch
        torch.cuda.empty_cache()
        shutil.rmtree(logs)
    finally:
        calls.close()
    train_cpu_phase(torch, dev, hps, ds)
    torch.cuda.empty_cache()
    rows = train_backward_phase(torch, dev, calls.seen)
    cuda_lib.reset_launches()
    return recs[0]["launches"], recs32[0]["launches"], rows, corpus, voc_run


# ---- phase 11: s2 / s1 training (cli/train_s2, cli/train_s1) and the
# trained models served ----

S_CONFIG = "configs/config.json"  # published: batch 8, lr 1e-4, betas (0.8, 0.99),
                                  # eps 1e-9, c_commit 100; TTV / PLM at full depth
S_UTTERANCES = 24       # phase 10's utterances of one length bucket: 3 batches of 8
S_FP32_UTTERANCES = 8   # the "fp32" runs: one batch of 8 an epoch
S_CPU_FRAMES = 64       # card vs CPU steps: 2 utterances cut to 64 frames
S_LOSS_TOL = 1e-4       # card vs CPU, each metric, relative
S_GRAD_TOL = 1e-3       # card vs CPU, relative L2 of all G (all D) gradients
S_VQ_TOL = 1e-5         # card vs CPU, the RVQ statistics, x max|CPU|
EXACT_RATIO = 2.0       # a gradient whose float32 CPU result is itself more than
                        # S_GRAD_TOL from float64: the card within this many
                        # times the CPU's distance from float64
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


def s_subset(corpus, dst, n: int = S_UTTERANCES, boundaries=None):
    """A filelist of n of the corpus's utterances, all in its most common
    length bucket (`boundaries`, cli/train_s2.BOUNDARIES by default), so
    that an epoch at batch b is n / b steps. Returns dst."""
    import os

    from megatts2_hierspeechpp_torch.cli.train_s2 import BOUNDARIES
    from megatts2_hierspeechpp_torch.data.dataset import (
        DatasetConfig, SidecarDataset)

    bounds = boundaries or BOUNDARIES

    ds = SidecarDataset(f"{corpus}/train_list.txt", DatasetConfig())
    bucket = [next(i for i in range(len(bounds) - 1)
                   if bounds[i] < t <= bounds[i + 1]) for t in ds.lengths()]
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


def run_cli(cli_mod, step_mod, torch, argv_runs, keys=("mel", "mel_lengths")):
    """cli_mod.main(argv) for each argv, step_mod.TrainStep wrapped in
    TimedStep (every serving kernel counted; `keys` its frames and lengths
    keys): (the last run's state, the step records, the runs' s)."""
    steps, secs = [], []
    make_step = step_mod.TrainStep

    def timed(*a, **kw):
        steps.append(TimedStep(torch, make_step(*a, **kw), PATH_KERNELS, *keys))
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


def check_run(label, recs, scalars, state, loss_keys, must=(), n=6):
    """Steps 1-n (n / 2, then n / 2 resumed), every logged loss finite; each
    kernel of `must` launched in every step, or with none given, no kernel
    of the serving path launched by a training step."""
    steps = [r["step"] for r in recs]
    if steps != list(range(1, n + 1)) or state.step != n:
        fail(f"{label}: steps {steps}, final {state.step}, expected 1-{n} "
             f"({n // 2}, then {n // 2} resumed from the checkpoint)")
    logged = [s["step"] for s in scalars if any(k in s for k in loss_keys)]
    if logged != list(range(1, n + 1)):
        fail(f"{label}: logged steps {logged}")
    for s in scalars:
        bad = {k: v for k, v in s.items() if not math.isfinite(v)}
        if bad:
            fail(f"{label} step {s['step']}: non-finite scalars {bad}")
    if must:
        missed = [r["launches"] for r in recs if min(r["launches"][k] for k in must) < 1]
        if missed:
            fail(f"{label}: a step did not launch {must}: {missed}")
        return
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


def card_vs_cpu(torch, dev, label, build, run, batch, desc=None, exact=None):
    """One step on the card and on the CPU from the same weights, batch and
    draws: build(device) -> state; run(state, batch, device) -> (metrics,
    {name: flat gradients}, {name: flat state to compare}). `exact`: flat
    float64 gradients of the same step for some names; such a gradient also
    passes if the card is no farther from it than EXACT_RATIO x the CPU's
    float32 result is (where float32 itself misses S_GRAD_TOL)."""
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
    exact_err = {k: {side: ((g[k].double() - ref).norm() / ref.norm()).item()
                     for side, g in (("card", gc), ("cpu", gp))}
                 for k, ref in (exact or {}).items()}
    line = {"phase": "train_card_vs_cpu", "path": label,
            **(desc or {"B": 2, "frames": S_CPU_FRAMES}), "card_ms": ms_c, "cpu_ms": ms_p,
            "metrics_card": mc, "metric_rel_err": loss_err,
            "grad_rel_l2": grad_err, "state_err_over_max": extra_err,
            "grad_rel_l2_to_float64": exact_err,
            "tolerance": {"metric": S_LOSS_TOL, "grad": S_GRAD_TOL,
                          "state": S_VQ_TOL,
                          "to_float64": f"card <= {EXACT_RATIO:g} x cpu"}}
    print(json.dumps(line), flush=True)
    if not all(math.isfinite(v) for v in mc.values()):
        fail(f"{label} card vs CPU: non-finite metrics {mc}")
    if not max(loss_err.values()) <= S_LOSS_TOL:
        fail(f"{label} card vs CPU: metrics differ {loss_err}")
    bad = {k: e for k, e in grad_err.items() if not (
        e <= S_GRAD_TOL or (k in exact_err and exact_err[k]["card"]
                            <= EXACT_RATIO * exact_err[k]["cpu"]))}
    if bad:
        fail(f"{label} card vs CPU: gradients differ {bad} {exact_err}")
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


def s_configs(tmp, hps, sub, prefix, **train):
    """The (1 epoch, 2 epochs) configs of a run on the filelist dir `sub`:
    logged every step, checkpoints and the eval hook every 3 steps unless
    `train` says otherwise."""
    import os

    opts = dict(log_interval=1, save_interval=3, eval_interval=3,
                eval_plots=False)
    opts.update(train)
    return tuple(train_config(os.path.join(tmp, f"{prefix}{e}.json"), hps, sub,
                              epochs=e, **opts) for e in (1, 2))


def synthetic_steps(torch, dev, step, state, label):
    """The synthetic 10 s batch: 1 warm-up and 3 CUDA-event-timed steps, one
    more profiled: ms, audio-s per s, peak memory, idle share, launches."""
    synth = synthetic_s2_batch(torch, dev, np.random.default_rng(17))
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(4):
        _, ms = event_ms(torch, lambda: step(state, synth,
                                             torch.Generator().manual_seed(30 + i)))
        times.append(ms)
    peak = torch.cuda.max_memory_allocated()
    b, t = S2_SYNTH[:2]
    med = float(np.median(times[1:]))
    prof = step_profile(torch, f"{label} synthetic B={b} T={t}", lambda: step(
        state, synth, torch.Generator().manual_seed(40)))
    return {"B": b, "T": t, "phones": S2_SYNTH[2], "step_ms": times,
            "step_ms_median": med,
            "audio_s_per_s": b * t * 320 / 16000 / (med / 1e3),
            "peak_memory_mb": peak / 2 ** 20,
            "device_idle_share": prof["device_idle_share"],
            "device_kernel_launches": prof["kernel_launches"],
            "groups_ms": prof["groups_ms"]}


def card_vs_cpu_bf16(torch, dev, label, build, run, batch):
    """One step in bf16 compute and one in float32 from the same weights,
    batch and draws, on the card and on the CPU: build(device, dtype name)
    -> state; run as card_vs_cpu's. Each side's bf16 step is judged by its
    distance from its own float32 step (metrics: the largest relative
    difference; gradients: relative L2), the card's within EXACT_RATIO x
    the CPU's: two bf16 paths that round in other places cannot meet float32
    tolerances against each other. A gradient's distance must also be at
    least the CPU's / EXACT_RATIO, so that a module the card left in
    float32 shows (a metric, one scalar, has no lower bound)."""
    dist, ms = {}, {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        res = {}
        for name in ("fp32", "bf16"):
            state = build(d, name)
            tb = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
            t0 = time.perf_counter()
            m, grads, _ = run(state, tb, d)
            m = {k: float(v) for k, v in m.items()}  # waits for the device
            ms[f"{side}_{name}"] = 1e3 * (time.perf_counter() - t0)
            res[name] = (m, {k: v.detach().cpu() for k, v in grads.items()})
            del state
        (m32, g32), (m16, g16) = res["fp32"], res["bf16"]
        if not all(math.isfinite(v) for v in m16.values()):
            fail(f"{label} bf16 on the {side}: non-finite metrics {m16}")
        dist[side] = {"metrics": max(abs(m16[k] - v) / max(abs(v), 1e-30)
                                     for k, v in m32.items()),
                      **{k: ((g16[k] - g).norm() / g.norm()).item()
                         for k, g in g32.items()}}
    line = {"phase": "train_card_vs_cpu", "path": label, "dtype": "bf16",
            "B": 2, "frames": S_CPU_FRAMES, "ms": ms,
            "distance_from_own_fp32": dist,
            "tolerance": f"card <= {EXACT_RATIO:g} x cpu; gradients: card >= "
                         f"cpu / {EXACT_RATIO:g}"}
    print(json.dumps(line), flush=True)
    bad = {k: (dist["card"][k], v) for k, v in dist["cpu"].items()
           if not dist["card"][k] <= EXACT_RATIO * v
           or (k != "metrics" and not dist["card"][k] >= v / EXACT_RATIO)}
    if bad:
        fail(f"{label} bf16 card vs CPU: card's distance from float32 outside "
             f"[cpu / {EXACT_RATIO}, {EXACT_RATIO} x cpu] {bad}")


def train_s2_phase(torch, dev, tmp, corpus):
    """cli/train_s2 at full width on S_UTTERANCES utterances at the CLI's
    default compute (bf16: the config sets no train.dtype, as the JAX CLI):
    3 steps, a checkpoint, 3 resumed; then train.dtype "fp32" on
    S_FP32_UTTERANCES (one batch an epoch): 1 step, a checkpoint, 1 resumed.
    For each run a profiled step of the same B = 8 batch and the synthetic
    10 s step; the card-vs-CPU gates in float32 (today's) and in bf16.
    Returns (the bf16 run's directory, its two configs, the first batch)."""
    import os

    from megatts2_hierspeechpp_torch.cli import train_s2 as cli
    from megatts2_hierspeechpp_torch.data.dataset import collate
    from megatts2_hierspeechpp_torch.nn.basic import MaskSource
    from megatts2_hierspeechpp_torch.train import s2
    from megatts2_hierspeechpp_torch.utils.config import load_hparams

    hps = load_hparams(S_CONFIG)
    if "dtype" in hps.train:
        fail(f"{S_CONFIG} sets train.dtype: the CLIs' default is not exercised")
    logs = os.path.join(tmp, "slogs")
    sub = s_subset(corpus, os.path.join(tmp, "s2corpus"))
    cfg1, cfg2 = s_configs(tmp, hps, sub, "s2_")
    sub8 = s_subset(corpus, os.path.join(tmp, "s2corpus8"), S_FP32_UTTERANCES)
    fcfgs = s_configs(tmp, hps, sub8, "s2f_", dtype="fp32", save_interval=1,
                      eval_interval=1)
    hps2, hpsf = load_hparams(cfg2), load_hparams(fcfgs[1])
    ds = cli.SidecarDataset(hps2.data.training_files, cli.DatasetConfig())
    sampler = cli.DistributedBucketSampler(ds.lengths(), hps2.train.batch_size,
                                           list(cli.BOUNDARIES), seed=hps2.train.seed)
    first = collate([ds[i] for i in sampler.epoch_batches(0)[0]], pad_multiple=64)
    step = s2.TrainStep(c_mel=hps2.train.c_mel, c_commit=hps2.train.c_commit)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}

    for label, dtype, cfgs, n in (("train_s2", "bf16", (cfg1, cfg2), 6),
                                  ("train_s2 fp32", "fp32", fcfgs, 2)):
        run = "s2" if dtype == "bf16" else "s2f"
        torch.cuda.reset_peak_memory_stats()
        state, recs, secs = run_cli(cli, s2, torch, [
            ["-c", c, "-m", run, "--logs_dir", logs] for c in cfgs])
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(logs, run, "scalars.jsonl")) as f:
            scalars = [json.loads(line) for line in f]
        for r in recs:
            print(json.dumps(dict(r, phase="train_s2_step", dtype=dtype)), flush=True)
        check_run(label, recs, scalars, state, ("loss/g/total",), n=n)
        want = (torch.bfloat16 if dtype == "bf16" else None)
        if state.ttv.dtype != want or state.disc.discriminators[0].out.dtype != want:
            fail(f"{label}: the models compute in {state.ttv.dtype}, not {dtype}")
        evals = [s for s in scalars if "eval/w2v_l1" in s]
        want_evals = [3, 6] if n == 6 else [1, 2]
        if [s["step"] for s in evals] != want_evals:
            fail(f"{label}: eval at steps {[s['step'] for s in evals]}, "
                 f"expected {want_evals}")
        prof = step_profile(torch, f"{label} B=8", lambda: step(
            state, tb, torch.Generator().manual_seed(5)))
        synth = synthetic_steps(torch, dev, step, state, label)
        line = {"phase": "train_s2", "dtype": dtype, "run": label,
                "config": S_CONFIG, "B": recs[0]["B"],
                "steps": [r["step"] for r in recs], "runs_s": secs,
                **rate_line(recs), "peak_memory_mb": peak / 2 ** 20,
                "our_kernel_launches_per_step": recs[0]["launches"],
                "device_kernel_launches_per_step": prof["kernel_launches"],
                "device_kernel_ms": prof["device_kernel_ms"],
                "device_idle_share": prof["device_idle_share"],
                "groups_ms": prof["groups_ms"], "synthetic": synth,
                "losses_last": {k: v for k, v in scalars[-2].items()
                                if k.startswith("loss/")},
                "eval_last": evals[-1]}
        print(json.dumps(line), flush=True)
        del state
        torch.cuda.empty_cache()
    del tb

    # card vs CPU: the same weights, batch, coin and dropout masks (drawn on
    # the CPU and moved); float32 at today's tolerances, then bf16
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
        hpsf, d, hpsf.train.seed, 1000), run, batch)
    hps_of = {"fp32": hpsf, "bf16": hps2}
    card_vs_cpu_bf16(torch, dev, "train_s2", lambda d, name: cli.build_state(
        hps_of[name], d, hps2.train.seed, 1000), run, batch)
    return os.path.join(logs, "s2"), (cfg1, cfg2, *fcfgs), first


def train_s1_phase(torch, dev, tmp, s2_dir, cfgs, first):
    """cli/train_s1 from train_s2's bf16 checkpoint at the CLI's default
    (bf16: the frozen TTV and the PLM): 3 steps + 3 resumed; then "fp32", 1
    step + 1 resumed; a profiled step of each; the card-vs-CPU gates in
    float32 and in bf16. Returns (the bf16 run's last state, the first batch
    on the card, the bf16 run's directory)."""
    import os

    from megatts2_hierspeechpp_torch.cli import train_s1 as cli
    from megatts2_hierspeechpp_torch.nn.basic import MaskSource
    from megatts2_hierspeechpp_torch.train import s1
    from megatts2_hierspeechpp_torch.utils.config import load_hparams

    logs = os.path.join(tmp, "slogs")
    ckpt = os.path.join(s2_dir, "ckpt")
    cfg1, cfg, fcfg1, fcfg = cfgs
    tb = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
    out = None
    for label, dtype, run_cfgs, n in (("train_s1", "bf16", (cfg1, cfg), 6),
                                      ("train_s1 fp32", "fp32", (fcfg1, fcfg), 2)):
        run = "s1" if dtype == "bf16" else "s1f"
        torch.cuda.reset_peak_memory_stats()
        state, recs, secs = run_cli(cli, s1, torch, [
            ["-c", c, "-m", run, "--logs_dir", logs, "--s2_ckpt", ckpt]
            for c in run_cfgs])
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(logs, run, "scalars.jsonl")) as f:
            scalars = [json.loads(line) for line in f]
        for r in recs:
            print(json.dumps(dict(r, phase="train_s1_step", dtype=dtype)), flush=True)
        check_run(label, recs, scalars, state, ("loss/plm",), n=n)
        want = torch.bfloat16 if dtype == "bf16" else None
        if state.plm.predict_layer.dtype != want or state.ttv.dtype != want:
            fail(f"{label}: the models compute in {state.plm.predict_layer.dtype}")
        rates = rate_line(recs)
        prof = step_profile(torch, f"{label} B=8", lambda: s1.TrainStep()(
            state, tb, torch.Generator().manual_seed(6)))
        line = {"phase": "train_s1", "dtype": dtype, "run": label,
                "config": S_CONFIG, "steps": [r["step"] for r in recs],
                "runs_s": secs, "step_ms": rates["step_ms"],
                "step_ms_median_after_first": rates["step_ms_median_after_first"],
                "tokens_per_s": rates["frames_per_s"],
                "audio_s_per_s": rates["audio_s_per_s"],
                "peak_memory_mb": peak / 2 ** 20,
                "our_kernel_launches_per_step": recs[0]["launches"],
                "device_kernel_launches_per_step": prof["kernel_launches"],
                "device_kernel_ms": prof["device_kernel_ms"],
                "device_idle_share": prof["device_idle_share"],
                "groups_ms": prof["groups_ms"],
                "metrics_last": {k: v for k, v in scalars[-2].items()
                                 if k.startswith(("loss/", "acc/"))}}
        print(json.dumps(line), flush=True)
        if dtype == "bf16":
            out = state
        else:
            del state
            torch.cuda.empty_cache()

    hps_of = {"fp32": load_hparams(fcfg), "bf16": load_hparams(cfg)}

    def build(d, name="fp32"):
        hps = hps_of[name]
        return cli.build_state(hps, d, cli.load_s2_vars(ckpt, hps, d))

    def run(st, tb, d):
        st, m = s1.TrainStep().with_draws(st, tb, MaskSource(
            torch.Generator().manual_seed(8)))
        return m, {"PLM": flat_grads(torch, st.opt.params)}, {}

    batch = cut_batch(first, S_CPU_FRAMES)
    card_vs_cpu(torch, dev, "train_s1", build, run, batch)
    card_vs_cpu_bf16(torch, dev, "train_s1", build, run, batch)
    return out, tb, os.path.join(logs, "s1")


def state_dicts_equal(got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(
        bool((got[k].cpu() == want[k].cpu()).all()) for k in want)


def serve_trained_phase(torch, dev, shapes, audio, state, batch, runs):
    """The trained models served through infer/from_training: the pipeline
    of the four run directories `runs` (phase 11's bf16 s2 and s1 runs,
    phase 10's bf16 vocoder run, phase 12's SpeechSR-48k run) serves the 10
    s tts request (exact=True) at 48 kHz, first at float32 compute, then
    once more at dtype=bfloat16. Gates: every model's state_dict equals its
    run's latest checkpoint; all four kernels launch (in bf16 the vocoder
    kernels' bf16 configuration and still one float32 plm_decode); the
    decode's teacher-forced gap against the float32 plain twin; the s1
    run's in-memory PLM, packed, then stepped once more (an optimizer's
    in-place update: its decode weights must be packed anew), then loaded
    with the checkpoint, decodes the pipeline's codes."""
    import os

    from megatts2_hierspeechpp_torch.infer.from_training import (
        build_pipeline_from_train_dirs)
    from megatts2_hierspeechpp_torch.models.plm import decode, teacher_forced_gap
    from megatts2_hierspeechpp_torch.models.vocoder import serving_state_dict
    from megatts2_hierspeechpp_torch.ops import cuda_lib
    from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib
    from megatts2_hierspeechpp_torch.train import s1

    s2_dir, s1_dir, voc_dir, sr_dir = runs
    plm = state.plm
    stale = plm.packed()
    stale_wqkv = stale.wqkv.clone()
    s1.TrainStep()(state, batch, torch.Generator().manual_seed(9))
    plm.eval()
    repacked = plm.packed() is not stale
    moved = not torch.equal(plm.packed().wqkv, stale_wqkv)

    raw = {d: ckpt_lib.restore_raw(os.path.join(d, "ckpt")) for d in runs}
    want = {"ttv": raw[s2_dir]["ttv"], "plm": raw[s1_dir]["plm"],
            "vocoder": serving_state_dict(raw[voc_dir]["gen"]),
            "speechsr": raw[sr_dir]["gen"]}
    lines = {}
    for label, dtype in (("serve_trained", None),
                         ("serve_trained bf16", torch.bfloat16)):
        t0 = time.perf_counter()
        pipe = build_pipeline_from_train_dirs(s2_dir, s1_dir, voc_dir,
                                              speechsr=sr_dir, dtype=dtype,
                                              device=dev)
        build_s = time.perf_counter() - t0
        unequal = [k for k, sd in want.items()
                   if not state_dicts_equal(getattr(pipe, k).state_dict(), sd)]
        if unequal:
            fail(f"{label}: state_dicts differ from the runs' checkpoints: {unequal}")
        prompt = pipe.prepare_prompt(audio)
        if dtype is None:
            (f, text, ls, n) = tts_requests(pipe, prompt)[-1]
            f32_plm = pipe.plm

        def request():
            return pipe.tts(text, prompt=prompt, length_scale=ls, output_sr=48000,
                            exact=True, return_intermediates=True)

        request()   # warm-up
        t0 = time.perf_counter()
        (out, ac, _), counts = run_path(torch, cuda_lib, shapes, label, request)
        ms = 1e3 * (time.perf_counter() - t0)
        gap, scale = teacher_forced_gap(f32_plm, ac.x_frame.float(), ac.codes)
        line = {"phase": label, "runs": list(runs), "build_s": build_s,
                "frames": ac.frames, "target_frames": f, "length_scale": ls,
                "ms": ms, "samples": int(out.shape[0]),
                "audio_s_per_s": (out.shape[0] / 48000) / (ms / 1e3),
                "calls": counts, "latent_dtype": str(ac.x_frame.dtype),
                "tf_gap": gap, "max_abs_logit": scale,
                "tolerance": f"{TF_MARGIN:g} x max|logit|",
                "state_dicts_equal_checkpoints": True}
        kernels = (PATH_KERNELS if dtype is None
                   else BF16_KERNELS + ("plm_decode",))
        if dtype is None:
            plm.load_state_dict(raw[s1_dir]["plm"])
            same = bool(torch.equal(decode(plm, ac.x_frame).cpu(), ac.codes.cpu()))
            line.update(repacked_after_step=repacked, weights_moved=moved,
                        codes_equal_trained_plm_loaded=same)
        print(json.dumps(line), flush=True)
        lines[label] = line
        if min(counts[k] for k in kernels) < 1 or counts["plm_decode"] != 1:
            fail(f"{label}: a kernel was not launched ({kernels}): {counts}")
        if out.shape != (960 * ac.frames,) or not np.isfinite(out).all():
            fail(f"{label}: output {out.shape}, finite {np.isfinite(out).all()}")
        if not gap <= TF_MARGIN * scale:
            fail(f"{label}: teacher-forced gap {gap} > {TF_MARGIN} x {scale}")
        if dtype is None and not (repacked and moved):
            fail(f"serve_trained: the decode weights were not packed anew after "
                 f"an optimizer step (repacked {repacked}, moved {moved})")
        if dtype is None and not same:
            fail("serve_trained: the trained PLM loaded with its checkpoint "
                 "decodes other codes than the pipeline's")
        if dtype is not None and ac.x_frame.dtype != torch.bfloat16:
            fail(f"{label}: the latent is {ac.x_frame.dtype}, not bf16")
        del pipe
        torch.cuda.empty_cache()
    return (lines["serve_trained"]["calls"],
            lines["serve_trained bf16"]["calls"])


# ---- phase 12: SpeechSR training (cli/train_sr) and the trained model served ----

SR_B, SR_SEG_IN = 16, 3200  # the CLI's defaults (48 kHz, ch 32): 0.2 s in, 0.6 s out
SR_RUN = ["--steps_per_epoch", "3", "--log_interval", "1", "--eval_interval", "3",
          "--no_eval_plots"]
SR_CPU = (2, 1600)      # card vs CPU step: B, seg_in (full width, the 48 kHz bank)
SR_SERVE_S = 10.0       # serve_trained_sr: seconds of 16 kHz input
SR_SERVE_TOL = 1e-4     # its output against the plain version, x max|plain|


def train_sr_phase(torch, dev, tmp, corpus, shapes):
    """cli/train_sr at its defaults on phase 10's corpus: 3 steps, a
    checkpoint, 3 resumed (amp_triple launched in every step); one step at
    24 kHz; a profiled step; the card-vs-CPU gate; the triple's forward and
    backward at its training launch shapes; the trained generator served.
    Returns (amp_triple launches per step, the train_shape rows, the 48 kHz
    run's directory)."""
    import os

    from megatts2_hierspeechpp_torch.cli import train_sr as cli
    from megatts2_hierspeechpp_torch.ops import cuda_lib
    from megatts2_hierspeechpp_torch.train import speechsr as srt

    logs = os.path.join(tmp, "srlogs")
    common = ["--data_dir", corpus, "--logs_dir", logs] + SR_RUN
    calls = KernelCalls()
    torch.cuda.reset_peak_memory_stats()
    try:
        with EvalProbe(torch, cli, "make_sr_eval_fn", shapes, "train_sr eval",
                       calls) as probe:
            calls.on = True
            shapes.path = "train_sr"
            state, recs, secs = run_cli(cli, srt, torch, [
                common + ["-m", "sr", "--epochs", "1"],
                common + ["-m", "sr", "--epochs", "2"]], keys=("lo", None))
            peak = torch.cuda.max_memory_allocated()
            shapes.path = "train_sr 24 kHz"
            _, recs24, _ = run_cli(cli, srt, torch, [
                ["--data_dir", corpus, "--logs_dir", logs, "-m", "sr24",
                 "--out_sr", "24000", "--epochs", "1", "--steps_per_epoch", "1",
                 "--eval_interval", "0"]], keys=("lo", None))
    finally:
        calls.on = False
        shapes.path = None
        calls.close()
    with open(os.path.join(logs, "sr", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    for r, sr in [(r, 48000) for r in recs] + [(r, 24000) for r in recs24]:
        print(json.dumps(dict(r, phase="train_sr_step", out_sr=sr)), flush=True)
    check_run("train_sr", recs, scalars, state, ("loss/g/total",), must=("amp_triple",))
    if min(r["launches"]["amp_triple"] for r in recs24) < 1:
        fail(f"train_sr 24 kHz: amp_triple not launched {recs24}")
    check_evals("train_sr", probe, scalars, ("mel_l1", "snr_db"), (3, 6))

    # one step of the first batch, profiled
    lo_w, hi_w = cli.load_corpus(corpus, None, 3, 1)
    first = next(cli.make_batch_iter(lo_w, hi_w, SR_B, SR_SEG_IN, 3, 1, 1234, 1)(0))
    tb = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
    prof = train_profile(torch, srt.TrainStep(), state, tb, 0, f"train_sr B={SR_B}")
    out_s = SR_B * SR_SEG_IN / 16000   # seconds of 48 kHz output per step
    med = float(np.median([r["ms"] for r in recs[1:]]))
    line = {"phase": "train_sr", "out_sr": 48000, "B": SR_B, "seg_in": SR_SEG_IN,
            "wavs": len(lo_w), "steps": [r["step"] for r in recs], "runs_s": secs,
            "step_ms": [r["ms"] for r in recs], "step_ms_median_after_first": med,
            "audio_s_per_s_out": out_s / (med / 1e3),
            "peak_memory_mb": peak / 2 ** 20,
            "launches_per_step": recs[0]["launches"],
            "device_kernel_launches_per_step": prof["kernel_launches"],
            "device_idle_share": prof["device_idle_share"],
            "step_24k_ms": [r["ms"] for r in recs24],
            "launches_per_step_24k": recs24[0]["launches"],
            "losses_last": {k: v for k, v in scalars[-2].items() if k.startswith("loss/")},
            "eval": probe.records}
    print(json.dumps(line), flush=True)
    del tb
    torch.cuda.empty_cache()

    # card vs CPU: the same weights and batch (the step draws nothing)
    b, seg = SR_CPU
    batch = next(cli.make_batch_iter(lo_w, hi_w, b, seg, 3, 1, 7, 1)(0))

    def build(d):
        return cli.build_state(48000, 32, 1e-4, 0.995, 40, d, 1234)

    def run(st, tb, d):
        st, m = srt.TrainStep()(st, tb)
        return m, {"G": flat_grads(torch, st.opt_g.params),
                   "D": flat_grads(torch, st.opt_d.params)}, {}

    card_vs_cpu(torch, dev, "train_sr", build, run, batch, {"B": b, "seg_in": seg},
                exact={"D": sr_d_grads_float64(torch, build("cpu"), batch)})
    rows = train_backward_phase(torch, dev, calls.seen)
    serve_trained_sr_phase(torch, dev, shapes, state)
    del state
    torch.cuda.empty_cache()
    cuda_lib.reset_launches()
    return recs[0]["launches"]["amp_triple"], rows, os.path.join(logs, "sr")


def sr_d_grads_float64(torch, state, batch):
    """The D step's gradients in float64 on the CPU, the fake from the
    float32 generator (flat, in the optimizer's order). Its bias gradients
    sum leaky-ReLU slopes over thousands of positions whose
    pre-activations sit near 0 at init: float32 rounding flips some, and
    the CPU's and the card's float32 results each stand about 2e-3 from
    this one."""
    from megatts2_hierspeechpp_torch.train import losses as L

    with torch.no_grad():
        fake = state.gen(torch.from_numpy(batch["lo"])).double()
    disc = state.disc.double()
    dr, dg, _, _ = disc(torch.from_numpy(batch["hi"]).double(), fake)
    L.discriminator_loss(dr, dg)[0].backward()
    return torch.cat([p.grad.flatten() for p in disc.parameters()])


def serve_trained_sr_phase(torch, dev, shapes, state):
    """The trained generator's state_dict in a serving SpeechSR-48k: one
    10 s 16 kHz waveform upsampled, one amp_triple launch, the output
    against the same module with the plain stage (composed_triple) on the
    card."""
    from megatts2_hierspeechpp_torch.models import speechsr
    from megatts2_hierspeechpp_torch.ops import cuda_lib
    from megatts2_hierspeechpp_torch.ops.amp_triple import composed_triple

    sr = speechsr.SpeechSR(32, 3, 1, seed=99, device=dev)
    sr.load_state_dict(state.gen.state_dict())
    x = torch.from_numpy(speech_like(SR_SERVE_S, 140.0, 23))[None, :, None].to(dev)
    with torch.no_grad():
        sr(x)   # warm-up
        t0 = time.perf_counter()
        y, counts = run_path(torch, cuda_lib, shapes, "serve_trained_sr", lambda: sr(x))
        ms = 1e3 * (time.perf_counter() - t0)
        fused = speechsr.fused_amp_triple
        speechsr.fused_amp_triple = composed_triple
        try:
            ref = sr(x)
        finally:
            speechsr.fused_amp_triple = fused
    err = (y - ref).abs().max().item()
    scale = ref.abs().max().item()
    line = {"phase": "serve_trained_sr", "samples_in": x.shape[1],
            "samples_out": y.shape[1], "ms": ms,
            "audio_s_per_s": SR_SERVE_S / (ms / 1e3), "calls": counts,
            "max_abs_err": err, "max_abs_ref": scale,
            "tolerance": f"{SR_SERVE_TOL:g} x max|plain|"}
    print(json.dumps(line), flush=True)
    if counts["amp_triple"] != 1:
        fail(f"serve_trained_sr: amp_triple launched {counts['amp_triple']} times")
    if y.shape != (1, 3 * x.shape[1], 1) or not torch.isfinite(y).all():
        fail(f"serve_trained_sr: output {tuple(y.shape)}")
    if not err <= SR_SERVE_TOL * scale:
        fail(f"serve_trained_sr: {err} > {SR_SERVE_TOL} x {scale}")


# ---- phase 13: MP-SENet denoiser training (cli/train_denoiser) and serving ----

DN_B, DN_SEG = 8, 32000     # the CLI's defaults (dense_channel 64, remat, attn_chunk 64)
DN_RUN = ["--steps_per_epoch", "3", "--log_interval", "1", "--eval_interval", "3"]
DN_CPU = (2, 8000)      # card vs CPU step: B, samples (0.5 s), full width
DN_REMAT_TOL = 1e-6     # remat on vs off on the card: loss relative, statistics x max


def train_denoiser_phase(torch, dev, tmp, corpus, shapes, audio):
    """cli/train_denoiser at its defaults (B 8, 2 s, dense_channel 64, 4 TS
    blocks, remat, attn_chunk 64) on phase 10's corpus: 3 steps, a
    checkpoint, 3 resumed; a profiled step; one step with remat off; the
    card-vs-CPU gate fed one STFT; remat on vs off on the card; the trained
    model served through TTSPipeline.denoise."""
    import os

    from megatts2_hierspeechpp_torch.cli import train_denoiser as cli
    from megatts2_hierspeechpp_torch.infer.pipeline import TTSPipeline
    from megatts2_hierspeechpp_torch.models.denoiser import MPNet
    from megatts2_hierspeechpp_torch.ops import cuda_lib
    from megatts2_hierspeechpp_torch.ops.stft import mag_pha_stft
    from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib
    from megatts2_hierspeechpp_torch.train import denoiser as dnt

    logs = os.path.join(tmp, "dnlogs")
    common = ["--data_dir", corpus, "--logs_dir", logs, "-m", "dn"] + DN_RUN
    torch.cuda.reset_peak_memory_stats()
    with EvalProbe(torch, cli, "make_denoiser_eval_fn", shapes,
                   "train_denoiser eval") as probe:
        state, recs, secs = run_cli(cli, dnt, torch, [
            common + ["--epochs", "1"], common + ["--epochs", "2"]],
            keys=("clean", None))
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(logs, "dn", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    for r in recs:
        print(json.dumps(dict(r, phase="train_denoiser_step")), flush=True)
    check_run("train_denoiser", recs, scalars, state, ("loss/total",))
    check_evals("train_denoiser", probe, scalars, ("mag_mse", "snr_improvement_db"),
                (3, 6))

    wavs = cli.load_wavs(corpus)[:-cli.EVAL_ROWS]
    first = next(cli.make_batch_iter(wavs, DN_B, DN_SEG, 0.0, 15.0, 1234, 1)(0))
    tb = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
    step = dnt.TrainStep(cli.N_FFT, cli.HOP, cli.WIN)
    prof = train_profile(torch, step, state, tb, 0, f"train_denoiser B={DN_B}")
    # remat off (the attention still chunked): does one step fit, and its peak
    del state
    torch.cuda.empty_cache()
    off = cli.build_state(64, 64, 5e-4, 0.99, 40, dev, 1234, remat=False)
    torch.cuda.reset_peak_memory_stats()
    try:
        _, off_ms = event_ms(torch, lambda: step(off, tb))
        remat_off = {"ran": True, "step_ms": off_ms,
                     "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    except torch.cuda.OutOfMemoryError as e:
        remat_off = {"ran": False, "error": str(e)[:200]}
    del off
    torch.cuda.empty_cache()
    med = float(np.median([r["ms"] for r in recs[1:]]))
    line = {"phase": "train_denoiser", "B": DN_B, "seg": DN_SEG,
            "steps": [r["step"] for r in recs], "runs_s": secs,
            "step_ms": [r["ms"] for r in recs], "step_ms_median_after_first": med,
            "audio_s_per_s": DN_B * DN_SEG / 16000 / (med / 1e3),
            "peak_memory_mb_remat": peak / 2 ** 20, "remat_off": remat_off,
            "our_kernel_launches_per_step": recs[0]["launches"],
            "device_kernel_launches_per_step": prof["kernel_launches"],
            "device_idle_share": prof["device_idle_share"],
            "losses_last": {k: v for k, v in scalars[-2].items() if k.startswith("loss/")},
            "eval": probe.records}
    print(json.dumps(line), flush=True)
    del tb

    # card vs CPU, and remat on vs off on the card: one STFT (the CPU's)
    b, n = DN_CPU
    small = next(cli.make_batch_iter(wavs, b, n, 0.0, 15.0, 11, 1)(0))
    with torch.no_grad():
        spectra = [a.numpy() for w in ("noisy", "clean")
                   for a in mag_pha_stft(torch.from_numpy(small[w]), cli.N_FFT,
                                         cli.HOP, cli.WIN, 0.3)]
    batch = dict(zip(("mag_n", "pha_n", "mag_c", "pha_c"), spectra), clean=small["clean"])

    def stats(st):
        return {k: v for k, v in st.model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    def run(st, tb, d):
        st, m = step.with_spectra(st, *(tb[k] for k in ("mag_n", "pha_n", "mag_c",
                                                         "pha_c", "clean")))
        return m, {"model": flat_grads(torch, st.opt.params)}, stats(st)

    def build(d, remat=True):
        return cli.build_state(64, 64, 5e-4, 0.99, 40, d, 1234, remat=remat)

    card_vs_cpu(torch, dev, "train_denoiser", build, run, batch, {"B": b, "samples": n})
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    outs = {}
    for remat in (True, False):
        st = build(dev, remat)
        m, _, s = run(st, tb, dev)
        outs[remat] = (float(m["loss/total"]), {k: v.clone() for k, v in s.items()},
                       int(st.model.state_dict()[
                           "TSConformer.0.time_conformer.ccm.ccm.5.num_batches_tracked"]))
        del st
    loss_err = abs(outs[True][0] - outs[False][0]) / abs(outs[False][0])
    stat_err = max(((outs[True][1][k] - v).abs().max() / v.abs().max()).item()
                   for k, v in outs[False][1].items())
    line = {"phase": "train_denoiser_remat", "B": b, "samples": n,
            "loss_rel_err": loss_err, "stats_err_over_max": stat_err,
            "num_batches_tracked": [outs[True][2], outs[False][2]],
            "tolerance": DN_REMAT_TOL}
    print(json.dumps(line), flush=True)
    if not (loss_err <= DN_REMAT_TOL and stat_err <= DN_REMAT_TOL
            and outs[True][2] == outs[False][2] == 1):
        fail(f"train_denoiser: remat on differs from off {line}")
    del tb
    torch.cuda.empty_cache()

    # the trained model served: B = 1, the 3 s prompt
    saved = ckpt_lib.restore_raw(os.path.join(logs, "dn", "ckpt"))
    model = MPNet(seed=99, device=dev)
    model.load_state_dict(saved["model"])
    pipe = TTSPipeline(vocoder=None, device=dev, denoiser=model)
    padded = pad_to(audio, 1600)
    pipe.denoise(padded)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    out, ms = event_ms(torch, lambda: pipe.denoise(padded))
    out = out.cpu().numpy()
    line = {"phase": "serve_trained_dn", "samples": len(padded), "ms": ms,
            "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
            "finite": bool(np.isfinite(out).all()),
            "rms_in": float(np.sqrt(np.mean(padded ** 2))),
            "rms_out": float(np.sqrt(np.mean(out ** 2)))}
    print(json.dumps(line), flush=True)
    if out.shape != padded.shape or not line["finite"]:
        fail(f"serve_trained_dn: output {out.shape}, finite {line['finite']}")
    del pipe, model
    cuda_lib.reset_launches()


# ---- cli_serving: the inference CLIs on reference-layout checkpoints ----

CLI_SEEDS = {"ttv": 2345, "plm": 3456, "voc": 1234, "sr": 4321, "den": 5678,
             "w2v": 4567}
CLI_FEATURE_WAVS = 8    # extract_features: utterances of phase 10's corpus


def reference_files(torch, d):
    """Reference-layout checkpoints of seeded port modules at the published
    widths, built on the CPU: the TTV, the PLM and the vocoder (a training
    build, its training-only members included) as {"model": sd}, SpeechSR-48k
    under `dec.`, the denoiser as {"generator": sd}, and the mms-300m
    wav2vec2 in HF Wav2Vec2ForPreTraining names with the `wav2vec2.` prefix
    and weight_g / weight_v."""
    import os

    from megatts2_hierspeechpp_torch.data import text as frontend
    from megatts2_hierspeechpp_torch.models.denoiser import MPNet
    from megatts2_hierspeechpp_torch.models.plm import ProsodyLM
    from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR
    from megatts2_hierspeechpp_torch.models.ttv import TTVModel
    from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder
    from megatts2_hierspeechpp_torch.models.wav2vec2 import Wav2Vec2

    sd = {
        "ttv": {"model": TTVModel(n_vocab=frontend.N_VOCAB, n_tone=frontend.N_TONE,
                                  n_language=frontend.N_LANGUAGE,
                                  seed=CLI_SEEDS["ttv"], device="cpu").state_dict()},
        "plm": {"model": ProsodyLM(seed=CLI_SEEDS["plm"], device="cpu").state_dict()},
        "voc": {"model": HierVocoder(seed=CLI_SEEDS["voc"], device="cpu",
                                     train=True).state_dict()},
        "sr": {"model": {f"dec.{k}": v for k, v in SpeechSR(
            32, 3, 1, seed=CLI_SEEDS["sr"], device="cpu").state_dict().items()}},
        "den": {"generator": MPNet(seed=CLI_SEEDS["den"], device="cpu").state_dict()},
        "w2v": {f"wav2vec2.{k}": v for k, v in Wav2Vec2(
            seed=CLI_SEEDS["w2v"], device="cpu").state_dict().items()},
    }
    paths = {}
    for name, obj in sd.items():
        paths[name] = os.path.join(d, f"{name}.pth")
        torch.save(obj, paths[name])
    return paths


def cli_call(torch, cuda_lib, shapes, label, fn):
    """(fn(), its launch counts, its ms on the host clock)."""
    t0 = time.perf_counter()
    out, counts = run_path(torch, cuda_lib, shapes, label, fn)
    return out, counts, 1e3 * (time.perf_counter() - t0)


def check_wav(label, path, sr, want):
    """The int16 wav at `path` against the float waveform `want`."""
    from scipy.io import wavfile

    from megatts2_hierspeechpp_torch.cli.infer_tts import to_int16

    got_sr, got = wavfile.read(path)
    ref = to_int16(want)
    if got_sr != sr or got.shape != ref.shape or not np.array_equal(got, ref):
        diff = (int(np.abs(got.astype(np.int32) - ref).max())
                if got.shape == ref.shape else None)
        fail(f"{label}: {path} ({got_sr} Hz, {got.shape}) differs from the "
             f"API call ({sr} Hz, {ref.shape}; max int16 diff {diff})")
    return len(got) / sr


def cli_serving_phase(torch, dev, tmp, corpus, shapes, audio):
    """The four inference CLIs in-process on the card, on reference-layout
    checkpoints of seeded weights at the published widths (reference_files):
    infer_tts on a 3-line text file (the tts phase's 5 and 10 s texts and a
    7 s one, at the 5 s text's length_scale) with the 3 s prompt, at 48 kHz with
    --denoise_ratio 0.8, at 16 kHz with --batch 2, and at 48 kHz with
    --stream; infer_sr on the prompt; infer_vc of a 5 s source to the
    prompt's voice; extract_features on CLI_FEATURE_WAVS of phase 10's
    utterances with the w2v file. Gates: every written wav equals, as int16,
    the in-process TTSPipeline call (build_pipeline_from_reference_ckpts) of
    the same inputs; each run's kernel launches equal the API calls' and,
    for tts, vc and SpeechSR, the per-request counts of the main path; the
    sidecars equal extract_features.features of the port's own Wav2Vec2.
    Records ms per line and per call on the host clock. Runs with cuDNN
    restricted to deterministic algorithms: under its defaults two calls of
    one request give waveforms up to 2e-7 apart, which can flip an int16
    step. Returns the launch counts of the 48 kHz denoise infer_tts run."""
    with deterministic_cudnn(torch):
        return _cli_serving(torch, dev, tmp, corpus, shapes, audio)


def _cli_serving(torch, dev, tmp, corpus, shapes, audio):
    import glob
    import os
    import shutil

    from scipy.io import wavfile

    from megatts2_hierspeechpp_torch.cli import extract_features as cli_feats
    from megatts2_hierspeechpp_torch.cli import infer_sr as cli_sr
    from megatts2_hierspeechpp_torch.cli import infer_tts as cli_tts
    from megatts2_hierspeechpp_torch.cli import infer_vc as cli_vc
    from megatts2_hierspeechpp_torch.infer.pipeline import (
        build_pipeline_from_reference_ckpts, load_wav2vec2)
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    d = os.path.join(tmp, "cli")
    os.makedirs(d)
    t0 = time.perf_counter()
    f = reference_files(torch, d)
    files_s = time.perf_counter() - t0
    prompt_path = os.path.join(d, "prompt.wav")
    wavfile.write(prompt_path, 16000, cli_tts.to_int16(audio))
    src = speech_like(VC_SECONDS[0], 120.0, 21)
    src_path = os.path.join(d, "source.wav")
    wavfile.write(src_path, 16000, cli_tts.to_int16(src))
    ref = build_pipeline_from_reference_ckpts(
        f["ttv"], f["plm"], f["voc"], speechsr_ckpt=f["sr"],
        denoiser_ckpt=f["den"], device=dev)
    prompt = cli_tts.load_wav_16k(prompt_path)
    feats = ref.prepare_prompt(prompt)
    reqs = tts_requests(ref, feats)
    ls = reqs[1][2]
    # 5, 7 and 10 s of speech: the 400- and 600-frame buckets, whose launch
    # shapes the tts phase's bucketed requests already gave (new_shape)
    lines = [reqs[1][1], tts_text(np.random.default_rng(12), 7.0), reqs[2][1]]
    txt = os.path.join(d, "texts.txt")
    with open(txt, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    base = ["--input_txt", txt, "--input_prompt", prompt_path, "--ckpt_ttv",
            f["ttv"], "--ckpt_plm", f["plm"], "--ckpt_voc", f["voc"],
            "--ckpt_sr", f["sr"], "--ckpt_denoiser", f["den"],
            "--length_scale", repr(ls)]
    kw = dict(length_scale=ls)
    ref.tts(lines[0], prompt=feats, output_sr=48000, **kw)   # warm-up

    runs = {
        "infer_tts 48k denoise": (
            ["--output_sr", "48000", "--denoise_ratio", "0.8"], 48000,
            lambda p: [ref.tts(t, prompt=p, output_sr=48000, denoise_ratio=0.8,
                               **kw) for t in lines], 0.8),
        "infer_tts 16k batch 2": (
            ["--batch", "2"], 16000,
            lambda p: (ref.tts_batch(lines[:2], prompt=p, **kw)
                       + ref.tts_batch(lines[2:], prompt=p, **kw)), 0.0),
        "infer_tts 48k stream": (
            ["--output_sr", "48000", "--stream"], 48000,
            lambda p: [np.concatenate(list(ref.tts_stream(
                t, prompt=p, output_sr=48000, **kw))) for t in lines], 0.0),
    }
    results = {}
    for label, (extra, sr, api, ratio) in runs.items():
        out_dir = os.path.join(d, label.replace(" ", "_"))
        recs, counts, ms = cli_call(torch, cuda_lib, shapes, label, lambda: cli_tts.main(
            base + extra + ["--output_dir", out_dir]))
        p = ref.prepare_prompt(prompt, ratio)
        wants, api_counts, api_ms = cli_call(torch, cuda_lib, shapes,
                                             f"{label} api", lambda: api(p))
        secs = [check_wav(label, r["path"], sr, w) for r, w in zip(recs, wants)]
        if len(recs) != len(lines):
            fail(f"{label}: {len(recs)} wavs for {len(lines)} lines")
        if counts != api_counts:
            fail(f"{label}: launches {counts}, the API calls' {api_counts}")
        results[label] = counts
        print(json.dumps({
            "phase": "cli_serving", "cli": label, "ms": ms, "api_ms": api_ms,
            "line_ms": [r["ms"] for r in recs], "audio_s": secs,
            "calls": counts, "wavs_equal_api": True}), flush=True)
    per_line = {k: v * len(lines) for k, v in TTS_CALLS.items()}
    if results["infer_tts 48k denoise"] != per_line:
        fail(f"infer_tts 48k: launches {results['infer_tts 48k denoise']}, "
             f"expected {per_line} ({len(lines)} x the tts counts)")
    want_batch = dict(per_line, amp_triple=4 * 2)   # two calls, no SpeechSR
    want_batch.update({k: 2 * v for k, v in EXPECTED_CALLS.items()
                       if k in ("aa_snakebeta", "ampblock")})
    if results["infer_tts 16k batch 2"] != want_batch:
        fail(f"infer_tts --batch 2: launches {results['infer_tts 16k batch 2']}, "
             f"expected {want_batch}")

    # infer_sr and infer_vc
    out_dir = os.path.join(d, "sr")
    path, counts, ms = cli_call(torch, cuda_lib, shapes, "infer_sr", lambda: cli_sr.main(
        ["--input_speech", prompt_path, "--ckpt", f["sr"], "--output_dir", out_dir]))
    want = cli_sr.super_resolve(ref.speechsr, prompt)
    secs = check_wav("infer_sr", path, 48000, want)
    sr_calls = dict({k: 0 for k in EXPECTED_CALLS}, amp_triple=1)
    if counts != sr_calls:
        fail(f"infer_sr: launches {counts}, expected {sr_calls}")
    print(json.dumps({"phase": "cli_serving", "cli": "infer_sr", "ms": ms,
                      "audio_s": secs, "calls": counts, "wavs_equal_api": True}),
          flush=True)
    w2v = load_wav2vec2(f["w2v"], dev)
    path, counts, ms = cli_call(torch, cuda_lib, shapes, "infer_vc", lambda: cli_vc.main(
        ["--source_speech", src_path, "--target_speech", prompt_path,
         "--ckpt_voc", f["voc"], "--ckpt_w2v", f["w2v"], "--output_dir",
         os.path.join(d, "vc")]))
    want, api_counts, api_ms = cli_call(torch, cuda_lib, shapes, "infer_vc api",
                                        lambda: ref.vc(cli_tts.load_wav_16k(src_path),
                                                       prompt, w2v))
    secs = check_wav("infer_vc", path, 16000, want)
    vc_calls = dict(EXPECTED_CALLS, amp_triple=EXPECTED_CALLS["amp_triple"] - 1)
    if counts != api_counts or counts != vc_calls:
        fail(f"infer_vc: launches {counts}, the API call's {api_counts}, "
             f"expected {vc_calls}")
    print(json.dumps({"phase": "cli_serving", "cli": "infer_vc", "ms": ms,
                      "api_ms": api_ms, "audio_s": secs, "calls": counts,
                      "wavs_equal_api": True}), flush=True)

    # extract_features on utterances of phase 10's corpus (the wavs alone)
    fdir = os.path.join(d, "feats")
    os.makedirs(fdir)
    for p in sorted(glob.glob(os.path.join(corpus, "*.wav")))[:CLI_FEATURE_WAVS]:
        shutil.copy(p, fdir)
    done, counts, ms = cli_call(torch, cuda_lib, shapes, "extract_features",
                                lambda: cli_feats.main(["--wav_dir", fdir,
                                                        "--w2v_ckpt", f["w2v"]]))
    if len(done) != CLI_FEATURE_WAVS:
        fail(f"extract_features: {len(done)} of {CLI_FEATURE_WAVS} wavs")
    for p in done:
        audio_p = wavfile.read(p)[1].astype(np.float32) / 32768.0
        for name, arr in cli_feats.features(audio_p, dev, w2v).items():
            got = np.load(p[:-4] + f".{name}.npy")
            if got.shape != arr.shape or not np.array_equal(got, arr):
                fail(f"extract_features: {p} .{name} differs from the API call")
    print(json.dumps({"phase": "cli_serving", "cli": "extract_features",
                      "wavs": len(done), "ms": ms, "ms_per_wav": ms / len(done),
                      "sidecars_equal_api": True, "reference_files_s": files_s}),
          flush=True)
    del ref, w2v
    torch.cuda.empty_cache()
    return results["infer_tts 48k denoise"]


# ---- the AR stack (ar_prep, ar_decode, train_ar) and the GPT prosody stack
# (gpt_stack): plain PyTorch, float32, no kernel of the port ----

AR_WAVS = ((16000, 2.0), (32000, 4.0), (64000, 6.0), (16000, 8.0),
           (32000, 10.0), (64000, 3.0))    # prepare_hubert's wavs: rate, seconds
AR_HUBERT_SEED = 6789
AR_HUBERT_TOL = 1e-3    # card vs CPU Hubert features, x max|CPU|
AR_BERT = dict(vocab_size=21128, hidden_size=1024, num_hidden_layers=24,
               num_attention_heads=16, intermediate_size=4096,
               max_position_embeddings=512)   # chinese-roberta-wwm-ext-large
AR_BERT_TOL = 1e-4      # card vs CPU 3-bert sidecars, x max|CPU|
AR_MELS = 8             # prepare_semantic's .hmel.npy sidecars
TIE_REL = 1e-5          # a code may differ from the CPU's where its two nearest
                        # codewords are this close (relative) on the CPU
AR_SEED = 1234          # the CLI's seed: the decode's seeded weights
AR_PROMPT, AR_MAX_NEW = 75, 250     # 3 s and 10 s of 25 Hz tokens
AR_PROFILE_STEPS = 50   # the profiled decode (on an H100 host, the profiler's
                        # post-processing of 250 steps' 52 k launches took
                        # most of a minute)
AR_ROWS = 4
AR_UTTERANCES = 64      # train_ar's tables: 8 batches of 8 an epoch
AR_MICRO_STEPS = 16     # 8 (2 optimizer updates), a checkpoint, 8 resumed
AR_SYNTH = (8, 400, 448, 1350, 1408)   # B, phones, padded, tokens (54 s), padded
AR_CPU = (2, 32, 64)    # the card vs CPU micro-step: B, phones, tokens
UPD_NOISE_K = 2.0       # update_check leaves out |g_cpu| < K x the tensor's
                        # largest |g_card - g_cpu|: no sign there is settled
GPT_SEED = 4242
GPT_SHAPE = (8, 3.0, 100, 300)     # B, prompt seconds, text tokens, mel tokens
GPT_MAX_NEW, GPT_TOP_K = 300, 50
DVAE_SECONDS = 10.0
DVAE_TOL = 1e-4         # card vs CPU DVAE outputs and EMA statistics, x max|CPU|


def no_kernel_launched(label, cuda_lib):
    """These stacks are plain PyTorch: a launch of the port's kernels
    between cuda_lib.reset_launches() and here is a fault."""
    if any(cuda_lib.LAUNCHES.values()):
        fail(f"{label}: launched the port's kernels {dict(cuda_lib.LAUNCHES)}")


def speech_at(sr: int, seconds: float, seed: int) -> np.ndarray:
    """speech_like's voice at any rate, as int16 PCM."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f = (120.0 + 15 * seed) * (1.0 + 0.2 * np.sin(2 * np.pi * 0.4 * t))
    phase = 2 * np.pi * np.cumsum(f) / sr
    env = np.clip(1.5 * np.sin(2 * np.pi * 1.25 * t + 0.3), 0.0, 1.0)
    y = env * sum(0.25 / h * np.sin(h * phase) for h in range(1, 7))
    return ((y + 0.005 * rng.standard_normal(len(t))) * 32767).astype(np.int16)


def nearest_two(torch, z, embed):
    """Squared distances of z (N, D) to its two nearest codewords (N, 2)."""
    d = (z.double()[:, None, :] - embed.double()[None]).square().sum(-1)
    return d.topk(2, dim=-1, largest=False).values


def code_check(torch, label, got, want, z, embed):
    """Codes equal the CPU's but at near ties (nearest_two within TIE_REL):
    (mismatches, of which near ties)."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    bad = np.nonzero(got != want)[0]
    if len(bad):
        d = nearest_two(torch, z.reshape(-1, z.shape[-1])[torch.from_numpy(bad)],
                        embed).numpy()
        far = bad[(d[:, 1] - d[:, 0]) > TIE_REL * d[:, 1]]
        if len(far):
            fail(f"{label}: codes differ from the CPU's at {far.tolist()[:8]}, "
                 "not near ties")
    return len(bad)


def ar_prep_phase(torch, dev, tmp, corpus, card):
    """The AR data front end on the card: prepare_text on a 4 / 5-column
    filelist of the corpus's lines (beside its 3-column trans.txt lines,
    which it skips) without BERT, then with --bert_ckpt (bert_branch: on
    the card against --device cpu; or the ImportError where `transformers`
    is absent); prepare_hubert on AR_WAVS with seeded full-width
    chinese-hubert-base weights as an HF-named .bin with the `hubert.`
    prefix, --n_heads 12 (ms per wav after the model's load; the 5-wav32k files equal the CPU's resample
    and mix within 1 LSB; the shortest wav's features card against CPU
    within AR_HUBERT_TOL x max); prepare_semantic on AR_MELS of the
    corpus's .hmel.npy sidecars with cli_serving's reference TTV .pth
    (every code the CPU's, or a near tie, reported)."""
    import glob
    import importlib.util
    import os
    import shutil

    from scipy.io import wavfile

    from megatts2_hierspeechpp_torch.cli import prepare_hubert as cli_hub
    from megatts2_hierspeechpp_torch.cli import prepare_semantic as cli_sem
    from megatts2_hierspeechpp_torch.cli import prepare_text as cli_txt
    from megatts2_hierspeechpp_torch.infer.pipeline import load_hubert
    from megatts2_hierspeechpp_torch.models.wav2vec2 import Hubert
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    cuda_lib.reset_launches()
    d = os.path.join(tmp, "ar_prep")
    os.makedirs(d)
    with open(os.path.join(corpus, "trans.txt"), encoding="utf-8") as f:
        trans = [ln.strip() for ln in f if ln.strip()]
    lines = []
    for i, ln in enumerate(trans):
        wav, spk, phones = ln.split("|")
        lines.append(f"{wav}|{spk}|zh|{phones}" + ("|中文" if i % 2 else ""))
    filelist = os.path.join(d, "text_list.txt")
    with open(filelist, "w", encoding="utf-8") as f:
        f.write("\n".join(lines + trans[:4]) + "\n")
    t0 = time.perf_counter()
    table = cli_txt.main(["--filelist", filelist, "--opt_dir", d])
    text_ms = 1e3 * (time.perf_counter() - t0)
    with open(table, encoding="utf-8") as f:
        n_rows = sum(1 for ln in f if ln.strip())
    if n_rows != len(lines):
        fail(f"prepare_text: {n_rows} rows for {len(lines)} 4/5-column lines")
    if importlib.util.find_spec("transformers") is None:
        try:
            cli_txt.main(["--filelist", filelist, "--opt_dir", d,
                          "--bert_ckpt", d])
            fail("prepare_text --bert_ckpt ran without transformers")
        except ImportError as e:
            bert = f"transformers absent: ImportError: {e}"
    else:
        bert = bert_branch(torch, cli_txt, filelist, lines, d)

    wav_dir = os.path.join(d, "wavs")
    os.makedirs(wav_dir)
    paths = []
    for i, (sr, secs) in enumerate(AR_WAVS):
        paths.append(os.path.join(wav_dir, f"w{i}_{sr // 1000}k.wav"))
        wavfile.write(paths[-1], sr, speech_at(sr, secs, i))
    hub_list = os.path.join(d, "hubert_list.txt")
    with open(hub_list, "w") as f:
        f.write("".join(f"{p}|spk|zh|x\n" for p in paths))
    ckpt = os.path.join(d, "chinese-hubert-base.bin")
    torch.save({f"hubert.{k}": v for k, v in Hubert(
        seed=AR_HUBERT_SEED, device="cpu").state_dict().items()}, ckpt)
    opt = os.path.join(d, "hubert_out")
    load, load_ms = cli_hub.load_hubert, []

    def timed_load(*a, **kw):   # the CLI's model build and load, timed apart
        t = time.perf_counter()
        out = load(*a, **kw)
        torch.cuda.synchronize()
        load_ms.append(1e3 * (time.perf_counter() - t))
        return out

    cli_hub.load_hubert = timed_load
    try:
        t0 = time.perf_counter()
        done = cli_hub.main(["--filelist", hub_list, "--opt_dir", opt,
                             "--ssl_ckpt", ckpt, "--n_heads", "12"])
        torch.cuda.synchronize()
        hub_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        cli_hub.load_hubert = load
    if len(done) != len(AR_WAVS):
        fail(f"prepare_hubert: {len(done)} of {len(AR_WAVS)} wavs")
    lsb = 0
    for p in paths:
        mix = cli_hub.normalize_mix(cli_hub.wav_32k(p, "cpu"))
        want = np.clip(mix, -32768, 32767).astype(np.int16)
        sr, got = wavfile.read(os.path.join(opt, "5-wav32k", os.path.basename(p)))
        if sr != 32000 or got.shape != want.shape:
            fail(f"prepare_hubert: {p} 5-wav32k {sr} Hz {got.shape}, CPU {want.shape}")
        lsb = max(lsb, int(np.abs(got.astype(np.int32) - want).max()))
    if lsb > 1:
        fail(f"prepare_hubert: 5-wav32k differs from the CPU's by {lsb} LSB")
    short = paths[0]
    hub_cpu = load_hubert(cli_hub._load_state_dict(ckpt), 12, "cpu")
    with torch.inference_mode():
        want = hub_cpu(cli_hub.ssl_input(cli_hub.normalize_mix(
            cli_hub.wav_32k(short, "cpu")), "cpu"))[0].numpy()
    got = np.load(os.path.join(opt, "4-cnhubert", os.path.basename(short) + ".npy"))
    feat_err = float(np.abs(got - want).max() / np.abs(want).max())
    if got.shape != want.shape or not feat_err <= AR_HUBERT_TOL:
        fail(f"prepare_hubert: features card vs CPU {feat_err} ({got.shape}, "
             f"{want.shape})")
    del hub_cpu

    mel_dir = os.path.join(d, "mels")
    os.makedirs(mel_dir)
    for p in sorted(glob.glob(os.path.join(corpus, "*.hmel.npy")))[:AR_MELS]:
        shutil.copy(p, mel_dir)
    ttv_path = os.path.join(tmp, "cli", "ttv.pth")
    tsv = os.path.join(d, "6-name2semantic.tsv")
    t0 = time.perf_counter()
    rows = cli_sem.main(["--mel_dir", mel_dir, "--s2_ckpt", ttv_path,
                         "--tsv_out", tsv])
    sem_ms = 1e3 * (time.perf_counter() - t0)
    if len(rows) != AR_MELS:
        fail(f"prepare_semantic: {len(rows)} of {AR_MELS} sidecars")
    ttv_cpu = cli_sem.load_ttv(ttv_path, "cpu")
    embed = ttv_cpu.quantizer.vq.layers[0]._codebook.embed
    n_codes = mismatched = 0
    for p in sorted(glob.glob(os.path.join(mel_dir, "*.hmel.npy"))):
        mel = np.load(p).astype(np.float32)
        mel = mel.T if mel.shape[0] == 80 else mel
        want = cli_sem.codes_of(ttv_cpu, mel, "cpu")
        t8 = len(want) * 8
        with torch.inference_mode():
            z = ttv_cpu.pre_vq_features(torch.from_numpy(mel[None, :t8]),
                                        torch.tensor([t8], dtype=torch.int32))[0][0]
        got = np.load(p.replace(".hmel.npy", ".semantic.npy"))
        n_codes += len(want)
        mismatched += code_check(torch, f"prepare_semantic {p}", got, want, z, embed)
    del ttv_cpu
    no_kernel_launched("ar_prep", cuda_lib)
    line = {"phase": "ar_prep", "card": card,
            "prepare_text": {"rows": n_rows, "skipped_3_column": 4, "ms": text_ms,
                             "bert_branch": bert},
            "prepare_hubert": {"wavs": [f"{sr} Hz {s:g} s" for sr, s in AR_WAVS],
                               "ms": hub_ms, "load_ms": load_ms[0],
                               "ms_per_wav": (hub_ms - load_ms[0]) / len(done),
                               "wav32k_max_lsb_vs_cpu": lsb,
                               "features_card_vs_cpu_over_max": feat_err,
                               "tolerance": AR_HUBERT_TOL},
            "prepare_semantic": {"sidecars": len(rows), "codes": n_codes,
                                 "ms": sem_ms, "codes_differing_near_ties": mismatched,
                                 "tie_rel": TIE_REL}}
    print(json.dumps(line), flush=True)


def bert_branch(torch, cli_txt, filelist, lines, d) -> dict:
    """prepare_text --bert_ckpt (where `transformers` is installed) with a
    seeded BertForMaskedLM at chinese-roberta-wwm-ext-large's widths
    (AR_BERT), on the card (the CLI's default device) and with --device
    cpu: a 3-bert sidecar of (phones, 1024) for every zh line with raw
    text, the card's within AR_BERT_TOL x max|CPU| of the CPU's, the two
    tables equal."""
    import os

    from transformers import BertConfig, BertForMaskedLM, BertTokenizer

    bdir = os.path.join(d, "bert")
    os.makedirs(bdir)
    with open(os.path.join(bdir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "中", "文"]))
    BertTokenizer(os.path.join(bdir, "vocab.txt")).save_pretrained(bdir)
    torch.manual_seed(0)
    BertForMaskedLM(BertConfig(**AR_BERT)).eval().save_pretrained(bdir)
    raw = [ln for ln in lines if len(ln.split("|")) > 4]
    out = {}
    for side in ("cuda", "cpu"):
        opt = os.path.join(d, f"bert_{side}")
        t0 = time.perf_counter()
        table = cli_txt.main(["--filelist", filelist, "--opt_dir", opt,
                              "--bert_ckpt", bdir]
                             + (["--device", "cpu"] if side == "cpu" else []))
        ms = 1e3 * (time.perf_counter() - t0)
        with open(table, encoding="utf-8") as f:
            rows = f.read()
        files = sorted(os.listdir(os.path.join(opt, "3-bert")))
        if len(files) != len(raw):
            fail(f"prepare_text --bert_ckpt ({side}): {len(files)} sidecars for "
                 f"{len(raw)} zh lines with raw text")
        feats = {}
        for row in rows.splitlines():
            name, phones = row.split("\t")[:2]
            p = os.path.join(opt, "3-bert", name + ".npy")
            if os.path.exists(p):
                feats[name] = np.load(p)
                if feats[name].shape != (len(phones.split()), AR_BERT["hidden_size"]):
                    fail(f"prepare_text --bert_ckpt ({side}): {p} {feats[name].shape}")
        out[side] = (ms, rows, feats)
    (card_ms, card_rows, card), (cpu_ms, cpu_rows, cpu) = out["cuda"], out["cpu"]
    if card_rows != cpu_rows or card.keys() != cpu.keys():
        fail("prepare_text --bert_ckpt: the card's table or sidecars are not the CPU's")
    err = max(float(np.abs(card[k] - cpu[k]).max() / np.abs(cpu[k]).max())
              for k in cpu)
    if not err <= AR_BERT_TOL:
        fail(f"prepare_text --bert_ckpt: sidecars card vs CPU {err} > {AR_BERT_TOL}")
    return {"transformers": "present", "widths": AR_BERT, "sidecars": len(card),
            "ms": card_ms, "cpu_ms": cpu_ms, "card_vs_cpu_over_max": err,
            "tolerance": AR_BERT_TOL}


def ar_text(frontend, clean, rng, seconds: float):
    """Phoneme ids of a tts_text of `seconds` (tone digits, tags stripped as
    prepare_text does)."""
    return [frontend.SYMBOL_TO_ID[p] for p in clean(tts_text(rng, seconds))]


def gumbel_draws(rng, steps: int, shape):
    """Seeded Gumbel(0, 1) noise of each decode step, on the host."""
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, (steps, *shape))
    return list((-np.log(-np.log(u))).astype(np.float32))


def steps_run(tokens, stop: int) -> int:
    """Steps a one-row decode ran: to its first stop token, or all."""
    hits = np.nonzero(np.asarray(tokens).reshape(-1) == stop)[0]
    return int(hits[0]) + 1 if len(hits) else len(np.asarray(tokens).reshape(-1))


def tf_gap(torch, logits, tokens, top_k: int = 1, draws=None) -> float:
    """The teacher-forced gap of one row's decode, over max|logits|: for
    each step the best score minus the chosen token's, the scores the
    logits (greedy) or the top-k logits plus the step's noise (sampled). A
    token outside the recompute's top-k (a float tie at its edge) scores
    its logit plus the step's largest noise, and its distance from the
    k-th logit counts too."""
    lg = logits.detach().float().cpu()
    tok = torch.as_tensor(np.asarray(tokens)).long()
    chosen = lg.gather(-1, tok[:, None])[:, 0]
    if draws is None:
        gap = lg.amax(-1) - chosen
    else:
        noise = torch.from_numpy(np.stack(draws[:len(tok)])).reshape(len(tok), -1)
        vals, idxs = lg.topk(top_k, dim=-1)
        scores = vals + noise
        hit = idxs == tok[:, None]
        own = torch.where(hit, scores, -math.inf).amax(-1)
        outside = torch.maximum(scores.amax(-1) - (chosen + noise.amax(-1)),
                                vals[:, -1] - chosen)
        gap = torch.where(hit.any(-1), scores.amax(-1) - own, outside)
    return float(gap.max() / lg.abs().max())


def ar_decode_phase(torch, dev, card):
    """t2s_decode of the CLI's Text2Semantic (full width, seeded weights) on
    the tts phase's 10 s Mandarin text as phoneme ids, BERT features N(0,
    1), a 75-token prompt, max_new 250: greedy and top_k 3 with fed noise;
    ms per step, tokens/s, the prefill, launches per step, device ms and
    idle share (profiler), peak memory; each step's token against a
    full-prefix recompute on the card and on the CPU within TF_MARGIN; B = 4
    rows (four texts cut to one phoneme count, one prompt) against their
    own B = 1 decodes."""
    from megatts2_hierspeechpp_torch.ar import t2s
    from megatts2_hierspeechpp_torch.cli.prepare_text import clean_phonemes
    from megatts2_hierspeechpp_torch.data import text as frontend
    from megatts2_hierspeechpp_torch.nn.decode import FedNoise
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    cuda_lib.reset_launches()
    build = dict(phoneme_vocab_size=frontend.N_VOCAB * 4, seed=AR_SEED)
    model = t2s.Text2Semantic(**build, device=dev)
    cpu_model = t2s.Text2Semantic(**build, device="cpu")
    rng = np.random.default_rng(11)     # tts_requests' texts: the last is 10 s
    ids = [ar_text(frontend, clean_phonemes, rng, f / 50)
           for f in REQUEST_FRAMES][-1]
    rng = np.random.default_rng(21)
    x = torch.tensor([ids])
    bert = torch.from_numpy(rng.standard_normal((1, len(ids), 1024)).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(0, 1024, (1, AR_PROMPT)))
    draws = gumbel_draws(rng, AR_MAX_NEW, (1, 3))
    on = [v.to(dev) for v in (x, bert, prompt)]

    def run(max_new, top_k=1, noise=None, inputs=on):
        return t2s.t2s_decode(model, *inputs, max_new=max_new, top_k=top_k,
                              noise=noise)

    run(8)
    _, prefill_ms = event_ms(torch, lambda: run(1))
    torch.cuda.reset_peak_memory_stats()
    (g_tok, g_len), g_ms = event_ms(torch, lambda: run(AR_MAX_NEW))
    (s_tok, s_len), s_ms = event_ms(torch, lambda: run(
        AR_MAX_NEW, 3, FedNoise(draws)))
    peak = torch.cuda.max_memory_allocated()
    prof = step_profile(torch, f"ar_decode greedy, {AR_PROFILE_STEPS} steps",
                        lambda: run(AR_PROFILE_STEPS))
    eos = model.eos
    out = {}
    for name, tok, length, ms, top_k, dr in (
            ("greedy", g_tok, g_len, g_ms, 1, None),
            ("top_k 3", s_tok, s_len, s_ms, 3, draws)):
        tok = tok.cpu().numpy()[0]
        n = steps_run(tok, eos)
        y = torch.cat([prompt, torch.from_numpy(tok[None, :n - 1])], dim=1)
        rows = slice(AR_PROMPT - 1, AR_PROMPT - 1 + n)
        with torch.inference_mode():
            card_lg = model.prefix_logits(*on[:2], y.to(dev))[0, rows]
            cpu_lg = cpu_model.prefix_logits(x, bert, y)[0, rows]
        gaps = {"card_recompute": tf_gap(torch, card_lg, tok[:n], top_k, dr),
                "cpu": tf_gap(torch, cpu_lg, tok[:n], top_k, dr)}
        if not max(gaps.values()) <= TF_MARGIN:
            fail(f"ar_decode {name}: teacher-forced gap {gaps} > {TF_MARGIN}")
        out[name] = {"steps": n, "tokens_before_eos": int(length[0]), "ms": ms, "ms_per_step": ms / n, "tokens_per_s": n / (ms / 1e3),
                     "tf_gap_over_max": gaps}
    launches = prof["kernel_launches"] / AR_PROFILE_STEPS

    rng = np.random.default_rng(31)
    texts = [ar_text(frontend, clean_phonemes, rng, 10.0) for _ in range(AR_ROWS)]
    n_ph = min(len(t) for t in texts)
    xb = torch.tensor([t[:n_ph] for t in texts])
    bb = torch.from_numpy(rng.standard_normal((AR_ROWS, n_ph, 1024)).astype(np.float32))
    pb = prompt.repeat(AR_ROWS, 1)
    inputs = [v.to(dev) for v in (xb, bb, pb)]
    (b_tok, _), b_ms = event_ms(torch, lambda: run(AR_MAX_NEW, inputs=inputs))
    equal, row_gaps = 0, []
    for i in range(AR_ROWS):
        one, _ = run(AR_MAX_NEW, inputs=[v[i:i + 1] for v in inputs])
        row = b_tok[i].cpu().numpy()
        if np.array_equal(row, one[0].cpu().numpy()):
            equal += 1
            continue
        n = steps_run(row, eos)
        y = torch.cat([pb[i:i + 1], torch.from_numpy(row[None, :n - 1])], dim=1)
        with torch.inference_mode():
            lg = model.prefix_logits(inputs[0][i:i + 1], inputs[1][i:i + 1],
                                     y.to(dev))[0, AR_PROMPT - 1:AR_PROMPT - 1 + n]
        row_gaps.append(tf_gap(torch, lg, row[:n]))
        if not row_gaps[-1] <= TF_MARGIN:
            fail(f"ar_decode B={AR_ROWS}: row {i} differs from its B=1 decode "
                 f"with a teacher-forced gap {row_gaps[-1]}")
    no_kernel_launched("ar_decode", cuda_lib)
    line = {"phase": "ar_decode", "card": card, "phones": len(ids),
            "prompt": AR_PROMPT, "max_new": AR_MAX_NEW, "prefill_ms": prefill_ms,
            "prefill_note": "t2s_decode at max_new 1: the prefill and one draw",
            **out, "launches_per_step": launches,
            "profiled_steps": AR_PROFILE_STEPS,
            "device_kernel_ms": prof["device_kernel_ms"],
            "device_idle_share": prof["device_idle_share"],
            "peak_memory_mb": peak / 2 ** 20,
            f"B={AR_ROWS}": {"phones": n_ph, "ms": b_ms,
                             "rows_equal_to_b1": equal, "other_rows_tf_gap": row_gaps},
            "tolerance": TF_MARGIN}
    print(json.dumps(line), flush=True)
    del model, cpu_model
    torch.cuda.empty_cache()


def ar_tables(corpus, dst, n: int):
    """The corpus's joined 2-name2text.txt / 6-name2semantic.tsv cut to the
    first n items that Text2SemanticDataset keeps (one length bucket)."""
    import os

    from megatts2_hierspeechpp_torch.ar.dataset import Text2SemanticDataset
    from megatts2_hierspeechpp_torch.data import text as frontend

    src = [os.path.join(corpus, f) for f in ("2-name2text.txt", "6-name2semantic.tsv")]
    ds = Text2SemanticDataset(*src, frontend.SYMBOL_TO_ID)
    keep = {it["name"] for it in ds.items[:n]}
    if len(keep) < n or max(ds.lengths()[:n]) > 200:
        fail(f"train_ar corpus: {len(keep)} items kept, {n} wanted in (0, 200]")
    os.makedirs(dst)
    out = []
    for path in src:
        out.append(os.path.join(dst, os.path.basename(path)))
        with open(path, encoding="utf-8") as f, open(out[-1], "w", encoding="utf-8") as g:
            g.writelines(ln for ln in f if ln.split("\t")[0] in keep)
    return out


def ar_synth_batch(torch, dev, rng, b, nx, nx_pad, ny, ny_pad):
    from megatts2_hierspeechpp_torch.data import text as frontend

    i32 = np.int32
    batch = {"x_ids": rng.integers(0, frontend.N_VOCAB, (b, nx_pad)).astype(i32),
             "x_lens": np.full(b, nx, i32),
             "y_ids": rng.integers(0, 1024, (b, ny_pad)).astype(i32),
             "y_lens": np.full(b, ny, i32),
             "bert_feature": rng.standard_normal((b, nx_pad, 1024)).astype(np.float32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train_ar_phase(torch, dev, tmp, corpus, shapes, card):
    """cli/train_ar.main at its defaults (B = 8, grad_accum 4, float32) on
    AR_UTTERANCES of the corpus's joined tables: 8 micro-steps (2 updates),
    a checkpoint, 8 resumed, the eval hook at the end of each (its interval
    set to 8 for the run); micro-step ms, tokens/s, peak memory, one
    micro-step profiled; the 54 s micro-step (AR_SYNTH); one micro-step
    card against CPU (ar_card_vs_cpu)."""
    import os

    from megatts2_hierspeechpp_torch.ar import trainer as ar_trainer
    from megatts2_hierspeechpp_torch.ar.dataset import Text2SemanticDataset, collate
    from megatts2_hierspeechpp_torch.cli import train_ar as cli
    from megatts2_hierspeechpp_torch.data import text as frontend
    from megatts2_hierspeechpp_torch.data.dataset import DistributedBucketSampler
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    cuda_lib.reset_launches()
    d = os.path.join(tmp, "train_ar")
    ph, sem = ar_tables(corpus, os.path.join(d, "tables"), AR_UTTERANCES)
    logs = os.path.join(d, "logs")
    argv = ["--phoneme_path", ph, "--semantic_path", sem, "-m", "run",
            "--logs_dir", logs, "--log_interval", "1"]
    half = AR_MICRO_STEPS // 2
    interval, cli.EVAL_INTERVAL = cli.EVAL_INTERVAL, half
    try:
        with EvalProbe(torch, cli, "make_ar_eval_fn", shapes, "train_ar eval") as probe:
            torch.cuda.reset_peak_memory_stats()
            state, recs, secs = run_cli(cli, ar_trainer, torch,
                                        [argv + ["--epochs", "1"], argv + ["--epochs", "2"]],
                                        keys=("y_ids", "y_lens"))
            peak = torch.cuda.max_memory_allocated()
    finally:
        cli.EVAL_INTERVAL = interval
    with open(os.path.join(logs, "run", "scalars.jsonl")) as f:
        scalars = [json.loads(ln) for ln in f]
    check_run("train_ar", recs, scalars, state, ("loss/t2s",), n=AR_MICRO_STEPS)
    check_evals("train_ar", probe, scalars, ("t2s_loss", "t2s_acc_top10"),
                (half, AR_MICRO_STEPS))
    if state.opt.count != AR_MICRO_STEPS // 4 or state.accum_count != 0:
        fail(f"train_ar: {state.opt.count} updates, accumulation count "
             f"{state.accum_count} after {AR_MICRO_STEPS} micro-steps")
    ds = Text2SemanticDataset(ph, sem, frontend.SYMBOL_TO_ID)
    sampler = DistributedBucketSampler(ds.lengths(), 8, list(cli.BOUNDARIES), seed=1234)
    batch = collate([ds[i] for i in sampler.epoch_batches(0)[0]], pad_multiple=64)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    step = ar_trainer.TrainStep(4)
    prof = step_profile(torch, "train_ar micro-step B=8", lambda: step(
        state, batch, torch.Generator().manual_seed(1)))
    line = {"phase": "train_ar", "card": card, "micro_steps": AR_MICRO_STEPS,
            "updates": state.opt.count, "runs_s": secs,
            **rate_line(recs, 1 / 25), "peak_memory_mb": peak / 2 ** 20,
            "batch_shapes": sorted({(r["B"], r["T"]) for r in recs}),
            "eval_ms": [r["ms"] for r in probe.records],
            "eval_scalars": [r["scalars"] for r in probe.records],
            "device_idle_share": prof["device_idle_share"],
            "device_kernel_launches": prof["kernel_launches"],
            "groups_ms": prof["groups_ms"]}
    line["tokens_per_s"] = line.pop("frames_per_s")
    line["audio_s_per_s_note"] = "25 Hz semantic tokens"
    print(json.dumps(line), flush=True)

    b, nx, nx_pad, ny, ny_pad = AR_SYNTH
    synth = ar_synth_batch(torch, dev, np.random.default_rng(5), *AR_SYNTH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = [event_ms(torch, lambda: step(state, synth,
                                          torch.Generator().manual_seed(2)))[1]
             for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    sprof = step_profile(torch, f"train_ar synthetic B={b} y={ny_pad} x={nx_pad}",
                         lambda: step(state, synth, torch.Generator().manual_seed(3)))
    print(json.dumps({"phase": "train_ar_synthetic", "card": card, "B": b,
                      "phones": nx, "phones_padded": nx_pad, "tokens": ny,
                      "tokens_padded": ny_pad, "seconds": ny / 25,
                      "micro_step_ms": times,
                      "tokens_per_s": b * ny / (times[-1] / 1e3),
                      "peak_memory_mb": peak / 2 ** 20,
                      "device_idle_share": sprof["device_idle_share"],
                      "groups_ms": sprof["groups_ms"]}), flush=True)
    del state, synth, batch
    torch.cuda.empty_cache()

    ar_card_vs_cpu(torch, dev)
    no_kernel_launched("train_ar", cuda_lib)


def ar_card_vs_cpu(torch, dev):
    """One train_ar micro-step at AR_CPU and the ScaledAdam update of its
    gradients, card against CPU from the same weights, each side from its
    own gradients: the metrics and the gradients (whole) under
    card_vs_cpu's gates, then the update (update_check)."""
    from megatts2_hierspeechpp_torch.ar import trainer as ar_trainer
    from megatts2_hierspeechpp_torch.ar.scaled_adam import ScaledAdam
    from megatts2_hierspeechpp_torch.ar.t2s import Text2Semantic
    from megatts2_hierspeechpp_torch.cli import train_ar as cli
    from megatts2_hierspeechpp_torch.data import text as frontend

    sides = {}

    def build_ar(device):
        model = Text2Semantic(phoneme_vocab_size=frontend.N_VOCAB * 4,
                              seed=AR_SEED, device=device, train=True)
        sched = cli.warmup_cosine_schedule(1e-4, 1e-2, 1e-4, 2000, 200000)
        return ar_trainer.create_state(model, ScaledAdam(model.parameters(), lr=sched))

    def run_ar(state, tb, device):
        out = state.model(*(tb[k] for k in ar_trainer.BATCH_KEYS))
        out["loss"].backward()
        grads = [p.grad for p in state.opt.params]
        upd = state.opt.updates(grads)
        names = [n for n, p in state.model.named_parameters() if p.requires_grad]
        sides[device.type] = [(n, g.detach().cpu(), u.cpu())
                              for n, g, u in zip(names, grads, upd)]
        return ({"loss/t2s": out["loss"].detach(), "acc/t2s": out["acc"]},
                {"grads": flat_grads(torch, state.opt.params)}, {})

    cb, cx, cy = AR_CPU
    cpu_batch = {k: v.cpu().numpy() for k, v in ar_synth_batch(
        torch, "cpu", np.random.default_rng(6), cb, cx, cx, cy, cy).items()}
    card_vs_cpu(torch, dev, "train_ar micro-step", build_ar, run_ar, cpu_batch,
                desc={"B": cb, "phones": cx, "tokens": cy})
    update_check(torch, "train_ar ScaledAdam update", sides["cuda"], sides["cpu"])


def update_check(torch, label, card, cpu):
    """The first ScaledAdam update, card against CPU, each from its own
    gradients: [(name, gradient, update)] per parameter. Adam's first step
    is g / (|g| + eps), about sign(g) wherever |g| is well above eps, so an
    element whose gradient lies within the two sides' rounding difference
    can take opposite whole steps. Such elements are left out by a rule on
    the gradients: in each tensor, |g_cpu| below UPD_NOISE_K x the tensor's
    largest |g_card - g_cpu| (its measured noise floor), unless both sides'
    gradient is exactly 0 (both updates are then 0). The rest is held to
    S_GRAD_TOL relative L2. Reported: the update's relative L2 over all
    elements and without the key third of each in_proj_bias (whose true
    gradient is 0: a key bias shifts a softmax row by a constant), what the
    left-out elements are and how much of the squared difference they
    carry."""
    gp, uc, up, drop, key, floors = [], [], [], [], [], []
    for (name, g_card, u_card), (_, g_cpu, u_cpu) in zip(card, cpu):
        floor = (g_card - g_cpu).abs().max()
        floors.append(floor.item())
        drop.append(((g_cpu.abs() < UPD_NOISE_K * floor)
                     & ((g_card != 0) | (g_cpu != 0))).flatten())
        k = torch.zeros(g_cpu.numel(), dtype=torch.bool)
        if name.endswith("in_proj_bias"):
            d = g_cpu.numel() // 3
            k[d:2 * d] = True
        key.append(k)
        gp.append(g_cpu.flatten())
        uc.append(u_card.flatten())
        up.append(u_cpu.flatten())
    gp, uc, up, drop, key = (torch.cat(x) for x in (gp, uc, up, drop, key))
    sq = (uc - up).square()

    def rel(m):
        return (sq[m].sum() / up[m].square().sum()).sqrt().item()

    line = {"phase": "train_card_vs_cpu", "path": label,
            "update_rel_l2_all": rel(torch.ones_like(drop)),
            "update_rel_l2_without_key_bias": rel(~key),
            "update_rel_l2_kept": rel(~drop),
            "elements": drop.numel(), "left_out": int(drop.sum()),
            "left_out_in_key_bias": int((drop & key).sum()),
            "key_bias_elements": int(key.sum()),
            "left_out_share_of_sq_diff": (sq[drop].sum() / sq.sum()).item()
            if sq.sum() > 0 else 0.0,
            "left_out_max_abs_grad": gp[drop].abs().max().item() if drop.any() else 0.0,
            "noise_floor_max": max(floors), "noise_k": UPD_NOISE_K,
            "tolerance": S_GRAD_TOL}
    print(json.dumps(line), flush=True)
    if not line["update_rel_l2_kept"] <= S_GRAD_TOL:
        fail(f"{label}: card vs CPU {line['update_rel_l2_kept']} > {S_GRAD_TOL} "
             "over the elements above the gradients' noise floor")


def mel_of(torch, seconds: float, seed: int) -> np.ndarray:
    """(T, 80) log-mel of speech_like at 50 Hz."""
    from megatts2_hierspeechpp_torch.ops.stft import mel_spectrogram_fixed

    wav = torch.from_numpy(speech_like(seconds, 110.0 + 20 * seed, seed))
    with torch.inference_mode():
        return mel_spectrogram_fixed(wav[None])[0].numpy()


def gpt_stack_phase(torch, dev, card):
    """GPTProsody at its defaults: one training forward and backward at
    B = 8 (3 s prompt mel, 100 text tokens, 300 mel tokens; ms, peak
    memory), card against CPU at B = 2; gpt_generate with max_new 300,
    top_k 50 from fed noise (ms per step, the teacher-forced gap against a
    recompute on the card and on the CPU); DiscreteVAE at its defaults:
    encode and decode of a 10 s mel (ms; codes card against CPU, near ties
    allowed), one training forward with its EMA step, card against CPU
    within DVAE_TOL."""
    from megatts2_hierspeechpp_torch.nn.decode import FedNoise
    from megatts2_hierspeechpp_torch.models import plm_gpt
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    cuda_lib.reset_launches()
    b, secs, nt, nm = GPT_SHAPE
    rng = np.random.default_rng(7)
    cond = np.stack([mel_of(torch, secs, i) for i in range(b)])
    batch = {"cond_mel": cond,
             "text_ids": rng.integers(0, 256, (b, nt)).astype(np.int32),
             "mel_tokens": rng.integers(0, 1024, (b, nm)).astype(np.int32),
             "mel_lens": rng.integers(nm // 2, nm + 1, b).astype(np.int32)}
    model = plm_gpt.GPTProsody(seed=GPT_SEED, device=dev, train=True)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        out = model(*tb.values())
        out["loss"].backward()
        return out

    fwd_bwd()
    torch.cuda.reset_peak_memory_stats()
    out, train_ms = event_ms(torch, fwd_bwd)
    peak = torch.cuda.max_memory_allocated()
    loss = out["loss"].item()
    if not math.isfinite(loss):
        fail(f"gpt_stack: loss {loss}")

    def build_gpt(device):
        return plm_gpt.GPTProsody(seed=GPT_SEED, device=device, train=True)

    def run_gpt(m, t, device):
        out = m(*(t[k] for k in ("cond_mel", "text_ids", "mel_tokens", "mel_lens")))
        out["loss"].backward()
        return ({"loss": out["loss"].detach()},
                {"grads": flat_grads(torch, m.parameters())}, {})

    card_vs_cpu(torch, dev, "gpt_prosody forward+backward", build_gpt, run_gpt,
                {k: np.ascontiguousarray(v[:2]) for k, v in batch.items()},
                desc={"B": 2, "prompt_frames": cond.shape[1], "text": nt, "mel": nm})

    cpu_model = plm_gpt.GPTProsody(seed=GPT_SEED, device="cpu")
    draws = gumbel_draws(rng, GPT_MAX_NEW, (1, GPT_TOP_K))
    g_in = [tb["cond_mel"][:1], tb["text_ids"][:1]]
    plm_gpt.gpt_generate(model, *g_in, max_new=8, top_k=GPT_TOP_K)
    (tok, _), gen_ms = event_ms(torch, lambda: plm_gpt.gpt_generate(
        model, *g_in, max_new=GPT_MAX_NEW, top_k=GPT_TOP_K, noise=FedNoise(draws)))
    tok = tok.cpu().numpy()[0]
    n = steps_run(tok, model.stop_mel)
    mel_in = torch.from_numpy(np.concatenate([[model.start_mel], tok[:n - 1]])[None])
    with torch.inference_mode():
        card_lg = model.mel_logits(*g_in, mel_in.to(dev))[0]
        cpu_lg = cpu_model.mel_logits(*(v.cpu() for v in g_in), mel_in)[0]
    gaps = {"card_recompute": tf_gap(torch, card_lg, tok[:n], GPT_TOP_K, draws),
            "cpu": tf_gap(torch, cpu_lg, tok[:n], GPT_TOP_K, draws)}
    if not max(gaps.values()) <= TF_MARGIN:
        fail(f"gpt_generate: teacher-forced gap {gaps} > {TF_MARGIN}")
    del model, cpu_model, tb
    torch.cuda.empty_cache()

    mel = torch.from_numpy(mel_of(torch, DVAE_SECONDS, 9)[None])
    dvae = plm_gpt.DiscreteVAE(seed=GPT_SEED, device=dev, train=True)
    dvae_cpu = plm_gpt.DiscreteVAE(seed=GPT_SEED, device="cpu", train=True)
    with torch.inference_mode():
        dvae.encode(mel.to(dev))
        codes, enc_ms = event_ms(torch, lambda: dvae.encode(mel.to(dev)))
        want = dvae_cpu.encode(mel)
        z = dvae_cpu._encode(mel)[0]
        differ = code_check(torch, "dvae encode", codes.cpu(), want, z,
                            dvae_cpu.codebook.embed)
        recon, dec_ms = event_ms(torch, lambda: dvae.decode(want.to(dev)))
        ref = dvae_cpu.decode(want)
        dec_err = float((recon.cpu() - ref).abs().max() / ref.abs().max())
    got = dvae(mel.to(dev), train=True)
    ref = dvae_cpu(mel, train=True)
    recon = ref["recon"].detach()
    errs = {"recon": float((got["recon"].detach().cpu() - recon).abs().max()
                           / recon.abs().max())}
    for k in ("commit", "loss"):
        errs[k] = abs(got[k].item() - ref[k].item()) / abs(ref[k].item())
    errs["decode"] = dec_err
    if not differ:   # a near-tie code moves the EMA statistics by a codeword
        for k in ("cluster_size", "embed_avg", "embed"):
            a, c = getattr(dvae.codebook, k).cpu(), getattr(dvae_cpu.codebook, k)
            errs[k] = float((a - c).abs().max() / c.abs().max())
    if not max(errs.values()) <= DVAE_TOL:
        fail(f"dvae card vs CPU: {errs} ({differ} codes differ at near ties)")
    no_kernel_launched("gpt_stack", cuda_lib)
    line = {"phase": "gpt_stack", "card": card,
            "train": {"B": b, "prompt_frames": cond.shape[1], "text": nt, "mel": nm,
                      "fwd_bwd_ms": train_ms, "loss": loss,
                      "peak_memory_mb": peak / 2 ** 20},
            "generate": {"max_new": GPT_MAX_NEW, "top_k": GPT_TOP_K, "steps": n,
                         "ms": gen_ms, "ms_per_step": gen_ms / n,
                         "tf_gap_over_max": gaps, "tolerance": TF_MARGIN},
            "dvae": {"frames": mel.shape[1], "codes": int(want.numel()),
                     "encode_ms": enc_ms, "decode_ms": dec_ms,
                     "codes_differing_near_ties": differ,
                     "card_vs_cpu_over_max": errs, "tolerance": DVAE_TOL}}
    print(json.dumps(line), flush=True)
    del dvae, dvae_cpu
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from megatts2_hierspeechpp_torch.device import resolve_device
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    t_start = time.perf_counter()
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

    def clock(after):  # the run's seconds at a phase boundary
        print(json.dumps({"phase": "clock", "after": after,
                          "seconds": time.perf_counter() - t_start}), flush=True)

    kernels = kernel_phase(torch, dev)
    kernels["amp_triple"] = epilogue_phase(torch, dev)
    kernels.update(kernel_bf16_phase(torch, dev))
    clock("kernel_bf16")
    snake_conv_phase(torch, dev)
    kernels["plm_decode"] = plm_phase(torch, dev)
    bf16 = plm_bf16_phase(torch, dev)
    kernels["plm_decode_bf16"] = [bf16]
    clock("plm_bf16")
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
    clock("vc")
    voc_bf16_calls = bf16_forward_phase(torch, dev, shapes)
    clock("bf16_forward")
    with tempfile.TemporaryDirectory() as tmp:
        train_bf16, train_launches, _, corpus, voc_run = train_vocoder_phase(
            torch, dev, shapes, tmp)
        clock("train_vocoder")
        s2_dir, cfgs, first = train_s2_phase(torch, dev, tmp, corpus)
        s1_state, batch, s1_dir = train_s1_phase(torch, dev, tmp, s2_dir, cfgs,
                                                 first)
        clock("train_s1")
        sr_launches, sr_rows, sr_dir = train_sr_phase(torch, dev, tmp, corpus,
                                                      shapes)
        clock("train_sr")
        serve_launches, serve16_launches = serve_trained_phase(
            torch, dev, shapes, audio, s1_state, batch,
            (s2_dir, s1_dir, voc_run, sr_dir))
        del s1_state, batch
        torch.cuda.empty_cache()
        clock("serve_trained")
        train_denoiser_phase(torch, dev, tmp, corpus, shapes, audio)
        clock("train_denoiser")
        cli_launches = cli_serving_phase(torch, dev, tmp, corpus, shapes, audio)
        clock("cli_serving")
        card = smi.splitlines()[0]
        ar_prep_phase(torch, dev, tmp, corpus, card)
        clock("ar_prep")
        ar_decode_phase(torch, dev, card)
        clock("ar_decode")
        train_ar_phase(torch, dev, tmp, corpus, shapes, card)
        clock("train_ar")
        gpt_stack_phase(torch, dev, card)
        clock("gpt_stack")
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
        if key in BF16_KERNELS:
            out[-1].update(
                launches=voc_bf16_calls[key],
                launches_from="bf16_forward, one bf16 HierVocoder call at B=4",
                launches_train_step=train_bf16[key],
                bound_ms_3xtf32=slowest["bound_ms_3xtf32"],
                err_over_ref=max(ln["err_over_ref"] for ln in lines))
            continue
        if train_launches.get(key, 0) > out[-1]["launches"]:
            out[-1].update(launches=train_launches[key],
                           launches_from="train_vocoder fp32, one B=32 step, phase 10")
        if key in serve_launches:
            out[-1]["launches_serve_trained"] = serve_launches[key]
        if key == "plm_decode":
            out[-1]["launches_serve_trained_bf16"] = serve16_launches[key]
            out[-1]["launches_cli_serving"] = cli_launches[key]
        if key == "amp_triple":
            out[-1]["launches_train_sr"] = sr_launches
            out[-1]["train_sr"] = [
                {k: r[k] for k in ("shape", "ms", "plain_ms", "bwd_plain_vjp_ms",
                                   "bound_ms", "bound_by", "fwd_err_over_ref",
                                   "grad_err_over_ref")}
                for r in sr_rows]
    print(json.dumps({"phase": "total", "seconds": time.perf_counter() - t_start}),
          flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
