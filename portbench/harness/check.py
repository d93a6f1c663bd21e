"""The comparison that decides `correct`.

After the window every row served in it is checked for its shapes, and
the reference works out again two samples of those rows, each drawn from
the seed with the longest row in it (the traffic file's `dur_rows` and
`check_rows`). Three numbers are compared, each with the configuration's
limit:

  dur_err   the durations the program's duration predictor gave (its
            output is log w; the durations are exp(log w) x length scale
            before their ceiling) against the reference's, on the
            `dur_rows` sample: per row the RMS of their log ratio (their
            relative error, whatever their size), and over the rows the
            configuration's quantile of it (`dur_err_quantile`: 1 the worst
            row)
  code_gap  the `check_rows` sample's prosody codes, teacher-forced through the
            reference's PLM on the reference's own latent: the widest gap
            by which a served code's logit lies below the best, over the
            largest |logit| of the row, worst position
  wav_err   the `check_rows` sample's waveforms, at the requested sample rate, against
            the reference's from the same durations and codes: relative
            L2 distance, worst row

The durations and codes are the program's outputs: each is judged (dur_err
with the ceiling check below, code_gap) before the reference builds a
waveform from them, as a served model's tokens are. A served row whose
integer durations are not the ceiling of its durations, or whose shapes
disagree with them (its length, its call's buckets), reads FAULT on the
number it breaks. The control puts the reference computed in a lower
precision in the program's place (`control_numbers`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.frontend import process_text
from portbench.reference.tts import frame_bucket, text_bucket

FAULT = 1e9


def dur_err(logw: np.ndarray, v_ref, ls: float) -> float:
    """logw: the program's log durations; v_ref: the reference's durations
    at length scale ls. The RMS of the log ratio of the two durations: the
    durations' relative error, whatever their size."""
    logw = np.asarray(logw, np.float64)
    ref = np.log(np.asarray(v_ref, np.float64) / ls)
    return float(np.sqrt(np.mean((logw - ref) ** 2))) if ref.size else 0.0


def ceiling_fault(d: np.ndarray, v: np.ndarray, n: int) -> bool:
    """The integer durations are not the ceiling of the values (to their
    float32 rounding), or the padding's are not 0."""
    d, v = np.asarray(d, np.float64), np.asarray(v, np.float64)
    lo, hi = np.ceil(v[:n] * (1 - 1e-6)), np.ceil(v[:n] * (1 + 1e-6))
    return bool(np.any(d[:n] < lo) or np.any(d[:n] > hi) or np.any(d[n:] != 0))


def code_gap(codes: np.ndarray, logits: torch.Tensor) -> float:
    lg = logits.double()
    c = torch.as_tensor(np.asarray(codes, np.int64), device=lg.device)[:lg.shape[0]]
    chosen = lg.gather(-1, c[:, None])[:, 0]
    return float(((lg.amax(-1) - chosen).max() / lg.abs().max()).cpu())


def wav_err(served: np.ndarray, ref: np.ndarray) -> float:
    served, ref = np.asarray(served, np.float64), np.asarray(ref, np.float64)
    if served.shape != ref.shape:
        return FAULT
    return float(np.linalg.norm(served - ref) / max(np.linalg.norm(ref), 1e-12))


def sample(rows: list, seed: int, n: int, stream: int = 9) -> list:
    """n of the served rows, drawn from the seed (and `stream`); the
    longest always in."""
    if len(rows) <= n:
        return list(rows)
    longest = max(range(len(rows)), key=lambda i: len(rows[i]["wav"]))
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, stream])
    rest = [i for i in range(len(rows)) if i != longest]
    pick = rng.choice(len(rest), n - 1, replace=False)
    return [rows[longest]] + [rows[rest[i]] for i in sorted(pick)]


def quantile(values: list, q: float) -> float:
    """Nearest-rank quantile, q in (0, 1]."""
    v = sorted(values)
    return float(v[max(0, math.ceil(q * len(v)) - 1)]) if v else 0.0


def program_durations(logw: np.ndarray, ls: float) -> np.ndarray:
    """The program's durations before their ceiling, as it forms them."""
    return np.exp(np.asarray(logw, np.float64)) * ls


def row_inputs(row: dict, prompts: list, ls: float, req_seed: int) -> dict:
    call, i = row["call"], row["index"]
    return dict(text=row["text"], audio=prompts[row["voice"]], length_scale=ls,
                seed=req_seed, n_pad=call["n_pad"], t_bucket=call["bucket"],
                batch=call["rows"], index=i, dur=call["dur"][i],
                codes=call["codes"][i], output_sr=row["output_sr"])


def shape_fault(ref, row: dict) -> bool:
    """The call's buckets and the row's length against its durations."""
    call = row["call"]
    if "shape_ok" not in call:
        frames = [int(math.ceil(float(np.sum(d)) / 2)) for d in call["dur"]]
        phones = [len(process_text(t)[0]) for t in call["texts"]]
        call["frames"] = frames
        call["shape_ok"] = (call["bucket"] == frame_bucket(max(frames))
                            and call["n_pad"] == text_bucket(max(phones)))
    n = int(320 * call["frames"][row["index"]] * ref.ratio_for(row["output_sr"]))
    return not call["shape_ok"] or len(row["wav"]) != n


def row_fault(ref, row: dict, ls: float) -> bool:
    """A served row's shapes, or its integer durations against the
    ceiling of its durations, are wrong."""
    call, i = row["call"], row["index"]
    n = len(process_text(row["text"])[0])
    v = program_durations(call["logw"][i], ls)
    return shape_fault(ref, row) or ceiling_fault(call["dur"][i], v, n)


def row_dur_err(ref, row: dict, prompts: list, ls: float, lower=None) -> float:
    """dur_err of one served row: the program's durations against the
    reference's, or with `lower` the control's."""
    call, i = row["call"], row["index"]
    audio = prompts[row["voice"]]
    n, v_ref = ref.durations(row["text"], audio, call["n_pad"], ls)
    if lower is not None:
        _, v_low = ref.durations(row["text"], audio, call["n_pad"], ls, lower)
        return dur_err(np.log(v_low.cpu().double().numpy() / ls), v_ref.cpu(), ls)
    return dur_err(np.asarray(call["logw"][i], np.float64)[:n], v_ref.cpu(), ls)


def judge(ref, served: list, dur_rows: list, rows: list, prompts: list, ls: float,
          req_seed: int, q: float, detail=None) -> dict:
    """The shapes and ceilings of every served row; dur_err over the
    sample `dur_rows`, code_gap and wav_err over the sample `rows`; the
    rows' readings and the durations' quantiles appended to `detail` when
    it is a list."""
    fault = any(row_fault(ref, row, ls) for row in served)
    durs = [row_dur_err(ref, row, prompts, ls) for row in dur_rows]
    nums = {"dur_err": FAULT if fault else quantile(durs, q), "code_gap": 0.0,
            "wav_err": 0.0}
    for row in rows:
        kw = row_inputs(row, prompts, ls, req_seed)
        out = ref.row(**kw)
        gap = code_gap(kw["codes"], out.logits)
        err = FAULT if shape_fault(ref, row) else wav_err(row["wav"], out.wav)
        nums["code_gap"] = max(nums["code_gap"], gap)
        nums["wav_err"] = max(nums["wav_err"], err)
        if detail is not None:
            detail.append({"row": out.v.shape[0], "frames": out.frames, "code_gap": gap,
                           "wav_err": err})
    if detail is not None:
        detail.append({"dur_rows": len(durs), **{f"dur_q{int(100 * x)}": quantile(durs, x)
                                                  for x in (0.5, 0.9, 1.0)}})
    return nums


def control_numbers(ref, dur_rows: list, rows: list, prompts: list, ls: float,
                    req_seed: int, q: float, lower: dict) -> dict:
    """The same numbers with the reference, each model run inside its
    `lower` context (precision.control), in the program's place, on the
    same rows: its own durations, the codes it puts first at each position
    of the served codes, and its waveform from the served durations and
    codes."""
    durs = [row_dur_err(ref, row, prompts, ls, lower) for row in dur_rows]
    nums = {"dur_err": quantile(durs, q), "code_gap": 0.0, "wav_err": 0.0}
    for row in rows:
        kw = row_inputs(row, prompts, ls, req_seed)
        out = ref.row(**kw)
        low = ref.row(**kw, lower=lower)
        nums["code_gap"] = max(nums["code_gap"],
                               code_gap(low.logits.argmax(-1).cpu().numpy(), out.logits))
        nums["wav_err"] = max(nums["wav_err"], wav_err(low.wav, out.wav))
    return nums
