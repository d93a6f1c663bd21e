"""One run of one cell: set-up, the measured window, the readings and the
comparison with the reference.

Set-up (all of it counted in setup_s): the traffic from the seed, the
weights drawn on the device, the pipeline built and loaded, one prompt per
voice (prepare_prompt(bucket=True)), the length scale, the server, and the
traffic file's warm-up calls through the server. The window then runs the
open or closed loop for `seconds`; nothing is built or compiled inside it.
After it the program is freed and the reference, built from the same seed,
judges the rows served in the window: the shapes of every row, the
durations of one sample of them, the codes and waveform of another
(harness/check.py).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from portbench.harness import check, load, program, trace, traffic, weights

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = ROOT / "configs"
PATIENCE = 40   # bisection steps of the length-scale search, at most


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def module_from(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """portbench/metrics/<name>.py, else the file of its name without the
    last suffix (one reader serves `x.serve` and `x.batch`)."""
    for stem in (name, name.rsplit(".", 1)[0]):
        path = ROOT / "metrics" / f"{stem}.py"
        if path.exists():
            return module_from(path)
    raise FileNotFoundError(f"no reader for metric {name}")


def calibrate(rec, texts: list, prompts: list, frames: int, tol: float):
    """(The length scale at which the duration pre-pass gives each voice's
    texts `frames` 50 Hz frames a text on average over all voices, within
    tol of it; each voice's mean frames a text there): bisection on a log
    scale, one pre-pass call a voice and step."""
    lo, hi = 0.02, 50.0
    for _ in range(PATIENCE):
        ls = math.sqrt(lo * hi)
        each = [float(np.mean(rec.pipe.duration(list(t), p, ls)))
                for t, p in zip(texts, prompts)]
        n = sum(each) / len(each)
        if abs(n - frames) <= tol * frames:
            return ls, each
        lo, hi = (ls, hi) if n < frames else (lo, ls)
    raise RuntimeError(f"no length_scale gives {frames} frames (last {n} at {ls})")


def _ratio_stats(served, due, tr) -> list:
    """min / median / max of served frames per second of requested speech."""
    want = {(traffic.text_of(tr, s.req), s.req.voice): s.req.speech_s for s in due}
    r = sorted(len(x["wav"]) / 960 / want[(x["text"], x["voice"])] for x in served
               if (x["text"], x["voice"]) in want)
    return [r[0], r[len(r) // 2], r[-1]] if r else []


def _hist(values) -> dict:
    out = {}
    for v in values:
        out[str(v)] = out.get(str(v), 0) + 1
    return out


class Run:
    """What the metric readers see: the cell's configuration (cfg) and
    counts; the window's calls and requests (calls, sent: every request
    due in it), its open and close (t0, t_end), its seconds, the drain
    past it (drain), setup_s and output_sr; with a trace, the trace and
    the calls inside it (traced_calls); each voice's prompt samples
    (prompt_samples) and the text of a request (text_of)."""

    def __init__(self, **fields):
        self.trace = None
        self.traced_calls = []
        self.__dict__.update(fields)


def run(workload: dict, seed: int, seconds: float, trace_on: bool,
        device="cuda", cfg=None, spec=None, process_start=None,
        log=lambda *a: None) -> dict:
    """One run of the cell `workload` (a BENCHMARK.json workloads entry
    with its metric lists under "end_to_end" / "per_layer"); `cfg` and
    `spec` override the configuration and traffic files (the tests' small
    sizes). Returns the result line's fields, the compared numbers under
    "checks"."""
    clock = time.perf_counter
    t_proc = process_start if process_start is not None else clock()
    cfg = cfg or read_json(CONFIG_DIR / f"{workload['config']}.json")
    spec = spec or traffic.load(workload["traffic"])
    counts = module_from(ROOT / "counts" / f"{workload['config']}.py")
    dev = torch.device(device)
    from megatts2_hierspeechpp_torch.infer.server import TTSServer

    phases = {"imports": clock() - t_proc}
    tr = traffic.make(spec, seed, seconds)
    phases["traffic"] = clock() - t_proc
    pipe = program.build(cfg, weights.draw_all(cfg, seed, dev), dev)
    phases["models"] = clock() - t_proc
    prompts = [pipe.prepare_prompt(a, bucket=True) for a in tr.prompts]
    rec = program.Recorder(pipe, {id(p): v for v, p in enumerate(prompts)}, clock)
    cal = spec["calibration"]
    ls, voice_frames = calibrate(rec, tr.calibration_texts, prompts, cal["frames"],
                                 cal["tol"])
    traffic.set_rates(tr, voice_frames, cal["frames"] / cal["seconds"])
    phases["calibration"] = clock() - t_proc
    req_seed = int(seed) % (2 ** 31)
    kw = dict(output_sr=spec["output_sr"], length_scale=ls, seed=req_seed)
    server = TTSServer(rec, max_batch=cfg["max_batch"], max_wait_ms=cfg["max_wait_ms"])

    def submit(req):
        return server.submit(traffic.text_of(tr, req), prompts[req.voice], **kw)

    wrng = traffic.rng_for(seed, 8)
    warm_errors = []
    for i, (rows, secs) in enumerate(spec["warmup"]):
        voices = [v for v in range(len(prompts))
                  if prompts[v].mel_ttv.shape[1] == prompts[i % len(prompts)].mel_ttv.shape[1]]
        vs = [voices[j % len(voices)] for j in range(rows)]
        futs = [server.submit(traffic.tts_text(wrng, secs, tr.rates[v],
                                               spec["phrase_syllables"]), prompts[v], **kw)
                for v in vs]
        for f in futs:
            try:
                f.result(timeout=spec["drain_s"])
            except Exception as e:  # a warm-up that never returns fails the run
                warm_errors.append(repr(e) or type(e).__name__)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phases["warmup"] = clock() - t_proc
    first_call = len(rec.calls)

    t0 = clock() + 0.05
    t_end = t0 + seconds
    setup_s = t0 - t_proc
    tracer = None
    if trace_on:
        start = max(0.0, seconds - spec["trace_s"])
        tracer = trace.Tracer(t0 + start, t_end, rec.calls)
        rec.tracer = tracer
    drain = spec["drain_s"]
    if spec["kind"] == "open":
        sent = load.open_loop(submit, tr.requests, t0, clock)
        while clock() < t_end:
            time.sleep(min(0.05, max(0.0, t_end - clock())))
        load.wait_all(sent, t_end + drain, clock)
        due = sent
    else:
        pool = iter(tr.requests)
        sent = load.closed_loop(submit, lambda: next(pool), spec["clients"],
                                t_end, drain, clock)
        due = sent
    server.close()
    rec.close()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    calls = rec.calls[first_call:]
    traced = trace.read(tracer) if tracer is not None else None

    # ---- the metrics: end-to-end, or per-layer in a traced run ----
    failed = [s for s in due if not s.ok]
    lateness = [s.sent - s.due for s in due] or [0.0]
    ctx = Run(cfg=cfg, counts=counts, calls=calls, sent=due, t0=t0, t_end=t_end,
              seconds=seconds, drain=drain, setup_s=setup_s, output_sr=spec["output_sr"],
              prompt_samples=[len(a) for a in tr.prompts],
              text_of=lambda r: traffic.text_of(tr, r))
    metrics = {}
    for m in workload["end_to_end"]:
        metrics[m["name"]] = {"value": metric_reader(m["name"]).read(ctx), "unit": m["unit"]}
    if trace_on:
        # host readings from the calls before the profiler started
        if tracer.done:
            ctx.calls = rec.calls[first_call:tracer.first]
        if traced is not None:
            ctx.trace, ctx.traced_calls = traced, rec.calls[tracer.first:tracer.last]
        for m in workload["per_layer"]:
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- correctness, after the program is freed ----
    rec.host_copies()
    by_key = {}
    for call in calls:
        if not call.ok:
            continue
        info = {"n_pad": call.n_pad, "bucket": call.bucket, "rows": len(call.keys),
                "dur": call.dur, "logw": call.logw, "codes": call.codes,
                "texts": [t for t, _ in call.keys]}
        for i, key in enumerate(call.keys):
            by_key[key] = (info, i)
    served = []   # every row served in the window
    for s in due:
        key = (traffic.text_of(tr, s.req), s.req.voice)
        if s.ok and key in by_key and (spec["kind"] == "open" or s.done <= t_end):
            info, i = by_key[key]
            served.append({"text": key[0], "voice": s.req.voice, "wav": s.wav,
                           "call": info, "index": i, "output_sr": kw["output_sr"]})
    del server, rec, pipe, prompts
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from portbench.reference.tts import Reference
    t_ref = clock()
    ref = Reference(cfg, weights.draw_all(cfg, seed, dev), dev)
    rows = check.sample(served, seed, spec["check_rows"])
    dur_rows = check.sample(served, seed, spec["dur_rows"], stream=10)
    detail = []
    nums = check.judge(ref, served, dur_rows, rows, tr.prompts, ls, req_seed,
                       cfg["dur_err_quantile"], detail)
    t_ref = clock() - t_ref
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in nums.items()}
    within = all(c["limit"] is not None and c["value"] <= c["limit"]
                 for c in checks.values())
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    log("info " + json.dumps({
        "length_scale": ls, "calls": len(calls), "served": len(served),
        "lateness_ms_max": 1e3 * max(lateness),
        "lateness_ms_median": 1e3 * statistics.median(lateness),
        "checked_rows": len(rows), "check_s": t_ref, "setup_phases_s": phases,
        "rows_per_call": _hist(len(c.keys) for c in calls),
        "buckets": _hist(c.bucket for c in calls),
        "call_s_mean": statistics.fmean([c.t1 - c.t0 for c in calls] or [0.0]),
        "frames_per_speech_s": _ratio_stats(served, due, tr),
        "errors": sorted({s.error for s in failed})[:3], "warmup_errors": warm_errors[:3]}))
    return {"correct": bool(within and not failed and rows and not warm_errors),
            "attempted": len(due),
            "failed": len(failed), "metrics": metrics, "memory_peak_bytes": peak,
            "trace": traced, "checks": checks, "sent": due, "calls": calls,
            "ref": ref, "dur_rows": dur_rows, "rows": rows, "length_scale": ls,
            "req_seed": req_seed, "prompts": tr.prompts, "t0": t0, "t_end": t_end,
            "detail": detail}
