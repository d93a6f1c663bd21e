"""Batched request queue over TTSPipeline: the serving front door.

Counterpart of `megatts2_hierspeechpp_tpu/infer/server.py:TTSServer`.
Callers submit requests from any thread; one worker thread owns the device.
It drains the queue, groups requests whose prompts share a padded
prompt-mel length and whose kwargs are equal, and runs each group as one
call: a lone request through `tts`, several of one speaker through
`tts_batch(prompt=...)`, several speakers through `tts_batch(prompts=...)`
(per-row cached style pairs). Requests with kwargs that tts_batch does not
take run alone through `tts`. The straggler window after the first
arrival is an absolute deadline, and a request that fails sets its own
future's exception; the worker goes on.

The worker enters torch.inference_mode itself (the mode is thread-local and
`tts` is not decorated) and, on a CUDA pipeline, the CUDA stream that was
current where the server was built, so PyTorch's operations and the
port's kernels (ops/cuda_lib.py launches on the current stream) share one
stream.

Counters, always on (`stats()`, a snapshot): requests `submitted`,
`served` (a waveform returned) and `failed` (an exception set); pipeline
`calls` and the `rows` they carried; `drains` of the queue and the
`groups` they made; `queue_s_sum` / `queue_s_max`, each request's seconds
from `submit` to the start of the call that serves it (time.perf_counter);
`depth`, the queue's size now. `submit` stamps a request once; only the
worker adds to the sums.

Spans (utils/profiling.annotate; recorded by a profiler started in the
worker thread): `server.wait` (blocked on an empty queue), `server.drain`
(the straggler window and the grouping), `server.call` (one group; its
args are the request ids, numbered from 1 at `submit`, and its rows) and
under it `server.reply` (setting the group's futures).

Usage:
    server = TTSServer(pipeline, max_batch=8, max_wait_ms=15)
    fut = server.submit("ni3 hao3 sp", prompt=prompt_feats, seed=7)
    wav = fut.result()
    server.stats()["queue_s_sum"]
    server.close()
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

# kwargs tts_batch takes with tts()'s meaning; a request with any other
# (codes=..., exact=..., return_intermediates=...) runs alone through tts()
from megatts2_hierspeechpp_torch.infer.pipeline import BATCH_KW as _BATCHABLE_KW
from megatts2_hierspeechpp_torch.utils.profiling import annotate

# the counters of stats(), each a sum since the server started
_COUNTS = ("submitted", "served", "failed", "calls", "rows", "drains", "groups")


@dataclass
class _Request:
    text: str
    prompt_key: int
    prompt: Any  # PromptFeatures
    kw: Dict[str, Any]
    id: int = 0
    t_submit: float = 0.0   # time.perf_counter at submit
    future: Future = field(default_factory=Future)


def _group_args(rs: list) -> str:
    """server.call's args: the group's request ids and rows."""
    return f"ids={[r.id for r in rs]} rows={len(rs)}"


class TTSServer:
    """Single-worker batching front end over a TTSPipeline."""

    def __init__(self, pipeline, max_batch: int = 8, max_wait_ms: float = 15.0):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        dev = getattr(pipeline, "device", None)
        self._stream = (torch.cuda.current_stream(dev)
                        if isinstance(dev, torch.device) and dev.type == "cuda"
                        else None)
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._lock = threading.Lock()   # the counters
        self._stats = dict.fromkeys(_COUNTS, 0)
        self._stats.update(queue_s_sum=0.0, queue_s_max=0.0)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._closed = False
        self._worker.start()

    # ---------------- client API ----------------

    def submit(self, text: str, prompt, **kw) -> Future:
        """Enqueue one utterance; `prompt` is a PromptFeatures (made once
        per speaker with pipeline.prepare_prompt). Returns a Future of the
        float32 waveform."""
        if self._closed:
            raise RuntimeError("server closed")
        req = _Request(text=text, prompt_key=id(prompt), prompt=prompt, kw=kw)
        with self._lock:
            self._stats["submitted"] += 1
            req.id = self._stats["submitted"]
        req.t_submit = time.perf_counter()
        self._q.put(req)
        return req.future

    def stats(self) -> dict:
        """A snapshot of the counters (module docstring) and the queue's
        current `depth`."""
        with self._lock:
            out = dict(self._stats)
        out["depth"] = self._q.qsize()
        return out

    def _count(self, **add):
        with self._lock:
            for k, v in add.items():
                self._stats[k] += v

    def close(self):
        self._closed = True
        self._q.put(None)
        self._worker.join()

    # ---------------- worker ----------------

    def _drain(self, first: _Request) -> list:
        """Up to max_batch requests, waiting for stragglers at most max_wait
        after the first arrival in all (an absolute deadline: a trickle of
        arrivals does not extend it)."""
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # the shutdown, for the main loop
                break
            batch.append(nxt)
        return batch

    def _run(self):
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        with torch.inference_mode(), stream:
            while True:
                with annotate("server.wait"):
                    req = self._q.get()
                if req is None:
                    return
                with annotate("server.drain"):
                    groups = self._groups(self._drain(req))
                self._count(drains=1, groups=len(groups))
                for rs in groups:
                    self._serve(rs)

    @staticmethod
    def _groups(batch: list) -> list:
        """Requests grouped by (padded prompt-mel length, kwargs); those with
        kwargs tts_batch does not take (possibly unhashable) alone."""
        groups: Dict[tuple, list] = {}
        singles = []
        for r in batch:
            if set(r.kw) <= _BATCHABLE_KW:
                key = (int(r.prompt.mel_ttv.shape[1]),
                       tuple(sorted(r.kw.items())))
                groups.setdefault(key, []).append(r)
            else:
                singles.append([r])
        return list(groups.values()) + singles

    def _serve(self, rs: list) -> None:
        t = time.perf_counter()
        waits = [t - r.t_submit for r in rs]
        with self._lock:
            st = self._stats
            st["calls"] += 1
            st["rows"] += len(rs)
            st["queue_s_sum"] += sum(waits)
            st["queue_s_max"] = max(st["queue_s_max"], *waits)
        with annotate("server.call", rs, _group_args):
            try:
                if len(rs) == 1:
                    r = rs[0]
                    wavs = [self.pipeline.tts(r.text, prompt=r.prompt, **r.kw)]
                elif len({r.prompt_key for r in rs}) == 1:
                    wavs = self.pipeline.tts_batch(
                        [r.text for r in rs], prompt=rs[0].prompt, **rs[0].kw)
                else:
                    wavs = self.pipeline.tts_batch(
                        [r.text for r in rs], prompts=[r.prompt for r in rs],
                        **rs[0].kw)
                with annotate("server.reply"):
                    for r, w in zip(rs, wavs):
                        r.future.set_result(np.asarray(w))
                self._count(served=len(rs))
            except Exception as e:  # the group's own futures; keep serving
                failed = [r for r in rs if not r.future.done()]
                for r in failed:
                    r.future.set_exception(e)
                self._count(served=len(rs) - len(failed), failed=len(failed))
