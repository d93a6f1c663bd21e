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

Usage:
    server = TTSServer(pipeline, max_batch=8, max_wait_ms=15)
    fut = server.submit("ni3 hao3 sp", prompt=prompt_feats, seed=7)
    wav = fut.result()
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


@dataclass
class _Request:
    text: str
    prompt_key: int
    prompt: Any  # PromptFeatures
    kw: Dict[str, Any]
    future: Future = field(default_factory=Future)


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
        self._q.put(req)
        return req.future

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
                req = self._q.get()
                if req is None:
                    return
                for rs in self._groups(self._drain(req)):
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
            for r, w in zip(rs, wavs):
                r.future.set_result(np.asarray(w))
        except Exception as e:  # the group's own futures; keep serving
            for r in rs:
                if not r.future.done():
                    r.future.set_exception(e)
