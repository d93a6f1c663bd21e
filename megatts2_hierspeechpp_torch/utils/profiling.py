"""Profiling: the port's spans and their exporter.

Counterpart of `megatts2_hierspeechpp_tpu/utils/profiling.py`:

  - `annotate(name, args=None, fmt=str)`: a named span, the one span
    primitive of the port. Off (no profiler recording in the calling
    thread: torch's profiler state is thread-local) it returns one shared
    no-op context, so a span costs a boolean check and allocates nothing.
    On, it opens a `torch.profiler.record_function` range named `name`;
    with `args`, the range carries `fmt(args)`, built only then, as its
    "args" keyword, which a profiler that records inputs
    (`record_shapes=True`, as `trace` does) keeps;
  - `SPAN_NAMES`: the closed set of span names, each with its parent on
    the serving path (None: a root). Every span the port opens is one of
    them, at stage granularity: never per layer, block or launch;
  - `trace(log_dir)`: a torch.profiler window over the CPU and, where there
    is one, the card, written as a Chrome trace (`trace.json`, viewable in
    chrome://tracing or Perfetto) into log_dir; the profiler object is
    yielded for `key_averages()`. Start it in the thread whose spans it
    should see: for a served pipeline, `TTSServer`'s worker.
"""
from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# span -> its parent (a tuple where the span opens under several, None at a
# root); `tts_stream` opens pipeline.* and vocoder.* before its first yield
SPAN_NAMES = {
    "server.wait": None,        # the worker blocked on an empty queue
    "server.drain": None,       # the straggler window and the grouping
    "server.call": None,        # one group; args: its request ids and rows
    "server.reply": "server.call",
    "pipeline.call": "server.call",   # tts / tts_batch; a root when called directly
    "pipeline.rows": "pipeline.call",
    "pipeline.duration": "pipeline.call",
    "pipeline.latent": "pipeline.call",
    "ttv.durations": ("pipeline.duration", "pipeline.latent"),
    "plm.decode": "pipeline.call",
    "pipeline.w2v": "pipeline.call",
    "pipeline.vocode": "pipeline.call",
    "vocoder.style": "pipeline.vocode",
    "vocoder.prior": "pipeline.vocode",
    "vocoder.noise": "pipeline.vocode",
    "vocoder.flow": "pipeline.vocode",
    "vocoder.source": "pipeline.vocode",
    "vocoder.generator": "pipeline.vocode",
    "speechsr": "pipeline.vocode",
    "weights.prep": ("vocoder.source", "vocoder.generator", "speechsr"),
    "pipeline.output": "pipeline.call",
    "plain_vjp": None,          # a kernel's backward (training)
}

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def annotate(name: str, args=None, fmt=str):
    """The span `name` (one of SPAN_NAMES) as a context manager: a
    record_function range while a profiler records in this thread, else a
    shared no-op. `fmt(args)` becomes the range's "args" keyword, formatted
    only when recorded."""
    if not _recording():
        return _OFF
    if args is None:
        return record_function(name)
    return torch._C._profiler._RecordFunctionFast(name, (), {"args": fmt(args)})


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on leaving it, write `<log_dir>/trace.json`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
