"""The port's spans and server counters (utils/profiling.py, infer/server.py):
`annotate` off builds nothing and opens no range, on records its span with
its args; every span the port opens is one of SPAN_NAMES; TTSServer.stats()
on the stub pipeline of tests/test_server.py, its counts under
concurrent submits, and the server's spans seen by a profiler started in
the worker thread; the small CPU pipeline of test_torch_tts.py under
tts_batch opens exactly the documented spans, each under its documented
parent, and gives the same waveform, bit for bit, with a profiler
recording and without."""
import re
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tests.test_server as stub_tests
from megatts2_hierspeechpp_torch.infer.server import TTSServer
from megatts2_hierspeechpp_torch.utils import profiling
from megatts2_hierspeechpp_torch.utils.profiling import SPAN_NAMES, annotate
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_pipeline import speechsrs  # noqa: F401  (fixture)
from tests.test_torch_tts import TEXT, pipelines  # noqa: F401  (fixture)
from tests.test_torch_vocoder import vocoders  # noqa: F401  (fixture)

PORT = Path(__file__).resolve().parents[1] / "megatts2_hierspeechpp_torch"


def _program_spans(prof):
    """[(name, start, end)] of the profiler's SPAN_NAMES ranges, in start
    order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() in SPAN_NAMES and e.device_type() == torch.autograd.DeviceType.CPU]
    return sorted(out, key=lambda x: (x[1], -x[2]))


def _parents(spans):
    """[(name, parent name or None)]: each span's innermost enclosing span."""
    out = []
    for i, (name, s, e) in enumerate(spans):
        # an enclosing span of the same bounds is the one that opened first
        cover = [(e2 - s2, -j, n2) for j, (n2, s2, e2) in enumerate(spans)
                 if s2 <= s and e <= e2 and (e2 - s2, -j) > (e - s, -i)]
        out.append((name, min(cover)[2] if cover else None))
    return out


def test_annotate_off_opens_nothing_and_builds_no_args(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("reached while no profiler records")

    monkeypatch.setattr(profiling, "record_function", boom)
    assert not torch._C._autograd._profiler_enabled()
    with annotate("pipeline.call"):
        with annotate("server.call", [1, 2], boom):
            pass
    # one shared no-op context: nothing allocated per span
    assert annotate("pipeline.call") is annotate("server.call", [3], boom)


def test_annotate_on_records_the_span_and_its_args():
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with annotate("pipeline.call"):
            with annotate("server.call", [4, 5], lambda ids: f"ids={ids}"):
                torch.ones(8) + 1
    got = {e.name(): e for e in prof.profiler.kineto_results.events()
           if e.name() in SPAN_NAMES}
    assert set(got) == {"pipeline.call", "server.call"}
    assert got["server.call"].kwinputs() == {"args": "ids=[4, 5]"}
    assert [p for _, p in _parents(_program_spans(prof))] == [None, "pipeline.call"]


def test_every_span_of_the_port_is_a_span_name():
    """Every annotate(...) in the port names one of SPAN_NAMES, each parent
    is one of them, and no record_function is opened beside annotate."""
    opened = set()
    for path in PORT.rglob("*.py"):
        src = path.read_text()
        if path.name != "profiling.py":
            assert "record_function" not in src, path
        opened |= set(re.findall(r'annotate\(\s*"([^"]+)"', src))
    assert opened <= set(SPAN_NAMES), opened - set(SPAN_NAMES)
    assert opened == set(SPAN_NAMES), set(SPAN_NAMES) - opened
    for parent in SPAN_NAMES.values():
        for p in (parent if isinstance(parent, tuple) else (parent,)):
            assert p is None or p in SPAN_NAMES, p


class SlowPipeline(stub_tests.StubPipeline):
    """The stub pipeline, each batched call taking `sleep` seconds."""

    def __init__(self, sleep=0.2):
        super().__init__()
        self.sleep = sleep

    def tts_batch(self, texts, prompt=None, prompts=None, **kw):
        time.sleep(self.sleep)
        return super().tts_batch(texts, prompt=prompt, prompts=prompts, **kw)


def test_server_stats_count_requests_calls_and_queue_time():
    pipe = SlowPipeline(0.2)
    server = TTSServer(pipe, max_batch=2, max_wait_ms=50)
    prompt = stub_tests.StubPrompt()
    try:
        futs = [server.submit(t, prompt, seed=1) for t in ("aa", "bb", "cc", "dd")]
        for f in futs:
            f.result(timeout=10)
        bad = server.submit("boom", prompt)   # alone through tts, which raises
        with pytest.raises(RuntimeError, match="synthesis failed"):
            bad.result(timeout=10)
        st = server.stats()
    finally:
        server.close()
    assert len(pipe.batch_calls) == 2 and len(pipe.single_calls) == 1
    assert {k: st[k] for k in ("submitted", "served", "failed", "calls", "rows",
                               "drains", "groups", "depth")} == dict(
        submitted=5, served=4, failed=1, calls=3, rows=5, drains=3, groups=3, depth=0)
    # the second group waited out the first group's call
    assert st["queue_s_sum"] >= 2 * 0.2 and st["queue_s_max"] >= 0.2
    assert st["queue_s_max"] <= st["queue_s_sum"]


def test_server_ids_and_counts_hold_under_concurrent_submits():
    """Many threads submitting at once with a short switch interval: no
    count is lost."""
    pipe = stub_tests.StubPipeline()
    server = TTSServer(pipe, max_batch=8, max_wait_ms=1)
    prompt = stub_tests.StubPrompt()
    futs, lock = [], threading.Lock()

    def client():
        for _ in range(50):
            f = server.submit("ab", prompt, seed=1)
            with lock:
                futs.append(f)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for f in futs:
            f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
        server.close()
    st = server.stats()
    assert st["submitted"] == st["served"] == st["rows"] == len(futs) == 800
    assert st["failed"] == 0 and st["groups"] == st["calls"]
    served = sum(len(texts) for texts, _, _ in pipe.batch_calls) + len(pipe.single_calls)
    assert served == 800


def test_profiler_in_the_worker_sees_the_server_spans():
    """A profiler started and stopped inside pipeline calls (as a tracing
    harness starts it, in the worker thread) records the worker's server
    spans, server.call with its request ids, in their nesting, and none of
    another thread's."""
    state = {}

    class Pipe(stub_tests.StubPipeline):
        def tts(self, text, prompt=None, **kw):
            if text == "start":
                state["prof"] = profile(activities=[ProfilerActivity.CPU],
                                        record_shapes=True)
                state["prof"].start()
            elif text == "stop":
                state["prof"].stop()
            return super().tts(text, prompt=prompt, **kw)

    server = TTSServer(Pipe(), max_batch=1, max_wait_ms=1)
    prompt = stub_tests.StubPrompt()
    try:
        server.submit("start", prompt).result(timeout=10)
        # the worker records; this thread does not, and its span is not seen
        assert not torch._C._autograd._profiler_enabled()
        with annotate("pipeline.output"):
            pass
        server.submit("middle", prompt).result(timeout=10)
        server.submit("stop", prompt).result(timeout=10)
    finally:
        server.close()
    events = [e for e in state["prof"].profiler.kineto_results.events()
              if e.name() in SPAN_NAMES]
    assert len({e.start_thread_id() for e in events}) == 1
    assert "pipeline.output" not in {e.name() for e in events}
    call, = [e for e in events if e.name() == "server.call"
             and e.kwinputs() == {"args": "ids=[2] rows=1"}]
    s, e = call.start_ns(), call.start_ns() + call.duration_ns()
    spans = _program_spans(state["prof"])
    assert any(n == "server.reply" and s <= a and b <= e for n, a, b in spans)
    names = {n for n, _, _ in spans}
    assert {"server.wait", "server.drain", "server.call", "server.reply"} <= names
    for name, parent in _parents(spans):
        if name == "server.reply":   # the first one's call opened before the start
            assert parent in ("server.call", None)
        else:
            assert parent is None, (name, parent)


# tts_batch with a shared prompt; SpeechSR at 48 kHz
SHARED = {"pipeline.call", "pipeline.rows", "pipeline.duration", "pipeline.latent",
          "ttv.durations", "plm.decode", "pipeline.w2v", "pipeline.vocode",
          "vocoder.style", "vocoder.prior", "vocoder.noise", "vocoder.flow",
          "vocoder.source", "vocoder.generator", "weights.prep", "speechsr",
          "pipeline.output"}


@pytest.mark.parametrize("per_row", [False, True])
def test_tts_batch_opens_the_documented_spans_and_keeps_its_waveform(pipelines, per_row):
    _, tp, audio = pipelines
    texts = [TEXT, "sil zh ang1 h ao3 sp"]
    if per_row:
        prompts = [tp.prepare_prompt(audio, bucket=True),
                   tp.prepare_prompt(audio[::-1].copy(), bucket=True)]
        kw = dict(prompts=prompts)
    else:
        kw = dict(prompt=tp.prepare_prompt(audio))
    kw.update(seed=3, output_sr=48000)
    with torch.inference_mode():
        plain = tp.tts_batch(texts, **kw)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = tp.tts_batch(texts, **kw)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    spans = _program_spans(prof)
    assert {n for n, _, _ in spans} == SHARED
    assert len(spans) <= 60
    for name, parent in _parents(spans):
        want = SPAN_NAMES[name]
        if name == "pipeline.call":
            assert parent is None   # called directly, not served
        else:
            assert parent in (want if isinstance(want, tuple) else (want,)), (name, parent)
    # the duration pre-pass and the latent each run the TTV's durations
    assert [p for n, p in _parents(spans) if n == "ttv.durations"] == [
        "pipeline.duration", "pipeline.latent"]
