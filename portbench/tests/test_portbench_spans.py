"""The program's spans and counters as the gap.* and server.queue_ms
readers and portbench/tools/idle_spans.py read them, on synthetic traces:
the device idle given to the spans by hand, the parts adding up to the
idle that device.idle_pct reads, the idle by innermost span, trace.read
keeping the spans' device-side annotations out of the busy time and the
kernels, the queue wait from the server's counters, the readers finding
their run's tracer and server among the live objects and reading nothing
from a build without spans or counters, and the tool's wrappers around
the harness."""
from __future__ import annotations

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import megatts2_hierspeechpp_torch.infer.server as server_mod  # noqa: E402
from portbench.harness import cell, gaps, trace  # noqa: E402
from portbench.tools import idle_spans  # noqa: E402

MS = 1_000_000   # ns

BUSY = [(10, 20), (30, 35), (50, 60), (80, 87)]
# one served call: (name, start, end) in ms, nested as the port nests them
SPANS = [("server.wait", 0, 5), ("server.drain", 5, 8), ("server.call", 8, 95),
         ("pipeline.call", 12, 90), ("pipeline.rows", 12, 15),
         ("pipeline.duration", 15, 28), ("ttv.durations", 16, 25),
         ("pipeline.latent", 28, 40), ("plm.decode", 40, 45),
         ("pipeline.w2v", 45, 52), ("pipeline.vocode", 55, 85),
         ("vocoder.noise", 56, 70), ("weights.prep", 72, 75),
         ("pipeline.output", 86, 90), ("server.reply", 91, 94)]
# idle: [0, 10) [20, 30) [35, 50) [60, 80) [87, 100) = 68 ms
PARTS = {"ttv": 20, "vocoder": 20, "decode": 5, "pipeline": 3, "server": 10,
         "wait": 5, "outside": 5}
INNERMOST = {"server.wait": 5, "server.drain": 3, "server.call": 4,
             "pipeline.call": 0, "pipeline.rows": 0, "pipeline.duration": 3,
             "ttv.durations": 5, "pipeline.latent": 7, "plm.decode": 5,
             "pipeline.w2v": 5, "pipeline.vocode": 7, "vocoder.noise": 10,
             "weights.prep": 3, "pipeline.output": 3, "server.reply": 3,
             "outside": 5}


def _trace():
    return trace.Trace(0, 100 * MS, busy=[(a * MS, b * MS) for a, b in BUSY])


def _spans(spans=SPANS):
    return [(n, a * MS, b * MS) for n, a, b in spans]


def test_parts_of_the_idle_by_hand():
    got = gaps.parts(_trace(), _spans())
    assert got == {k: v * MS for k, v in PARTS.items()}
    idle = 100 * MS - trace.union_ns(_trace().busy, 0, 100 * MS)
    assert sum(got.values()) == idle == 68 * MS


@pytest.mark.parametrize("part", ["ttv", "vocoder", "pipeline", "server"])
def test_each_part_by_hand_without_spans_all_is_outside(part):
    assert gaps.parts(_trace(), _spans())[part] == PARTS[part] * MS
    bare = gaps.parts(_trace(), [])
    assert bare[part] == 0 and bare["outside"] == 68 * MS


def test_parts_add_up_to_what_device_idle_pct_reads():
    tr = _trace()
    idle_pct = cell.metric_reader("device.idle_pct.batch").read(cell.Run(trace=tr))
    assert sum(gaps.parts(tr, _spans()).values()) / MS == pytest.approx(idle_pct)


def test_idle_by_innermost_span_by_hand():
    got = gaps.innermost(_trace(), _spans())
    assert {k: v for k, v in got.items() if v} == {
        k: v * MS for k, v in INNERMOST.items() if v}
    assert sum(got.values()) == 68 * MS


def test_interval_helpers():
    assert gaps.merge([(5, 7), (0, 2), (1, 3), (4, 4)]) == [(0, 3), (5, 7)]
    assert gaps.minus([(0, 10)], [(2, 3), (5, 12)]) == [(0, 2), (3, 5)]
    assert gaps.overlap([(0, 4), (6, 10)], [(3, 7)]) == 2


class _Event:
    def __init__(self, name, start, end, cuda=False, activity="", annotation=False):
        self._n, self._s, self._e, self._cuda = name, start, end, cuda
        self._a, self._u = activity, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def activity_type(self):
        return self._a

    def is_user_annotation(self):
        return self._u


def _tracer(events):
    return SimpleNamespace(done=True, prof=SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events))))


def test_program_spans_stay_out_of_busy_and_kernels():
    events = [_Event("pb.trace_begin", 0, 0), _Event("pb.trace_end", 100, 100),
              _Event("pb.call", 11, 91), _Event("pipeline.call", 12, 90),
              _Event("aten::add", 13, 14),
              _Event("k1", 10, 20, cuda=True, activity="kernel"),
              _Event("Memcpy HtoD", 30, 35, cuda=True, activity="gpu_memcpy"),
              # the spans' device-side annotations, named by their activity
              # type or, where torch gives none, as user annotations
              _Event("server.call", 8, 95, cuda=True, activity="gpu_user_annotation"),
              _Event("pipeline.vocode", 55, 85, cuda=True, annotation=True)]
    tr = trace.read(_tracer(events))
    assert (tr.t0, tr.t1) == (0, 100)
    assert tr.kernels == [("k1", 10, 20)]
    assert tr.busy == [(10, 20), (30, 35)]
    assert tr.spans == [("pb.call", 11, 91)]
    assert gaps.program_spans(_tracer(events)) == [("pipeline.call", 12, 90)]
    assert gaps.program_spans(None) == []


def test_queue_ms_from_two_snapshots():
    opened = {"rows": 8, "queue_s_sum": 2.0, "served": 8}
    closed = {"rows": 48, "queue_s_sum": 20.0, "served": 48}
    assert gaps.queue_ms(opened, closed) == pytest.approx(450.0)
    assert gaps.queue_ms(closed, closed) is None


class _Pipe:
    def tts(self, text, prompt=None, **kw):
        return self.tts_batch([text])[0]

    def tts_batch(self, texts, prompt=None, prompts=None, **kw):
        time.sleep(0.02)
        return [np.zeros(4, np.float32) for _ in texts]


def test_tool_takes_the_spans_and_the_counters_itself(monkeypatch):
    # the tool wraps these in its own process; the test puts them back
    monkeypatch.setattr(server_mod, "TTSServer", server_mod.TTSServer)
    monkeypatch.setattr(trace, "read", trace.read)
    monkeypatch.setattr(trace.Tracer, "__init__", trace.Tracer.__init__)
    got = idle_spans.instrument(trace, gaps)
    prompt = SimpleNamespace(mel_ttv=np.zeros((1, 10, 80), np.float32))
    server = server_mod.TTSServer(_Pipe(), max_batch=2, max_wait_ms=5)
    server.submit("warm", prompt).result(timeout=10)
    trace.Tracer(0.0, 1.0, [])          # the window opens
    futs = [server.submit(t, prompt) for t in ("aa", "bb", "cc")]
    for f in futs:
        f.result(timeout=10)
    server.close()
    assert got["open"]["served"] == 1 and got["close"]["served"] == 4
    assert gaps.queue_ms(got["open"], got["close"]) >= 0.0
    events = [_Event("pb.trace_begin", 0, 0), _Event("pb.trace_end", 9, 9),
              _Event("server.call", 1, 8)]
    assert trace.read(_tracer(events)).spans == []
    assert got["spans"] == [("server.call", 1, 8)]


GAP_METRICS = {"gap.ttv_ms.batch": "ttv", "gap.vocoder_ms.batch": "vocoder",
               "gap.pipeline_ms.batch": "pipeline", "gap.server_ms.batch": "server"}


@pytest.mark.parametrize("metric", sorted(GAP_METRICS))
def test_gap_readers_by_hand_per_traced_call(metric):
    run = cell.Run(trace=_trace(), traced_calls=["call 1", "call 2"])
    run.program = {"spans": _spans(), "stats": None}
    got = cell.metric_reader(metric).read(run)
    assert got == pytest.approx(PARTS[GAP_METRICS[metric]] / 2)
    # the four, with the decode, the wait and no span, make up the idle
    rest = sum(PARTS[k] for k in ("decode", "wait", "outside")) / 2
    total = sum(cell.metric_reader(m).read(run) for m in GAP_METRICS) + rest
    idle_pct = cell.metric_reader("device.idle_pct.batch").read(run)
    assert total * 2 == pytest.approx(idle_pct)


class _RecordedPipe(_Pipe):
    def __init__(self):
        self.calls = []

    def tts_batch(self, texts, prompt=None, prompts=None, **kw):
        self.calls.append(SimpleNamespace(keys=list(texts)))
        return super().tts_batch(texts)


def _stopped_tracer(events):
    t = trace.Tracer(0.0, 1.0, [])
    t.done, t.prof = True, _tracer(events).prof
    return t


def test_readers_find_the_runs_tracer_and_server_among_live_objects():
    events = [_Event("pb.trace_begin", 0, 0), _Event("pb.trace_end", 100 * MS, 100 * MS),
              _Event("pb.call", 11 * MS, 91 * MS)]
    events += [_Event(n, a, b) for n, a, b in _spans()]
    mine = _stopped_tracer(events)
    other = _stopped_tracer([_Event("pb.trace_begin", 7, 7),
                             _Event("server.call", 8, 9)])
    pipe = _RecordedPipe()
    prompt = SimpleNamespace(mel_ttv=np.zeros((1, 10, 80), np.float32))
    server = server_mod.TTSServer(pipe, max_batch=4, max_wait_ms=50)
    for f in [server.submit(t, prompt) for t in ("aa", "bb", "cc")]:
        f.result(timeout=10)
    server.close()
    stranger = server_mod.TTSServer(_RecordedPipe())   # another run's server
    stranger.close()
    run = cell.Run(trace=_trace(), calls=[], traced_calls=list(pipe.calls))
    assert gaps.found(run)["spans"] == _spans()
    stats = server.stats()
    assert gaps.found(run)["stats"] == stats and stats["rows"] == 3
    queue = cell.metric_reader("server.queue_ms.batch").read(run)
    assert queue == pytest.approx(1e3 * stats["queue_s_sum"] / 3) and queue > 0
    assert cell.metric_reader("gap.vocoder_ms.batch").read(run) == pytest.approx(
        PARTS["vocoder"] / len(run.traced_calls))
    del mine, other


def test_readers_read_nothing_without_the_programs_spans_or_counters(monkeypatch):
    """A build before SPAN_NAMES and TTSServer.stats: every new reader
    returns None and none raises."""
    from megatts2_hierspeechpp_torch.utils import profiling
    monkeypatch.delattr(profiling, "SPAN_NAMES")
    monkeypatch.delattr(server_mod.TTSServer, "stats")
    events = [_Event("pb.trace_begin", 0, 0), _Event("pipeline.call", 12, 90)]
    tracer = _stopped_tracer(events)
    pipe = _RecordedPipe()
    server = server_mod.TTSServer(pipe, max_batch=2, max_wait_ms=5)
    server.submit("aa", SimpleNamespace(mel_ttv=np.zeros((1, 10, 80)))).result(timeout=10)
    server.close()
    run = cell.Run(trace=_trace(), calls=list(pipe.calls), traced_calls=list(pipe.calls))
    for m in list(GAP_METRICS) + ["server.queue_ms.batch"]:
        assert cell.metric_reader(m).read(run) is None, m
    assert cell.metric_reader("gap.ttv_ms.batch").read(cell.Run()) is None
    del tracer
