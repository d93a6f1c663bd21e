"""The harness's plumbing on the CPU: schedules from the seed, the load
generators against a stub server, the end-to-end readings, the result
line, and run.py without a card."""
from __future__ import annotations

import collections
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import pytest

from portbench.harness import cell, load, traffic
from portbench.tests import small

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 12345


def _open_spec():
    spec = small.traffic("open")
    spec["rate_rps"] = 50.0
    return spec


def _e2e(name, sent, t_end, drain, seconds):
    """An end-to-end metric as its reader in portbench/metrics/ takes it."""
    run = cell.Run(sent=sent, t_end=t_end, drain=drain, seconds=seconds,
                   output_sr=48000, setup_s=0.0)
    return cell.metric_reader(name).read(run)


def _make(spec, seed, seconds):
    tr = traffic.make(spec, seed, seconds)
    traffic.set_rates(tr, [100 + 10 * v for v in range(spec["voices"])])
    return tr


def test_same_seed_same_schedule():
    for kind in ("open", "closed"):
        spec = small.traffic(kind) if kind == "closed" else _open_spec()
        a, b = _make(spec, SEED, 2.0), _make(spec, SEED, 2.0)
        key = lambda tr: [(r.due, r.voice, r.speech_s, traffic.text_of(tr, r))  # noqa: E731
                          for r in tr.requests[:40]]
        assert key(a) == key(b)
        assert [p.tobytes() for p in a.prompts] == [p.tobytes() for p in b.prompts]
        c = _make(spec, SEED + 1, 2.0)
        assert key(c) != key(a)


def test_voice_rates_set_request_lengths():
    """A voice whose calibration text took twice the frames gets half the
    syllables a second."""
    spec = _open_spec()
    tr = traffic.make(spec, SEED, 2.0)
    traffic.set_rates(tr, [100, 200])
    assert tr.rates[0] == pytest.approx(2 * tr.rates[1])
    for r in tr.requests[:20]:
        syl = traffic.text_of(tr, r).count(" ") // 2
        assert abs(syl - r.speech_s * tr.rates[r.voice]) <= 6


def test_seeds_share_sizes_and_gaps():
    spec = _open_spec()
    a, b = _make(spec, 1, 4.0), _make(spec, 2, 4.0)
    assert sorted(r.speech_s for r in a.requests) == sorted(r.speech_s for r in b.requests)
    assert len(a.requests) == len(b.requests) == 200
    assert collections.Counter(r.voice for r in a.requests) == \
        collections.Counter(r.voice for r in b.requests)
    # the same gaps in another order: the same last arrival, other sequences
    assert a.requests[-1].due == pytest.approx(b.requests[-1].due)
    assert [r.due for r in a.requests] != [r.due for r in b.requests]


class StubServer:
    """Finishes each request `delay` seconds after it is submitted; the
    requests in `fail` raise, those in `hang` never finish."""

    def __init__(self, delay, fail=(), hang=()):
        self.delay, self.fail, self.hang = delay, set(fail), set(hang)
        self.timers = []

    def submit(self, req):
        fut = Future()
        if req.index in self.hang:
            return fut

        def finish():
            if req.index in self.fail:
                fut.set_exception(RuntimeError("stub failure"))
            else:
                fut.set_result([0.0] * 48000)
        t = threading.Timer(self.delay, finish)
        t.start()
        self.timers.append(t)
        return fut


def test_open_loop_latency_counts_from_the_due_time():
    spec = _open_spec()
    tr = _make(spec, SEED, 1.0)
    stub = StubServer(0.05, fail={3}, hang={7})
    t0 = time.perf_counter() + 0.02
    sent = load.open_loop(stub.submit, tr.requests, t0)
    load.wait_all(sent, time.perf_counter() + 2.0)
    assert [s.req.index for s in sent] == sorted(
        range(len(tr.requests)), key=lambda i: tr.requests[i].due)
    for s in sent:
        assert s.due == pytest.approx(t0 + s.req.due)
        assert s.sent >= s.due
        if s.ok:
            assert s.done - s.due >= 0.05
    by = {s.req.index: s for s in sent}
    assert not by[3].ok and by[3].done and "stub failure" in by[3].error
    assert not by[7].ok and not by[7].done
    t_end = t0 + 1.0
    p95 = _e2e("latency_p95_ms", sent, t_end, 2.0, 1.0)
    ok = sorted(s.done - s.due for s in sent if s.ok)
    assert p95 >= 1e3 * ok[len(ok) // 2]
    # two of fifty failed or unfinished: they sit above the 95th percentile
    assert p95 <= 1e3 * ok[-1]


def test_failures_above_the_percentile_read_as_the_drain():
    class S:
        def __init__(self, due, done, ok):
            self.due, self.done, self.ok, self.sent = due, done, ok, due
    due = [S(0.0, 0.1, True)] + [S(0.0, 0.0, False)] * 4
    assert _e2e("latency_p95_ms", due, 10.0, 5.0, 10.0) == 15e3


def test_closed_loop_counts_only_audio_returned_in_the_window():
    spec = small.traffic("closed")
    tr = _make(spec, SEED, 1.0)
    stub = StubServer(0.2)
    pool = iter(tr.requests)
    t_end = time.perf_counter() + 1.0
    sent = load.closed_loop(stub.submit, lambda: next(pool), 3, t_end, 2.0)
    assert all(s.ok for s in sent)
    inside = [s for s in sent if s.done <= t_end]
    assert len(inside) < len(sent)        # the last round ends after the window
    rate = _e2e("audio_s_per_s", sent, t_end, 2.0, 1.0)
    assert rate == pytest.approx(len(inside))
    assert all(s.sent < t_end for s in sent)


def test_result_line_keys():
    sys.path.insert(0, str(ROOT))
    from portbench import run
    res = {"correct": True, "attempted": 3, "failed": 0, "trace": None,
           "metrics": {"setup_s": {"value": 1.0, "unit": "s"},
                       "mfu.serve": {"value": 0.1, "unit": "%"}},
           "checks": {"wav_err": {"value": 1e-6, "limit": 1e-4}}}
    cellent = {"end_to_end": [{"name": "setup_s"}], "per_layer": [{"name": "mfu.serve"}]}
    line = run.result_line(res, cellent, False, {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert list(line["metrics"]) == ["setup_s"]
    line = run.result_line(res, cellent, True, {"platform": "gpu"})
    assert list(line["metrics"]) == ["mfu.serve"] and list(line)[-1] == "checks"


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "tts48k_bf16.batch_long", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
