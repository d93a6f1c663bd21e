"""Device idle of a traced stretch, put down to the program's own spans.

The program's spans are the worker's CPU ranges whose names are in the
port's utils/profiling.SPAN_NAMES (`program_spans` takes them from a
stopped trace.Tracer; trace.read keeps only the harness's pb.* ranges).
Device idle is the traced stretch [t0, t1] less the union of `busy` (every
kernel, copy and memset). Each piece of it is given to the spans that cover
it, by interval intersection (ns), in PARTS' order: the TTV's stages, the
vocoder with SpeechSR, the decode, the rest of the pipeline call, the
server's drain and call outside the pipeline, the worker's wait on an empty
queue, and what no program span covers. The parts add up to the idle time
exactly. `innermost` names each idle piece by the innermost span open over
it instead. `queue_ms` reads the server's own counters (TTSServer.stats).

The readers gap.*_ms and server.queue_ms take a run's program spans and
its server's counters through `found`: the harness's Run carries neither
the stopped Tracer nor the server, so `found` looks both up among the
live objects once (gc) and keeps them on the Run. Where the program has no
SPAN_NAMES or no TTSServer.stats (a build before them), it finds nothing
and the readers return None.
"""
from __future__ import annotations

import gc

import torch

STAGES = ("pipeline.duration", "pipeline.latent", "pipeline.w2v",
          "pipeline.vocode", "plm.decode")
# part -> (spans it lies inside, spans it lies outside)
PARTS = {
    "ttv": (("pipeline.duration", "pipeline.latent", "pipeline.w2v"), ()),
    "vocoder": (("pipeline.vocode",), ()),
    "decode": (("plm.decode",), ()),
    "pipeline": (("pipeline.call",), STAGES),
    "server": (("server.drain", "server.call"), ("pipeline.call",)),
    "wait": (("server.wait",), ()),
}


def _stamps(e) -> tuple:
    """(start, end) ns of a profiler event, as trace.read takes them."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return 1000 * e.start_us(), 1000 * (e.start_us() + e.duration_us())


def _host_spans(tracer, names) -> tuple:
    """(the start of pb.trace_begin or None, [(name, start, end)] ns of
    the host ranges named in `names`) of a stopped trace.Tracer."""
    begin, out = None, []
    for e in tracer.prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        if name in names:
            out.append((name, *_stamps(e)))
        elif name == "pb.trace_begin":
            begin = _stamps(e)[0]
    return begin, out


def program_spans(tracer) -> list:
    """[(name, start, end)] ns of the program's host spans in a stopped
    trace.Tracer, on the clock of trace.read's kernels and busy intervals."""
    from megatts2_hierspeechpp_torch.utils.profiling import SPAN_NAMES
    if tracer is None or not tracer.done:
        return []
    return _host_spans(tracer, SPAN_NAMES)[1]


def merge(intervals) -> list:
    """Sorted, disjoint [a, b) intervals covering the same points."""
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def minus(a: list, b: list) -> list:
    """a less b, both merged."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def overlap(a: list, b: list) -> int:
    """The length of a and b together, both merged."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(tr) -> list:
    """The traced stretch's device idle, merged."""
    return minus([(tr.t0, tr.t1)], merge(tr.busy))


def _cover(spans, names) -> list:
    return merge((s, e) for n, s, e in spans if n in names)


def parts(tr, spans) -> dict:
    """{part: idle ns} over PARTS and "outside" (no program span); the
    parts taken in PARTS' order, each less those before it, so that they
    add up to the idle time."""
    rest = idle(tr)
    out = {}
    for part, (inside, outside) in PARTS.items():
        piece = minus(_cover(spans, inside), _cover(spans, outside))
        out[part] = overlap(rest, piece)
        rest = minus(rest, piece)
    out["outside"] = sum(b - a for a, b in rest)
    return out


def innermost(tr, spans) -> dict:
    """{span name: idle ns} with each idle piece given to the innermost
    (shortest) program span open over it; "outside" where none is."""
    sp = [(s, e, n) for n, s, e in spans if e > s]
    cuts = sorted({t for s, e, _ in sp for t in (s, e)})
    out, gaps, j = {}, idle(tr), 0
    for a, b in zip(cuts, cuts[1:]):
        cover = [(e - s, n) for s, e, n in sp if s <= a and e >= b]
        if not cover:
            continue
        while j < len(gaps) and gaps[j][1] <= a:
            j += 1
        k, got = j, 0
        while k < len(gaps) and gaps[k][0] < b:
            got += min(b, gaps[k][1]) - max(a, gaps[k][0])
            k += 1
        name = min(cover)[1]
        out[name] = out.get(name, 0) + got
    out["outside"] = sum(b - a for a, b in gaps) - sum(out.values())
    return out


def queue_ms(stats_open: dict, stats_close: dict):
    """The mean ms from submit to the start of the serving call over the
    requests whose call started between two TTSServer.stats() snapshots
    (queue_s_sum over rows; rows equal served when nothing fails), or None
    where no row was served between them."""
    rows = stats_close["rows"] - stats_open["rows"]
    if rows <= 0:
        return None
    return 1e3 * (stats_close["queue_s_sum"] - stats_open["queue_s_sum"]) / rows


def found(run) -> dict:
    """{"spans": the program spans of run.trace's stretch, "stats": the
    run's TTSServer.stats() at its close}, each None where not found:
    looked up once among the live objects and kept on the run."""
    if "program" not in run.__dict__:
        run.program = _find(run)
    return run.program


def _find(run) -> dict:
    from portbench.harness.trace import Tracer
    from megatts2_hierspeechpp_torch.infer.server import TTSServer
    try:
        from megatts2_hierspeechpp_torch.utils.profiling import SPAN_NAMES
    except ImportError:
        SPAN_NAMES = None
    tracers, servers = [], []
    for o in gc.get_objects():
        kind = type(o)
        if issubclass(kind, Tracer):
            tracers.append(o)
        elif issubclass(kind, TTSServer):
            servers.append(o)
    out = {"spans": None, "stats": None}
    tr = getattr(run, "trace", None)
    if SPAN_NAMES is not None and tr is not None:
        for t in tracers:
            if t.done and t.prof is not None:
                begin, spans = _host_spans(t, SPAN_NAMES)
                if begin == tr.t0:
                    out["spans"] = spans
                    break
    mine = {id(c) for c in list(getattr(run, "calls", ()))
            + list(getattr(run, "traced_calls", ()))}
    for s in servers:
        calls = getattr(s.pipeline, "calls", ())
        if hasattr(s, "stats") and any(id(c) in mine for c in calls):
            out["stats"] = s.stats()
            break
    return out


def part_ms(run, part: str):
    """ms of device idle in `part` (PARTS) per traced call, or None."""
    spans = found(run)["spans"]
    if not spans or run.trace is None or not run.traced_calls:
        return None
    if "idle_parts" not in run.__dict__:
        run.idle_parts = parts(run.trace, spans)
    return run.idle_parts[part] / 1e6 / len(run.traced_calls)
