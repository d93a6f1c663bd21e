"""Where a traced run's device idle falls among the program's spans.

    python3 portbench/tools/idle_spans.py --workload <cell> --seeds 1,2,3 --seconds 51

Each seed runs the cell once with --trace 1 and prints one JSON line: the
result line's per-layer metrics and device, the traced stretch's idle ms
per traced call by part (harness/gaps.PARTS, with "outside": no program
span) and by innermost span, how far the parts' sum falls from the idle
time, the server's queue wait over the window from its own counters
(TTSServer.stats), the kernels named like a program span (none where the
spans' device-side annotations are kept out of the kernels), and the host
seconds of the traced calls (pb.call) and of every call of the window.

The harness's trace.read keeps no program span and cell.run takes no
snapshot of the server's counters, so this tool takes both itself: it
wraps trace.read, trace.Tracer (made at the window's open in a traced run)
and the server's close, in its own process.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def instrument(trace_mod, gaps_mod) -> dict:
    """Wrap the harness so that each run leaves its program spans and its
    server counters at the window's open and at the close in the dict
    returned (keys spans, open, close), anew for every run."""
    import megatts2_hierspeechpp_torch.infer.server as server_mod
    got = {}
    base = server_mod.TTSServer
    read, tracer_init = trace_mod.read, trace_mod.Tracer.__init__

    class Server(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            got.clear()
            got["server"] = self

        def close(self):
            super().close()
            got["close"] = self.stats()

    def init(self, *a, **kw):
        tracer_init(self, *a, **kw)
        if "server" in got:
            got["open"] = got["server"].stats()

    def read_spans(tracer):
        got["spans"] = gaps_mod.program_spans(tracer)
        return read(tracer)

    server_mod.TTSServer = Server
    trace_mod.Tracer.__init__ = init
    trace_mod.read = read_spans
    return got


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench.harness import cell, gaps, trace
    from portbench.run import cell_entry, result_line
    from megatts2_hierspeechpp_torch.utils.profiling import SPAN_NAMES
    wl = cell_entry(args.workload)
    got = instrument(trace, gaps)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = cell.run(wl, seed, args.seconds, True,
                       log=lambda s: print(s, file=sys.stderr, flush=True))
        tr = res["trace"]
        spans = got.get("spans", [])
        device = {"kind": torch.cuda.get_device_name(0)}
        line = {"seed": seed, **result_line(res, wl, True, device)}
        calls = [(e - s) / 1e9 for n, s, e in tr.spans if n == "pb.call"] if tr else []
        n = len(calls)
        idle = sum(b - a for a, b in gaps.idle(tr)) if tr else 0
        line["traced_calls"] = n
        line["traced_call_s_mean"] = statistics.fmean(calls) if calls else None
        line["call_s_mean"] = statistics.fmean([c.t1 - c.t0 for c in res["calls"]])
        line["idle_ms_per_call"] = idle / 1e6 / n if n else None
        line["span_named_kernels"] = sum(k[0] in SPAN_NAMES for k in tr.kernels) if tr else None
        if "open" in got and "close" in got:
            line["server_queue_ms"] = gaps.queue_ms(got["open"], got["close"])
        if spans and n:
            parts = gaps.parts(tr, spans)
            line["parts_ms_per_call"] = {k: v / 1e6 / n for k, v in parts.items()}
            line["parts_sum_error"] = (sum(parts.values()) - idle) / idle if idle else 0.0
            line["innermost_ms_per_call"] = {
                k: v / 1e6 / n for k, v in sorted(gaps.innermost(tr, spans).items(),
                                                  key=lambda kv: -kv[1])}
            line["spans_per_call"] = len(spans) / n
        print(json.dumps(line), flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
