"""Find a serving cell's knee: its open loop at a list of rates, one set-up
per rate, each printed as one JSON line (latency quantiles, the backlog
at the window's close, and the late-window latency against the early).

    python3 portbench/tools/sweep.py --workload <cell> --seed <n> --seconds 20 --rates 6,8,10

The knee is the highest rate whose backlog stays bounded: the requests of
the window's last quarter wait no longer than those of its first.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench.harness import cell, traffic
    from portbench.run import cell_entry
    wl = cell_entry(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        spec = traffic.load(wl["traffic"])
        spec["rate_rps"] = rate
        res = cell.run(wl, args.seed, args.seconds, False, spec=spec,
                       log=lambda s: print(s, file=sys.stderr, flush=True))
        due = res["sent"]
        lat = sorted((s.done - s.due) for s in due if s.ok)
        quarter = args.seconds / 4
        early = [s.done - s.due for s in due if s.ok and s.req.due < quarter]
        late = [s.done - s.due for s in due if s.ok and s.req.due >= 3 * quarter]
        backlog = sum(1 for s in due if not s.done or s.done > res["t_end"])
        print(json.dumps({
            "rate_rps": rate, "requests": len(due), "failed": res["failed"],
            "p50_ms": 1e3 * lat[len(lat) // 2], "p95_ms": res["metrics"]["latency_p95_ms"]["value"],
            "early_median_ms": 1e3 * statistics.median(early or [0]),
            "late_median_ms": 1e3 * statistics.median(late or [0]),
            "backlog_at_close": backlog, "correct": res["correct"],
            "calls": len(res["calls"]),
            "rows_per_call": sum(len(c.keys) for c in res["calls"]) / max(1, len(res["calls"]))}),
            flush=True)
        del res
    return 0


if __name__ == "__main__":
    sys.exit(main())
