"""Run one cell of BENCHMARK.json once on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, with --trace 1 a breakdown, and
last the numbers compared with their limits (checks), which also end
standard error. Exits non-zero with no result line when CUDA or enough
cards are missing, when the port is absent, or when jax, jaxlib, flax or
the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "megatts2_hierspeechpp_tpu")


def process_start() -> float:
    """The process's start on the perf_counter clock (/proc: its start
    time in clock ticks after boot against the uptime now), else the
    start of this module."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return min(_T_START, time.perf_counter() - (uptime - started))
    except (OSError, ValueError, IndexError):
        return _T_START


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_entry(name: str) -> dict:
    """The workload entry of BENCHMARK.json with the metric entries that
    the cell reports (those without a workloads list, or listing it)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    own = lambda m: name in m.get("workloads", [name])  # noqa: E731
    return dict(cells[name], end_to_end=[m for m in bench["end_to_end"] if own(m)],
                per_layer=[m for m in bench["per_layer"] if own(m)])


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def result_line(res: dict, cell: dict, traced: bool, device: dict) -> dict:
    """The last line's object: correct, attempted, failed, the cell's
    end-to-end (or, traced, per-layer) metrics, device (traced: with
    busy_s, window_s) and breakdown, and last the compared numbers."""
    from portbench.harness import trace

    names = {m["name"] for m in (cell["per_layer"] if traced else cell["end_to_end"])}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"],
           "metrics": {k: v for k, v in res["metrics"].items() if k in names},
           "device": device}
    tr = res["trace"]
    if traced and tr is not None:
        device["busy_s"] = trace.union_ns(tr.busy, tr.t0, tr.t1) / 1e9
        device["window_s"] = (tr.t1 - tr.t0) / 1e9
        by_name = {}
        for name, s, e in tr.kernels:
            by_name[name[:160]] = by_name.get(name[:160], 0.0) + (e - s) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(trace.idle_gaps(tr).items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [list(x) for x in top],
                            "idle_gaps": [list(x) for x in gaps]}
    out["checks"] = res["checks"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = process_start()
    cell = cell_entry(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    from portbench.harness import cell as cell_lib

    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    res = cell_lib.run(cell, args.seed, args.seconds, bool(args.trace),
                       device="cuda", process_start=started, log=log)
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the port must not load: {found}", file=sys.stderr)
        return 4

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": res["memory_peak_bytes"],
              "power_limit": power_limit()}
    if args.trace and res["trace"] is None:
        print("the traced stretch was not recorded", file=sys.stderr)
        return 5
    out = result_line(res, cell, bool(args.trace), device)
    for k, c in res["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
