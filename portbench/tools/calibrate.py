"""Readings that set a cell's limits: the program's compared numbers on
many seeds, and the control's (the reference in the next lower precision
in the program's place) on the same rows, all in one process.

    python3 portbench/tools/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 8 [--controls 3]

Each seed runs the cell once at its own load for `seconds` and prints one
JSON line: the program's numbers and, for the first `controls` seeds, the
control's.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench.harness import cell, check
    from portbench.reference.precision import control
    from portbench.run import cell_entry
    wl = cell_entry(args.workload)
    cfg = cell.read_json(cell.CONFIG_DIR / f"{wl['config']}.json")
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        res = cell.run(wl, seed, args.seconds, False,
                       log=lambda s: print(s, file=sys.stderr, flush=True))
        line = {"seed": seed, "correct": res["correct"], "failed": res["failed"],
                "program": {k: v["value"] for k, v in res["checks"].items()},
                "rows": res["detail"]}
        if i < args.controls:
            line["control"] = check.control_numbers(
                res["ref"], res["dur_rows"], res["rows"], res["prompts"], res["length_scale"],
                res["req_seed"], cfg["dur_err_quantile"], control(cfg))
        print(json.dumps(line), flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
