"""The bf16 decode kernel's multi-row launch beside its one-row launch, on
the card (csrc/plm_decode_bf16.cu, ProsodyLM at its published width, seed
99 as chip_smoke.py's plm_bf16 line):

  - one row at T = 500 (chip_smoke's latent): ms, a hash of its codes, us a
    token by phase from the stamps (chip_smoke.plm_split_bf16);
  - MAX_ROWS rows at T = 500 and 800: each row's codes against its own
    one-row launch (bit for bit), ms, and the same stamp split;
  - `models/plm.decode` of 8 rows at T = 800 (a `tts_batch` call of the
    batch cell): ms, launches and rows a launch (cuda_lib.ROWS).

It imports the package of the current directory, so a parent tree is
timed by the same script from the parent's root; `--one-row` keeps to
what a one-row kernel has. Run from a tree's root:

    python3 tools/bench_plm_rows.py [--one-row] [--reps 5] [--out FILE]
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--one-row", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from megatts2_hierspeechpp_torch.models.plm import ProsodyLM, decode
    from megatts2_hierspeechpp_torch.ops import cuda_lib
    from megatts2_hierspeechpp_torch.ops.plm_decode import plm_decode_greedy

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    model = ProsodyLM(seed=99, device=dev)
    w, go = model.packed(), model.go_id
    gen = torch.Generator().manual_seed(5)
    line = {"tree": os.getcwd(), "card": card(), "torch": torch.__version__}
    with torch.inference_mode():
        tc = torch.randn(1, 500, 256, generator=gen).to(dev)
        codes = plm_decode_greedy(w, tc, go)
        line["one_row"] = {
            "T": 500,
            "ms": chip_smoke.time_ms(torch, lambda: plm_decode_greedy(w, tc, go),
                                     args.reps),
            "codes_sha1": hashlib.sha1(codes.cpu().numpy().tobytes()).hexdigest(),
            "split": chip_smoke.plm_split_bf16(torch, w, tc, go)}
        if not args.one_row:
            from megatts2_hierspeechpp_torch.ops.plm_decode import MAX_ROWS

            line["rows"] = []
            for t in (500, 800):
                tcb = torch.randn(MAX_ROWS, t, 256, generator=gen).to(dev)
                got = plm_decode_greedy(w, tcb, go)
                one = torch.cat([plm_decode_greedy(w, tcb[i:i + 1], go)
                                 for i in range(MAX_ROWS)])
                ms = chip_smoke.time_ms(torch, lambda: plm_decode_greedy(w, tcb, go),
                                        args.reps)
                ms1 = chip_smoke.time_ms(torch, lambda: plm_decode_greedy(
                    w, tcb[:1], go), args.reps)
                line["rows"].append({
                    "T": t, "rows": MAX_ROWS, "ms": ms, "one_row_ms": ms1,
                    "rows_equal_one_row": [bool(torch.equal(got[i], one[i]))
                                           for i in range(MAX_ROWS)],
                    "split": chip_smoke.plm_split_bf16(torch, w, tcb, go)})
        tc8 = torch.randn(8, 800, 256, generator=gen).to(dev)
        decode(model, tc8)
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        decode(model, tc8)
        torch.cuda.synchronize()
        launches = cuda_lib.LAUNCHES["plm_decode_bf16"]
        rows = getattr(cuda_lib, "ROWS", {}).get("plm_decode_bf16")
        line["decode_8x800"] = {
            "ms": chip_smoke.time_ms(torch, lambda: decode(model, tc8), args.reps),
            "launches": launches, "rows": rows,
            "rows_per_launch": None if rows is None else rows / launches}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    bad = [r for r in line.get("rows", []) if not all(r["rows_equal_one_row"])]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
