#!/usr/bin/env python3
"""The bf16 tail of the AMPBlock triple (csrc/triple_post_bf16.cu) alone on
one CUDA card, at the launch shapes of its paths, against its plain
version and, optionally, beside the tail it replaced.

    python3 tools/bench_tail_bf16.py [--parent DIR] [--out FILE]

For each (B, T, C) of SHAPES (bench.py's bf16 SpeechSR-48k and Generator
tails at B = 4 x 1000 frames, the vocoder CLI's eval and training step at
B = 32, the B = 1 serving shapes of chip_smoke.py's kernel_bf16 lines),
chip_smoke.py's tail_bf16_line: the kernel's largest error against
composed_epilogue (gate 2^-8 x max|plain|), its plan, device ms per launch
(torch.profiler), the bytes bound, a copy of the same bytes and, at the
first four shapes, its segment sweep. With --parent, DIR is a tree whose
megatts2_hierspeechpp_torch/csrc/triple_epilogue.cu still has the bf16
instantiation of triple_post_kernel (its entry point taking a y_bytes
argument), such as the parent of the commit that added this kernel
(`git archive <parent> megatts2_hierspeechpp_torch/csrc | tar -x -C DIR`):
that file is compiled alone and its bf16 tail timed on the same inputs in
turns with the kernel (parent, kernel, kernel, parent), held to the same
gate, in a "tail_bf16_parent" line. Every line is also appended to
--out; the card's name and power limit come first. Needs a card; imports
no JAX.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = ((4, 960000, 32), (4, 320000, 16), (32, 61440, 16),
          (32, 10240, 16), (1, 160000, 16), (1, 480000, 32))


def parent_tail(parent: Path, build: Path):
    """The tail entry point of the parent tree's triple_epilogue.cu,
    compiled alone: fn(r0, r1, r2, alpha, inv_beta, w7, y, B, T, C, tile,
    smem_bytes, stamps, y_bytes, stream)."""
    from megatts2_hierspeechpp_torch.ops import cuda_lib

    src = parent / "megatts2_hierspeechpp_torch" / "csrc" / "triple_epilogue.cu"
    build.mkdir(parents=True, exist_ok=True)
    so = build / "libparent_tail.so"
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True)
    fn = ctypes.CDLL(str(so)).triple_post_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [i] * 5 + [p, i, p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "tail_bf16.jsonl")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_tail_bf16: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from megatts2_hierspeechpp_torch.ops import amp_triple, cuda_lib

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cuda_lib.lib()
    parent = (parent_tail(args.parent, ROOT / "build" / "parent_tail")
              if args.parent else None)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(18)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def emit(line):
        with args.out.open("a") as f:
            f.write(json.dumps(dict(line, card=card)) + "\n")

    for b, t, c in SHAPES:
        rs = [randn(b, t, c, scale=3.0) for _ in range(3)]
        post = (torch.exp(randn(c, scale=0.2)), torch.exp(randn(c, scale=0.2)),
                randn(7, c, scale=0.1 * (7 * c) ** -0.5))
        emit(cs.tail_bf16_line(torch, rs, post, "tail_bf16", "bench_tail_bf16"))
        if parent is None:
            continue
        with torch.inference_mode():
            ref = amp_triple.composed_epilogue(*rs, post)
            plan = amp_triple.epilogue_plan(b, t, c)
            yp = torch.empty((b, t, 1), device=dev, dtype=torch.bfloat16)

            def old():
                err = parent(*map(cuda_lib.ptr, (*rs, *post, yp)), b, t, c,
                             plan["tile"], plan["smem"], None, 2,
                             cuda_lib.stream(dev))
                if err:
                    raise RuntimeError(f"parent triple_post_fwd: cudaError {err}")
                return yp

            def new():
                return amp_triple.fused_epilogue(*rs, post, torch.bfloat16)

            scale = ref.abs().max().item()
            err = (old().float() - ref).abs().max().item()
            turns = [cs.device_ms(torch, *((old, ("triple_post_kernel",))
                                          if arm == "parent" else
                                          (new, ("triple_post_bf16_kernel",))),
                                  args.reps)
                     for arm in ("parent", "kernel", "kernel", "parent")]
        line = {"phase": "tail_bf16_parent", "shape": f"B={b} T={t} C={c}",
                "parent_max_abs_err": err, "max_abs_ref": scale,
                "parent_tile": plan["tile"],
                "parent_device_ms": [turns[0], turns[3]],
                "device_ms": [turns[1], turns[2]]}
        print(json.dumps(line), flush=True)
        emit(line)
        if not err <= cs.BF16_MARGIN * scale:
            cs.fail(f"parent tail {line['shape']}: max abs err {err}")
        del rs, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
