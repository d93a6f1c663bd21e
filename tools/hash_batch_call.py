"""One `tts_batch` call at the shape of the benchmark's batch cell, hashed:
the pipeline, its weights and the voices built from `--seed` as
portbench/run.py builds them for `tts48k_bf16.batch_long`, the length
scale calibrated as there, then 8 rows of one voice (texts of 7-13 s of
speech), whose waveforms are hashed (SHA-1 of the float32 samples in row
order) and the call timed on the host clock around a synchronize.

It imports the package of the current directory, so two trees (a parent
and a change) are compared by running it from each tree's root:

    python3 tools/hash_batch_call.py [--seed N] [--calls 3]
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=5550001234)
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from portbench.harness import cell, program, traffic, weights

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    name = "tts48k_bf16.batch_long"
    bench = json.load(open("BENCHMARK.json"))
    work = next(w for w in bench["workloads"] if w["name"] == name)
    cfg = cell.read_json(cell.CONFIG_DIR / f"{work['config']}.json")
    spec = traffic.load(work["traffic"])
    tr = traffic.make(spec, args.seed, 51.0)
    pipe = program.build(cfg, weights.draw_all(cfg, args.seed, dev), dev)
    prompts = [pipe.prepare_prompt(a, bucket=True) for a in tr.prompts]
    rec = program.Recorder(pipe, {id(p): v for v, p in enumerate(prompts)},
                           time.perf_counter)
    cal = spec["calibration"]
    ls, voice_frames = cell.calibrate(rec, tr.calibration_texts, prompts,
                                      cal["frames"], cal["tol"])
    traffic.set_rates(tr, voice_frames, cal["frames"] / cal["seconds"])
    rng = traffic.rng_for(args.seed, 8)
    texts = [traffic.tts_text(rng, float(s), tr.rates[0], spec["phrase_syllables"])
             for s in np.linspace(7.0, 13.0, 8)]
    kw = dict(output_sr=spec["output_sr"], length_scale=ls,
              seed=args.seed % (2 ** 31))
    times, digests = [], set()
    for _ in range(args.calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs = pipe.tts_batch(texts, prompt=prompts[0], **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        h = hashlib.sha1()
        for w in wavs:
            h.update(np.asarray(w, dtype=np.float32).tobytes())
        digests.add(h.hexdigest())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tree": os.getcwd(), "card": card, "seed": args.seed,
                      "rows": len(texts), "frames": [len(w) // 960 for w in wavs],
                      "audio_s": sum(len(w) for w in wavs) / spec["output_sr"],
                      "call_s": times, "sha1": sorted(digests)}), flush=True)
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
