"""Multi-process dry runs of the data-parallel trainers and the
tensor-parallel decode, and the process launcher they share.

Counterpart of `__graft_entry__.dryrun_multichip` (one step of each
trainer on an n-device mesh, then a tensor-parallel PLM decode) and of
`tools/smoke_distributed.py` (a cross-process all-reduce). The rank
functions live here so that spawned ranks import only torch and this
package.

`spawn(fn, world, args)` starts `world` processes (the spawn method), each
joining a process group through a FileStore in a fresh directory, runs
`fn(rank, world, *args)` in each and returns the ranks' results in rank
order; a rank's exception is raised in the caller with its traceback, and
every process is ended before it returns.

  python -m megatts2_hierspeechpp_torch.parallel.dryrun [--world 2] [--device cpu]

The ranks run on the card (every rank on cuda:0, over gloo) unless the
caller asks for the CPU; without CUDA the card default raises.
"""
from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.parallel import mesh


def _rank_main(fn, rank: int, world: int, store_path: Optional[str],
               timeout: float, args: tuple, results) -> None:
    try:
        torch.set_num_threads(2)   # several ranks share the host's cores
        if store_path is not None:
            dist.init_process_group(
                "gloo", store=dist.FileStore(store_path, world), rank=rank,
                world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 (reported to the caller, re-raised there)
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, args: tuple = (), timeout: float = 900.0,
          store_dir: Optional[str] = None, init_group: bool = True) -> List:
    """fn(rank, world, *args) in `world` spawned processes of one gloo
    process group (gloo also takes CUDA tensors, so several ranks may share
    one card); returns the results in rank order. `fn` and `args`
    are pickled: fn must be importable by name. With init_group False, fn
    starts the group itself (as a CLI under torchrun does). Raises
    RuntimeError with the failing ranks' tracebacks, TimeoutError after
    `timeout` seconds."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dist_", dir=store_dir)
    store = os.path.join(tmp, "store") if init_group else None
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, timeout, args, results))
             for r in range(world)]
    got: Dict[int, object] = {}
    errors: Dict[int, str] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(got) + len(errors) < world:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    if errors:   # the others wait on the failed rank
                        break
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))}"
                                       f" did not finish in {timeout} s")
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in errors
                        and r not in got]
                for r in dead:
                    errors[r] = f"rank {r} exited with {procs[r].exitcode}"
                if errors:   # a rank is gone: the others may wait forever
                    deadline = min(deadline, time.monotonic() + 10)
                continue
            (got if ok else errors)[rank] = payload
            if errors:
                deadline = min(deadline, time.monotonic() + 10)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("\n".join(f"--- rank {r} ---\n{e}"
                                     for r, e in sorted(errors.items())))
    return [got[r] for r in range(world)]


def digest(module: torch.nn.Module) -> str:
    """sha256 of every parameter and buffer's bytes, in state_dict order:
    equal digests on two ranks mean bitwise-equal state."""
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


# ---------- rank functions ----------


def allreduce_smoke(rank: int, world: int, device: str = "cuda") -> float:
    """Each rank holds row (rank + 1) of a global (world, 8) array; the
    gather of the rows and its sum are checked on every rank (the
    all-reduce smoke of tools/smoke_distributed.py)."""
    local = torch.full((1, 8), rank + 1.0, device=resolve_device(device))
    with mesh.global_batch():
        rows = mesh.gather_rows(local)
        total = float(mesh.batch_sum(local.sum()))
    want = 8.0 * world * (world + 1) / 2
    assert torch.equal(rows[:, 0].cpu(), torch.arange(1.0, world + 1.0))
    assert total == want, (total, want)
    return total


def s2_batch(b: int, n: int = 6, mel_len: int = 16, seed: int = 0) -> dict:
    """An s2 batch of b rows (the dry run's `_s2_batch`), row i's valid
    frames mel_len - 3 i (at least 8), so the ranks' mask sums differ."""
    rng = np.random.default_rng(seed)
    dur = np.zeros((b, n), np.float32)
    lens = np.maximum(mel_len - 3 * np.arange(b), 8).astype(np.int32)
    for i in range(b):
        d = rng.integers(1, 6, n).astype(np.float32)
        d = np.floor(d * (2 * lens[i]) / d.sum())
        d[0] += 2 * lens[i] - d.sum()
        dur[i] = d
    frame = (np.arange(mel_len)[None] < lens[:, None]).astype(np.float32)
    return {
        "x_ids": rng.integers(0, 40, (b, n)),
        "tone": rng.integers(0, 10, (b, n)),
        "language": rng.integers(0, 3, (b, n)),
        "x_lengths": np.full((b,), n, np.int32),
        "w2v": rng.standard_normal((b, mel_len, 1024)).astype(np.float32)
        * frame[..., None],
        "w2v_lengths": lens,
        "mel": rng.standard_normal((b, mel_len, 80)).astype(np.float32)
        * frame[..., None],
        "mel_lengths": lens,
        "pitch": np.abs(rng.standard_normal((b, mel_len * 4))).astype(np.float32)
        * np.repeat(frame, 4, 1),
        "pitch_lengths": 4 * lens,
        "dur": dur,
        "mrte_mel": rng.standard_normal((b, 24, 80)).astype(np.float32),
        "mrte_mel_lengths": np.full((b,), 24, np.int32),
    }


def vocoder_batch(b: int, t: int = 16, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    lens = np.maximum(t - 3 * np.arange(b), 8)
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.float32)[..., None]
    return {
        "spec": np.abs(rng.standard_normal((b, t, 641))).astype(np.float32) * mask,
        "audio": rng.uniform(-0.5, 0.5, (b, 320 * t)).astype(np.float32),
        "mel": rng.standard_normal((b, t, 80)).astype(np.float32) * mask,
        "w2v": rng.standard_normal((b, t, 1024)).astype(np.float32) * mask,
        "f0": np.abs(rng.standard_normal((b, 4 * t))).astype(np.float32) * 100,
        "mask": mask,
        "lengths": lens.astype(np.int64),
    }


def ar_batch(b: int, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "x_ids": rng.integers(0, 40, (b, 8)).astype(np.int64),
        "x_lens": np.maximum(8 - np.arange(b), 5).astype(np.int64),
        "y_ids": rng.integers(0, 32, (b, 8)).astype(np.int64),
        "y_lens": np.maximum(8 - 2 * np.arange(b), 4).astype(np.int64),
        "bert_feature": np.zeros((b, 8, 1024), np.float32),
    }


def _rows(batch: dict, rank: int, world: int, device) -> dict:
    n = next(iter(batch.values())).shape[0] // world
    return {k: torch.from_numpy(np.ascontiguousarray(v[rank * n:(rank + 1) * n]))
            .to(device) for k, v in batch.items()}


def _finite(metrics: dict) -> dict:
    vals = {k: float(v) for k, v in metrics.items()}
    bad = {k: v for k, v in vals.items() if not np.isfinite(v)}
    if bad:
        raise FloatingPointError(f"non-finite metrics {bad}")
    return vals


def dryrun_steps(rank: int, world: int, device: str = "cuda",
                 rows: int = 1) -> dict:
    """One step each of s2, s1, the vocoder and AR (grad_accum 2: two
    micro-steps, one update) on `rows` rows per rank of a global batch,
    small models seeded alike on every rank. Returns each trainer's
    metrics and the digest of its state after the step."""
    from megatts2_hierspeechpp_torch.ar import trainer as ar_trainer
    from megatts2_hierspeechpp_torch.ar.scaled_adam import ScaledAdam
    from megatts2_hierspeechpp_torch.ar.t2s import Text2Semantic
    from megatts2_hierspeechpp_torch.models.discriminators import (
        MultiPeriodDiscriminator,
        MultiResSpecDiscriminator,
    )
    from megatts2_hierspeechpp_torch.models.plm import ProsodyLM
    from megatts2_hierspeechpp_torch.models.ttv import TTVModel
    from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder
    from megatts2_hierspeechpp_torch.train import s1, s2
    from megatts2_hierspeechpp_torch.train import vocoder as voc
    from megatts2_hierspeechpp_torch.train.loop import step_generator

    device = resolve_device(device)
    n = rows * world
    out = {}
    ttv_kw = dict(n_vocab=40, n_tone=10, n_language=3, text_layers=1,
                  mel_enc_layers=1, w2v_enc_layers=1, w2v_dec_layers=2,
                  device=device)
    ttv = TTVModel(**ttv_kw, seed=0, train=True)
    st = s2.create_state(ttv, MultiResSpecDiscriminator(seed=1, device=device),
                         lr=1e-4, steps_per_epoch=10)
    st, m = s2.TrainStep()(st, _rows(s2_batch(n), rank, world, device),
                           step_generator(1, 0, 0))
    out["s2"] = {"metrics": _finite(m), "digest": digest(st.ttv) + digest(st.disc)}

    frozen = TTVModel(**ttv_kw, seed=0)
    frozen.load_state_dict(st.ttv.state_dict())
    plm = ProsodyLM(n_layers=2, seed=2, device=device, train=True)
    s1_state = s1.create_state(plm, frozen, lr=1e-4, steps_per_epoch=10)
    s1_state, m = s1.TrainStep()(s1_state, _rows(s2_batch(n), rank, world,
                                                 device), step_generator(1, 0, 1))
    out["s1"] = {"metrics": _finite(m), "digest": digest(s1_state.plm)}

    gen = HierVocoder(upsample_initial_channel=64, posterior_wn_layers=4,
                      n_flows=1, flow_layers=1, seed=4, device=device,
                      train=True)
    mpd = MultiPeriodDiscriminator(((256, 64, 256), (128, 32, 128)), (2, 3),
                                   seed=5, device=device)
    vs = voc.create_state(gen, mpd, lr=1e-4, steps_per_epoch=10)
    vs, m = voc.TrainStep(segment_frames=8)(
        vs, _rows(vocoder_batch(n), rank, world, device),
        step_generator(1, 0, 2))
    out["vocoder"] = {"metrics": _finite(m),
                      "digest": digest(vs.gen) + digest(vs.disc)}

    t2s = Text2Semantic(hidden_dim=64, embedding_dim=64, n_heads=2,
                        n_layers=1, vocab_size=33, phoneme_vocab_size=40,
                        seed=6, device=device, train=True)
    ar = ar_trainer.create_state(t2s, ScaledAdam(t2s.parameters(), lr=1e-3))
    step = ar_trainer.TrainStep(grad_accum=2)
    for i in range(2):
        ar, m = step(ar, _rows(ar_batch(n, seed=3 + i), rank, world, device),
                     step_generator(1, 0, 3 + i))
    out["ar"] = {"metrics": _finite(m), "digest": digest(ar.model)}
    return out


def tp_decode_check(rank: int, world: int, device: str = "cuda",
                    t: int = 24) -> dict:
    """The tensor-parallel ProsodyLM decode (greedy and top-k 5) and the
    sharded teacher-forced loss against the one-card ones, on every rank:
    the sharded decode is the plain float32 loop, so its one-card greedy
    reference names float32 weights and cache (on the card the float32
    kernel, not the bf16 serving default). Returns the codes and the
    losses."""
    from megatts2_hierspeechpp_torch.models.plm import ProsodyLM, decode
    from megatts2_hierspeechpp_torch.ops.plm_decode import plain_decode
    from megatts2_hierspeechpp_torch.parallel.tp import row_sum, shard_module

    device = resolve_device(device)
    plm = ProsodyLM(n_layers=2, seed=7, device=device)
    tc = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, t, 256)).astype(np.float32)).to(device)
    shard = shard_module(plm, rank, world)
    w = shard.packed()
    greedy = plain_decode(w, tc, shard.go_id, row_sum=row_sum)
    topk = plain_decode(w, tc, shard.go_id, top_k=5, row_sum=row_sum,
                        generator=torch.Generator(device).manual_seed(3))
    lens = torch.tensor([t, t - 5], device=device)
    codes = greedy.long()
    with torch.no_grad():
        loss = float(shard.loss_dict(tc, codes, lens)["loss"])
        want_loss = float(plm.loss_dict(tc, codes, lens)["loss"])
    f32 = dict(weight_dtype=torch.float32, cache_dtype=torch.float32)
    want = torch.cat([decode(plm, tc[i:i + 1], **f32) for i in range(2)])
    want_topk = decode(plm, tc, top_k=5,
                       generator=torch.Generator(device).manual_seed(3))
    return {"greedy_equal": bool(torch.equal(greedy, want)),
            "topk_equal": bool(torch.equal(topk, want_topk)),
            "loss": loss, "want_loss": want_loss}


def dryrun_multichip(world: int = 2, device: str = "cuda",
                     store_dir: Optional[str] = None) -> dict:
    """One step of each of s2, s1, the vocoder and AR on `world` ranks,
    every rank's state bitwise equal after it, and the tensor-parallel
    decode at world 2 equal to the one-card decode; gloo, on `device`
    (every rank on the same card when it is "cuda")."""
    resolve_device(device)   # raises here, before any rank starts
    smoke = spawn(allreduce_smoke, world, (device,), store_dir=store_dir)
    steps = spawn(dryrun_steps, world, (device,), store_dir=store_dir)
    for kind in steps[0]:
        digests = {s[kind]["digest"] for s in steps}
        if len(digests) != 1:
            raise AssertionError(f"{kind}: ranks hold different states")
    tp = spawn(tp_decode_check, 2, (device,), store_dir=store_dir)
    for r in tp:
        if not (r["greedy_equal"] and r["topk_equal"]):
            raise AssertionError(f"tensor-parallel codes differ: {r}")
        if abs(r["loss"] - r["want_loss"]) > 1e-5 * abs(r["want_loss"]):
            raise AssertionError(f"tensor-parallel loss differs: {r}")
    return {"allreduce": smoke[0],
            "metrics": {k: v["metrics"] for k, v in steps[0].items()},
            "tp": tp[0]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.world, args.device)))


if __name__ == "__main__":
    main()
