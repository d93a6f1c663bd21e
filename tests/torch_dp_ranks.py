"""Rank functions of the data-parallel parity tests (tests/test_torch_dp_*.py).

Each runs one port train step on its rank's rows of a global batch, inside
a process group that parallel/dryrun.spawn set up, from weights given as
state_dicts, and returns numpy: the metrics, the gradients each optimizer
received (after the ranks' reduction, before any clip), and the state
after the step. This module imports torch and the port only: the spawned
ranks never import JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from megatts2_hierspeechpp_torch.nn.basic import MaskSource


def _np(t):
    return t.detach().cpu().numpy()


def _rows(batch: dict, rank: int, world: int) -> dict:
    n = next(iter(batch.values())).shape[0] // world
    return {k: torch.from_numpy(np.ascontiguousarray(v[rank * n:(rank + 1) * n]))
            for k, v in batch.items()}


def _snapshot(opt, module, store: dict, key: str) -> None:
    """Record the gradients `opt` receives, by `module`'s parameter names,
    when its step is called."""
    names = [n for n, p in module.named_parameters() if p.requires_grad]
    step = opt.step

    def recorded(*args, **kwargs):
        store[key] = {n: _np(p.grad) for n, p in zip(names, opt.params)
                      if p.grad is not None}
        return step(*args, **kwargs)

    opt.step = recorded


def _result(metrics, grads, *modules) -> dict:
    state = {}
    for prefix, m in modules:
        state.update({f"{prefix}{k}": _np(v) for k, v in m.state_dict().items()})
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "state": state}


def s2_rank(rank, world, ttv_kw, ttv_sd, disc_sd, batch, coin, masks):
    from megatts2_hierspeechpp_torch.models.discriminators import (
        MultiResSpecDiscriminator,
    )
    from megatts2_hierspeechpp_torch.models.ttv import TTVModel
    from megatts2_hierspeechpp_torch.train import s2

    ttv = TTVModel(**ttv_kw, device="cpu", train=True)
    ttv.load_state_dict(ttv_sd, strict=True)
    disc = MultiResSpecDiscriminator(device="cpu")
    disc.load_state_dict(disc_sd, strict=True)
    state = s2.create_state(ttv, disc, lr=1e-4, steps_per_epoch=10)
    grads = {}
    _snapshot(state.opt_g, ttv, grads, "g")
    _snapshot(state.opt_d, disc, grads, "d")
    src = MaskSource(masks=[torch.from_numpy(m) for m in masks])
    state, metrics = s2.TrainStep(c_mel=1.0, c_commit=100.0).with_draws(
        state, _rows(batch, rank, world), torch.tensor(coin), src)
    assert not src.masks
    return _result(metrics, grads, ("ttv.", ttv), ("disc.", disc))


def s1_rank(rank, world, ttv_kw, ttv_sd, plm_kw, plm_sd, batch, masks):
    from megatts2_hierspeechpp_torch.models.plm import ProsodyLM
    from megatts2_hierspeechpp_torch.models.ttv import TTVModel
    from megatts2_hierspeechpp_torch.train import s1

    ttv = TTVModel(**ttv_kw, device="cpu")
    ttv.load_state_dict(ttv_sd, strict=True)
    plm = ProsodyLM(**plm_kw, device="cpu", train=True)
    plm.load_state_dict(plm_sd, strict=True)
    state = s1.create_state(plm, ttv, lr=1e-4, steps_per_epoch=10)
    grads = {}
    _snapshot(state.opt, plm, grads, "g")
    src = MaskSource(masks=[torch.from_numpy(m) for m in masks])
    state, metrics = s1.TrainStep().with_draws(state, _rows(batch, rank, world),
                                               src)
    assert not src.masks
    return _result(metrics, grads, ("", plm))


def vocoder_rank(rank, world, gen_kw, gen_sd, mpd_kw, mpd_sd, batch, starts,
                 noise):
    from megatts2_hierspeechpp_torch.models.discriminators import (
        MultiPeriodDiscriminator,
    )
    from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder
    from megatts2_hierspeechpp_torch.train import vocoder as voc

    gen = HierVocoder(**gen_kw, device="cpu", train=True)
    gen.load_state_dict(gen_sd, strict=True)
    disc = MultiPeriodDiscriminator(**mpd_kw, device="cpu")
    disc.load_state_dict(mpd_sd, strict=True)
    state = voc.create_state(gen, disc, lr=1e-4, steps_per_epoch=10)
    grads = {}
    _snapshot(state.opt_g, gen, grads, "g")
    _snapshot(state.opt_d, disc, grads, "d")
    rows = _rows({"starts": starts, "noise": noise}, rank, world)
    tb = _rows(batch, rank, world)
    tb["lengths"] = tb["lengths"].long()
    state, metrics = voc.TrainStep(segment_frames=8).with_draws(
        state, tb, rows["starts"].long(), rows["noise"])
    return _result(metrics, grads, ("gen.", gen), ("disc.", disc))


def sr_rank(rank, world, sr_args, gen_sd, mpd_kw, mpd_sd, batch, step_kw):
    from megatts2_hierspeechpp_torch.models.discriminators import (
        MultiPeriodDiscriminator,
    )
    from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR
    from megatts2_hierspeechpp_torch.train import speechsr as srt

    gen = SpeechSR(*sr_args, device="cpu", train=True)
    gen.load_state_dict(gen_sd, strict=True)
    disc = MultiPeriodDiscriminator(**mpd_kw, device="cpu")
    disc.load_state_dict(mpd_sd, strict=True)
    state = srt.create_state(gen, disc, lr=1e-4, steps_per_epoch=10)
    grads = {}
    _snapshot(state.opt_g, gen, grads, "g")
    _snapshot(state.opt_d, disc, grads, "d")
    state, metrics = srt.TrainStep(**step_kw)(state, _rows(batch, rank, world))
    return _result(metrics, grads, ("gen.", gen), ("disc.", disc))


def denoiser_rank(rank, world, mp_kw, sd, spectra, clean, step_cfg,
                  local_attention=False):
    """`local_attention`: the attention left to the rank's own rows (no
    gather), the model the port must not be; the test expects it to miss
    the JAX step."""
    from megatts2_hierspeechpp_torch.models.denoiser import MPNet
    from megatts2_hierspeechpp_torch.parallel import mesh
    from megatts2_hierspeechpp_torch.train import denoiser as dnt

    if local_attention:
        mesh.gather_rows = lambda x: x
    model = MPNet(**mp_kw, device="cpu", train=True)
    model.load_state_dict(sd, strict=True)
    state = dnt.create_state(model, lr=5e-4, max_grad_norm=5.0,
                             steps_per_epoch=10)
    grads = {}
    _snapshot(state.opt, model, grads, "g")
    rows = _rows({f"s{i}": s for i, s in enumerate(spectra)} | {"clean": clean},
                 rank, world)
    state, metrics = dnt.TrainStep(*step_cfg).with_spectra(
        state, *(rows[f"s{i}"] for i in range(4)), rows["clean"])
    return _result(metrics, grads, ("", model))


def ar_rank(rank, world, t2s_kw, sd, sched, batches, grad_accum):
    from megatts2_hierspeechpp_torch.ar import trainer
    from megatts2_hierspeechpp_torch.ar.scaled_adam import (
        ScaledAdam,
        warmup_cosine_schedule,
    )
    from megatts2_hierspeechpp_torch.ar.t2s import Text2Semantic

    model = Text2Semantic(**t2s_kw, device="cpu", train=True)
    model.load_state_dict(sd, strict=True)
    state = trainer.create_state(
        model, ScaledAdam(model.parameters(), lr=warmup_cosine_schedule(*sched)))
    step = trainer.TrainStep(grad_accum=grad_accum)
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, _rows(b, rank, world),
                        torch.Generator().manual_seed(i))
        metrics.append({k: float(v) for k, v in m.items()})
    names = [n for n, _ in model.named_parameters()]
    return {"metrics": metrics, "accum_count": state.accum_count,
            "state": {n: _np(p) for n, p in model.named_parameters()},
            "mu": {n: _np(m) for n, m in zip(names, state.opt.mu)},
            "nu": {n: _np(v) for n, v in zip(names, state.opt.nu)}}


def kmeans_rank(rank, world, ttv_kw, ttv_sd, batch):
    """cli/train_s2.kmeans_init on this rank's row of `batch`: the
    codebooks it leaves."""
    from megatts2_hierspeechpp_torch.cli.train_s2 import kmeans_init
    from megatts2_hierspeechpp_torch.models.ttv import TTVModel

    ttv = TTVModel(**ttv_kw, device="cpu", train=True)
    ttv.load_state_dict(ttv_sd)
    kmeans_init(ttv, {k: v[rank:rank + 1] for k, v in batch.items()}, seed=5)
    return {k: _np(v) for k, v in ttv.quantizer.state_dict().items()}


def tp_rank(rank, world, plm_kw, plm_sd, tc, codes, lens, t2s_kw, t2s_sd,
            t2s_inputs, draws, dec_kw):
    """The rank's tensor-parallel shards of a ProsodyLM and a Text2Semantic:
    the PLM's teacher-forced loss on (tc, codes, lens), its greedy and
    top-k 5 decodes of tc (the top-k also one-card, same seed), and
    t2s_decode of t2s_inputs on the T2S shard with the Gumbel draws given;
    the shard's first in_proj_weight."""
    from megatts2_hierspeechpp_torch.ar.t2s import Text2Semantic, t2s_decode
    from megatts2_hierspeechpp_torch.models.plm import ProsodyLM, decode
    from megatts2_hierspeechpp_torch.nn.decode import FedNoise
    from megatts2_hierspeechpp_torch.ops.plm_decode import plain_decode
    from megatts2_hierspeechpp_torch.parallel.tp import row_sum, shard_module

    plm = ProsodyLM(**plm_kw, device="cpu")
    plm.load_state_dict(plm_sd, strict=True)
    shard = shard_module(plm, rank, world)
    tc, codes, lens = map(torch.from_numpy, (tc, codes, lens))
    with torch.no_grad():
        loss = float(shard.loss_dict(tc, codes, lens)["loss"])
    topk = dict(top_k=5, temperature=0.8)

    def tp_decode(**kw):   # the plain loop on the shard's weights
        return plain_decode(shard.packed(), tc, shard.go_id, row_sum=row_sum,
                            **kw)
    t2s = Text2Semantic(**t2s_kw, device="cpu")
    t2s.load_state_dict(t2s_sd, strict=True)
    t2s_shard = shard_module(t2s, rank, world)
    tokens, lengths = t2s_decode(t2s_shard, *map(torch.from_numpy, t2s_inputs),
                                 noise=FedNoise(draws), **dec_kw)
    return {"loss": loss, "greedy": _np(tp_decode()),
            "topk": _np(tp_decode(**topk, generator=torch.Generator().manual_seed(11))),
            "topk_one": _np(decode(plm, tc, **topk,
                                   generator=torch.Generator().manual_seed(11))),
            "t2s_tokens": _np(tokens), "t2s_lengths": _np(lengths),
            "in_proj_weight": _np(t2s_shard.h.layers[0].self_attn.in_proj_weight)}


def launcher_env(rank: int, world: int, port: int) -> None:
    """The variables torchrun sets for a rank on this host."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))


def env_init_rank(rank, world, port):
    """init_distributed("cpu") from the launcher's variables: the group's
    size, rank and backend, and an all-reduce across it."""
    import torch.distributed as dist

    from megatts2_hierspeechpp_torch.parallel import mesh

    launcher_env(rank, world, port)
    dev = mesh.init_distributed("cpu")
    x = torch.tensor([rank + 1.0])
    dist.all_reduce(x)
    return {"device": str(dev), "world": mesh.world(), "rank": mesh.rank(),
            "main": mesh.is_main(), "backend": dist.get_backend(),
            "sum": float(x)}


def cli_rank(rank, world, port, module, argv, attr):
    """A training CLI's main(argv) on this rank under the launcher's
    variables; the trained module `attr` of the state it returns."""
    import importlib

    launcher_env(rank, world, port)
    state = importlib.import_module(module).main(argv)
    return {k: _np(v) for k, v in getattr(state, attr).state_dict().items()}


def pad_rank(rank, world, shapes):
    """mesh.pad_to_global on this rank's arrays of the given shapes."""
    from megatts2_hierspeechpp_torch.parallel import mesh

    batch = {k: np.full(s[rank], rank + 1, np.float32) for k, s in shapes.items()}
    return {k: v for k, v in mesh.pad_to_global(batch).items()}


def bn_rank(rank, world, x, w, b):
    """GlobalBatchNorm1d on this rank's rows of x (N, C, L) inside a
    data-parallel step: the output rows, the input gradient of
    sum(out * w) (w the global weights of the output), the parameter
    gradients summed over the ranks, the running statistics."""
    from megatts2_hierspeechpp_torch.parallel import mesh

    n = x.shape[0] // world
    bn = mesh.GlobalBatchNorm1d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(b[0]))
        bn.bias.copy_(torch.from_numpy(b[1]))
    xr = torch.from_numpy(x[rank * n:(rank + 1) * n]).requires_grad_(True)
    with mesh.global_batch():
        y = bn(xr)
        (y * torch.from_numpy(w[rank * n:(rank + 1) * n])).sum().backward()
        mesh.reduce_grads(bn.parameters(), average=False)
    return {"y": _np(y), "dx": _np(xr.grad), "dw": _np(bn.weight.grad),
            "db": _np(bn.bias.grad), "mean": _np(bn.running_mean),
            "var": _np(bn.running_var)}
