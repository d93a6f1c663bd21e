"""The decode the port serves against the decode the JAX package serves, on
the CPU.

The JAX `decode` sends a B = 1 greedy decode on the accelerator to its
kernel at the kernel's defaults, bf16 weights and bf16 KV cache
(`pallas_plm_decode.plm_decode_greedy`); its CPU path and sampling are the
float32 scan. The port's `plm_decode_greedy` takes the same defaults, and
`models/plm.decode` routes a greedy decode on a card to it with those
defaults, a bf16 batch in groups of MAX_ROWS rows (other dtypes one row a
call), the CPU and sampling to the float32 plain loop; an explicit dtype
holds on either route. A tensor on the meta device stands
for one on a card where only the route is checked.

Small configuration as tests/test_torch_plm.py: ProsodyLM(n_layers=2,
tc_latent_dim=44). Codes are compared exactly where both sides run the
same loop in the same dtypes; against the JAX kernel in interpret mode a
code may flip only at a near tie (teacher-forced gap <= 1e-3 x max|logits|,
as tests/test_torch_plm.py holds the bf16 twin).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_plm_serving.py -q
"""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megatts2_hierspeechpp_torch.models import plm as tplm
from megatts2_hierspeechpp_torch.ops import cuda_lib
from megatts2_hierspeechpp_torch.ops import plm_decode as tdec
from megatts2_hierspeechpp_tpu.ops import pallas_plm_decode as jdec
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_plm import _tc, plms  # noqa: F401  (fixture)

DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
BF, F32 = torch.bfloat16, torch.float32


def _defaults(fn, *names):
    sig = inspect.signature(fn).parameters
    return tuple(sig[n].default for n in names)


def test_kernel_defaults_equal_the_jax_kernels():
    """The fault this guards: the port's kernel wrapper defaulted to
    float32 while the JAX kernel, which JAX's decode serves, is bf16."""
    names = ("weight_dtype", "cache_dtype")
    want = tuple(DTYPES[d] for d in _defaults(jdec.plm_decode_greedy, *names))
    assert want == (BF, BF)
    assert _defaults(tdec.plm_decode_greedy, *names) == want
    assert _defaults(tdec.phase_stamps, *names) == want
    # the plain loop stays float32: the counterpart of the JAX scan
    assert _defaults(tdec.plain_decode, *names) == (F32, F32)
    assert _defaults(tdec.plain_gap, *names) == (F32, F32)
    assert _defaults(tplm.decode, *names) == (None, None)


def test_wrapper_on_cpu_is_its_bf16_twin(plms):
    """On a CPU tensor the wrapper at its defaults is the bf16 plain twin
    (not the float32 loop), and counts no launch."""
    _, _, tm = plms
    w = tm.packed()
    tc = torch.from_numpy(_tc(29, 12))
    cuda_lib.reset_launches()
    got = tdec.plm_decode_greedy(w, tc, tm.go_id)
    assert torch.equal(got, tdec.plain_decode(w, tc, tm.go_id,
                                              weight_dtype=BF, cache_dtype=BF))
    assert tdec.plain_gap(w, tc, got, tm.go_id, BF, BF)[0] == 0
    assert sum(cuda_lib.LAUNCHES.values()) == 0


def test_wrapper_defaults_match_the_jax_kernel_defaults(plms):
    """Both kernels at their own defaults on one latent: the port's (its
    bf16 twin on the CPU) against the JAX kernel in interpret mode."""
    _, params, tm = plms
    t = 24
    tc = _tc(t, 13)
    want = np.array(jdec.plm_decode_greedy(params, jnp.asarray(tc), n_layers=2,
                                           n_heads=4, chunk=8, interpret=True))
    got = tdec.plm_decode_greedy(tm.packed(), torch.from_numpy(tc), tm.go_id)
    gap, scale = tdec.plain_gap(tm.packed(), torch.from_numpy(tc),
                                torch.from_numpy(want), tm.go_id, BF, BF)
    assert gap <= 1e-3 * scale, (gap, scale)
    assert (got.numpy() == want).mean() >= 0.9


def test_decode_on_cpu_is_the_float32_loop(plms):
    """The CPU route: greedy row by row and sampling in float32, as the
    JAX CPU scan; an explicit bf16 pair runs the bf16 twin."""
    _, _, tm = plms
    w = tm.packed()
    tc = torch.from_numpy(_tc(17, 14, b=2))
    rows = [tdec.plain_decode(w, tc[i:i + 1], tm.go_id) for i in range(2)]
    assert torch.equal(tplm.decode(tm, tc), torch.cat(rows))
    got = tplm.decode(tm, tc, weight_dtype=BF, cache_dtype=BF)
    assert torch.equal(got, torch.cat([tdec.plain_decode(
        w, tc[i:i + 1], tm.go_id, weight_dtype=BF, cache_dtype=BF)
        for i in range(2)]))
    draw = tplm.decode(tm, tc, top_k=4, generator=torch.Generator().manual_seed(5))
    assert torch.equal(draw, tdec.plain_decode(
        w, tc, tm.go_id, 4, generator=torch.Generator().manual_seed(5)))


class _Spy:
    """Stands in for a function: records its keyword dtypes, returns
    zero codes of the latent's length."""

    def __init__(self):
        self.calls = []

    def __call__(self, w, tc, go_id=1024, *args, **kw):
        self.calls.append((tuple(tc.shape), args, kw))
        return torch.zeros(tc.shape[0], tc.shape[1], dtype=torch.int32)


@pytest.mark.parametrize("b", [1, 3])
def test_card_route_is_the_kernel_per_row_at_its_defaults(plms, monkeypatch, b):
    """A greedy decode off the CPU calls the kernel wrapper and passes no
    dtype, so the wrapper's bf16 defaults hold: a batch of up to MAX_ROWS
    rows in one call (each row decoded as JAX decodes a B = 1 request, its
    codes its own one-row launch's); an explicit float32 pair is passed on,
    one row a call; sampling never reaches the wrapper."""
    _, _, tm = plms
    kernel, plain = _Spy(), _Spy()
    monkeypatch.setattr(tplm, "plm_decode_greedy", kernel)
    monkeypatch.setattr(tplm, "plain_decode", plain)
    tc = torch.from_numpy(_tc(11, 15, b=b)).to("meta")
    assert tplm.decode(tm, tc).shape == (b, 11)
    assert kernel.calls == [((b, 11, 44), (), {})]
    kernel.calls.clear()
    tplm.decode(tm, tc, weight_dtype=F32, cache_dtype=F32)
    assert kernel.calls == [((1, 11, 44), (), {"weight_dtype": F32,
                                              "cache_dtype": F32})] * b
    kernel.calls.clear()
    tplm.decode(tm, tc, top_k=5)
    assert kernel.calls == [] and len(plain.calls) == 1
    assert plain.calls[0][1][-2:] == (F32, F32)


class _RowSpy:
    """Stands in for the kernel wrapper: records each call's rows and
    dtypes, and returns as codes each row's index in the whole batch (the
    calls' rows counted in order), so the concatenation's order shows."""

    def __init__(self):
        self.calls, self.rows = [], 0

    def __call__(self, w, tc, go_id=1024, **kw):
        b, t = tc.shape[:2]
        self.calls.append((b, kw))
        codes = torch.arange(self.rows, self.rows + b, dtype=torch.int32)
        self.rows += b
        return codes[:, None].expand(b, t)


@pytest.mark.parametrize("b,groups", [(8, [4, 4]), (5, [4, 1]), (1, [1]),
                                      (4, [4]), (9, [4, 4, 1])])
def test_card_route_groups_bf16_rows(plms, monkeypatch, b, groups):
    """bf16 weights and cache (the defaults, or named): the rows in order in
    groups of MAX_ROWS, one wrapper call a group, concatenated in order; the
    span's args are the rows and the calls."""
    _, _, tm = plms
    assert tdec.MAX_ROWS == 4
    spans = []
    real = tplm.annotate

    def annotate(name, args=None, fmt=str):
        spans.append((name, None if args is None else fmt(args)))
        return real(name, args, fmt)

    monkeypatch.setattr(tplm, "annotate", annotate)
    tc = torch.from_numpy(_tc(7, 16, b=b)).to("meta")
    for kw in ({}, {"weight_dtype": BF, "cache_dtype": BF}):
        spy = _RowSpy()
        monkeypatch.setattr(tplm, "plm_decode_greedy", spy)
        got = tplm.decode(tm, tc, **kw)
        assert [n for n, _ in spy.calls] == groups
        assert all(k == kw for _, k in spy.calls)
        assert torch.equal(got, torch.arange(b, dtype=torch.int32)[:, None]
                           .expand(b, 7))
    assert spans == [("plm.decode", f"rows={b} launches={len(groups)}")] * 2


@pytest.mark.parametrize("kw", [{"weight_dtype": F32, "cache_dtype": F32},
                                {"weight_dtype": BF, "cache_dtype": F32},
                                {"weight_dtype": F32, "cache_dtype": BF},
                                {"top_k": 3}])
def test_other_decodes_stay_per_row(plms, monkeypatch, kw):
    """float32, the mixed pairs and top-k sampling never group rows: one
    wrapper call a row, or the plain loop."""
    _, _, tm = plms
    spy, plain = _RowSpy(), _Spy()
    monkeypatch.setattr(tplm, "plm_decode_greedy", spy)
    monkeypatch.setattr(tplm, "plain_decode", plain)
    tc = torch.from_numpy(_tc(7, 17, b=8)).to("meta")
    tplm.decode(tm, tc, **kw)
    if "top_k" in kw:
        assert spy.calls == [] and len(plain.calls) == 1
    else:
        assert [n for n, _ in spy.calls] == [1] * 8


def test_wrapper_takes_rows_in_bf16_only(plms):
    """The wrapper takes up to MAX_ROWS rows with bf16 weights and cache
    (on the CPU its plain twin row by row, each row its own call's codes)
    and one row in any other pair."""
    _, _, tm = plms
    w = tm.packed()
    tc = torch.from_numpy(_tc(9, 18, b=tdec.MAX_ROWS + 1))
    got = tdec.plm_decode_greedy(w, tc[:3], tm.go_id)
    assert torch.equal(got, torch.cat([tdec.plm_decode_greedy(w, tc[i:i + 1], tm.go_id)
                                       for i in range(3)]))
    with pytest.raises(ValueError, match="B = 1"):
        tdec.plm_decode_greedy(w, tc, tm.go_id)
    for dts in ((F32, F32), (BF, F32), (F32, BF)):
        with pytest.raises(ValueError, match="B = 1"):
            tdec.plm_decode_greedy(w, tc[:2], tm.go_id, *dts)


def test_reset_clears_the_row_count():
    cuda_lib.ROWS["plm_decode_bf16"] = 7
    cuda_lib.LAUNCHES["plm_decode_bf16"] = 2
    cuda_lib.reset_launches()
    assert cuda_lib.ROWS == {"plm_decode_bf16": 0}
    assert cuda_lib.LAUNCHES["plm_decode_bf16"] == 0
