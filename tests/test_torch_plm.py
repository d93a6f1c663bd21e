"""The port's prosody LM against the JAX package on the CPU: the
teacher-forced forward, the plain KV-cached decode (greedy and top-k), the
decode's dispatch, and the TTV / PLM weight carry-over round trips at
reference depth; the bf16 configuration's plain twin against the JAX
kernel's bf16 default. The CUDA decode kernel is held against the plain
version on a card in test_torch_cuda.py and chip_smoke.py.

Small configuration: ProsodyLM(n_layers=2, tc_latent_dim=44) (d = 64, 4
heads) with seeded random params, as tests/test_pallas_plm_decode.py sizes
it. Tolerance: atol 1e-4 on logits; greedy codes exact at T = 1, 3, 37, 64,
and every code within 1e-4 x max|logits| of its row's max logit under the
teacher-forced forward."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import plm_from_jax, ttv_from_jax
from megatts2_hierspeechpp_torch.models import plm as tplm
from megatts2_hierspeechpp_torch.models.ttv import TTVModel as TorchTTV
from megatts2_hierspeechpp_torch.ops import cuda_lib
from megatts2_hierspeechpp_torch.ops import plm_decode as tdec
from megatts2_hierspeechpp_tpu.models import convert as jconvert
from megatts2_hierspeechpp_tpu.models import plm as jplm
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_vocoder import _check, random_params

SMALL = dict(n_layers=2, tc_latent_dim=44)
MARGIN = 1e-4  # x max|logits|


def _tc(t, seed, dim=44, b=1):
    return np.random.default_rng(seed).standard_normal((b, t, dim)).astype(np.float32)


def plm_params(jm, seed):
    """random_params, with N(0, 1) code embeddings and unit-scale LayerNorms
    so that the logits are spread as a trained model's are."""
    t = 8
    params = random_params(jm, seed, _tc(t, 0, jm.tc_latent_dim),
                           np.zeros((1, t), np.int32), np.full((1,), t, np.int32))
    rng = np.random.default_rng(seed + 1)
    params["pc_embedding"]["embedding"] = rng.standard_normal(
        params["pc_embedding"]["embedding"].shape).astype(np.float32)
    params["pos_alpha"] = np.ones(1, np.float32)
    for i in range(jm.n_layers):
        for n in ("norm1", "norm2"):
            params[f"layer_{i}"][n]["scale"] = 1.0 + params[f"layer_{i}"][n]["scale"]
    return params


@pytest.fixture(scope="module")
def plms():
    jm = jplm.ProsodyLM(**SMALL, p_dropout=0.0)
    params = plm_params(jm, 31)
    tm = tplm.ProsodyLM(**SMALL, device="cpu")
    tm.load_state_dict(plm_from_jax(params), strict=True)
    return jm, params, tm


def test_teacher_forced_forward_matches_jax(plms):
    jm, params, tm = plms
    t = 23
    tc = _tc(t, 1, b=2)
    codes = np.random.default_rng(2).integers(0, 1024, (2, t)).astype(np.int32)
    lens = np.array([23, 15], np.int32)
    want = jax.jit(jm.apply)({"params": params}, tc, codes, lens)["logits"]
    got = tm(torch.from_numpy(tc), torch.from_numpy(codes), torch.from_numpy(lens))
    assert got.shape == (2, t, 1024)
    # padded query rows attend only to masked keys after their length: compare
    # the rows inside each length
    for b, n in enumerate(lens):
        _check(got[b, :n], np.asarray(want)[b, :n])


@pytest.mark.parametrize("t", [1, 3, 37, 64])
def test_plain_greedy_decode_matches_jax_exactly(plms, t):
    jm, params, tm = plms
    tc = _tc(t, 40 + t)
    want = np.asarray(jplm.decode(params, jnp.asarray(tc), n_layers=2, n_heads=4))
    got = tplm.decode(tm, torch.from_numpy(tc))
    assert got.dtype == torch.int32 and got.shape == (1, t)
    np.testing.assert_array_equal(got.numpy(), want)
    gap, scale = tplm.teacher_forced_gap(tm, torch.from_numpy(tc), got)
    assert gap <= MARGIN * scale


def test_plain_decode_batched_and_top_k(plms):
    """B > 1 greedy equals each row decoded alone; top-k draws valid codes,
    reproducibly from the generator's seed, and top_k=1 is greedy."""
    _, _, tm = plms
    tc = torch.from_numpy(_tc(12, 5, b=2))
    both = tplm.decode(tm, tc)
    for b in range(2):
        assert torch.equal(both[b:b + 1], tplm.decode(tm, tc[b:b + 1]))
    draw = lambda seed: tplm.decode(  # noqa: E731
        tm, tc, top_k=10, temperature=0.8,
        generator=torch.Generator().manual_seed(seed))
    a, b = draw(3), draw(3)
    assert torch.equal(a, b) and ((a >= 0) & (a < 1024)).all()
    assert torch.equal(tplm.decode(tm, tc, top_k=1), both)


def test_decode_kernel_wrapper_on_cpu_is_the_plain_version(plms):
    """On a CPU tensor the kernel wrapper takes the plain version and counts
    no launch; it refuses a batch in float32 and more than MAX_ROWS rows in
    bf16 (a bf16 batch up to MAX_ROWS is its rows' one-row calls)."""
    _, _, tm = plms
    tc = torch.from_numpy(_tc(9, 6))
    cuda_lib.reset_launches()
    w = tm.packed()
    f32 = torch.float32
    assert torch.equal(tdec.plm_decode_greedy(w, tc, tm.go_id, f32, f32),
                       tdec.plain_decode(w, tc, tm.go_id))
    assert cuda_lib.LAUNCHES["plm_decode"] == 0
    with pytest.raises(ValueError, match=r"\(B, T, C\), B = 1"):
        tdec.plm_decode_greedy(w, torch.cat([tc, tc]), tm.go_id, f32, f32)
    with pytest.raises(ValueError, match=r"\(B, T, C\), B = 1"):
        tdec.plm_decode_greedy(w, torch.cat([tc] * (tdec.MAX_ROWS + 1)), tm.go_id)
    assert torch.equal(tdec.plm_decode_greedy(w, torch.cat([tc, tc]), tm.go_id),
                       torch.cat([tdec.plm_decode_greedy(w, tc, tm.go_id)] * 2))


def test_packed_weights_are_cached_until_load():
    """decode packs the weights once; a state_dict load packs them anew."""
    lm = tplm.ProsodyLM(n_layers=1, tc_latent_dim=12, device="cpu", seed=1)
    w = lm.packed()
    assert lm.packed() is w
    other = tplm.ProsodyLM(n_layers=1, tc_latent_dim=12, device="cpu", seed=2)
    lm.load_state_dict(other.state_dict())
    fresh = lm.packed()
    assert fresh is not w and torch.equal(fresh.wqkv, other.packed().wqkv)
    assert not torch.equal(fresh.wqkv, w.wqkv)
    lm.to("cpu")
    assert lm.packed() is not fresh


def test_weight_roundtrip_reference_depth():
    """Port TTV / PLM state_dicts at reference depth -> JAX trees through the
    JAX package's own convert_ttv / convert_plm -> back through ttv_from_jax /
    plm_from_jax: the same names, shapes and values (strict load)."""
    for model, to_jax, back in (
            (TorchTTV(device="cpu", seed=13), jconvert.convert_ttv, ttv_from_jax),
            (tplm.ProsodyLM(device="cpu", seed=14), jconvert.convert_plm, plm_from_jax)):
        sd = model.state_dict()
        out = back(to_jax(sd))
        assert out.keys() == sd.keys()
        for k, v in sd.items():
            assert out[k].shape == v.shape and torch.equal(out[k], v.float()), k
        model.load_state_dict(out, strict=True)


def test_bf16_plain_twin_matches_jax_bf16_kernel(plms):
    """The bf16 configuration (weights and KV cache bf16, float32 sums): the
    plain twin against the JAX kernel in interpret mode with its bf16
    defaults, at T = 48, 2 layers, as tests/test_pallas_plm_decode.py sizes
    it. Codes agree; a flip must be a near tie: the twin's teacher-forced
    gap on the JAX codes <= 1e-3 x max|logits|."""
    from megatts2_hierspeechpp_tpu.ops.pallas_plm_decode import (
        plm_decode_greedy as jax_kernel)

    _, params, tm = plms
    t = 48
    tc = _tc(t, 3)
    want = np.array(jax_kernel(params, jnp.asarray(tc), n_layers=2,
                               n_heads=4, go_id=1024, chunk=16,
                               interpret=True))
    bf = torch.bfloat16
    w = tm.packed()
    got = tplm.decode(tm, torch.from_numpy(tc), weight_dtype=bf,
                      cache_dtype=bf)
    assert got.shape == (1, t) and got.dtype == torch.int32
    gap, scale = tdec.plain_gap(w, torch.from_numpy(tc), torch.from_numpy(want),
                                tm.go_id, bf, bf)
    assert gap <= 1e-3 * scale, (gap, scale)
    np.testing.assert_array_equal(got.numpy(), want)
    # the twin's own codes are its greedy codes: gap 0
    assert tdec.plain_gap(w, torch.from_numpy(tc), got, tm.go_id, bf, bf)[0] == 0
