"""The port's HierVocoder against the JAX package on the CPU; the weight
carry-over round trip at reference depth; and the port's import and device
rules. voice_conversion is in test_torch_vc.py; SpeechSR, the mel front-end
and the decode pipeline in test_torch_pipeline.py.

Small configuration: HierVocoder(upsample_initial_channel=64,
posterior_wn_layers=4, n_flows=1, flow_layers=1), 16 frames, with seeded
random params. Tolerance: atol 1e-4."""
import importlib.util
import pkgutil
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import megatts2_hierspeechpp_torch
from megatts2_hierspeechpp_torch.convert import speechsr_from_jax, vocoder_from_jax
from megatts2_hierspeechpp_torch.infer.pipeline import TTSPipeline as TorchPipeline
from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR as TorchSR
from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder as TorchVocoder
from megatts2_hierspeechpp_tpu.models import convert as jconvert
from megatts2_hierspeechpp_tpu.models.vocoder import HierVocoder as JaxVocoder
from megatts2_hierspeechpp_tpu.utils import convert_ref
from tests.test_torch_kernels import few_torch_threads  # noqa: F401

SMALL = dict(upsample_initial_channel=64, posterior_wn_layers=4, n_flows=1,
             flow_layers=1)
T = 16
REPO = Path(__file__).resolve().parents[1]


def random_params(module, seed, *args):
    """Seeded random params with the structure of module.init(*args), built
    from jax.eval_shape (no init compile): kernels and weight-norm v
    N(0, 1/fan_in) times 0.5, weight-norm g 1, biases N(0, 0.05^2), snake
    log-alpha/beta N(0, 0.2^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]

    def leaf(path, s):
        name = path[-1].key
        if name in ("kernel", "v"):
            v = rng.standard_normal(s.shape) * 0.5 / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "g":
            v = np.ones(s.shape)
        elif name in ("alpha", "beta"):
            v = rng.standard_normal(s.shape) * 0.2
        else:
            v = rng.standard_normal(s.shape) * 0.05
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(t=T, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, t, 80)).astype(np.float32),
            rng.standard_normal((1, t, 1024)).astype(np.float32),
            np.ones((1, t, 1), np.float32),
            np.log(rng.uniform(100, 250, (1, 4 * t, 1))).astype(np.float32))


@pytest.fixture(scope="module")
def vocoders():
    jm = JaxVocoder(**SMALL)
    params = random_params(jm, 1, *_inputs())
    tm = TorchVocoder(**SMALL, device="cpu")
    tm.load_state_dict(vocoder_from_jax(params), strict=True)
    return jm, params, tm


def _check(got, want, atol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def test_forward_matches_jax(vocoders):
    """HierVocoder.forward: the __graft_entry__.entry() signature."""
    jm, params, tm = vocoders
    mel, w2v, mask, f0 = _inputs(seed=5)
    jo, je = jax.jit(jm.apply)({"params": params}, mel, w2v, mask, f0)
    to, te = tm(*map(torch.from_numpy, (mel, w2v, mask, f0)))
    assert to.shape == (1, 320 * T, 1) and te.shape == (1, 4 * T, 1)
    _check(to, jo)
    _check(te, je)


def test_weight_roundtrip_reference_depth():
    """Port state_dicts at reference depth -> JAX trees through the JAX
    package's own per-submodule converters -> back through
    vocoder_from_jax / speechsr_from_jax: exactly the same tensors."""
    voc = TorchVocoder(device="cpu", seed=11)
    sd = voc.state_dict()
    tree = {
        "enc_p_l": jconvert.posterior_sf_encoder(sd, "enc_p_l"),
        "flow_l": convert_ref.dit_coupling_block(sd, "flow_l", 4, 3),
        "flow": convert_ref.dit_coupling_block(sd, "flow", 4, 3),
        "dec": jconvert.generator(sd, "dec", 5),
        "sn": jconvert.source_network(sd, "sn"),
        "emb_g": convert_ref.style_encoder(sd, "emb_g"),
    }
    back = vocoder_from_jax(tree)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k

    sr = TorchSR(device="cpu", seed=12)
    sd = sr.state_dict()
    back = speechsr_from_jax(jconvert.convert_speechsr(sd, ""))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax, flax or the
    JAX package."""
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|flax|megatts2_hierspeechpp_tpu)\b", re.M)
    pkg = megatts2_hierspeechpp_torch
    files = [REPO / "chip_smoke.py"]
    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        files.append(Path(importlib.util.find_spec(mod.name).origin))
    assert len(files) > 15
    for f in files:
        assert not pat.search(f.read_text()), f


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchVocoder(**SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchSR(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchPipeline(TorchVocoder(**SMALL, device="cpu"))
