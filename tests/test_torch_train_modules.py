"""The vocoder trainer's modules in the port against the JAX package on the
CPU: the training spectra, WNConv2d and the discriminators, the losses, the
training members of HierVocoder (enc_q, mel_decoder, the forward flows) and
its training methods (train_encode, decode_slice, f0_extraction).

Small configuration (as tests/test_train_s1_vocoder.py): HierVocoder
(upsample_initial_channel 64, posterior_wn_layers 4, n_flows 1,
flow_layers 1), MPD at resolutions (256, 64, 256), (128, 32, 128) and
periods (2, 3); B = 2, T = 16 frames. Weights are seeded random JAX trees
carried over by convert.*_from_jax. Tolerances, stated per check: spectra
1e-5 relative to the largest value; discriminators and vocoder modules
atol 1e-4 (float32 sums in another order); losses 1e-6 relative; the forward
flows followed by reverse give their input back within 1e-5."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import mpd_from_jax, vocoder_from_jax
from megatts2_hierspeechpp_torch.models import discriminators as tdisc
from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder as TorchVocoder
from megatts2_hierspeechpp_torch.nn.conv import WNConv2d as TorchWNConv2d
from megatts2_hierspeechpp_torch.ops import stft as tstft
from megatts2_hierspeechpp_torch.train import losses as tlosses
from megatts2_hierspeechpp_tpu.models import discriminators as jdisc
from megatts2_hierspeechpp_tpu.models.vocoder import HierVocoder as JaxVocoder
from megatts2_hierspeechpp_tpu.nn.conv import WNConv2d as JaxWNConv2d
from megatts2_hierspeechpp_tpu.ops import stft as jstft
from megatts2_hierspeechpp_tpu.train import losses as jlosses
from tests.test_torch_kernels import few_torch_threads  # noqa: F401

SMALL = dict(upsample_initial_channel=64, posterior_wn_layers=4, n_flows=1,
             flow_layers=1)
MPD_SMALL = dict(resolutions=((256, 64, 256), (128, 32, 128)), periods=(2, 3))
B, T = 2, 16
ATOL = 1e-4


def random_tree(init_fn, seed, *args):
    """Seeded random params with the structure init_fn(key, *args) gives,
    through jax.eval_shape (no init compile), at nn/init.py's scales: conv
    kernels and weight-norm v N(0, 0.25/fan_in), 1x1 ones and Dense
    N(0, 1/fan_in); weight-norm g = ||v|| (the effective weight is v; the
    norm over Cin of a transposed conv, else over every axis but Cout);
    snake log-alpha/beta N(0, 0.2^2); the rest N(0, 0.05^2). At these
    scales the small Generator's output stays off tanh's saturation, where
    float32 rounds the slope 1 - tanh^2 to a few bits."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)["params"]

    def leaf(path, s):
        name = path[-1].key
        if name in ("kernel", "v"):
            fan_in = np.prod(s.shape[:-1])
            gain = 0.5 if len(s.shape) > 2 and np.prod(s.shape[:-2]) > 1 else 1.0
            v = rng.standard_normal(s.shape) * gain / np.sqrt(fan_in)
        elif name == "g":
            v = np.ones(s.shape)
        elif name in ("alpha", "beta"):
            v = rng.standard_normal(s.shape) * 0.2
        else:
            v = rng.standard_normal(s.shape) * 0.05
        return v.astype(np.float32)

    def set_g(path, node):
        if isinstance(node, dict):
            node = {k: set_g(path + (k,), v) for k, v in node.items()}
            if "v" in node and "g" in node:
                v = node["v"]
                axes = ((0, 2) if path and path[-1].startswith("ups_")
                        else tuple(range(v.ndim - 1)))
                node["g"] = np.sqrt(np.square(v).sum(axis=axes)).astype(np.float32)
        return node

    return set_g((), jax.tree_util.tree_map_with_path(leaf, shapes))


def voc_inputs(b=B, t=T, seed=0):
    """(spec, audio (B, 320T, 1), mel, w2v, log1p f0 (B, 4T, 1), mask)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = np.ones((b, t, 1), f32)
    if b > 1:
        mask[1, t - 3:] = 0.0  # a shorter second row
    return (rng.standard_normal((b, t, 641)).astype(f32),
            rng.uniform(-0.5, 0.5, (b, 320 * t, 1)).astype(f32),
            rng.standard_normal((b, t, 80)).astype(f32),
            rng.standard_normal((b, t, 1024)).astype(f32),
            np.log1p(rng.uniform(0, 250, (b, 4 * t, 1))).astype(f32),
            mask)


def jax_vocoder_params(seed=1):
    """A JAX init_all tree (every member, the training ones too)."""
    jm = JaxVocoder(**SMALL)
    k = jax.random.PRNGKey(0)
    args = voc_inputs(1)
    return jm, random_tree(functools.partial(jm.init, method=JaxVocoder.init_all),
                           seed, *args, {"z_q": k, "z_p": k, "z_l": k})


@pytest.fixture(scope="module")
def vocoders():
    jm, params = jax_vocoder_params()
    tm = TorchVocoder(**SMALL, device="cpu", train=True)
    tm.load_state_dict(vocoder_from_jax(params), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def mpds():
    jm = jdisc.MultiPeriodDiscriminator(**MPD_SMALL)
    y = np.zeros((1, 2560, 1), np.float32)
    params = random_tree(jm.init, 2, y, y)
    tm = tdisc.MultiPeriodDiscriminator(**MPD_SMALL, device="cpu")
    tm.load_state_dict(mpd_from_jax(params), strict=True)
    return jm, params, tm


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _rel_close(got, want, rel):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ---- spectra ----

def test_training_spectra_match_jax():
    """linear_spectrogram, spec_to_mel (slaney filterbank, fmax None and
    8000) and the discriminator's normalised complex STFT: 1e-5 of the
    largest value."""
    y = np.random.default_rng(3).uniform(-0.5, 0.5, (2, 320 * 20)).astype(np.float32)
    spec = tstft.linear_spectrogram(_t(y))
    jspec = jstft.linear_spectrogram(jnp.asarray(y))
    assert spec.shape == (2, 20, 641)
    _rel_close(spec, jspec, 1e-5)
    for fmax in (None, 8000.0):
        mel = tstft.spec_to_mel(spec, 16000, 1280, 80, 0.0, fmax)
        _rel_close(mel, jstft.spec_to_mel(jspec, 16000, 1280, 80, 0.0, fmax), 1e-5)
        np.testing.assert_allclose(
            tstft.mel_filterbank(16000, 1280, 80, 0.0, fmax, htk=False,
                                 slaney_norm=True),
            jstft.mel_filterbank(16000, 1280, 80, 0.0, fmax, htk=False,
                                 slaney_norm=True), rtol=1e-6, atol=1e-9)
    for n_fft, hop, win in ((256, 64, 256), (128, 32, 128)):
        got = tdisc.normalized_complex_stft(_t(y), n_fft, hop, win)
        want = np.asarray(jdisc._normalized_complex_stft(jnp.asarray(y), n_fft, hop, win))
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale


# ---- discriminators ----

def test_wnconv2d_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 7, 5)).astype(np.float32)
    jm = JaxWNConv2d(6, (3, 5), (2, 1), (1, 2), (1, 2))
    params = random_tree(jm.init, 5, x)
    tm = TorchWNConv2d(5, 6, (3, 5), (2, 1), (1, 2), (1, 2))
    sd = {k[len("discriminators.0.conv_post."):]: v for k, v in mpd_from_jax(
        {"disc_r_0": {"conv_post": params}}).items()}
    tm.load_state_dict(sd, strict=True)
    _close(tm(_t(x)), jax.jit(jm.apply)({"params": params}, x))


def test_mpd_matches_jax(mpds):
    """MultiPeriodDiscriminator: logits and every feature map of each
    discriminator (period 3 reflect-pads the 2570-sample input)."""
    jm, params, tm = mpds
    rng = np.random.default_rng(6)
    y = rng.uniform(-0.5, 0.5, (2, 2570, 1)).astype(np.float32)
    y_hat = rng.uniform(-0.5, 0.5, (2, 2570, 1)).astype(np.float32)
    got = tm(_t(y), _t(y_hat))
    want = jax.jit(jm.apply)({"params": params}, y, y_hat)
    for g_list, w_list in zip(got[:2], want[:2]):   # logits
        assert len(g_list) == len(w_list) == 4
        for g, w in zip(g_list, w_list):
            _close(g, w)
    for g_maps, w_maps in zip(got[2:], want[2:]):   # feature maps
        for gm, wm in zip(g_maps, w_maps):
            assert len(gm) == len(wm)
            for g, w in zip(gm, wm):
                assert g.shape == w.shape
                _close(g, w)


def test_losses_match_jax():
    rng = np.random.default_rng(7)
    outs = [[rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9)]
            for _ in range(2)]
    fmaps = [[[rng.standard_normal((2, 4, 3, c)).astype(np.float32) for c in (2, 3)]
              for _ in range(2)] for _ in range(2)]
    tt = lambda tree: jax.tree.map(_t, tree)  # noqa: E731
    jj = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    pairs = [
        (tlosses.feature_loss(*tt(fmaps)), jlosses.feature_loss(*jj(fmaps))),
        (tlosses.discriminator_loss(*tt(outs))[0],
         jlosses.discriminator_loss(*jj(outs))[0]),
        (tlosses.generator_loss(tt(outs[1]))[0],
         jlosses.generator_loss(jj(outs[1]))[0]),
    ]
    z, lq, mp, lp = (rng.standard_normal((2, 6, 4)).astype(np.float32) * 0.5
                     for _ in range(4))
    mask = np.ones((2, 6, 1), np.float32)
    mask[1, 4:] = 0
    pairs.append((tlosses.kl_loss(*map(_t, (z, lq, mp, lp, mask))),
                  jlosses.kl_loss(*map(jnp.asarray, (z, lq, mp, lp, mask)))))
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---- vocoder training members and methods ----

def _apply(jm, params, method, *args, **kw):
    return jax.jit(functools.partial(jm.apply, method=method, **kw))(
        {"params": params}, *args)


def test_posterior_audio_encoder_matches_jax(vocoders):
    """enc_q with sample=False (z = m): z, m, logs."""
    jm, params, tm = vocoders
    spec, audio, mel, _, _, mask = voc_inputs(seed=8)
    g = np.random.default_rng(9).standard_normal((B, 256)).astype(np.float32)
    want = _apply(jm, params, lambda m, *a: m.enc_q(*a, sample=False),
                  spec, audio, mask, g)
    got = tm.enc_q(_t(spec), _t(audio), _t(mask), _t(g))
    for gt, w in zip(got, want):
        _close(gt, w)


def test_mel_decoder_matches_jax(vocoders):
    jm, params, tm = vocoders
    rng = np.random.default_rng(10)
    z = rng.standard_normal((B, T, 192)).astype(np.float32)
    g = rng.standard_normal((B, 256)).astype(np.float32)
    mask = voc_inputs()[-1]
    want = _apply(jm, params, lambda m, *a: m.mel_decoder(*a), z, mask, g)
    got = tm.mel_decoder(_t(z), _t(mask), g=_t(g))
    assert got.shape == (B, T, 20)
    _close(got, want)


def test_forward_flows_match_jax_and_invert(vocoders):
    """flow then flow_l, forward direction, against JAX; reverse(forward(z))
    gives z back within 1e-5 (on the mask)."""
    jm, params, tm = vocoders
    rng = np.random.default_rng(11)
    z = rng.standard_normal((B, T, 192)).astype(np.float32)
    g = rng.standard_normal((B, 256)).astype(np.float32)
    mask = voc_inputs()[-1]
    z = z * mask
    want = _apply(jm, params, lambda m, z_, mk, g_: m.flow_l(
        m.flow(z_, mk, g_, reverse=False), mk, g_, reverse=False), z, mask, g)
    zt, mt, gt = _t(z), _t(mask), _t(g)
    got = tm.flow_l(tm.flow(zt, mt, gt), mt, gt)
    _close(got, want)
    back = tm.flow.reverse(tm.flow_l.reverse(got, mt, gt), mt, gt)
    np.testing.assert_allclose(back.detach().numpy(), z, atol=1e-5, rtol=0)


def test_train_encode_decode_slice_f0_match_jax(vocoders):
    """train_encode with z_q's noise drawn from the key JAX's own enc_q
    uses, decode_slice on an 8-frame window of z_q, and f0_extraction
    without noise."""
    jm, params, tm = vocoders
    spec, audio, mel, w2v, lf0, mask = voc_inputs(seed=12)
    k = jax.random.split(jax.random.PRNGKey(5), 3)
    rngs = {"z_q": k[0], "z_p": k[1], "z_l": k[2]}
    want = _apply(jm, params, JaxVocoder.train_encode, spec, audio, mel, w2v,
                  lf0, mask, rngs)
    noise = np.asarray(jax.random.normal(k[0], (B, T, 192), jnp.float32))
    with torch.no_grad():
        got = tm.train_encode(*map(_t, (spec, audio, mel, w2v, lf0, mask)),
                              _t(noise))
        assert set(got) == set(want)
        for name in want:
            _close(got[name], want[name])
        z = np.asarray(want["z_q"])[:, 4:12]
        wav, e_ = _apply(jm, params, JaxVocoder.decode_slice, z, want["g"])
        got_wav, got_e = tm.decode_slice(_t(z), _t(want["g"]))
        assert got_wav.shape == (B, 320 * 8, 1) and got_e.shape == (B, 32, 1)
        _close(got_wav, wav)
        _close(got_e, e_)
        want_f0 = _apply(jm, params, JaxVocoder.f0_extraction, spec, mel, mask,
                         audio)
        _close(tm.f0_extraction(*map(_t, (spec, mel, mask, audio))), want_f0)
