"""The plain reference against the port's plain path on the CPU, at small
widths, from one state_dict: durations, the latent, the PLM's logits, the
w2v features and log-f0, and the served waveform of a two-row batch."""
from __future__ import annotations

import math

import pytest
import torch

from portbench.harness import program, traffic, weights
from portbench.harness.check import (
    ceiling_fault, code_gap, dur_err, program_durations, wav_err)
from portbench.reference.tts import Reference, frame_bucket
from portbench.tests import small

SEED = 4242


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(2)
    cfg = small.config()
    states = weights.draw_all(cfg, SEED, "cpu")
    pipe = program.build(cfg, states, "cpu")
    ref = Reference(cfg, states, "cpu")
    rng = traffic.rng_for(SEED, 1)
    audio = [traffic.prompt_audio(rng, 1.3, 150.0), traffic.prompt_audio(rng, 1.7, 120.0)]
    prompts = [pipe.prepare_prompt(a, bucket=True) for a in audio]
    texts = [traffic.tts_text(rng, s, 5.18, 8) for s in (0.8, 1.2)]
    return cfg, pipe, ref, audio, prompts, texts


def test_state_dict_names_match(pair):
    cfg, pipe, ref, *_ = pair
    for name in ("ttv", "plm", "vocoder", "speechsr"):
        port = set(getattr(pipe, name).state_dict())
        assert port == set(ref.models[name].state_dict()), name


def test_durations_latent_logits_features(pair):
    cfg, pipe, ref, audio, prompts, texts = pair
    ls = 3.0
    rows = pipe._rows(texts[:1], prompts[:1], exact=False)
    with torch.inference_mode():
        x_p, g_p, m_p, dur = pipe.ttv._durations(rows.x_ids, rows.tone, rows.lang,
                                                 rows.x_len, rows.mel_ttv, rows.mel_len, ls)
        logw = pipe.ttv.duration_predictor(x_p, m_p, g_p)[0, :, 0].numpy()
        n_pad = rows.x_ids.shape[1]
        n, x, g, v = ref.encode(texts[0], audio[0], n_pad)
        v_p = program_durations(logw, ls)
        assert dur_err(logw[:n], (v * ls)[0, :n].numpy(), ls) < 1e-5
        assert not ceiling_fault(dur[0].numpy(), v_p, n)
        frames = int(math.ceil(float(dur.sum()) / 2))
        t = frame_bucket(frames)
        x_p, g_p, fl, fm = pipe.ttv.inf_extract_tc_latent(
            rows.x_ids, rows.tone, rows.lang, rows.x_len, rows.mel_ttv,
            rows.mel_len, 2 * t, length_scale=ls)
        x_r = ref.models["ttv"].latent(x, dur, n, 2 * t)
        # the frames past the row's own are masked downstream
        torch.testing.assert_close(x_r[:, :frames], x_p[:, :frames], rtol=1e-4, atol=1e-4)
        codes = torch.randint(0, cfg["plm"]["vq_bins"], (1, t))
        lp = pipe.plm(x_p, codes)
        lr = ref.models["plm"].logits(x_r, codes)
        torch.testing.assert_close(lr[:, :frames], lp[:, :frames], rtol=1e-4, atol=1e-4)
        assert code_gap(lp.argmax(-1)[0, :frames].numpy(), lr[0, :frames]) < 1e-4
        w_p, f_p = pipe.ttv.inf_plm_gen(x_p, g_p, codes[None], fm)
        f_p = torch.where(f_p < math.log(55.0), torch.zeros_like(f_p), f_p)
        w_r, f_r = ref.models["ttv"].w2v_lf0(x_r, g, codes, fm)
        torch.testing.assert_close(w_r[:, :frames], w_p[:, :frames], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(f_r[:, :4 * frames], f_p[:, :4 * frames],
                                   rtol=1e-4, atol=1e-4)


def test_batched_waveforms(pair):
    """Both rows of a tts_batch call over two voices, as the server makes
    it, against the reference's rows at the call's shapes."""
    cfg, pipe, ref, audio, prompts, texts = pair
    rec = program.Recorder(pipe, {id(p): v for v, p in enumerate(prompts)})
    try:
        ls, seed = 3.0, 77
        wavs = rec.tts_batch(texts, prompts=prompts, output_sr=48000,
                             length_scale=ls, seed=seed)
    finally:
        rec.close()
    rec.host_copies()
    call = rec.calls[-1]
    for i in range(2):
        out = ref.row(texts[i], audio[i], ls, seed, call.n_pad, call.bucket, 2, i,
                      call.dur[i], call.codes[i])
        assert out.frames == len(wavs[i]) // 960
        assert wav_err(wavs[i], out.wav) < 1e-5
        assert code_gap(call.codes[i], out.logits) < 1e-5
        n = out.v.shape[0]
        v = program_durations(call.logw[i], ls)
        assert dur_err(call.logw[i][:n], out.v.numpy(), ls) < 1e-5
        assert not ceiling_fault(call.dur[i], v, n)
