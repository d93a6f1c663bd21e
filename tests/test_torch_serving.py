"""The port's serving surface against the JAX package on the CPU: the
bucketed `tts` (exact=False, the default), B=2 `duration` / `acoustic` with
rows of different text lengths, `tts_batch` with a shared prompt and with
per-row prompts, `tts_stream` chunk by chunk (16 and 48 kHz, and a final
raw chunk shorter than the SR halo), and the cases that raise. At 48 kHz
the SR stage is held on the port's own 16 kHz output (see
test_tts_batch_super_resolves_each_row_as_jax and _check_stream).

The small pipelines of test_torch_tts.py (seeded random params, the same
weights on both sides); noise_scale_vc = 0 (the frameworks draw different
noise from a seed). Tolerances: frame counts and greedy codes exact; w2v and
log-f0 atol 1e-4; waveforms atol 1e-4 x the peak of the JAX output (the
per-module float32 agreement carried through the vocoder and SpeechSR);
a batch row equals its own tts call, and a stream its tts after peak
normalisation, within 1e-4 (the JAX contract, tests/test_pipeline.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.infer import pipeline as tpipe
from megatts2_hierspeechpp_tpu.data import text as jtext
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_pipeline import speechsrs  # noqa: F401  (fixture)
from tests.test_torch_denoiser import jax_stft  # noqa: F401  (fixture)
from tests.test_torch_tts import (  # noqa: F401  (fixtures)
    TEXT,
    denoised_pipelines,
    pipelines,
)
from tests.test_torch_vocoder import _check, vocoders  # noqa: F401  (fixture)

TEXTS = (TEXT, "sil zh ang1 h ao3 sp")
KW = dict(noise_scale_vc=0.0, seed=5)
# TEXT is 11 frames at length_scale 1 with these weights; streams run it
# longer, so that 16-frame chunks make a stream of several
STREAM = dict(KW, length_scale=5.0)


def _close(got, want, tol=1e-4):
    """max |got - want| <= tol x max|want|, with the same length."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _speakers(n=3, seed=60):
    """n distinct prompts of 17000-25000 samples: one 2 s grid when
    bucketed."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(17000 + 4000 * i) * 0.2).astype(np.float32)
            for i in range(n)]


def test_buckets_are_the_jax_sizes():
    from megatts2_hierspeechpp_tpu.infer import pipeline as jpipe

    for n in (1, 16, 17, 199, 200, 201, 599, 2000, 2001, 2401, 5000):
        assert tpipe._bucket(n) == jpipe._bucket(n)
        assert tpipe._bucket_text(n) == jpipe._bucket_text(n)


@pytest.mark.parametrize("output_sr", [16000, 48000])
def test_bucketed_tts_matches_jax_default(pipelines, output_sr):
    jp, tp, audio = pipelines
    want, inter = jp.tts(TEXT, audio, output_sr=output_sr,
                         return_intermediates=True, **KW)
    got, ac, raw = tp.tts(TEXT, audio, output_sr=output_sr,
                          return_intermediates=True, **KW)
    t = inter["frame_lengths"]
    assert ac.frames == t and tpipe._bucket(t) > t  # padded frames run
    np.testing.assert_array_equal(ac.codes.numpy(), inter["codes"])
    _check(ac.w2v, inter["w2v"])
    _check(ac.lf0, inter["lf0"])
    assert got.shape == (320 * t * output_sr // 16000,)
    _close(got, want)


def test_batched_duration_and_acoustic_match_jax(pipelines):
    """Two rows of different phone counts padded to one text bucket, one
    frame bucket: per-row frames, codes, w2v and log-f0 as the JAX stages
    compute them for the same padded batch."""
    jp, tp, audio = pipelines
    seqs = [jtext.process_text(t) for t in TEXTS]
    lens = np.array([len(s[0]) for s in seqs], np.int32)
    assert lens[0] != lens[1]
    n_pad = tpipe._bucket_text(int(lens.max()))
    arr = np.zeros((3, 2, n_pad), np.int32)
    for i, s in enumerate(seqs):
        arr[:, i, :lens[i]] = s
    jprompt = jp.prepare_prompt(audio)
    mel = jnp.tile(jprompt.mel_ttv, (2, 1, 1))
    mel_len = jnp.full((2,), mel.shape[1], jnp.int32)
    want_frames = np.asarray(jp._stage("duration")(
        jp.ttv_vars, *map(jnp.asarray, arr), jnp.asarray(lens), mel, mel_len,
        jnp.float32(1.0)))
    t_voc = tpipe._bucket(int(want_frames.max()))
    w2v, lf0, frame_lengths, _, _, codes = jp._stage("acoustic")(
        jp.ttv_vars, jp.plm_params, *map(jnp.asarray, arr), jnp.asarray(lens),
        mel, mel_len, jnp.float32(1.0), jax.random.PRNGKey(5),
        jnp.zeros((1, 1), jnp.int32), out_budget=2 * t_voc, top_k=0,
        mode="plm")

    prompt = tp.prepare_prompt(audio)
    frames = tp.duration(list(TEXTS), prompt)
    np.testing.assert_array_equal(frames, want_frames)
    assert frames[0] != frames[1]
    ac = tp.acoustic(list(TEXTS), prompt, t_voc)
    assert ac.w2v.shape == (2, t_voc, 1024)
    np.testing.assert_array_equal(ac.frame_lengths.numpy(),
                                  np.asarray(frame_lengths))
    np.testing.assert_array_equal(ac.codes.numpy(), np.asarray(codes))
    _check(ac.w2v, w2v)
    _check(ac.lf0, lf0)
    # a text alone in the same padding gives its row of the batch
    one = tp.acoustic([TEXTS[1]] * 2, prompt, t_voc)
    np.testing.assert_array_equal(one.codes[1].numpy(), ac.codes[1].numpy())


def test_tts_batch_shared_prompt_matches_jax(pipelines):
    """One speaker, two texts: each row as the JAX tts_batch computes it
    and as the port's own tts call (the JAX contract, 1e-4)."""
    jp, tp, audio = pipelines
    want = jp.tts_batch(list(TEXTS), prompt_audio=audio, **KW)
    prompt = tp.prepare_prompt(audio)
    got = tp.tts_batch(list(TEXTS), prompt=prompt, **KW)
    assert len(got) == 2 and got[0].shape != got[1].shape
    for text, g, w in zip(TEXTS, got, want):
        _close(g, w)
        _close(g, tp.tts(text, prompt=prompt, **KW))


def test_tts_batch_super_resolves_each_row_as_jax(pipelines):
    """output_sr=48000 at B=2: the rows' 16 kHz waveforms through the JAX
    SpeechSR give the port's 48 kHz rows, and tts_batch returns each row
    cut to its frames and peak-normalised. (The whole 48 kHz rows differ
    from the JAX rows by up to 2.2e-4 of the peak: the random-weight
    vocoder amplifies float32 reduction order at B=2, where the JAX batch
    itself differs from its own single calls by 7e-5; the vocoder's B=2
    rows are held at 16 kHz above.)"""
    jp, tp, audio = pipelines
    prompt = tp.prepare_prompt(audio)
    rows = tp._rows(list(TEXTS), [prompt] * 2, exact=False)
    frames = tp._frames(rows, 1.0)
    ac = tp._acoustic(rows, tpipe._bucket(int(frames.max())), seed=5)
    raw16 = tp._vocode(prompt, ac, 0.0, 5, 0.0, 16000)
    raw48 = tp._vocode(prompt, ac, 0.0, 5, 0.0, 48000)
    want = np.asarray(jp._stage("sr")(jp.speechsr_params,
                                      jnp.asarray(raw16.numpy())[..., None]))
    _close(raw48, want[..., 0])
    got = tp.tts_batch(list(TEXTS), prompt=prompt, output_sr=48000, **KW)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(
            g, tpipe._peak_normalise(raw48[i, :960 * frames[i]].numpy()))


def test_tts_batch_per_row_prompts_match_jax_and_own_tts(pipelines):
    """Three speakers on the 1 s grid in one batch: each row as the JAX
    tts_batch computes it, and as the port's own tts call on its prompt
    (style pooled at each prompt's own length, cached)."""
    jp, tp, _ = pipelines
    texts = list(TEXTS) + ["sil n i3 h ao3 sp"]
    audios = _speakers()
    jprompts = [jp.prepare_prompt(a, bucket=True) for a in audios]
    tprompts = [tp.prepare_prompt(a, bucket=True) for a in audios]
    assert len({p.mel_ttv.shape[1] for p in tprompts}) == 1
    assert len({p.t_samples for p in tprompts}) == 3
    want = jp.tts_batch(texts, prompts=jprompts, **KW)
    got = tp.tts_batch(texts, prompts=tprompts, **KW)
    assert all(p.style_pair is not None for p in tprompts)  # cached
    for text, p, g, w in zip(texts, tprompts, got, want):
        _close(g, w)
        _close(g, tp.tts(text, prompt=p, **KW))


def _jax_sr_pieces(jp, raw, hs=512):
    """The JAX tts_stream's SR plan (one chunk of lookahead, edge pieces
    without an outer halo, a raw chunk under hs samples merged into the
    piece before it) on given 16 kHz chunks, through its sr_chunk
    executables."""
    def piece(mid, left, right):
        kind = ("full" if left is None and right is None else
                "first" if left is None else "last" if right is None else "mid")
        x = np.concatenate([p for p in (left, mid, right) if p is not None])
        fn = jp._stage(f"sr_chunk:{kind}:{len(mid)}:{hs}")
        return np.asarray(fn(jp.speechsr_params,
                             jnp.asarray(x)[None, :, None]))[0, :, 0]

    out, prev, prev_left = [], None, None
    for r in raw:
        if prev is not None:
            if len(r) < hs:
                prev = np.concatenate([prev, r])
                continue
            out.append(piece(prev, prev_left, r[:hs]))
            prev_left = prev[-hs:]
        prev = r
    out.append(piece(prev, prev_left, None))
    return out


def _check_stream(jp, tp, audio, **kw):
    """The 16 kHz stream chunk by chunk against the JAX stream, and the 48
    kHz stream piece by piece against the JAX SR plan on the port's own 16
    kHz chunks. (Whole 48 kHz pieces differ from the JAX ones by up to
    1.14e-4 of the peak: the random-weight vocoder at the 200-frame bucket
    carries 6.5e-5-8.7e-5 into each 16 kHz chunk, and SpeechSR amplifies
    it.) Returns the 16 kHz chunks."""
    want = list(jp.tts_stream(TEXT, audio, **kw))
    got = list(tp.tts_stream(TEXT, audio, **kw))
    assert len(got) == len(want)
    peak = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        assert np.abs(g - w).max() <= 1e-4 * peak
    up = list(tp.tts_stream(TEXT, audio, output_sr=48000, **kw))
    ref = _jax_sr_pieces(jp, got)
    assert len(up) == len(ref)
    peak = max(np.abs(r).max() for r in ref)
    for u, r in zip(up, ref):
        assert u.shape == r.shape and u.dtype == np.float32
        assert np.abs(u - r).max() <= 1e-4 * peak
    assert sum(map(len, up)) == 3 * sum(map(len, got))
    return got, up


def test_tts_stream_matches_jax_chunk_by_chunk(pipelines):
    """chunk_frames = halo_frames = 16: first, interior and last chunks
    inside the 200-frame bucket, at 16 and 48 kHz."""
    jp, tp, audio = pipelines
    got, _ = _check_stream(jp, tp, audio, chunk_frames=16, halo_frames=16,
                           **STREAM)
    assert len(got) >= 3


def test_tts_stream_short_final_chunk_matches_jax(pipelines):
    """chunk_frames = frames - 1: the last raw chunk is 320 samples, under
    the 512-sample SR halo, and merges into the piece before it."""
    jp, tp, audio = pipelines
    t = tp.duration(TEXT, tp.prepare_prompt(audio), STREAM["length_scale"])
    raw, up = _check_stream(jp, tp, audio, chunk_frames=t - 1,
                            halo_frames=16, **STREAM)
    assert [len(r) for r in raw] == [320 * (t - 1), 320]
    assert [len(u) for u in up] == [960 * t]


def test_tts_stream_with_a_covering_halo_equals_tts(pipelines):
    """With 32-frame chunks and halos the 16 kHz stream is the bucketed
    tts after peak normalisation, within 1e-4 (the JAX stream is within
    3.9e-5 of its tts here). A 16-frame halo does not cover this small
    Generator's receptive field: both frameworks' streams then differ from
    their tts by 0.11 at the first chunk's edge."""
    _, tp, audio = pipelines
    whole = np.concatenate(list(tp.tts_stream(
        TEXT, audio, chunk_frames=32, halo_frames=32, **STREAM)))
    full = tp.tts(TEXT, audio, **STREAM)
    assert whole.shape == full.shape
    assert np.abs(tpipe._peak_normalise(whole) - full).max() < 1e-4


def test_tts_stream_48k_equals_tts_but_at_its_tail_as_jax(pipelines):
    """At 48 kHz (32-frame chunks and halos) the stream is the bucketed tts
    after the least-squares gain in all but its last 1024 samples, within
    1e-4. In those the tts's SpeechSR sees the bucket's padding frames
    while the stream's last piece ends at the sequence edge: the port's
    stream differs from its tts there as the JAX stream differs from the
    JAX tts (by 0.718 of the peak, 3 samples from the end, with these
    weights), within 1e-3."""
    jp, tp, audio = pipelines
    kw = dict(chunk_frames=32, halo_frames=32, output_sr=48000, **STREAM)
    diffs = []
    for p in (jp, tp):
        wav = np.concatenate(list(p.tts_stream(TEXT, audio, **kw)))
        full = p.tts(TEXT, audio, output_sr=48000, **STREAM)
        assert wav.shape == full.shape
        iw, jf = wav[:-1024], full[:-1024]
        gain = float(np.dot(iw, jf) / np.dot(iw, iw))
        assert np.abs(gain * iw - jf).max() < 1e-4
        diffs.append(gain * wav - full)
    want, got = diffs
    assert np.abs(got - want).max() <= 1e-3
    assert np.argmax(np.abs(got)) == np.argmax(np.abs(want))


def test_serving_refuses_what_it_cannot_honour(pipelines):
    _, tp, audio = pipelines
    prompt = tp.prepare_prompt(audio)
    texts = list(TEXTS)
    with pytest.raises(ValueError, match="does not support"):
        tp.tts_batch(texts, prompt=prompt, exact=True)
    with pytest.raises(ValueError, match="not both"):
        tp.tts_batch(texts, prompts=[prompt, prompt], prompt=prompt)
    with pytest.raises(ValueError, match="2 prompts for 1 texts"):
        tp.tts_batch(texts[:1], prompts=[prompt, prompt])
    long = tp.prepare_prompt(np.concatenate([audio, audio]))
    with pytest.raises(ValueError, match="share the padded prompt-mel"):
        tp.tts_batch(texts, prompts=[prompt, long])
    with pytest.raises(ValueError, match="does not match"):
        tp.tts_batch(texts, prompt=prompt, output_sr=24000)
    assert torch.is_inference_mode_enabled() is False


def test_serving_with_denoise_ratio_matches_jax(denoised_pipelines, jax_stft):
    """denoise_ratio > 0 from prompt audio in tts_batch and tts_stream: the
    prompt is denoised and the style interpolated, as the JAX pipeline
    serves it (16 kHz, shared prompt)."""
    jp, tp, audio = denoised_pipelines
    kw = dict(KW, denoise_ratio=0.5)
    want = jp.tts_batch(list(TEXTS), prompt_audio=audio, **kw)
    got = tp.tts_batch(list(TEXTS), prompt_audio=audio, **kw)
    for g, w in zip(got, want):
        _close(g, w)
    skw = dict(STREAM, denoise_ratio=0.5, chunk_frames=16, halo_frames=16)
    want = list(jp.tts_stream(TEXT, audio, **skw))
    got = list(tp.tts_stream(TEXT, audio, **skw))
    assert len(got) == len(want) >= 3
    peak = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * peak
    assert torch.is_inference_mode_enabled() is False


def test_serving_with_denoise_ratio_and_no_denoiser(pipelines):
    """No denoiser attached: every entry point runs at denoise_ratio > 0,
    with the style pair [orig; orig] (so the ratio changes nothing), as the
    JAX pipeline does."""
    _, tp, audio = pipelines
    prompt = tp.prepare_prompt(audio)
    texts = list(TEXTS)
    for ratio in (0.0, 0.5):
        kw = dict(KW, denoise_ratio=ratio)
        outs = (tp.tts(TEXT, audio, **kw), tp.tts_batch(texts, prompt=prompt, **kw),
                np.concatenate(list(tp.tts_stream(TEXT, audio, **kw))))
        if ratio == 0.0:
            base = outs
        else:
            np.testing.assert_array_equal(outs[0], base[0])
            for g, w in zip(outs[1], base[1]):
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(outs[2], base[2])
