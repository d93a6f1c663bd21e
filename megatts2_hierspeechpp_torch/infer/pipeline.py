"""Zero-shot TTS serving pipeline.

Counterpart of `megatts2_hierspeechpp_tpu/infer/pipeline.py:TTSPipeline`:

  text -> frontend -> [duration pre-pass] -> [acoustic: TTV latent -> PLM
  greedy decode -> w2v / log-f0 -> pitch clip] -> [vocoder] -> [SpeechSR]
  -> peak normalisation

Length buckets, as the JAX pipeline's (`_bucket`, `_bucket_text`): by
default (`exact=False`) the phone ids pad to `_bucket_text(n)`, and the
acoustic stage and the vocoder run at `t_voc = _bucket(frames)` 50 Hz
frames, the output cut to the request's own 320 * frames samples (times
the SR ratio). `exact=True` runs at the exact lengths (acoustic budget 2 *
predicted frames), the JAX `tts(..., exact=True)`.

Serving surface: `tts` (one request), `tts_batch` (B texts, one shared
prompt or one prompt per row, one shared bucket), `tts_stream` (chunked
Generator decode with halos, chunked SpeechSR with one chunk of
lookahead), `prepare_prompt(bucket=True)` (prompts on a 1 s grid, so
speakers share a batch) and `prompt_style` (the vocoder's style pair,
computed once per prompt). `infer/server.py` batches concurrent requests
over them. `synthesize` / `render` run the decode half alone on
caller-supplied w2v features and log-f0.

Voice conversion, `vc` (reference inference_vc.py): the source's Wav2Vec2
layer-7 features and its YIN f0, normalised to the target speaker's f0
statistics, vocoded in the target's style.

The vocoder's style is interpolated between the prompt (or target) and its
MP-SENet-denoised copy by `denoise_ratio`: the [orig; denoised] mel pair.
With no denoiser attached, the pair is [orig; orig], as in the JAX
pipeline. A vocoder or SpeechSR of bf16 compute hands back a bf16 waveform,
taken to float32 before its peak normalisation. The stages run under
torch.inference_mode; `tts`, `tts_batch` and `tts_stream` enter it per
stage, so a generator's caller is never left inside it.

Loading: `build_pipeline_from_reference_ckpts` from the reference's torch
checkpoints (`load_reference`: the port's modules carry the reference's
names), `infer/from_training.py` from the port's own training runs.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from megatts2_hierspeechpp_torch import convert
from megatts2_hierspeechpp_torch.data import text as text_frontend
from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.models import plm as plm_lib
from megatts2_hierspeechpp_torch.models.denoiser import MPNet
from megatts2_hierspeechpp_torch.models.plm import ProsodyLM
from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR, rate_for
from megatts2_hierspeechpp_torch.models.ttv import TTVModel
from megatts2_hierspeechpp_torch.models.vocoder import (
    HierVocoder,
    serving_state_dict,
)
from megatts2_hierspeechpp_torch.models.wav2vec2 import KERNELS, Hubert, Wav2Vec2
from megatts2_hierspeechpp_torch.ops.f0 import yin_f0
from megatts2_hierspeechpp_torch.ops.stft import (
    istft,
    mag_pha_stft,
    mel_spectrogram_fixed,
)

LF0_FLOOR = math.log(55.0)  # predicted log-f0 below this is unvoiced: 0
# kwargs of tts_batch, each with tts()'s meaning
BATCH_KW = frozenset({"denoise_ratio", "noise_scale_vc", "length_scale",
                      "seed", "top_k", "use_plm", "output_sr"})


def _bucket(n: int, sizes=(200, 400, 600, 800, 1200, 1600, 2000)) -> int:
    for s in sizes:
        if n <= s:
            return s
    return ((n + 399) // 400) * 400


def _bucket_text(n: int, sizes=(16, 32, 64, 96, 128, 192, 256, 384, 512)) -> int:
    for s in sizes:
        if n <= s:
            return s
    return ((n + 63) // 64) * 64


@dataclass
class PromptFeatures:
    """Per-prompt features, computed once and reused across requests."""

    mel_ttv: torch.Tensor   # (1, T_pad, 80) mel of the padded prompt
    mel_pair: torch.Tensor  # (2, T, 80) mel of [orig; denoised], true length
    t_samples: int
    # (1, 2, C) the vocoder's [orig; denoised] style pair, pooled at the
    # prompt's own length; filled by TTSPipeline.prompt_style
    style_pair: Optional[torch.Tensor] = None


@dataclass
class Acoustic:
    """Output of the acoustic stage for B rows at a budget of T 50 Hz
    frames (`frames`); `frame_lengths` holds each row's own."""

    w2v: torch.Tensor            # (B, T, 1024)
    lf0: torch.Tensor            # (B, 4T) log(f0 + 1), clipped at log(55)
    frame_mask: torch.Tensor     # (B, T, 1)
    x_frame: torch.Tensor        # (B, T, 256) TTV latent
    codes: torch.Tensor          # (B, T) int32 prosody codes
    frame_lengths: torch.Tensor  # (B,) int32

    @property
    def frames(self) -> int:
        return self.w2v.shape[1]

    def cut(self, row: int, t: int) -> "Acoustic":
        """Row `row` at its first t frames."""
        return Acoustic(self.w2v[row:row + 1, :t], self.lf0[row:row + 1, :4 * t],
                        self.frame_mask[row:row + 1, :t],
                        self.x_frame[row:row + 1, :t],
                        self.codes[row:row + 1, :t],
                        self.frame_lengths[row:row + 1])


@dataclass
class _Rows:
    """B text rows and their prompts, padded for the TTV model."""

    x_ids: torch.Tensor    # (B, N_pad) long
    tone: torch.Tensor
    lang: torch.Tensor
    x_len: torch.Tensor    # (B,) phones per row
    mel_ttv: torch.Tensor  # (B, T_pad, 80)
    mel_len: torch.Tensor  # (B,) the padded prompt-mel length, every row


@dataclass
class TTSPipeline:
    vocoder: HierVocoder
    speechsr: Optional[SpeechSR] = None
    device: str | torch.device = "cuda"
    ttv: Optional[TTVModel] = None
    plm: Optional[ProsodyLM] = None
    denoiser: Optional[MPNet] = None
    # the reference denoiser's STFT (denoiser/config.json)
    denoiser_cfg: dict = field(default_factory=lambda: dict(
        n_fft=400, hop=100, win=400, compress=0.3))

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _check_output_sr(self, output_sr: int) -> float:
        """Validate output_sr against the attached SpeechSR and return the
        sample-count ratio to 16 kHz."""
        if output_sr == 16000:
            return 1.0
        if self.speechsr is None:
            raise ValueError(f"output_sr={output_sr} needs a SpeechSR model")
        num, den = self.speechsr.rate_num, self.speechsr.rate_den
        model_sr = 16000 * num // den
        if output_sr != model_sr:
            raise ValueError(
                f"output_sr={output_sr} does not match the loaded SpeechSR "
                f"model (x{num}/{den} -> {model_sr} Hz); load the matching "
                "checkpoint or request output_sr=16000")
        return num / den

    def _check_tts(self, use_plm: bool = True, codes=None) -> None:
        if self.ttv is None or (use_plm and codes is None and self.plm is None):
            raise ValueError("tts needs the ttv (and plm) models")

    @torch.inference_mode()
    def denoise(self, audio) -> torch.Tensor:
        """MP-SENet denoising (reference denoiser/infer.py): audio (T,) at
        16 kHz -> (T,) on the pipeline's device. The waveform is scaled to
        unit RMS, the denoiser maps its compressed STFT magnitude and phase,
        the magnitude is decompressed, and the iSTFT is scaled back."""
        if self.denoiser is None:
            raise ValueError("denoise needs a denoiser (MPNet)")
        cfg = self.denoiser_cfg
        wav = torch.as_tensor(np.asarray(audio, np.float32)).to(self.device)[None]
        norm = torch.sqrt(wav.shape[-1] / wav.square().sum())
        mag, pha = mag_pha_stft(wav * norm, cfg["n_fft"], cfg["hop"],
                                cfg["win"], cfg["compress"])
        mag, pha = self.denoiser(mag, pha)
        spec = torch.polar(mag ** (1.0 / cfg["compress"]), pha)
        out = istft(spec, cfg["n_fft"], cfg["hop"], cfg["win"],
                    length=wav.shape[-1])
        return (out / norm)[0]

    def _mel_pair(self, audio: np.ndarray, padded: np.ndarray,
                  denoise_ratio: float) -> torch.Tensor:
        """(2, T, 80) mel of [audio; denoised audio] at the true length; the
        denoiser runs on the padded audio when denoise_ratio > 0 and one is
        attached, else the second row is the audio itself."""
        orig = torch.from_numpy(audio).to(self.device)
        if denoise_ratio > 0 and self.denoiser is not None:
            den = self.denoise(padded)[:len(audio)]
        else:
            den = orig
        return mel_spectrogram_fixed(torch.stack([orig, den]))

    @torch.inference_mode()
    def prepare_prompt(self, prompt_audio: np.ndarray,
                       denoise_ratio: float = 0.0,
                       bucket: bool = False) -> PromptFeatures:
        """prompt_audio: (T,) float at 16 kHz. mel_ttv is the mel of the
        prompt zero-padded to (T // grid + 1) * grid samples (always at
        least one sample, as the reference pads), grid 1600 (100 ms, the
        reference's) or with bucket=True 16000 (1 s: many speakers share a
        padded length, so they batch); mel_pair is the mel of [orig;
        denoised] at the true length, the padded prompt denoised when
        denoise_ratio > 0 (see _mel_pair)."""
        audio = np.asarray(prompt_audio, np.float32)
        t_a = len(audio)
        grid = 16000 if bucket else 1600
        padded = np.pad(audio, (0, (t_a // grid + 1) * grid - t_a))
        mel_ttv = mel_spectrogram_fixed(
            torch.from_numpy(padded[None]).to(self.device))
        mel_pair = self._mel_pair(audio, padded, denoise_ratio)
        return PromptFeatures(mel_ttv=mel_ttv, mel_pair=mel_pair, t_samples=t_a)

    @torch.inference_mode()
    def prompt_style(self, prompt: PromptFeatures) -> torch.Tensor:
        """(1, 2, C) vocoder style pair of a prompt, computed once and
        cached on it (pooled at the prompt's own length)."""
        if prompt.style_pair is None:
            mel = prompt.mel_pair
            prompt.style_pair = self.vocoder.style_pairs(
                mel, torch.ones(*mel.shape[:2], 1, device=mel.device))
        return prompt.style_pair

    # ---------- acoustic half ----------

    def _rows(self, texts: Sequence[str], prompts: Sequence[PromptFeatures],
              exact: bool) -> _Rows:
        """Phone ids, tones and languages of B texts, zero-padded to the
        longest (exact) or to its _bucket_text; the prompts' mels (one
        padded length for all rows)."""
        seqs = [text_frontend.process_text(t) for t in texts]
        n_max = max(len(ids) for ids, _, _ in seqs)
        n_pad = n_max if exact else _bucket_text(n_max)
        arr = np.zeros((3, len(seqs), n_pad), np.int64)
        for i, seq in enumerate(seqs):
            arr[:, i, :len(seq[0])] = seq
        ids, tone, lang = torch.from_numpy(arr).to(self.device)
        x_len = torch.tensor([len(q[0]) for q in seqs], device=self.device)
        lens = {p.mel_ttv.shape[1] for p in prompts}
        if len(lens) != 1:
            raise ValueError(
                "per-row prompts must share the padded prompt-mel length "
                f"(got {sorted(lens)}); prepare_prompt(bucket=True) puts "
                "speakers on a common 1 s grid")
        if len({id(p) for p in prompts}) == 1:
            mel = prompts[0].mel_ttv.repeat(len(prompts), 1, 1)
        else:
            mel = torch.cat([p.mel_ttv for p in prompts])
        mel_len = torch.full((len(prompts),), mel.shape[1], device=self.device)
        return _Rows(ids, tone, lang, x_len, mel, mel_len)

    def _prompt_rows(self, texts, prompt):
        """(single, texts, prompts): a str or a list of texts, one prompt or
        one per text."""
        single = isinstance(texts, str)
        texts = [texts] if single else list(texts)
        prompts = (list(prompt) if isinstance(prompt, (list, tuple))
                   else [prompt] * len(texts))
        if len(prompts) != len(texts):
            raise ValueError(f"{len(prompts)} prompts for {len(texts)} texts")
        return single, texts, prompts

    @torch.inference_mode()
    def _frames(self, rows: _Rows, length_scale: float) -> np.ndarray:
        return self.ttv.predict_frame_lengths(
            rows.x_ids, rows.tone, rows.lang, rows.x_len, rows.mel_ttv,
            rows.mel_len, length_scale).cpu().numpy()

    @torch.inference_mode()
    def _acoustic(self, rows: _Rows, frames: int, length_scale: float = 1.0,
                  mode: str = "plm", top_k: int = 0, seed: int = 1234,
                  codes: Optional[np.ndarray] = None) -> Acoustic:
        x_frame, g, frame_lengths, frame_mask = self.ttv.inf_extract_tc_latent(
            rows.x_ids, rows.tone, rows.lang, rows.x_len, rows.mel_ttv,
            rows.mel_len, 2 * frames, length_scale=length_scale)
        b, t_need = x_frame.shape[:2]
        if mode == "plm":
            pcodes = plm_lib.decode(
                self.plm, x_frame, top_k=top_k,
                generator=torch.Generator(self.device).manual_seed(seed))
        elif mode == "given":
            given = torch.as_tensor(np.asarray(codes), dtype=torch.int32)
            given = given.reshape(b, -1)[:, :t_need].to(self.device)
            pcodes = torch.zeros(b, t_need, dtype=torch.int32, device=self.device)
            pcodes[:, :given.shape[1]] = given
        elif mode == "prompt":
            pc = self.ttv.prompt_codes(rows.mel_ttv, rows.mel_len)
            reps = -(-t_need // pc.shape[1])
            pcodes = pc.repeat(1, reps)[:, :t_need]
        else:
            raise ValueError(f"unknown acoustic mode {mode!r}")
        w2v, lf0 = self.ttv.inf_plm_gen(x_frame, g, pcodes[None], frame_mask)
        # pitch clip (inference_plm.py:169): the vocoder takes log(f0 + 1)
        # as it comes, with unvoiced frames at 0
        lf0 = torch.where(lf0 < LF0_FLOOR, torch.zeros_like(lf0), lf0)
        return Acoustic(w2v, lf0, frame_mask, x_frame, pcodes, frame_lengths)

    def duration(self, text, prompt, length_scale: float = 1.0,
                 exact: bool = False):
        """Duration pre-pass: the predicted 50 Hz frame count of `text` (an
        int), or of each of a list of texts (an int array); `prompt` is one
        PromptFeatures or one per text. The text pads as `tts(exact=...)`
        pads it (the duration predictor's LSTM reads the padding)."""
        single, texts, prompts = self._prompt_rows(text, prompt)
        frames = self._frames(self._rows(texts, prompts, exact), length_scale)
        return int(frames[0]) if single else frames

    def acoustic(self, text, prompt, frames: int, length_scale: float = 1.0,
                 mode: str = "plm", top_k: int = 0, seed: int = 1234,
                 codes: Optional[np.ndarray] = None,
                 exact: bool = False) -> Acoustic:
        """TTV latent -> prosody codes -> w2v / log-f0 -> pitch clip, for
        one text or a list (`prompt`: one or one per text), at a 100 Hz
        budget of 2 * frames shared by the rows.

        mode "plm": greedy (top_k 0) or top-k PLM decode, the top-k draws
        from a generator on the pipeline's device seeded with `seed`;
        "prompt": the prompt's own RVQ codes tiled to the length; "given":
        `codes`, zero-padded or cut to the length."""
        _, texts, prompts = self._prompt_rows(text, prompt)
        return self._acoustic(self._rows(texts, prompts, exact), frames,
                              length_scale, mode, top_k, seed, codes)

    def tts(self, text: str, prompt_audio: Optional[np.ndarray] = None,
            denoise_ratio: float = 0.0, noise_scale_vc: float = 0.333,
            length_scale: float = 1.0, output_sr: int = 16000,
            seed: int = 1234, top_k: int = 0, use_plm: bool = True,
            prompt: Optional[PromptFeatures] = None, exact: bool = False,
            codes: Optional[np.ndarray] = None,
            return_intermediates: bool = False):
        """Text + prompt -> float32 numpy waveform at output_sr, peak 0.999.

        With return_intermediates, also returns the Acoustic outputs cut to
        the request's frames and the waveform before normalisation (on the
        device)."""
        self._check_tts(use_plm, codes)
        ratio = self._check_output_sr(output_sr)  # fail before any compute
        if prompt is None:
            if prompt_audio is None:
                raise ValueError("need prompt_audio or prompt features")
            prompt = self.prepare_prompt(prompt_audio, denoise_ratio)
        mode = "given" if codes is not None else ("plm" if use_plm else "prompt")
        rows = self._rows([text], [prompt], exact)
        frames = int(self._frames(rows, length_scale)[0])
        t_voc = frames if exact else _bucket(frames)
        ac = self._acoustic(rows, t_voc, length_scale, mode, top_k, seed, codes)
        wav = self._vocode(prompt, ac, noise_scale_vc, seed, denoise_ratio,
                           output_sr)
        raw = wav[0, :int(320 * frames * ratio)]
        out = _peak_normalise(raw.float().cpu().numpy())
        if return_intermediates:
            return out, ac.cut(0, frames), raw
        return out

    def tts_batch(self, texts: Sequence[str],
                  prompt_audio: Optional[np.ndarray] = None,
                  prompt: Optional[PromptFeatures] = None,
                  prompts: Optional[Sequence[PromptFeatures]] = None,
                  **kw) -> list:
        """B texts in one pass: text padded to one bucket, the acoustic
        stage and the vocoder at B rows and one frame bucket (the longest
        row's), each row cut to its own length and peak-normalised.

        Prompts: `prompt` / `prompt_audio`, one speaker shared by the rows
        (its style broadcast over them), or `prompts`, one per row, which
        must share the padded prompt-mel length (prepare_prompt(bucket=
        True)); their style pairs are each pooled at the prompt's own
        length (prompt_style, cached), so each row computes what its own
        tts() call does. Unknown kwargs raise rather than give other audio
        than tts() would."""
        unknown = set(kw) - BATCH_KW
        if unknown:
            raise ValueError(
                f"tts_batch does not support kwargs {sorted(unknown)}; "
                "use tts() for per-request options")
        denoise_ratio = kw.get("denoise_ratio", 0.0)
        use_plm = kw.get("use_plm", True)
        self._check_tts(use_plm)
        output_sr = kw.get("output_sr", 16000)
        ratio = self._check_output_sr(output_sr)
        b = len(texts)
        if prompts is not None:
            if prompt is not None or prompt_audio is not None:
                raise ValueError("pass either `prompts` (per-row) or a shared "
                                 "`prompt`/`prompt_audio`, not both")
            if len(prompts) != b:
                raise ValueError(f"{len(prompts)} prompts for {b} texts")
            rows = self._rows(texts, prompts, exact=False)
        else:
            if prompt is None:
                if prompt_audio is None:
                    raise ValueError("need prompt_audio, prompt or prompts")
                prompt = self.prepare_prompt(prompt_audio, denoise_ratio)
            rows = self._rows(texts, [prompt] * b, exact=False)
        length_scale = kw.get("length_scale", 1.0)
        seed = kw.get("seed", 1234)
        frames = self._frames(rows, length_scale)
        ac = self._acoustic(rows, _bucket(int(frames.max())), length_scale,
                            "plm" if use_plm else "prompt", kw.get("top_k", 0),
                            seed)
        style = (list(prompts) if prompts is not None else prompt)
        wav = self._vocode(style, ac, kw.get("noise_scale_vc", 0.333), seed,
                           denoise_ratio, output_sr).float().cpu().numpy()
        return [_peak_normalise(wav[i, :int(320 * int(frames[i]) * ratio)])
                for i in range(b)]

    def tts_stream(self, text: str, prompt_audio: Optional[np.ndarray] = None,
                   denoise_ratio: float = 0.0, noise_scale_vc: float = 0.333,
                   length_scale: float = 1.0, seed: int = 1234,
                   top_k: int = 0, use_plm: bool = True,
                   prompt: Optional[PromptFeatures] = None,
                   chunk_frames: int = 200, halo_frames: int = 32,
                   output_sr: int = 16000, sr_halo: int = 512):
        """Streaming TTS: yields float32 numpy chunks (4 s of audio per chunk
        at the default) as the Generator decodes them.

        The vocoder splits at the Generator (HierVocoder.vc_latent /
        decode_latent): style, posterior, flows and SourceNetwork run once
        over the bucketed utterance; the convolutional Generator decodes
        overlapping chunks with `halo_frames` of real latent on each inner
        side, discarded. The first and last chunks carry no outer halo:
        their array edge is the sequence edge, where the whole decode pads
        each layer with zeros (a zero-input halo is not that, since biases
        and the style make padded activations nonzero). Interior windows lie
        wholly inside [0, t_voc); the last segment absorbs the rest. The
        emitted total is the request's 320 * frames samples. Chunks are raw
        tanh output, not peak-normalised (the global peak is unknown
        mid-stream).

        output_sr != 16000 super-resolves each piece with `sr_halo` real
        samples on each inner side and one chunk of lookahead (the SR
        stack's right halo is the next chunk); a final raw chunk shorter
        than sr_halo is merged into the previous piece."""
        self._check_tts(use_plm)
        ratio = self._check_output_sr(output_sr)
        ck, h = chunk_frames, halo_frames
        if ck < h:
            raise ValueError("chunk_frames must be >= halo_frames")
        if prompt is None:
            if prompt_audio is None:
                raise ValueError("need prompt_audio or prompt features")
            prompt = self.prepare_prompt(prompt_audio, denoise_ratio)
        rows = self._rows([text], [prompt], exact=False)
        frames = int(self._frames(rows, length_scale)[0])
        t_voc = _bucket(frames)
        ac = self._acoustic(rows, t_voc, length_scale,
                            "plm" if use_plm else "prompt", top_k, seed)
        z, e, g = self._latent(prompt, ac, noise_scale_vc, seed, denoise_ratio)

        if t_voc <= ck + h:
            segments = [("full", 0, t_voc)]
        else:
            s, starts = ck, []
            while s + ck + h <= t_voc:
                starts.append(s)
                s += ck
            segments = ([("first", 0, ck)] + [("mid", x, ck) for x in starts]
                        + [("last", s, t_voc - s)])

        def raw_chunks():
            emitted = 0
            for kind, start, length in segments:
                chunk = self._decode_chunk(z, e, g, kind, start, length, h)
                take = min(len(chunk), 320 * frames - emitted)
                if take <= 0:
                    break
                emitted += take
                yield chunk[:take]

        if ratio == 1.0:
            yield from raw_chunks()
            return
        hs = sr_halo
        prev, prev_left = None, None
        for r in raw_chunks():
            if prev is not None:
                if len(r) < hs:
                    # too short to be a right halo: merged into the previous
                    # piece, which then ends at the sequence edge
                    prev = np.concatenate([prev, r])
                    continue
                yield self._sr_piece(prev, prev_left, r[:hs])
                prev_left = prev[-hs:]
            prev = r
        if prev is not None:
            yield self._sr_piece(prev, prev_left, None)

    # ---------- decode half ----------

    def _style(self, style):
        """The vocoder's style input: (mel_pair, trg_mask) of one shared
        prompt, or the (B, 2, C) cached style pairs of per-row prompts."""
        if isinstance(style, PromptFeatures):
            mel = style.mel_pair
            return mel, torch.ones(*mel.shape[:2], 1, device=self.device)
        return torch.cat([self.prompt_style(p) for p in style])

    @torch.inference_mode()
    def _vocode(self, style, ac: Acoustic, noise_scale: float, seed: int,
                denoise_ratio: float, output_sr: int) -> torch.Tensor:
        """(B, N) waveform at output_sr over the whole budget, uncut. style:
        a PromptFeatures or a list of one per row. The posterior noise comes
        from torch.Generator().manual_seed(seed + 1)."""
        gen = torch.Generator().manual_seed(seed + 1)
        f0 = ac.lf0[..., None]
        st = self._style(style)
        if isinstance(st, tuple):
            wav = self.vocoder.voice_conversion(
                ac.w2v, ac.frame_mask, *st, f0, noise_scale, gen, denoise_ratio)
        else:
            wav = self.vocoder.voice_conversion_from_style(
                ac.w2v, ac.frame_mask, st, f0, noise_scale, gen, denoise_ratio)
        if self._check_output_sr(output_sr) != 1.0:
            wav = self.speechsr(wav)
        return wav[..., 0]

    @torch.inference_mode()
    def _latent(self, prompt: PromptFeatures, ac: Acoustic, noise_scale: float,
                seed: int, denoise_ratio: float):
        mel, mask = self._style(prompt)
        return self.vocoder.vc_latent(
            ac.w2v, ac.frame_mask, mel, mask, ac.lf0[..., None], noise_scale,
            torch.Generator().manual_seed(seed + 1), denoise_ratio)

    @torch.inference_mode()
    def _decode_chunk(self, z, e, g, kind: str, start: int, length: int,
                      h: int) -> np.ndarray:
        """One streamed Generator segment (tts_stream's plan) -> float32
        numpy samples."""
        if kind == "full":
            wav = self.vocoder.decode_latent(z, e, g)
        elif kind == "first":
            wav = self.vocoder.decode_latent(
                z[:, :length + h], e[:, :4 * (length + h)], g)[:, :320 * length]
        elif kind == "mid":
            lo, hi = start - h, start + length + h
            wav = self.vocoder.decode_latent(
                z[:, lo:hi], e[:, 4 * lo:4 * hi], g)[:, 320 * h:320 * (h + length)]
        else:  # last
            wav = self.vocoder.decode_latent(
                z[:, start - h:], e[:, 4 * (start - h):], g)[:, 320 * h:]
        return wav[0, :, 0].float().cpu().numpy()

    @torch.inference_mode()
    def _sr_piece(self, mid: np.ndarray, left, right) -> np.ndarray:
        """SpeechSR of one streamed piece with its real-sample halos (None at
        a sequence edge), cut to the piece's own output samples."""
        num, den = self.speechsr.rate_num, self.speechsr.rate_den
        x = np.concatenate([p for p in (left, mid, right) if p is not None])
        y = self.speechsr(torch.from_numpy(x).to(self.device)[None, :, None])
        start = 0 if left is None else len(left) * num // den
        return y[0, start:start + len(mid) * num // den, 0].float().cpu().numpy()

    @torch.inference_mode()
    def render(self, prompt: PromptFeatures, w2v, frame_mask, lf0,
               noise_scale: float = 0.333, seed: int = 1234,
               denoise_ratio: float = 0.0, output_sr: int = 16000):
        """The waveform before peak normalisation, (N,) on the device.

        w2v: (1, T, 1024); frame_mask: (1, T, 1); lf0: (1, 4T) log(f0 + 1).
        The posterior noise comes from torch.Generator().manual_seed(seed +
        1)."""
        ratio = self._check_output_sr(output_sr)
        t_frames = w2v.shape[1]
        dev = self.device
        wav = self.vocoder.voice_conversion(
            w2v.to(dev), frame_mask.to(dev), *self._style(prompt),
            lf0.to(dev)[..., None], noise_scale,
            torch.Generator().manual_seed(seed + 1), denoise_ratio)
        if ratio != 1.0:
            wav = self.speechsr(wav)
        return wav[0, :int(320 * t_frames * ratio), 0]

    @torch.inference_mode()
    def vc(self, source_audio: np.ndarray, target_audio: np.ndarray,
           w2v_model: Wav2Vec2, denoise_ratio: float = 0.0,
           noise_scale_vc: float = 0.333, output_sr: int = 16000,
           seed: int = 1234, src_f0: Optional[np.ndarray] = None,
           trg_f0: Optional[np.ndarray] = None,
           return_intermediates: bool = False):
        """Voice conversion (reference inference_vc.py): the source's
        content and pitch contour in the target's voice -> float32 numpy
        waveform at output_sr, peak 0.999, over the padded source.

        The source is zero-padded to a multiple of 1280 samples (at least
        one added); w2v_model reads it reflect-padded by 40 on each side
        (T / 320 frames). Its f0 (YIN at 200 Hz, or `src_f0`) is normalised
        to the target's voiced-frame mean and standard deviation (YIN, or
        `trg_f0`; both in Hz, 0 where unvoiced) when both have voiced
        frames, clipped at 0, and enters the vocoder as log(f0 + 1), cut or
        zero-padded to 4 values per frame. The style is the target's
        [orig; denoised] pair (prepare_prompt's, on the 1600 grid). The
        posterior noise comes from torch.Generator().manual_seed(seed)
        (tts uses seed + 1, as the JAX pipeline does).

        With return_intermediates, also returns dict(w2v (1, T, 1024) on
        the device, lf0 (the whole log(f0 + 1) contour, numpy), t_frames)."""
        ratio = self._check_output_sr(output_sr)  # fail before any compute
        dev = self.device
        src = np.asarray(source_audio, np.float32)
        t_s = len(src)
        src = torch.from_numpy(np.pad(src, (0, (t_s // 1280 + 1) * 1280 - t_s)))
        src = src.to(dev)[None]
        w2v = w2v_model(F.pad(src[:, None], (40, 40), mode="reflect")[:, 0])
        t_frames = w2v.shape[1]
        trg = np.asarray(target_audio, np.float32)
        f0 = (np.array(src_f0, np.float32) if src_f0 is not None
              else yin_f0(src)[0].cpu().numpy())
        t_f0 = (np.asarray(trg_f0, np.float32) if trg_f0 is not None
                else yin_f0(torch.from_numpy(trg).to(dev)[None])[0].cpu().numpy())
        ii, jj = f0 != 0, t_f0 != 0
        if ii.any() and jj.any():  # numpy std: ddof 0, as the reference
            f0[ii] = (f0[ii] - f0[ii].mean()) / max(f0[ii].std(), 1e-6)
            f0[ii] = np.clip(f0[ii] * t_f0[jj].std() + t_f0[jj].mean(), 0, None)
        lf0 = np.log(f0 + 1.0)
        lf0_in = np.zeros(4 * t_frames, np.float32)
        lf0_in[:min(len(lf0), 4 * t_frames)] = lf0[:4 * t_frames]

        t_t = len(trg)
        padded = np.pad(trg, (0, (t_t // 1600 + 1) * 1600 - t_t))
        mel = self._mel_pair(trg, padded, denoise_ratio)
        wav = self.vocoder.voice_conversion(
            w2v, torch.ones(1, t_frames, 1, device=dev), mel,
            torch.ones(*mel.shape[:2], 1, device=dev),
            torch.from_numpy(lf0_in).to(dev)[None, :, None], noise_scale_vc,
            torch.Generator().manual_seed(seed), denoise_ratio)
        if ratio != 1.0:
            wav = self.speechsr(wav)
        out = _peak_normalise(wav[0, :, 0].float().cpu().numpy())
        if return_intermediates:
            return out, dict(w2v=w2v, lf0=lf0, t_frames=t_frames)
        return out

    def synthesize(self, prompt: PromptFeatures, w2v, frame_mask, lf0,
                   noise_scale: float = 0.333, seed: int = 1234,
                   denoise_ratio: float = 0.0,
                   output_sr: int = 16000) -> np.ndarray:
        """Vocode + super-resolve + peak-normalise to 0.999 -> float32 numpy
        waveform at output_sr."""
        return _peak_normalise(self.render(
            prompt, w2v, frame_mask, lf0, noise_scale, seed, denoise_ratio,
            output_sr).float().cpu().numpy())


def _peak_normalise(wav: np.ndarray) -> np.ndarray:
    peak = np.abs(wav).max()
    return (wav / max(peak, 1e-8) * 0.999).astype(np.float32)


# ---------- reference checkpoints ----------


def load_torch_checkpoint(path: str) -> dict:
    """A reference .pth checkpoint's model state_dict on the CPU: its
    "model" entry, or the file's dict itself (JAX infer/pipeline.py:58)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return dict(ckpt.get("model", ckpt))


_LSTM_BIAS_HH = re.compile(r"(.*)\.bias_hh_(l\d+(?:_reverse)?)")


def load_reference(module: torch.nn.Module, state_dict: dict):
    """Load a reference-named state_dict into `module` and return it.

    Every key of the module must be in it (missing keys raise); keys the
    module lacks are dropped, as the JAX converters read only their
    modules' keys. Each LSTM's two biases become one, bias_ih + bias_hh
    with bias_hh 0, as the JAX converters fold them (the port trains
    bias_ih alone, nn/lstm.py)."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state_dict))
    if missing:
        raise KeyError(f"{type(module).__name__}: the checkpoint lacks "
                       f"{len(missing)} keys, e.g. {missing[:4]}")
    sd = {k: state_dict[k] for k in own}
    for k in own:
        m = _LSTM_BIAS_HH.fullmatch(k)
        if m:
            ih = f"{m.group(1)}.bias_ih_{m.group(2)}"
            sd[ih] = sd[ih].float() + sd[k].float()
            sd[k] = torch.zeros_like(sd[ih])
    module.load_state_dict(sd, strict=True)
    return module


def load_speechsr(path: str, output_sr: int = 48000, dtype=None,
                  device: str | torch.device = "cuda") -> SpeechSR:
    """A serving SpeechSR from a reference checkpoint: the Generator's
    `dec.`-prefixed keys (JAX convert_speechsr(sd, "dec")); its width is the
    checkpoint's."""
    sd = {k[len("dec."):]: v for k, v in load_torch_checkpoint(path).items()
          if k.startswith("dec.")}
    return speechsr_from_state_dict(sd, output_sr, dtype, device)


def speechsr_from_state_dict(sd: dict, output_sr: int = 48000, dtype=None,
                             device: str | torch.device = "cuda") -> SpeechSR:
    """A serving SpeechSR of a state_dict in the port's names (a reference
    Generator's `dec.` keys, or a cli/train_sr run's "gen"); its width is
    the state_dict's."""
    sr = SpeechSR(int(sd["conv_pre.weight_v"].shape[0]), *rate_for(output_sr),
                  device="cpu", dtype=dtype)
    return load_reference(sr, sd).to(resolve_device(device))


def load_denoiser(path: str, device: str | torch.device = "cuda") -> MPNet:
    """The MP-SENet denoiser of a reference checkpoint: its "generator"
    entry, else its "model" entry, else the file's dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("generator", ckpt.get("model", ckpt))
    return load_reference(MPNet(device="cpu"), sd).to(resolve_device(device))


def wav2vec2_state_dict(sd: dict) -> dict:
    """An HF Wav2Vec2ForPreTraining (or Wav2Vec2Model) state_dict in the
    port's names: the optional `wav2vec2.` prefix stripped, and the
    positional conv's weight norm (weight_g / weight_v, or the
    parametrizations' original0 / original1) fused and stored as g = |w|,
    v = w, as JAX convert_wav2vec2 and convert.wav2vec2_from_jax carry it.
    The layers past the port's and the pre-training heads are left for
    load_reference to drop."""
    pfx = "wav2vec2." if any(k.startswith("wav2vec2.") for k in sd) else ""
    sd = {k[len(pfx):]: v for k, v in sd.items() if k.startswith(pfx)}
    base = "encoder.pos_conv_embed.conv"
    names = ((f"{base}.weight_g", f"{base}.weight_v")
             if f"{base}.weight_g" in sd else
             (f"{base}.parametrizations.weight.original0",
              f"{base}.parametrizations.weight.original1"))
    g, v = (sd.pop(n).detach().float().numpy() for n in names)
    convert.pos_conv_weight_norm(sd, base, convert.fuse_pos_conv(g, v))
    return sd


def load_wav2vec2(path: str, device: str | torch.device = "cuda") -> Wav2Vec2:
    """The 7-layer Wav2Vec2 (vc and the .hw2v sidecars) from an HF mms-300m
    state_dict file (wav2vec2_state_dict)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return load_reference(Wav2Vec2(device="cpu"),
                          wav2vec2_state_dict(sd)).to(resolve_device(device))


def hubert_state_dict(sd: dict) -> dict:
    """An HF HubertModel state_dict in the port's names: the optional
    `hubert.` prefix stripped, the positional conv's parametrizations
    spelling (original0 / original1) renamed to weight_g / weight_v (the
    same weight norm over the kernel axis)."""
    sd = {k.removeprefix("hubert."): v for k, v in sd.items()}
    base = "encoder.pos_conv_embed.conv.parametrizations.weight"
    if f"{base}.original0" in sd:
        conv = "encoder.pos_conv_embed.conv"
        sd[f"{conv}.weight_g"] = sd.pop(f"{base}.original0")
        sd[f"{conv}.weight_v"] = sd.pop(f"{base}.original1")
    return sd


def load_hubert(sd: dict, n_heads: int = 12,
                device: str | torch.device = "cuda") -> Hubert:
    """A Hubert of an HF HubertModel state_dict's widths and depth (the head
    count is not recoverable from it) with its weights (hubert_state_dict),
    on `device`."""
    sd = hubert_state_dict(sd)
    n_layers = max(int(k.split(".")[2]) for k in sd
                   if k.startswith("encoder.layers.")) + 1
    pos_v = sd["encoder.pos_conv_embed.conv.weight_v"]
    hidden = sd["feature_projection.projection.bias"].shape[0]
    model = Hubert(
        hidden_size=hidden, n_heads=n_heads,
        ffn_dim=sd["encoder.layers.0.feed_forward.intermediate_dense.bias"].shape[0],
        n_layers=n_layers, pos_conv_kernel=pos_v.shape[2],
        pos_conv_groups=hidden // pos_v.shape[1],
        conv_dim=tuple(sd[f"feature_extractor.conv_layers.{i}.conv.weight"].shape[0]
                       for i in range(len(KERNELS))),
        device="cpu")
    return load_reference(model, sd).to(resolve_device(device))


def build_pipeline_from_reference_ckpts(
        ttv_ckpt: str, plm_ckpt: str, vocoder_ckpt: str,
        speechsr_ckpt: Optional[str] = None,
        denoiser_ckpt: Optional[str] = None, speechsr_rate: int = 48000,
        device: str | torch.device = "cuda") -> TTSPipeline:
    """A TTSPipeline from the reference's torch checkpoints at the
    published widths (JAX infer/pipeline.py:848): the TTV, the PLM and the
    vocoder (its training-only members dropped, serving_state_dict), and
    optionally SpeechSR (`speechsr_rate` 24000 or 48000) and the denoiser.
    Float32, on `device`."""
    dev = resolve_device(device)
    ttv = load_reference(
        TTVModel(n_vocab=text_frontend.N_VOCAB, n_tone=text_frontend.N_TONE,
                 n_language=text_frontend.N_LANGUAGE, device="cpu"),
        load_torch_checkpoint(ttv_ckpt))
    plm = load_reference(ProsodyLM(device="cpu"), load_torch_checkpoint(plm_ckpt))
    voc = load_reference(HierVocoder(device="cpu"),
                         serving_state_dict(load_torch_checkpoint(vocoder_ckpt)))
    sr = (load_speechsr(speechsr_ckpt, speechsr_rate, device=dev)
          if speechsr_ckpt else None)
    den = load_denoiser(denoiser_ckpt, dev) if denoiser_ckpt else None
    return TTSPipeline(voc.to(dev), sr, dev, ttv=ttv.to(dev), plm=plm.to(dev),
                       denoiser=den)
