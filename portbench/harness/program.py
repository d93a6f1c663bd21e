"""The system under test: the port's TTSPipeline behind its TTSServer, and
the benchmark's instruments around the calls into each of its layers.

`build` makes the pipeline as the configuration's entry point does
(infer/pipeline.build_pipeline_from_reference_ckpts for float32,
infer/from_training.build_pipeline_from_train_dirs for a compute dtype):
each model constructed at the configuration's widths, moved to the device
and loaded, with load_reference, from the benchmark's own state_dicts.

`Recorder` stands between the server and the pipeline. It forwards
`tts` / `tts_batch` and records each call's rows, host span, padded shapes
and the outputs the reference judges: the duration predictor's output
(log durations), the integer durations the TTV took from it
(TTVModel._durations) and the prosody codes served (models/plm.decode). Around the pipeline's stages it opens profiler
ranges named pb.call, pb.duration, pb.latent, pb.decode, pb.w2v,
pb.vocoder and pb.speechsr, which a traced run reads.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field

import torch

PORT_KEYS = {
    "ttv": ("n_vocab", "n_tone", "n_language", "inter_channels",
            "hidden_channels", "gin_channels", "prosody_size", "vq_bins",
            "stride", "text_layers", "mel_enc_layers", "w2v_enc_layers",
            "w2v_dec_layers"),
    "plm": ("n_layers", "n_heads", "vq_dim", "tc_latent_dim", "vq_bins"),
    "vocoder": ("inter_channels", "hidden_channels", "resblock_kernel_sizes",
                "resblock_dilation_sizes", "upsample_rates",
                "upsample_initial_channel", "upsample_kernel_sizes",
                "gin_channels", "posterior_wn_layers", "n_flows", "flow_layers"),
    "speechsr": ("upsample_initial_channel", "rate_num", "rate_den",
                 "resblock_kernel_sizes", "resblock_dilation_sizes"),
}
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def build(cfg: dict, states: dict, device):
    from megatts2_hierspeechpp_torch.infer.pipeline import (
        TTSPipeline, load_reference)
    from megatts2_hierspeechpp_torch.models.plm import ProsodyLM
    from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR
    from megatts2_hierspeechpp_torch.models.ttv import TTVModel
    from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder

    dtype = DTYPES[cfg["compute_dtype"]]
    dev = torch.device(device)
    models = {}
    for name, cls in (("ttv", TTVModel), ("plm", ProsodyLM),
                      ("vocoder", HierVocoder), ("speechsr", SpeechSR)):
        kw = {k: cfg[name][k] for k in PORT_KEYS[name]}
        for k in ("resblock_kernel_sizes", "upsample_rates", "upsample_kernel_sizes"):
            if k in kw:
                kw[k] = tuple(kw[k])
        if "resblock_dilation_sizes" in kw:
            kw["resblock_dilation_sizes"] = tuple(map(tuple, kw["resblock_dilation_sizes"]))
        m = cls(**kw, device="cpu", dtype=dtype).to(dev)
        models[name] = load_reference(m, states[name])
    return TTSPipeline(models["vocoder"], models["speechsr"], dev,
                       ttv=models["ttv"], plm=models["plm"])


@dataclass
class Call:
    """One pipeline call as the recorder saw it."""
    t0: float
    t1: float = 0.0
    keys: list = field(default_factory=list)    # (text, voice) per row
    n_pad: int = 0
    bucket: int = 0
    dur: object = None      # (B, n_pad) integer durations, as predicted
    logw: object = None     # (B, n_pad) the duration predictor's output
    codes: object = None    # (B, bucket) codes, as served
    ok: bool = True


def _span(name, fn):
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return wrapped


class Recorder:
    """The pipeline as TTSServer sees it: tts / tts_batch forwarded, each
    call recorded (see the module docstring). `voice_of` maps a prompt's
    id to its voice number. All recording happens in the server's worker
    thread, the only caller."""

    def __init__(self, pipe, voice_of: dict, clock=time.perf_counter):
        self.pipe, self.voice_of, self.clock = pipe, voice_of, clock
        self.device = pipe.device
        self.calls: list[Call] = []
        self.tracer = None             # set by a traced run (trace.Tracer)
        self._dur, self._logw, self._codes = [], [], []
        self._undo = []
        ttv = pipe.ttv
        self._patch(ttv, "_durations", self._record_durations(ttv._durations))
        self._patch(ttv.duration_predictor, "forward",
                    self._record_logw(ttv.duration_predictor.forward))
        for obj, attr, span in ((ttv, "predict_frame_lengths", "pb.duration"),
                                (ttv, "inf_extract_tc_latent", "pb.latent"),
                                (ttv, "inf_plm_gen", "pb.w2v"),
                                (pipe.vocoder, "voice_conversion", "pb.vocoder"),
                                (pipe.vocoder, "voice_conversion_from_style", "pb.vocoder"),
                                (pipe.speechsr, "forward", "pb.speechsr")):
            self._patch(obj, attr, _span(span, getattr(obj, attr)))
        from megatts2_hierspeechpp_torch.models import plm as plm_lib
        # the pipeline looks decode up on its module at each call
        self._patch(plm_lib, "decode", _span("pb.decode",
                                             self._record_codes(plm_lib.decode)),
                    module=True)

    def _patch(self, obj, attr, new, module=False):
        old = obj.__dict__.get(attr, None) if not module else getattr(obj, attr)
        setattr(obj, attr, new)
        self._undo.append((obj, attr, old, module))

    def close(self):
        """Take the instruments off the program."""
        for obj, attr, old, module in reversed(self._undo):
            if module or old is not None:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)
        self._undo = []

    def _record_durations(self, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            self._dur.append(out[3])
            return out
        return wrapped

    def _record_logw(self, fn):
        def wrapped(*a, **kw):
            logw = fn(*a, **kw)
            self._logw.append(logw)
            return logw
        return wrapped

    def _record_codes(self, fn):
        def wrapped(*a, **kw):
            codes = fn(*a, **kw)
            self._codes.append(codes)
            return codes
        return wrapped

    # ---- the calls the server makes ----

    def tts(self, text, prompt=None, **kw):
        return self._call([text], [prompt],
                          lambda: self.pipe.tts(text, prompt=prompt, **kw))

    def tts_batch(self, texts, prompt=None, prompts=None, **kw):
        ps = list(prompts) if prompts is not None else [prompt] * len(texts)
        return self._call(list(texts), ps, lambda: self.pipe.tts_batch(
            texts, prompt=prompt, prompts=prompts, **kw))

    def _call(self, texts, prompts, run):
        if self.tracer is not None:
            self.tracer.before_call(self.clock())
        call = Call(self.clock(), keys=[(t, self.voice_of[id(p)])
                                        for t, p in zip(texts, prompts)])
        self._dur, self._logw, self._codes = [], [], []
        try:
            with torch.profiler.record_function("pb.call"):
                out = run()
        except Exception:
            call.ok = False
            raise
        finally:
            call.t1 = self.clock()
            self.calls.append(call)
            if self.tracer is not None:
                self.tracer.after_call(self.clock())
        call.dur = self._dur[-1]
        call.logw = self._logw[-1][..., 0]
        call.codes = self._codes[-1]
        call.n_pad, call.bucket = int(call.dur.shape[1]), int(call.codes.shape[1])
        return out

    def host_copies(self):
        """Move every call's recorded durations and codes to the host."""
        for c in self.calls:
            if c.ok and torch.is_tensor(c.dur):
                c.dur = c.dur.cpu().numpy()
                c.logw = c.logw.float().cpu().numpy()
                c.codes = c.codes.cpu().numpy()


