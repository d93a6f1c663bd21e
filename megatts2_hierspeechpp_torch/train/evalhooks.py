"""Periodic-eval hooks of the training CLIs.

Counterpart of `megatts2_hierspeechpp_tpu/train/evalhooks.py` (reference
evaluate() and its TensorBoard images, train_ms.py:345-405): each hook runs
on a fixed held-out batch and returns scalars, which the loop logs under
"eval/"; the s2, vocoder and SpeechSR hooks also write PNGs into
<model_dir>/eval/ when `plot` (matplotlib is imported only then).
"""
from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch

from megatts2_hierspeechpp_torch.ops import stft as tstft
from megatts2_hierspeechpp_torch.train.s1 import EXTRACT_INPUTS, extract


def _masked_l1(pred, target, mask):
    """mean |pred - target| over the mask broadcast to pred's shape."""
    mask = torch.broadcast_to(mask.to(pred.dtype), pred.shape)
    return ((pred - target).abs() * mask).sum() / mask.sum().clamp_min(1.0)


def _snr_db(est, ref):
    """10 log10 of ref's energy over the energy of est - ref."""
    err = (est - ref).square().sum()
    return 10.0 * torch.log10(ref.square().sum() / err.clamp_min(1e-12))


def _on(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def make_s2_eval_fn(eval_batch: Dict[str, np.ndarray],
                    plot: bool = True) -> Callable:
    """Inference from ground-truth durations (TTVModel.infer_gt_dur) on
    the held-out batch: scalars w2v_l1 and lf0_l1 (masked L1 of the w2v
    and of log(f0 + 1)); with `plot`, the predicted and true w2v of the
    first item and its f0 overlay as PNGs."""

    def eval_fn(state, step: int, model_dir: str) -> Dict[str, float]:
        ttv = state.ttv
        b = _on(eval_batch, next(ttv.parameters()).device)
        with torch.no_grad():
            w2v_pred, pred_lf0 = ttv.infer_gt_dur(*(b[k] for k in EXTRACT_INPUTS))
            t = b["w2v"].shape[1]
            w2v_mask = torch.arange(t, device=w2v_pred.device)[None] < \
                b["w2v_lengths"][:, None]
            l1_w2v = _masked_l1(w2v_pred, b["w2v"], w2v_mask[..., None])
            tp = b["pitch"].shape[1]
            p_mask = torch.arange(tp, device=w2v_pred.device)[None] < \
                b["pitch_lengths"][:, None]
            l1_lf0 = _masked_l1(pred_lf0, torch.log(b["pitch"] + 1.0), p_mask)
        if plot:
            from megatts2_hierspeechpp_torch.utils.plotting import (
                save_f0_plot, save_spectrogram_plot)

            out = os.path.join(model_dir, "eval")
            n0 = int(eval_batch["w2v_lengths"][0])
            save_spectrogram_plot(w2v_pred[0, :n0].cpu().numpy(),
                                  os.path.join(out, f"w2v_pred_{step}.png"),
                                  title=f"w2v pred @ step {step}")
            save_spectrogram_plot(eval_batch["w2v"][0, :n0],
                                  os.path.join(out, "w2v_gt.png"),
                                  title="w2v ground truth")
            p0 = int(eval_batch["pitch_lengths"][0])
            f0_p = np.exp(pred_lf0[0, :p0].cpu().numpy()) - 1.0
            save_f0_plot(eval_batch["pitch"][0, :p0], f0_p,
                         os.path.join(out, f"f0_{step}.png"))
        return {"w2v_l1": float(l1_w2v), "lf0_l1": float(l1_lf0)}

    return eval_fn


def make_s1_eval_fn(eval_batch: Dict[str, np.ndarray]) -> Callable:
    """The PLM's held-out NLL per frame and top-10 accuracy, without
    dropout: scalars plm_loss and plm_acc_top10."""
    def eval_fn(state, step: int, model_dir: str) -> Dict[str, float]:
        b = _on(eval_batch, next(state.plm.parameters()).device)
        x_frame, lr_codes = extract(state.ttv, b)
        with torch.no_grad():  # no MaskSource is active: no dropout
            out = state.plm.loss_dict(x_frame, lr_codes, b["mel_lengths"])
        return {"plm_loss": float(out["loss_log"]),
                "plm_acc_top10": float(out["acc"])}

    return eval_fn


def make_ar_eval_fn(eval_batch: Dict[str, np.ndarray]) -> Callable:
    """Text2Semantic's held-out CE loss (summed, as the training loss) and
    accuracy, without dropout: scalars t2s_loss and t2s_acc_top10. The key
    is the JAX hook's; the accuracy is the model's top-`top_k_acc` (3 at
    the CLI's default), not top-10, as in JAX."""
    def eval_fn(state, step: int, model_dir: str) -> Dict[str, float]:
        b = _on(eval_batch, next(state.model.parameters()).device)
        with torch.no_grad():  # no MaskSource is active: no dropout
            out = state.model(b["x_ids"], b["x_lens"], b["y_ids"], b["y_lens"],
                              b["bert_feature"])
        return {"t2s_loss": float(out["loss"]),
                "t2s_acc_top10": float(out["acc"])}

    return eval_fn


def make_vocoder_eval_fn(eval_batch: Dict[str, np.ndarray],
                         plot: bool = True) -> Callable:
    """Inference of the vocoder being trained, as built (HierVocoder.forward
    with no generator: z = m x mask; a bf16 build computes in bf16, as the
    JAX hook runs the trained model's dtype) on the held-out batch, the mels
    in float32: scalar mel_l1, the
    masked L1 between the fixed log-mels of the synthesized and the true
    audio over the shorter frame count; with `plot`, the first item's
    excitation (expm1 of e_, in Hz) over its f0 as a PNG."""

    def eval_fn(state, step: int, model_dir: str) -> Dict[str, float]:
        gen = state.gen
        b = _on(eval_batch, next(gen.parameters()).device)
        with torch.no_grad():
            # log1p: the serving-domain f0, as train/vocoder.py encodes it
            wav_hat, e_ = gen(b["mel"], b["w2v"], b["mask"],
                              torch.log1p(b["f0"])[..., None])
            mel_hat = tstft.mel_spectrogram_fixed(wav_hat[..., 0].float())
            mel_gt = tstft.mel_spectrogram_fixed(b["audio"])
            t = min(mel_hat.shape[1], mel_gt.shape[1], b["mask"].shape[1])
            l1 = _masked_l1(mel_hat[:, :t], mel_gt[:, :t], b["mask"][:, :t])
        if plot:
            from megatts2_hierspeechpp_torch.utils.plotting import save_f0_plot

            n0 = int(eval_batch["lengths"][0])
            save_f0_plot(eval_batch["f0"][0, :4 * n0],
                         np.expm1(e_[0, :4 * n0, 0].float().cpu().numpy()),
                         os.path.join(model_dir, "eval", f"excitation_{step}.png"))
        return {"mel_l1": float(l1)}

    return eval_fn


def make_sr_eval_fn(eval_batch: Dict[str, np.ndarray], sr_out: int,
                    plot: bool = True) -> Callable:
    """SpeechSR on the held-out (lo, hi) batch: scalars mel_l1 (the mean
    L1 of the slaney log-mels at sr_out, n_fft 1280, hop 320, 128 bins) and
    snr_db (10 log10 of the target's energy over the error's); with `plot`,
    the first item's predicted and true log-mels as PNGs (the JAX hook
    takes the log of these log-mels once more, which is NaN below 1)."""

    def mel(wav):
        spec = tstft.linear_spectrogram(wav[..., 0], 1280, 320, 1280)
        return tstft.spec_to_mel(spec, sr_out, 1280, 128, 0.0, None)

    def eval_fn(state, step: int, model_dir: str) -> Dict[str, float]:
        b = _on(eval_batch, next(state.gen.parameters()).device)
        with torch.no_grad():
            fake = state.gen(b["lo"])
            mel_f, mel_r = mel(fake), mel(b["hi"])
            l1 = (mel_f - mel_r).abs().mean()
            snr = _snr_db(fake, b["hi"])
        if plot:
            from megatts2_hierspeechpp_torch.utils.plotting import (
                save_spectrogram_plot)

            out = os.path.join(model_dir, "eval")
            for name, m in (("pred", mel_f), ("gt", mel_r)):
                save_spectrogram_plot(m[0].cpu().numpy(),
                                      os.path.join(out, f"sr_{name}_{step}.png"),
                                      title=name)
        return {"mel_l1": float(l1), "snr_db": float(snr)}

    return eval_fn


def make_denoiser_eval_fn(eval_batch: Dict[str, np.ndarray], n_fft: int = 400,
                          hop: int = 100, win: int = 400,
                          compress: float = 0.3) -> Callable:
    """MP-SENet in eval() mode (BatchNorm on its running statistics) on the
    held-out (noisy, clean) batch: scalars mag_mse (compressed magnitude
    against the clean one) and snr_improvement_db (the denoised waveform's
    SNR minus the noisy input's)."""

    def eval_fn(state, step: int, model_dir: str) -> Dict[str, float]:
        model = state.model
        b = _on(eval_batch, next(model.parameters()).device)
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                mag_n, pha_n = tstft.mag_pha_stft(b["noisy"], n_fft, hop, win,
                                                  compress)
                mag_c, _ = tstft.mag_pha_stft(b["clean"], n_fft, hop, win,
                                              compress)
                mag_g, pha_g = model(mag_n, pha_n)
                l_mag = (mag_g - mag_c).square().mean()
                spec = torch.polar(mag_g ** (1.0 / compress), pha_g)
                wav_g = tstft.istft(spec, n_fft, hop, win, b["clean"].shape[-1])
                snr_i = _snr_db(wav_g, b["clean"]) - _snr_db(b["noisy"], b["clean"])
        finally:
            model.train(was_training)
        return {"mag_mse": float(l_mag), "snr_improvement_db": float(snr_i)}

    return eval_fn
