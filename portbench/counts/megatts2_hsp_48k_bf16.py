"""Work counts of the megatts2_hsp_48k_bf16 configuration: every model and kernel of the
served path at the configuration's widths (counts/work.py), with the
vocoder kernels' bf16 configuration (bf16 activations, packed bf16 weights, one pass of bf16 tensor-core products)."""
from portbench.counts import work

BF16_KERNELS = True


def row_flops(cfg, n, prompt_frames, prompt_true_frames, frames):
    return work.row_flops(cfg, n, prompt_frames, prompt_true_frames, frames)


def decode_bound_s(cfg, rows, t):
    return work.decode_bound_s(cfg["plm"], rows, t)


def vocoder_bound_s(cfg, rows, frames):
    return sum(work.launch_bound_s(x, BF16_KERNELS)
               for x in work.vocoder_launches(cfg, rows, frames, BF16_KERNELS))
