"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

PEAKS = {
    "bf16_flops_s": 989e12,   # bf16 / fp16 tensor cores
    "tf32_flops_s": 495e12,   # TF32 tensor cores
    "fp32_flops_s": 67e12,    # float32 outside the tensor cores
    "hbm_bytes_s": 3.35e12,   # HBM3
}
