"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit)."""

H100_SXM = {
    "bf16_flops": 989e12,
    "f32_flops": 67e12,
    "tf32_flops": 495e12,
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
}
