"""Published dense peaks of one NVIDIA H100 SXM (data sheet, 700 W)."""

BF16_FLOPS = 989.4e12      # bf16 / fp16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12  # HBM3
