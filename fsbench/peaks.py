"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, 700 W)."""

BF16_FLOPS = 989e12      # bfloat16 tensor cores, dense
FP32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
