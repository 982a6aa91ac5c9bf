"""Peak rates of the card the benchmark runs on: NVIDIA's data sheet for
the H100 80GB HBM3 (SXM5) at its 700 W power limit, dense rates.  A card
set below that limit runs slower under load; every result names the card
and the benchmark prints its power limit beside its numbers."""

# HBM3 bytes/s.
PEAK_BYTES_S = 3.35e12
# fp32 FLOP/s on the CUDA cores, outside the tensor cores.
PEAK_FP32_FLOP_S = 67e12
# Dense TF32 FLOP/s of the tensor cores: the rate that prices every fp32
# product here, since the kernels run fp32 products as 3xTF32 on the
# tensor cores (pricing them at the CUDA cores' rate could pass 100 %).
PEAK_TF32_FLOP_S = 495e12
# Dense bf16 (and fp16) FLOP/s of the tensor cores.
PEAK_BF16_FLOP_S = 989e12
# Dense int8 OP/s of the tensor cores.
PEAK_INT8_OPS_S = 1979e12
