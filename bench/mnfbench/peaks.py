"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  The yardstick: later changes to
the program do not move these."""

#: float32 outside the tensor cores, FLOP/s (the CNN cells compute in f32).
F32_FLOPS = 67e12
#: bfloat16 / float16 on the tensor cores, FLOP/s.
BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s.
HBM_BYTES = 3.35e12
