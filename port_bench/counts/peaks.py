"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit): HBM3 bandwidth and float32 outside the tensor
cores. A card set below 700 W reaches less; the result's ``device`` carries
the card's ``power_limit_w`` beside every share of these."""
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
