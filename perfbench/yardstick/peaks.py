"""The NVIDIA H100 SXM's published peaks (data sheet; dense, without
sparsity, at its 700 W power limit). A card set below 700 W reaches less:
each result line carries the card's power limit beside these."""

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # bf16 dense, tensor cores
