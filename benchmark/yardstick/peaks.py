"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates without
sparsity, at the full 700 W power limit). A card set to a lower power
limit runs below them; the run records the limit beside its numbers."""

BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12          # outside the tensor cores; an FMA counts two
TF32_FLOP_S = 495e12
HBM_BYTES_S = 3.35e12
