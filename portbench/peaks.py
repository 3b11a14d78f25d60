"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit), against which the shares are reckoned."""

BF16_FLOPS_PER_S = 989.4e12
HBM_BYTES_PER_S = 3.35e12
