"""Eq. 2 utility scoring with the Eq. 13 column sums (CUDA kernel K1)."""
