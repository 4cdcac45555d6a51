"""k-NN evidence: top-k search over a training set (CUDA kernel K2)."""
