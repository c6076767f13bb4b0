"""The port's kernels (K1-K9) with their plain PyTorch versions."""
