"""Preprocess, sampling and distance ops, and the CUDA kernel wrappers.

``cuda_preprocess`` (B1, gather+whiten) and ``cuda_conv`` (B2, block 0) hold
the hand-written kernels; each keeps its plain PyTorch version beside it.
"""
