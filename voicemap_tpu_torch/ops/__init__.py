"""Preprocess, sampling and distance ops, and the CUDA kernel wrappers.

``cuda_preprocess`` (B1, gather+whiten), ``cuda_conv`` (B2, block 0, with its
int8 requantizing epilogue) and ``cuda_quant_block`` (B3, the int8 mid block)
hold the hand-written kernels; each keeps its plain PyTorch version beside it.
"""
