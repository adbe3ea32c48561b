"""Preprocess, sampling and distance ops, and the CUDA kernel wrappers.

``cuda_preprocess`` (B1, gather+whiten), ``cuda_conv`` (B2, block 0, with its
int8 requantizing epilogue), ``cuda_quant_block`` (B3, the int8 mid block),
``cuda_conv_train`` (B4 and B5, block 0 in training) and ``cuda_routing``
(B7, the blocks-1+ train pool and routing passes) hold the hand-written
kernels; each keeps its plain PyTorch version beside it. ``conv_train``
wraps B4/B5 and B7 in ``autograd.Function`` classes.
"""
