"""Preprocess, sampling and distance ops, and the CUDA kernel wrappers.

``cuda_preprocess`` (B1, gather+whiten), ``cuda_conv`` (B2, block 0, with its
int8 requantizing epilogue; B8, the bf16 blocks 1+), ``cuda_quant_block``
(B3, the int8 mid block, and B10, its stage prefixes),
``cuda_conv_train`` (B4 and B5, block 0 in training), ``cuda_routing`` (B7,
the blocks-1+ train pool and routing passes), ``cuda_melspec`` (B6,
config #4's fused log-mel) and ``cuda_distance`` (B9, the siamese head's
weighted-L1 scores) hold the hand-written kernels; each keeps its
plain PyTorch version beside it. ``melspec`` is the log-mel reference with
its numpy constants. ``conv_train`` wraps B4/B5 and B7 in
``autograd.Function`` classes.
"""
