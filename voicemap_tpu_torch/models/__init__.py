"""Conv encoder, speaker classifier, siamese verification net, the log-mel 2D
models, fast and int8 inference, the pooled-GEMM specification of the fused
blocks (``fused_encoder``), the converters."""
