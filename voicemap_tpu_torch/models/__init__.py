"""Conv encoder, speaker classifier, fast inference and the flax converter."""
