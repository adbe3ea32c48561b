"""Conv encoder, speaker classifier, the log-mel 2D models, fast and int8
inference, the converters."""
