"""Conv encoder, speaker classifier, fast and int8 inference, the converters."""
