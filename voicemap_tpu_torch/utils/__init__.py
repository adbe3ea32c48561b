"""Timing on CUDA events, the profilers and the stage attribution."""
