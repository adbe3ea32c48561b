"""Timing on CUDA events."""
