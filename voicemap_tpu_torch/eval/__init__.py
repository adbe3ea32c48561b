"""Batched n-shot k-way evaluation."""
