"""Corpus container (pandas-free)."""
