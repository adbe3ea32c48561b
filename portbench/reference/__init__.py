"""Plain references, one module per model family, named by the ``reference``
key of a configuration's file. They import torch and the benchmark's own
data generator, never the program under test."""

from __future__ import annotations

import importlib


def load(config: dict):
    return importlib.import_module(f"{__name__}.{config['reference']}")
