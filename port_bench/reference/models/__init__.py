"""The plain models, one module a model, found by the configuration's
``model`` name (:func:`port_bench.reference.models.load`)."""
from __future__ import annotations

import importlib


def load(name: str):
    """The module ``port_bench.reference.models.<name>``."""
    return importlib.import_module(f"{__name__}.{name}")
