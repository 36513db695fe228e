"""Network registry (counterpart of gfla_tpu/models/__init__.py). Only the
pose generator is ported so far."""

from __future__ import annotations

from typing import Any, Dict

from gfla_tpu_torch.models.generators import PoseGenerator

GENERATORS: Dict[str, Any] = {"pose": PoseGenerator}


def define_g(name: str, **kwargs):
    """Instantiate a generator by registry name (reference define_g)."""
    if name not in GENERATORS:
        raise KeyError(f"unknown generator '{name}'; have {sorted(GENERATORS)}")
    return GENERATORS[name](**kwargs)
