"""Weights carried into the port's scope.

``params_from_numpy`` puts a ``{name: np.ndarray}`` dict (for example a
scope of the reference package, read out as numpy) into a scope as
tensors on a place.  It works because both packages build the same
parameter names under ``unique_name.guard()``.
"""

import numpy as np
import torch

from .core.scope import global_scope
from .places import default_place

__all__ = ["params_from_numpy"]


def params_from_numpy(arrays, scope=None, place=None):
    """Copy every array into `scope` (default: the global scope) as a
    tensor on `place` (default: ``default_place()``, the card, which
    raises where there is none: pass ``CPUPlace()`` for the CPU).
    Returns the names set."""
    scope = scope if scope is not None else global_scope()
    device = (place if place is not None else default_place()).torch_device()
    for name, arr in arrays.items():
        scope.set(name, torch.tensor(np.asarray(arr), device=device))
    return sorted(arrays)
