"""Carry parameters across from the JAX package.

The JAX package's parameter pytrees are dataclasses too, with the same field
names as the port's (``Track``, ``BicycleParams``, ``MPCParam``,
``SystemParam``, ...).  :func:`numpy_fields` reads any such dataclass into a
dict of numpy arrays; :func:`to_port` turns that dict into the port's
dataclass on a given device and dtype.  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .device import resolve


def numpy_fields(obj) -> dict[str, Any]:
    """Every field of a dataclass as a numpy array (static ints stay ints)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v if isinstance(v, int) else np.asarray(v)
    return out


def to_port(cls, arrays: Mapping[str, Any], *, device="cuda", dtype=torch.float64):
    """Build the port's dataclass ``cls`` from numpy arrays keyed by field name."""
    dev = resolve(device)
    kw = {}
    for f in dataclasses.fields(cls):
        v = arrays[f.name]
        if f.type in ("int", int):
            kw[f.name] = int(v)
        else:
            kw[f.name] = torch.as_tensor(np.array(v, np.float64), dtype=dtype, device=dev)
    return cls(**kw)

