"""Observation field normalization (port of cpr_tpu/obs.py).

Port of the reference observation normalizers
(reference: simulator/protocols/ssz_tools.ml:1-74 `NormalizeObs`):

- raw mode keeps the natural scale of each field,
- unit mode squashes each field into [0, 1]: unbounded non-negative ints via
  2/pi * atan(x / scale), signed ints via 0.5 + atan(x / scale)/pi, discrete
  fields via i/(n-1).

All arithmetic is float32 with the constants rounded to float32 first,
the order the JAX package evaluates them in; atan and tan may differ
from XLA's by a few ULP.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

BOOL = "bool"
DISCRETE = "discrete"
UINT = "uint"  # unbounded non-negative int
INT = "int"  # unbounded signed int

_F32 = torch.float32


@dataclass(frozen=True)
class Field:
    name: str
    kind: str = UINT
    scale: int = 1  # atan squash scale for uint/int
    n: int = 2  # number of values for discrete


def _c(x, like):
    """x rounded to a float32 tensor on like's device; filled on the
    device, since a CUDA graph may capture the encoders and no host value
    may be copied to the card inside one."""
    return torch.full((), x, dtype=_F32, device=like.device)


def field_to_float(field: Field, x, unit: bool):
    """Encode one field value as float (ssz_tools.ml:11-40)."""
    x = torch.as_tensor(x).to(_F32)
    if not unit:
        return x
    if field.kind == BOOL:
        return x
    if field.kind == DISCRETE:
        return x / _c(field.n - 1, x)
    if field.kind == UINT:
        return _c(2.0 / math.pi, x) * torch.atan(x / _c(field.scale, x))
    if field.kind == INT:
        return 0.5 + torch.atan(x / _c(field.scale, x)) / _c(math.pi, x)
    raise ValueError(field.kind)


def field_of_float(field: Field, v, unit: bool):
    """Decode one float back into the field's natural scale (ssz_tools.ml:20-59)."""
    v = torch.as_tensor(v).to(_F32)
    if not unit:
        return torch.round(v) if field.kind != BOOL else v >= 0.5
    if field.kind == BOOL:
        return v >= 0.5
    if field.kind == DISCRETE:
        return torch.floor(v * (field.n - 1))
    if field.kind == UINT:
        return torch.round(torch.tan(_c(math.pi / 2.0, v) * v) * field.scale)
    if field.kind == INT:
        return torch.round(torch.tan(_c(math.pi, v) * (v - 0.5)) * field.scale)
    raise ValueError(field.kind)


def encode(fields: tuple[Field, ...], values, unit: bool):
    """Encode a tuple of natural-scale values into a float observation vector."""
    if len(fields) != len(values):
        raise ValueError(f"{len(fields)} fields, {len(values)} values")
    return torch.stack(
        [field_to_float(f, v, unit) for f, v in zip(fields, values)], dim=-1
    )


def low_high(fields: tuple[Field, ...], unit: bool):
    """Observation-space bounds (ssz_tools.ml:64-73)."""
    low = np.zeros(len(fields), dtype=np.float32)
    high = np.zeros(len(fields), dtype=np.float32)
    for i, f in enumerate(fields):
        if unit:
            low[i], high[i] = 0.0, 1.0
        elif f.kind == BOOL:
            low[i], high[i] = 0.0, 1.0
        elif f.kind == DISCRETE:
            low[i], high[i] = 0.0, float(f.n - 1)
        elif f.kind == UINT:
            low[i], high[i] = 0.0, np.inf
        elif f.kind == INT:
            low[i], high[i] = -np.inf, np.inf
        else:
            raise ValueError(f.kind)
    return low, high
