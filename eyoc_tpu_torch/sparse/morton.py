"""Morton (Z-order) keys (counterpart of eyoc_tpu/sparse/morton.py).

Level-0 voxel coordinates are shifted into a window of 2^bits cells per
axis and interleaved bit by bit (z least significant) into a non-negative
int32 key. `key >> 3` is the parent cell's key at every level, so one sort
orders every coarser lattice. Every key operation stays in int32, and
INVALID_KEY (int32 max) sorts last.
"""

from __future__ import annotations

import torch

BITS = (10, 10, 8)
INVALID_KEY = 2 ** 31 - 1


def dims(bits=BITS) -> tuple:
    return (1 << bits[0], 1 << bits[1], 1 << bits[2])


def shift(bits=BITS) -> tuple:
    gx, gy, gz = dims(bits)
    return (gx // 2, gy // 2, gz // 2)


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits between the low 10 bits of v (int32)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _compact3(v: torch.Tensor) -> torch.Tensor:
    """Inverse of _spread3: extract every third bit."""
    v = v & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & 0x3FF
    return v


def in_window(coords: torch.Tensor, bits=BITS) -> torch.Tensor:
    """Unshifted coords [..., 3] int32 -> [...] bool."""
    sh = torch.tensor(shift(bits), dtype=torch.int32, device=coords.device)
    g = torch.tensor(dims(bits), dtype=torch.int32, device=coords.device)
    return torch.all((coords >= -sh) & (coords < g - sh), dim=-1)


def encode(coords: torch.Tensor, valid: torch.Tensor, bits=BITS) -> torch.Tensor:
    """Unshifted lattice coords [..., 3] int32 -> keys [...] int32;
    invalid or out-of-window entries become INVALID_KEY."""
    ok = valid & in_window(coords, bits)
    sh = torch.tensor(shift(bits), dtype=torch.int32, device=coords.device)
    hi = torch.tensor(dims(bits), dtype=torch.int32, device=coords.device) - 1
    s = torch.minimum(torch.clamp(coords + sh, min=0), hi)
    key = ((_spread3(s[..., 0]) << 2) | (_spread3(s[..., 1]) << 1)
           | _spread3(s[..., 2]))
    return torch.where(ok, key, torch.full_like(key, INVALID_KEY))


def decode(key: torch.Tensor) -> torch.Tensor:
    """Keys [...] -> SHIFTED coords [..., 3] int32 on the key's lattice."""
    return torch.stack(axes_of(key), dim=-1)


def grid_dims(level: int, bits=BITS) -> tuple:
    """Dense-grid dims of the SHIFTED level-l lattice."""
    gx, gy, gz = dims(bits)
    return (max(1, gx >> level), max(1, gy >> level), max(1, gz >> level))


def axes_of(key: torch.Tensor) -> tuple:
    """Keys [...] -> (x, y, z) SHIFTED per-axis int32 vectors."""
    return _compact3(key >> 2), _compact3(key >> 1), _compact3(key)
