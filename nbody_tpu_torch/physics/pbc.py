"""Periodic-boundary-condition math (port of nbody_tpu/physics/pbc.py).

torch.round rounds half to even like jnp.round, and torch.remainder takes
the divisor's sign like jnp.mod, so both give the JAX package's bits.
"""

from __future__ import annotations

import torch


def min_image_diff(a: torch.Tensor, b: torch.Tensor, box: float = 1.0) -> torch.Tensor:
    """Signed displacement a - b under the min-image convention."""
    d = a - b
    return d - box * torch.round(d / box)


def min_image_sq_dist(a: torch.Tensor, b: torch.Tensor, box: float = 1.0) -> torch.Tensor:
    """Elementwise squared min-image difference (reference nn.py:123-134)."""
    d = min_image_diff(a, b, box)
    return d * d


def wrap_coords(x: torch.Tensor, box: float = 1.0) -> torch.Tensor:
    """Map coordinates into [0, box)."""
    return torch.remainder(x, box)
