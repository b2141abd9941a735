"""Index-band arithmetic of the banded kNN path (port of
nbody_tpu/ops/banded.py:37-46 and :154-161): ``default_band``, the band
the banded kNN search and the coverage guard assume, and
``band_violations``, the count of links outside it.  The neighbor ops
themselves go through the step's route (ops/route.py).
"""

from __future__ import annotations

import torch


def default_band(cells: int, window: int = 3) -> int:
    """Index band covering every flat offset a +-window lattice-kNN
    neighbor can have: |rel| <= window*c^2 + (c-1)*c + (c-1) < (window+1)*c^2
    (a wrapped y or z coordinate does not fold in flat index space), so
    band = 2*(window+1)*c^2, rounded up to 256 and capped at N."""
    n = cells ** 3
    return min(n, -(-2 * (window + 1) * cells * cells // 256) * 256)


def band_violations(idx: torch.Tensor, band: int) -> torch.Tensor:
    """Neighbor links outside the circular band (0 for a correct band):
    idx (..., N, K); rel in [-band//2, band//2] is in band."""
    n = idx.shape[-2]
    rows = torch.arange(n, dtype=idx.dtype, device=idx.device)[:, None]
    rel = torch.remainder(idx - rows + n // 2, n) - n // 2
    return torch.sum((rel < -(band // 2)) | (rel > band // 2))
