"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference.

Training (the first three steps of the object the window then runs):
  knn_mismatch  the (sample, particle) rows of the first batch whose
              program kNN ids are not a nearest set: self not at slot 0,
              an id out of range, or the sorted squared min-image
              distances of its neighbours off the reference's by more
              than rounding (KNN_TOL on the unit torus; a near tie may
              go either way);
  loss_gap    |loss - reference loss| / |reference loss| of the first
              step (the later steps' losses swing from seed to seed: one
              Adam step from the random init cuts the loss 3-10 times, and
              the next amplifies the sign flips of near-zero gradients);
  grad_gap    the first gradient, as the optimizer got it: by the worst
              leaf, |norm - reference norm| / max(reference norm, the
              median leaf's reference norm);
  update_gap  the parameters' change after the three steps, by the same
              measure, over the leaves whose reference gradient is not
              nought to rounding (at least a thousandth of the median
              leaf's norm).
Rollout (the sampled chains of the window, hop by hop, each hop's
reference run on the program's own input to that hop):
  hop_rel_l2  the largest ||residual - reference|| / ||reference||;
  hop_max_err the largest |residual - reference| of any particle and
              axis over the reference residual's rms.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

from benchmark_torch.harness import Check
from benchmark_torch.reference import common

# a leaf whose reference gradient norm is under this share of the median
# leaf's moves under Adam by round-off alone, and is not compared
NOUGHT_SHARE = 1e-3
# squared distances on the unit torus that differ by less are one to
# rounding: float32 positions near 1 carry ~6e-8, a neighbour's squared
# distance (~2e-3 at 32^3) ~1e-8
KNN_TOL = 1e-7


def knn_mismatch(prog: torch.Tensor, ref: torch.Tensor,
                 pos_norm: torch.Tensor) -> int:
    """Rows of (b, N, K) ids whose neighbours are not the reference's to
    rounding (see the module's note), by the positions (b, N, 3) on the
    unit torus that the reference searched."""
    b, n, _ = ref.shape
    if tuple(prog.shape) != tuple(ref.shape):
        return b * n
    prog = prog.long()
    bad = ((prog < 0) | (prog >= n)).any(-1)
    prog = prog.clamp(0, n - 1)
    bad |= prog[..., 0] != torch.arange(n)
    pos = pos_norm.double()

    def sorted_d2(idx):
        d = common.min_image(common.gather(pos, idx) - pos[:, :, None, :], 1.0)
        return torch.sort(torch.sum(d * d, dim=-1), dim=-1).values

    bad |= torch.amax(torch.abs(sorted_d2(prog) - sorted_d2(ref.long())), -1) > KNN_TOL
    return int(bad.sum())


def _norms(leaves: Sequence[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in leaves]


def norm_gap(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
             keep: Sequence[bool] = None) -> float:
    """Worst leaf's |norm - reference norm| over max(the reference norm,
    the median leaf's reference norm)."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn)
    gaps = [abs(p - r) / max(r, med, 1e-30)
            for i, (p, r) in enumerate(zip(pn, rn)) if keep is None or keep[i]]
    return max(gaps) if gaps else float("nan")


def counted_leaves(ref_grads: Sequence[torch.Tensor]) -> List[bool]:
    rn = _norms(ref_grads)
    med = statistics.median(rn)
    return [r >= NOUGHT_SHARE * med for r in rn]


def train_checks(prog: Dict, ref: Dict, limits: Dict) -> List[Check]:
    """prog and ref: {"losses": [3], "grads": [leaves], "deltas": [leaves],
    "knn": (b, N, K) ids of the first batch}; ref also "pos_norm"."""
    p, r = prog["losses"][0], ref["losses"][0]
    loss_gap = abs(p - r) / max(abs(r), 1e-30)
    loss_gap = loss_gap if math.isfinite(loss_gap) else float("inf")
    keep = counted_leaves(ref["grads"])
    return [Check("knn_mismatch", knn_mismatch(prog["knn"], ref["knn"], ref["pos_norm"]),
                  limits["knn_mismatch"]),
            Check("loss_gap", loss_gap, limits["loss_gap"]),
            Check("grad_gap", norm_gap(prog["grads"], ref["grads"]),
                  limits["grad_gap"]),
            Check("update_gap", norm_gap(prog["deltas"], ref["deltas"], keep),
                  limits["update_gap"])]


def hop_gaps(res: torch.Tensor, ref: torch.Tensor):
    """(relative L2 gap, max gap over rms) of one hop's residuals."""
    res, ref = res.double(), ref.double()
    d = res - ref
    rms = float(torch.sqrt(torch.mean(ref * ref)))
    rel = float(torch.linalg.vector_norm(d) / max(float(torch.linalg.vector_norm(ref)), 1e-30))
    mx = float(torch.max(torch.abs(d))) / max(rms, 1e-30)
    return (rel if math.isfinite(rel) else float("inf"),
            mx if math.isfinite(mx) else float("inf"))


def rollout_checks(gaps: Sequence[tuple], limits: Dict) -> List[Check]:
    return [Check("hop_rel_l2", max(g[0] for g in gaps), limits["hop_rel_l2"]),
            Check("hop_max_err", max(g[1] for g in gaps), limits["hop_max_err"])]
