"""Multi-step autoregressive rollout across the redshift chain (port of
nbody_tpu/train/rollout.py; BASELINE.json config 3).

One model per adjacent redshift pair, all of one architecture, so their
parameters stack on a leading step axis T.  Each hop runs the model's
forward (its train-mode forward, as JAX make_rollout calls model.apply)
with the hop's parameters through ``torch.func.functional_call``, on
x_in = [grid, current displacement], and adds the predicted residual to
the displacement.  The graph families rebuild the kNN graph inside every
hop on the model's device (kernel A, then B and C in every layer on the
card).  Forward only: no gradient is kept.  The JAX lax.scan is a Python
loop over the hops here; nothing in it reads the device.  While a
profiler records, each hop is the span ``rollout.hop`` and each coverage
count ``rollout.monitor`` (tracing.py); a hop opens no step timeline.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch.func import functional_call

from nbody_tpu_torch import tracing
from nbody_tpu_torch.physics.losses import loss_za


def check_chain_family(family: str):
    """The chain feeds 6 input channels: refuse shiftinv_vel, which takes
    9 (JAX cannot run it here either)."""
    if family == "shiftinv_vel":
        raise ValueError("the rollout chain feeds 6 input channels; the "
                         "shiftinv_vel family (--velocity) takes 9")


def stack_params(params_seq: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack same-named parameter dicts (e.g. dict(model.named_parameters())
    of each pair's model) on a leading step axis, detached."""
    return {name: torch.stack([p[name].detach() for p in params_seq])
            for name in params_seq[0]}


def make_rollout(model: torch.nn.Module,
                 coverage_fn: Optional[Callable] = None) -> Callable:
    """Build rollout(stacked_params, x_in0) -> (final_disp, trajectory).

    stacked_params: {name: (T, ...)} from stack_params; x_in0 (b, N, 6) =
    [centred grid, initial displacement].  Returns the final displacement
    (b, N, 3) and the trajectory (T, b, N, 3) of displacements after each
    hop.  coverage_fn (optional): x_in (b, N, 6) -> a scalar count,
    evaluated on every hop's input; then the result is (final, (traj,
    per-hop counts (T,)))."""
    check_chain_family(model.cfg.family)

    @torch.no_grad()
    def rollout(stacked_params: Dict[str, torch.Tensor], x_in0: torch.Tensor):
        q = x_in0[..., :3]
        disp = x_in0[..., 3:6]
        steps = next(iter(stacked_params.values())).shape[0]
        traj, counts = [], []
        for t in range(steps):
            with tracing.span("rollout.hop"):
                x_in = torch.cat([q, disp], dim=-1)
                params_t = {name: v[t] for name, v in stacked_params.items()}
                disp = disp + functional_call(model, params_t, (x_in,))
                traj.append(disp)
            if coverage_fn is not None:
                with tracing.span("rollout.monitor"):
                    counts.append(coverage_fn(x_in))
        traj = torch.stack(traj)
        if coverage_fn is not None:
            return disp, (traj, torch.stack(counts))
        return disp, traj

    return rollout


def rollout_mse(model: torch.nn.Module, stacked_params: Dict[str, torch.Tensor],
                x_in0: torch.Tensor, truth_traj: torch.Tensor) -> torch.Tensor:
    """Per-hop position MSE (loss_za) of the rollout against a truth
    displacement trajectory (T, b, N, 3): the BASELINE.json rollout
    metric, (T,)."""
    _, traj = make_rollout(model)(stacked_params, x_in0)
    return torch.stack([loss_za(a, b) for a, b in zip(traj, truth_traj)])
