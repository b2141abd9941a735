"""Training losses (port of nbody_tpu/physics/losses.py; reference
nn.py:151-180)."""

from __future__ import annotations

import torch

from nbody_tpu_torch import tracing


def loss_za(predicted_error: torch.Tensor, true_error: torch.Tensor) -> torch.Tensor:
    """Mean over (batch, particles) of the squared error summed over xyz
    (reference loss_ZA, nn.py:151-166).  Counts the prediction's batch x
    particles as ``loss.particles`` (tracing.py)."""
    tracing.count("loss.particles",
                  predicted_error.numel() // predicted_error.shape[-1])
    err = torch.square(predicted_error - true_error)
    return torch.mean(torch.sum(err, dim=-1))


def mse_za(fpm_displacement: torch.Tensor,
           za_displacement: torch.Tensor) -> torch.Tensor:
    """ZA-approximation baseline error (reference mse_za, nn.py:177-180)."""
    err = torch.square(fpm_displacement - za_displacement)
    return torch.mean(torch.sum(err, dim=-1))
