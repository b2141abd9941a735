"""Parameter store (port of nbody_tpu/models/base.py; reference
utils.py:292-386).

A model's parameters are per-layer W (num_weights, k_in, k_out) and
B (num_biases, k_out), held in f32 by a ``LayerParams`` module.  Init
matches the reference's distributions (glorot-normal weights, biases
1e-8) drawn from a ``torch.Generator``; the draws differ from the JAX
package's threefry streams, so parity tests load the JAX parameters with
``params_from_jax`` instead of matching seeds.  The shiftinv_vel family
adds two output scalars (``ShiftInvVelParams``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from nbody_tpu_torch import config as C


class LayerParams(nn.Module):
    """Per-layer {"W", "B"} parameters of a layer stack (f32)."""

    def __init__(self, layers: Sequence[Dict[str, torch.Tensor]]):
        super().__init__()
        self.W = nn.ParameterList([nn.Parameter(p["W"]) for p in layers])
        self.B = nn.ParameterList([nn.Parameter(p["B"]) for p in layers])

    def __len__(self) -> int:
        return len(self.W)

    def layers(self, dtype=None) -> List[Dict[str, torch.Tensor]]:
        """The parameters as [{"W", "B"}, ...], cast to `dtype` if given
        (a differentiable cast: gradients reach the f32 parameters)."""
        return [{"W": w if dtype is None else w.to(dtype),
                 "B": b if dtype is None else b.to(dtype)}
                for w, b in zip(self.W, self.B)]


def glorot_normal(generator: torch.Generator, shape: Sequence[int],
                  dtype=torch.float32) -> torch.Tensor:
    """Glorot/Xavier normal over the trailing (fan_in, fan_out) dims."""
    fan_in, fan_out = shape[-2], shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(tuple(shape), generator=generator, dtype=dtype)


def init_network_params(generator: torch.Generator, channels: Sequence[int],
                        num_weights: int = 1, num_biases: int = 1) -> LayerParams:
    """Per-layer params for a channel stack (reference utils.py:370-379),
    drawn layer by layer from `generator` (on the CPU)."""
    layers = []
    for k_in, k_out in zip(channels[:-1], channels[1:]):
        layers.append({
            "W": glorot_normal(generator, (num_weights, k_in, k_out)),
            "B": torch.full((num_biases, k_out), C.BIAS_INIT)})
    return LayerParams(layers)


class ShiftInvVelParams(LayerParams):
    """The shiftinv_vel parameters: the layer stack plus ``T`` (2,), the
    learnable output scalars (loc, vel) of models/shiftinv.py:235-244."""

    def __init__(self, layers: Sequence[Dict[str, torch.Tensor]],
                 t: torch.Tensor):
        super().__init__(layers)
        self.T = nn.Parameter(t)


def params_from_jax(tree) -> LayerParams:
    """Load the JAX package's parameter pytree, converted to numpy, as the
    port's f32 parameters: a list of {"W", "B"} (shiftinv), or the
    shiftinv_vel dict {"layers": [...], "T": (2,)}."""
    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    layers = tree["layers"] if isinstance(tree, dict) else tree
    layers = [{"W": f32(p["W"]), "B": f32(p["B"])} for p in layers]
    if isinstance(tree, dict):
        return ShiftInvVelParams(layers, f32(tree["T"]))
    return LayerParams(layers)

