"""Parameter store (port of nbody_tpu/models/base.py; reference
utils.py:292-386).

A model's parameters are per-layer W (num_weights, k_in, k_out) and
B (num_biases, k_out), held in f32 by a ``LayerParams`` module.  Init
matches the reference's distributions (glorot-normal weights, biases
1e-8) drawn from a ``torch.Generator``; the draws differ from the JAX
package's threefry streams, so parity tests load the JAX parameters with
``params_from_jax`` instead of matching seeds.  The shiftinv_vel family
adds two output scalars (``ShiftInvVelParams``); the set family uses
``LayerParams`` with one W and one B a layer, and the attn family holds
its gate, residual and batch-norm parameters in ``AttnParams``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.utils.checkpoint
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


def remat_layer(fn: Callable, remat: bool) -> Callable:
    """A graph layer, or with `remat` the same layer recomputed in the
    backward pass (the port of jax.checkpoint around each layer,
    models/shiftinv.py:125, models/shiftinv15.py:576-577): torch.utils.
    checkpoint without reentrancy, and without saving the RNG state -- the
    forward draws no random numbers, and fit_scan's CUDA-graph capture
    must not touch the generator."""
    if not remat:
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False, preserve_rng_state=False)


class ShiftInvVelParams(LayerParams):
    """The shiftinv_vel parameters: the layer stack plus ``T`` (2,), the
    learnable output scalars (loc, vel) of models/shiftinv.py:235-244."""

    def __init__(self, layers: Sequence[Dict[str, torch.Tensor]],
                 t: torch.Tensor):
        super().__init__(layers)
        self.T = nn.Parameter(t)


ATTN_KEYS = ("Wf", "Wg", "Wh", "R", "B", "gamma", "beta")


class AttnParams(nn.Module):
    """The attn family's per-layer parameters (models/attn.py:37-57):
    Wf, Wg, Wh (k_in, k_out), R (6, k_out), B, gamma and beta (k_out),
    each a ParameterList over the layers (f32)."""

    def __init__(self, layers: Sequence[Dict[str, torch.Tensor]]):
        super().__init__()
        for key in ATTN_KEYS:
            setattr(self, key, nn.ParameterList(
                [nn.Parameter(p[key]) for p in layers]))

    def __len__(self) -> int:
        return len(self.Wf)

    def layers(self, dtype=None) -> List[Dict[str, torch.Tensor]]:
        """[{"Wf", ..., "beta"}, ...], cast to `dtype` if given."""
        return [{key: (t if dtype is None else t.to(dtype))
                 for key, t in zip(ATTN_KEYS, ts)}
                for ts in zip(*(getattr(self, key) for key in ATTN_KEYS))]


def params_from_jax(tree) -> nn.Module:
    """Load the JAX package's parameter pytree, converted to numpy, as the
    port's f32 parameters: a list of {"W", "B"} (set, shiftinv), the
    shiftinv_vel dict {"layers": [...], "T": (2,)}, or a list of attn
    layers {"Wf", ..., "beta"}."""
    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    layers = tree["layers"] if isinstance(tree, dict) else tree
    if "Wf" in layers[0]:
        return AttnParams([{key: f32(p[key]) for key in ATTN_KEYS}
                           for p in layers])
    layers = [{"W": f32(p["W"]), "B": f32(p["B"])} for p in layers]
    if isinstance(tree, dict):
        return ShiftInvVelParams(layers, f32(tree["T"]))
    return LayerParams(layers)

