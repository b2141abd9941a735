"""Attention + residual set network (port of nbody_tpu/models/attn.py;
reference experiment.py:83-157).

A stack of channel-gate attention layers, each followed by leaky relu
(slope 0.01) and then batch norm, with tanh residual projections from
the 6-channel input.  The residual r is recomputed every layer and
merged only into the last layer's input (h + r), as the reference
executes.  The "attention" is a (k, k) channel gate softmax(xf^T xg)
applied to xh; with ``batch_coupled_gate`` (the reference) the gram
runs over all b*N rows at once, else per sample.

Batch norm keeps the JAX package's documented deviation: batch
statistics over (b, N) (population variance, eps 1e-3) in train mode,
and the reference's frozen (0, 1) statistics in eval mode.  Every
product is a plain torch op, as it was an XLA op outside any Pallas
kernel in JAX.

Tracing (tracing.py): in an open step timeline each layer's gate (the
three mean-centred products, the gram, its softmax, the product with xh
and B) is a segment of kind ``gate`` (marks ``gate<i>``,
``gate<i>.gate``, and backward ``gate<i>.backward``,
``gate<i>.backward.gate``), and each hidden layer's leaky relu and batch
norm one of kind ``norm`` (``norm<i>`` ... ``norm<i>.backward.norm``).
Every forward counts ``attn.gate`` and ``attn.norm`` (23 and 22 at
ATTN_CHANNELS) and, a gate, the rows its gram reduced, ``attn.gate_rows``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from nbody_tpu_torch import tracing
from nbody_tpu_torch.models.base import AttnParams, glorot_normal

ATTN_BIAS_INIT = 1e-6   # reference experiment.py:54


def init_attn_params(generator: torch.Generator,
                     channels: Sequence[int]) -> AttnParams:
    """Per layer: glorot-normal Wf, Wg, Wh (k_in, k_out) and R (6, k_out),
    B = ATTN_BIAS_INIT, batch norm's gamma 1 and beta 0."""
    layers = []
    for k_in, k_out in zip(channels[:-1], channels[1:]):
        layers.append({
            "Wf": glorot_normal(generator, (k_in, k_out)),
            "Wg": glorot_normal(generator, (k_in, k_out)),
            "Wh": glorot_normal(generator, (k_in, k_out)),
            "R": glorot_normal(generator, (channels[0], k_out)),
            "B": torch.full((k_out,), ATTN_BIAS_INIT),
            "gamma": torch.ones(k_out), "beta": torch.zeros(k_out)})
    return AttnParams(layers)


def set_transform(x_in: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-centred matmul (reference experiment.py:83-89)."""
    out = torch.matmul(x_in - torch.mean(x_in, dim=1, keepdim=True), w)
    return out if b is None else out + b


def _gate(x_in: torch.Tensor, wf: torch.Tensor, wg: torch.Tensor,
          wh: torch.Tensor, bias: torch.Tensor,
          batch_coupled_gate: bool) -> torch.Tensor:
    xf = set_transform(x_in, wf)
    xg = set_transform(x_in, wg)
    xh = set_transform(x_in, wh)
    if batch_coupled_gate:
        k = xf.shape[-1]
        gram = torch.matmul(xf.reshape(-1, k).T, xg.reshape(-1, k))  # (k, k)
    else:
        gram = torch.matmul(xf.transpose(1, 2), xg)                 # (b, k, k)
    return torch.matmul(xh, torch.softmax(gram, dim=-1)) + bias


def attn_layer(x_in: torch.Tensor, p: Dict[str, torch.Tensor],
               batch_coupled_gate: bool = True) -> torch.Tensor:
    """Channel-gate attention (reference experiment.py:108-132), a
    ``gate`` segment of the open timeline; counts ``attn.gate`` and the
    rows its gram reduces, ``attn.gate_rows`` (b x N coupled, else N)."""
    b, n, _ = x_in.shape
    tracing.count("attn.gate")
    tracing.count("attn.gate_rows", b * n if batch_coupled_gate else n)
    return tracing.segment("gate", "gate", _gate, x_in, p["Wf"], p["Wg"],
                           p["Wh"], p["B"], batch_coupled_gate)


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-3, train_mode: bool = True) -> torch.Tensor:
    """Batch statistics over (b, N), population variance, in train mode;
    the frozen (0, 1) statistics in eval mode."""
    if train_mode:
        mu = torch.mean(x, dim=(0, 1), keepdim=True)
        var = torch.var(x, dim=(0, 1), keepdim=True, correction=0)
    else:
        mu = torch.zeros((), dtype=x.dtype, device=x.device)
        var = torch.ones((), dtype=x.dtype, device=x.device)
    return gamma * (x - mu) * torch.rsqrt(var + eps) + beta


def attn_network(params: List[Dict[str, torch.Tensor]], x_in: torch.Tensor,
                 batch_coupled_gate: bool = True,
                 train_mode: bool = True) -> torch.Tensor:
    """[attn -> leaky relu -> batch norm] stack, the tanh input residual of
    the last hidden layer merged into the final layer's input (reference
    net_fwd, experiment.py:139-157)."""
    def norm(h, gamma, beta):
        return batch_norm(F.leaky_relu(h, 0.01), gamma, beta,
                          train_mode=train_mode)

    def hidden(h, p):
        tracing.count("attn.norm")
        return tracing.segment("norm", "norm", norm,
                               attn_layer(h, p, batch_coupled_gate),
                               p["gamma"], p["beta"])

    h = hidden(x_in, params[0])
    r = torch.tanh(set_transform(x_in, params[0]["R"]))
    for p in params[1:-1]:
        h = hidden(h, p)
        r = torch.tanh(set_transform(x_in, p["R"]))
    return attn_layer(h + r, params[-1], batch_coupled_gate)
