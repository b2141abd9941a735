"""Plain float32 reference of the attention + residual set network
(evdcush/N-Body_PointCloudEvolution, experiment.py:83-157: the
mean-centred ``set_transform``, the channel-gate ``attn_layer``, the
leaky-relu + batch-norm stack and the tanh input residual of
``net_fwd``), trained on loss_za with Adam.

Per layer (c in, q out): xf, xg and xh are the input less its mean over
the particles of each sample, times Wf, Wg and Wh (c, q); the gate is the
row softmax of the (q, q) gram xf^T xg, summed over every row of the
batch (the reference's reshape to (b N, q) before the product,
experiment.py:122-128) or, with ``coupled`` False, over each sample's N
rows; the layer's output is xh times the gate, plus B.  Every layer but
the last is followed by leaky relu (slope 0.01) and batch norm with
gamma and beta; the residual r = tanh(set_transform(x_in, R)), R (6, q),
is computed in every hidden layer from the 6-column input, and only the
last hidden layer's is added to the final layer's input.

Departures from the published code, which the port shares: batch norm
takes the batch's statistics over (b, N) in training, with the
population variance and eps 1e-3 (the published code left its statistics
frozen at mean 0, variance 1, so that its "batch norm" was a fixed
affine map).  The batch norm is written as tf.nn.batch_normalization
computes it (x times gamma / sqrt(var + eps), plus beta less mean times
that).

Nothing here imports the program; ``common.f32_within`` keeps TF32 off
on the card.  The whole batch runs at once: the gate and the statistics
couple its cubes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark_torch.reference import common

# the per-layer parameters, in the order the leaves are compared
KEYS = ("Wf", "Wg", "Wh", "R", "B", "gamma", "beta")
LEAK = 0.01
BN_EPS = 1e-3


def _centred(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """set_transform: (x - its mean over the particles) @ w."""
    return (x - x.mean(dim=1, keepdim=True)) @ w


def _gate(x: torch.Tensor, layer: Dict[str, torch.Tensor], coupled: bool) -> torch.Tensor:
    xf, xg, xh = (_centred(x, layer[w]) for w in ("Wf", "Wg", "Wh"))
    if coupled:
        gram = torch.einsum("bnk,bnl->kl", xf, xg)
        return torch.einsum("bnk,kl->bnl", xh, torch.softmax(gram, dim=-1)) + layer["B"]
    gram = torch.einsum("bnk,bnl->bkl", xf, xg)
    return torch.einsum("bnk,bkl->bnl", xh, torch.softmax(gram, dim=-1)) + layer["B"]


def _batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(0, 1))
    var = ((x - mean) ** 2).mean(dim=(0, 1))
    inv = gamma / torch.sqrt(var + BN_EPS)
    return x * inv + (beta - mean * inv)


def forward(layers: Sequence[Dict[str, torch.Tensor]], x_in: torch.Tensor,
            coupled: bool = True) -> torch.Tensor:
    """net_fwd: x_in (b, N, 6) -> (b, N, q_last)."""
    h, r = x_in, None
    for layer in layers[:-1]:
        h = torch.nn.functional.leaky_relu(_gate(h, layer, coupled), LEAK)
        h = _batch_norm(h, layer["gamma"], layer["beta"])
        r = torch.tanh(_centred(x_in, layer["R"]))
    return _gate(h + r, layers[-1], coupled)


def leaves(layers: Sequence[Dict[str, torch.Tensor]]) -> List[torch.Tensor]:
    """The parameters as one list: each key of KEYS over the layers."""
    return [layer[key] for key in KEYS for layer in layers]


def gradient(layers: Sequence[Dict[str, torch.Tensor]], x_in: torch.Tensor,
             target: torch.Tensor, dtype=torch.float32):
    """(loss, the gradient of every leaf in ``leaves``' order) of one batch,
    computed in `dtype` from `layers`; a leaf the loss does not reach (the
    unused residual weights, the last layer's gamma and beta) has a zero
    gradient."""
    nl = len(layers)
    params = [p.detach().to(dtype).requires_grad_(True) for p in leaves(layers)]
    cur = [{key: params[k * nl + i] for k, key in enumerate(KEYS)} for i in range(nl)]
    with common.f32_within():
        loss = common.loss_za(forward(cur, x_in.to(dtype)), target.to(dtype))
        got = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(params, got)]


def train_steps(layers: Sequence[Dict[str, torch.Tensor]], batches, lr: float):
    """The reference's train steps from `layers` (float32, not modified)
    over `batches` [(x_in (b, N, 6), target (b, N, 3)), ...], each batch
    whole -> (losses, first gradients, parameter changes, each step's
    per-cube losses), the leaves in ``leaves``' order."""
    nl = len(layers)
    params = [p.detach().clone() for p in leaves(layers)]
    start = [p.clone() for p in params]
    adam = common.Adam(params, lr)
    losses, first, per_cube = [], None, []
    for x_in, target in batches:
        cur = [{key: params[k * nl + i] for k, key in enumerate(KEYS)} for i in range(nl)]
        loss, grads = gradient(cur, x_in, target)
        losses.append(float(loss))
        with torch.no_grad(), common.f32_within():
            pred = forward(cur, x_in)
            per_cube.append(torch.mean(torch.sum((pred - target) ** 2, dim=-1), dim=1).tolist())
        if first is None:
            first = [g.clone() for g in grads]
        adam.step(grads)
        del pred, grads
    return losses, first, [q - q0 for q, q0 in zip(params, start)], per_cube
