"""The port's own measurement: host spans, the train step's device
timeline, counters and chunk samples (the counterpart of
nbody_tpu/utils/profiling.py).

Tracing is on exactly while a torch profiler records
(``torch.autograd._profiler_enabled()``): the CLI's ``--trace DIR`` and a
caller's own ``torch.profiler.profile`` turn it on; there is no flag.

``span(name)``
    A ``torch.profiler.record_function`` range while a profiler records,
    else nothing (one flag check).  The ranges sit on the profiler's
    clock beside the device kernels, so an idle gap on the card can be
    put down to what the host was doing.  No span encloses a call into
    the Saver from the trainer's side: a caller's Saver may start or stop
    the profiler.

The step timeline
    ``mark(name)`` records an ordered mark into the open timeline: a
    timing CUDA event on the current stream, made with ``external=True``
    so that a stream capture records it as a node of the CUDA graph (on
    the CPU, which runs synchronously, a ``time.perf_counter()``
    reading).  The time from one mark to the next, in stream order, is
    the device time of the segment, keyed by the mark that ends it.
    ``probe(h, name)`` is an identity autograd Function at a layer
    boundary: its forward marks ``name``; its backward marks
    ``name + ".backward"`` where the gradient of that layer's output is
    complete, so the segment it ends is the backward of what follows the
    layer (the next layer; for the last layer, the loss and the head).
    The backward marks are boundaries in stream order: the segments sum
    to the step exactly, while the split between adjacent layers is
    approximate where autograd interleaves weight and input gradients.

    ``segment(kind, name, fn, x, ...)`` runs ``fn(x, ...)`` between two
    such probes: the forward segment that closes on it is
    ``<name><i>.<kind>`` and the backward's ``<name><i>.backward.<kind>``
    (i counts the step's calls of `name`, so every mark of a step has its
    own name); the work before each is ``<name><i>`` and
    ``<name><i>.backward``.  A reader sums a kind's segments by their
    suffix.  The kinds: ``layout`` (``layout(name, fn, x, ...)``, a copy
    of x into another order, ops/blocked.py), ``gate`` and ``norm`` (an
    attn layer's channel gate and its leaky relu and batch norm,
    models/attn.py).

    A timeline is open only inside ``timeline(device, always)``: the
    train step opens one always while TrainScan captures the step's CUDA
    graph (every replay then records its marks again) and, on an eager
    step, only while a profiler records.  With none open ``mark`` and
    ``probe`` return at once and add no autograd node.

Counters
    ``count(name, n)`` adds to one registry: ``launch.<wrapper>`` (the
    CUDA kernel wrappers), ``loss.particles`` (batch x particles of every
    prediction that reaches physics.losses.loss_za), ``coverage.host_rows``
    (the rows the coverage check's host k-d tree searched), ``attn.gate``
    and ``attn.norm`` (an attn forward's channel gates and batch norms),
    ``attn.gate_rows`` (the rows each gate's gram reduced: b x N when the
    gate is batch-coupled, N when it is per sample),
    ``graph.captures``, ``graph.replays`` and ``timeline.marks``.
    TrainScan takes back what a capture counted (a capture runs nothing on
    the card), keeps it as the graph's counts and adds them at every
    replay, so every counter counts work the card did, eagerly or
    replayed.  ``counters()`` is a
    snapshot, ``delta(before)`` the change since one.

Samples
    ``sample(steps, device_ms, before)``, at a chunk's loss read in
    Trainer.fit_scan (where the host has synchronized), appends the
    chunk's steps, the timeline of its last step in ms and its counter
    deltas to ``samples()`` while a profiler records.  ``reset()`` clears
    the counters and the samples.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

_counts: Dict[str, int] = {}
_samples: List[dict] = []
_open: Optional["Timeline"] = None


def recording() -> bool:
    """Whether a torch profiler records in this process."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A profiler range named `name` while a profiler records, else a
    context that does nothing."""
    if recording():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class Timeline:
    """The ordered marks of one train step: CUDA timing events on a card,
    host clock readings on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.names: List[str] = []
        self._marks: list = []
        self._calls: Dict[str, int] = {}

    def mark(self, name: str):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True, external=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.names.append(name)
        self._marks.append(ev)
        count("timeline.marks")

    def tag(self, name: str) -> str:
        """`name` with the count of its earlier tags in this step."""
        i = self._calls.get(name, 0)
        self._calls[name] = i + 1
        return f"{name}{i}"

    def segments_ms(self) -> Dict[str, float]:
        """{mark: ms since the previous mark} for every mark after the
        first, in order.  On a card the step's work must have completed
        (the caller has synchronized)."""
        m = self._marks
        if self.cuda:
            ms = [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        else:
            ms = [1e3 * (b - a) for a, b in zip(m, m[1:])]
        return dict(zip(self.names[1:], ms))


@contextlib.contextmanager
def timeline(device, always: bool = False):
    """Open a step timeline for the block, `always` or while a profiler
    records, and yield it; yield None (and open nothing) otherwise or
    where one is open already."""
    global _open
    if _open is not None or not (always or recording()):
        yield None
        return
    tl = _open = Timeline(device)
    try:
        yield tl
    finally:
        _open = None


def mark(name: str):
    """Mark `name` in the open timeline; nothing where none is open."""
    tl = _open
    if tl is not None:
        tl.mark(name)


class _Probe(torch.autograd.Function):
    """Identity on its tensors: marks `name` in the forward, and `back` in
    the backward once the gradients of all of them are complete."""

    @staticmethod
    def forward(ctx, tl, name, back, *ts):
        ctx.tl, ctx.back = tl, back
        tl.mark(name)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        ctx.tl.mark(ctx.back)
        return (None, None, None) + grads


def probe(h: torch.Tensor, name: str) -> torch.Tensor:
    """h, marked `name` in the forward and `name`.backward in the backward
    of the open timeline; h itself, with no autograd node, where none is
    open."""
    tl = _open
    if tl is None:
        return h
    return _Probe.apply(tl, name, name + ".backward", h)[0]


def segment(kind: str, name: str, fn, x: torch.Tensor, *args):
    """fn(x, *args), with its forward and backward marked apart in the open
    timeline as segments of `kind` (the module's note); fn(x, *args)
    alone, with no autograd node, where none is open.  The backward's
    closing mark waits for the gradients of x and of every tensor in args
    that needs one (a layer's weights: its segment holds their gradients
    too, also where x needs none)."""
    tl = _open
    if tl is None:
        return fn(x, *args)
    tag = tl.tag(name)
    grads = [i for i, a in enumerate(args)
             if isinstance(a, torch.Tensor) and a.requires_grad]
    x, *probed = _Probe.apply(tl, tag, f"{tag}.backward.{kind}", x,
                              *(args[i] for i in grads))
    args = list(args)
    for i, a in zip(grads, probed):
        args[i] = a
    return _Probe.apply(tl, f"{tag}.{kind}", tag + ".backward", fn(x, *args))[0]


def layout(name: str, fn, x: torch.Tensor, *args):
    """fn(x, *args), layout work, as a segment of kind ``layout``."""
    return segment("layout", name, fn, x, *args)


def count(name: str, n: int = 1):
    """Add n to the counter `name`."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    return dict(_counts)


def delta(before: Dict[str, int]) -> Dict[str, int]:
    """{counter: change since the snapshot `before`}, nonzero changes only."""
    return {k: v - before.get(k, 0) for k, v in _counts.items()
            if v != before.get(k, 0)}


def add(deltas: Dict[str, int]):
    """Add a delta (a graph's counts at its replay)."""
    for k, v in deltas.items():
        count(k, v)


def restore(snapshot: Dict[str, int]):
    """Set the counters back to a snapshot (taking back what a capture
    counted)."""
    _counts.clear()
    _counts.update(snapshot)


def sample(steps: int, device_ms: Optional[Dict[str, float]],
           before: Dict[str, int]):
    """Append one chunk's sample while a profiler records: its steps, its
    last step's timeline in ms ({} where it had none) and the counters'
    change since `before`."""
    if recording():
        _samples.append({"steps": int(steps), "device_ms": dict(device_ms or {}),
                         "counts": delta(before)})


def samples() -> List[dict]:
    """The samples taken so far, oldest first."""
    return list(_samples)


def reset():
    """Clear the counters and the samples."""
    _counts.clear()
    _samples.clear()
