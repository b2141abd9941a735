"""What the program samples of its own training run
(nbody_tpu_torch/tracing.py), reduced for the per-layer readers.

At each chunk's loss read, while a profiler records, the program's
fit_scan appends one sample: the chunk's steps, the timeline of its last
step ({mark: device ms since the previous mark}, on the card CUDA events
captured into the step's graph) and its counters' change.  A traced
window's samples are the newest ones whose steps add up to the window's
units.  A program without that module or those samples gives nothing,
and the readers then report nothing.
"""

from __future__ import annotations

from typing import List, Optional

# a phase of the train step: the segments after the opening mark (from
# the first segment where None) up to and including the closing mark
PHASES = {"forward": (None, "loss"), "backward": ("loss", "backward"),
          "adam": ("backward", "adam")}


def window_samples(view) -> List[dict]:
    """The program's samples of the traced window, oldest first; [] where
    the program takes none or they do not add up to the window."""
    try:
        from nbody_tpu_torch import tracing
    except ImportError:
        return []
    out, steps = [], 0
    for s in reversed(tracing.samples()):
        if steps >= view.units:
            break
        out.append(s)
        steps += s["steps"]
    return out[::-1] if view.units > 0 and steps == view.units else []


def phase_ms(device_ms: dict, phase: str) -> Optional[float]:
    """The device ms of `phase` in one step's timeline, or None where a
    mark it needs is missing."""
    opening, closing = PHASES[phase]
    names = list(device_ms)
    if closing not in names or (opening is not None and opening not in names):
        return None
    lo = 0 if opening is None else names.index(opening) + 1
    hi = names.index(closing)
    if hi < lo:
        return None
    return sum(device_ms[n] for n in names[lo:hi + 1])


def mean_phase_ms(view, phase: str) -> Optional[float]:
    """The mean of `phase` over the window's samples, or None."""
    got = [phase_ms(s["device_ms"], phase) for s in window_samples(view)]
    got = [v for v in got if v is not None]
    return sum(got) / len(got) if got else None


def counted(view, name: str) -> Optional[int]:
    """The counter `name`'s change summed over the window's samples, or
    None where the window has none."""
    got = window_samples(view)
    return sum(s["counts"].get(name, 0) for s in got) if got else None
