"""Checkpoint save / restore with torch.save (port of
nbody_tpu/io_/checkpoint.py).

One file a checkpoint, ``{base_dir}/chkpt-{step}.pt``, holding the
model's and the optimizer's ``state_dict`` and the global step: the JAX
TrainState (params, optax state, step).  A trainer, or anything with the
Trainer's ``state_dict`` / ``load_state_dict``, is saved and restored in
place.  The JAX package's checkpoints are orbax directories
(``chkpt-{step}/``); orbax is a JAX library, so the port does not read
them and refuses a directory that holds only those.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

_STEP_FILE = "chkpt-{step}.pt"
_STEP_RE = re.compile(r"chkpt-(\d+)\.pt")
_ORBAX_RE = re.compile(r"chkpt-(\d+)")


def _ckpt_path(base: str, step: int) -> str:
    return os.path.join(os.path.abspath(base), _STEP_FILE.format(step=step))


def save_checkpoint(base_dir: str, state: Any, step: int) -> str:
    """Write state.state_dict() (model, optimizer) and `step` to
    base_dir/chkpt-{step}.pt; returns the path."""
    path = _ckpt_path(base_dir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({**state.state_dict(), "step": int(step)}, tmp)
    os.replace(tmp, path)    # a reader never sees half a file
    return path


def latest_step(base_dir: str) -> Optional[int]:
    """Largest saved step in base_dir, or None."""
    if not os.path.isdir(base_dir):
        return None
    steps = [int(m.group(1)) for m in map(_STEP_RE.fullmatch, os.listdir(base_dir))
             if m]
    return max(steps) if steps else None


def restore_checkpoint(base_dir: str, state: Any, step: Optional[int] = None) -> int:
    """Load the checkpoint at `step` (default: the latest) into `state` in
    place, mapped onto its device; returns the restored step."""
    if step is None:
        step = latest_step(base_dir)
        if step is None:
            orbax = (os.path.isdir(base_dir) and any(
                _ORBAX_RE.fullmatch(n) and os.path.isdir(os.path.join(base_dir, n))
                for n in os.listdir(base_dir)))
            if orbax:
                raise ValueError(
                    f"{base_dir} holds only orbax checkpoint directories "
                    "(chkpt-N/) of the JAX package; nbody_tpu_torch reads "
                    "its own chkpt-N.pt files and cannot load them")
            raise FileNotFoundError(f"no checkpoints under {base_dir}")
    payload = torch.load(_ckpt_path(base_dir, step), map_location=state.device,
                         weights_only=True)
    state.load_state_dict(payload)
    return int(payload["step"])
