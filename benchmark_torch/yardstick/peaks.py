"""The H100's published peaks and the roofline bound of a piece of work.

Copied from chip_smoke.py (``H100_*``, ``bound``): NVIDIA's
data sheet for the H100 SXM, dense rates without sparsity, at the full
700 W power limit.  A card set below it runs slower under load, so every
share the benchmark reports is printed beside the card's power limit
(``power_limit``).
"""

from __future__ import annotations

import subprocess

H100_BYTES_PER_S = 3.35e12      # HBM3
H100_FP32_OPS = 67e12           # outside the tensor cores
H100_BF16_TC_OPS = 989e12       # bf16 tensor cores, dense


def bound(n_bytes, ops=0.0, ops_rate=H100_FP32_OPS):
    """(bound_s, bound_by): the least time the card could take for work
    that moves n_bytes (each input read once, each output written once)
    and does `ops` operations at `ops_rate` per second."""
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = ops / ops_rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def query_power_limit():
    """Start nvidia-smi's query of the card's name and power limit (it
    takes a second; read it with ``read_power_limit``)."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def read_power_limit(query) -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    if isinstance(query, str):
        return query
    try:
        out, _ = query.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        query.kill()
        query.communicate()
        return "nvidia-smi timed out"
    lines = out.strip().splitlines()
    return lines[0] if lines else "nvidia-smi gave nothing"


def power_limit() -> str:
    return read_power_limit(query_power_limit())
