"""Logical bytes of the neighbor gathers and scatters, shared by the
families' counts.

A call is (kind, rows, edges, width, elem): a gather reads a table of
`rows` rows of `width` values and writes `edges` rows; a scatter (a
segment sum) reads `edges` rows and writes `rows` sums; both read one
int32 id an edge.  Each input row, id and output row is counted once,
whatever the kernel that implements the call reads again, so the count
is the same for every implementation, and a roofline share compares
implementations on the same work.
"""

from __future__ import annotations

from typing import NamedTuple

ID_BYTES = 4
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


class Call(NamedTuple):
    kind: str        # "gather" or "scatter"
    rows: int        # node-table rows (gather input, scatter output)
    edges: int       # edge rows (gather output, scatter input)
    width: int       # values a row
    elem: int        # bytes a value


def call_bytes(c: Call) -> int:
    return (c.rows + c.edges) * c.width * c.elem + c.edges * ID_BYTES


def pairs(channels):
    return list(zip(channels[:-1], channels[1:]))


def route_of(traffic: dict) -> str:
    """The neighbor route a traffic mix runs: "index" for --mask_dtype
    index, "int8" / "int4", else "direct" (the default kernels B/C)."""
    m = traffic.get("mask_dtype", "auto")
    return m if m in ("index", "int8", "int4") else "direct"
