"""The benchmark's arithmetic: interval unions, and the least
time of a piece of work on a card."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().with_name("peaks.json")


def merged(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def peaks_for(kind: str, path: Path = PEAKS) -> dict | None:
    """The table's peaks for the card named ``kind``, or None."""
    return json.loads(path.read_text()).get(kind)


def least_time_s(work: dict, peaks: dict) -> float:
    """The least time a card with ``peaks`` needs for ``work`` (FLOPs in
    matrix products, other FLOPs, bytes): the larger of the compute term
    and the memory term."""
    compute = (work["mm_flops"] / peaks["mm_flops_per_s"]
               + work["other_flops"] / peaks["other_flops_per_s"])
    return max(compute, work["bytes"] / peaks["bytes_per_s"])


def scale_work(per_row: dict, rows: int, calls: int) -> dict:
    """The work of ``calls`` calls over ``rows`` rows in all, from a
    configuration's frozen counts per row (and bytes per call)."""
    return {"mm_flops": per_row["mm_flops"] * rows,
            "other_flops": per_row["other_flops"] * rows,
            "bytes": (per_row["bytes"] * rows
                      + per_row.get("bytes_per_call", 0) * calls)}
