"""Arithmetic on device records and step times: the union of intervals
(busy time, never above the window), the idle gaps between them, and the
spread statistics the bounds are set from."""

from __future__ import annotations

import statistics


def union_length(intervals):
    """Total length covered by ``intervals`` [(start, end), ...]: records
    that overlap (kernels side by side on several streams) count once."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def clipped(intervals, lo, hi):
    """``intervals`` cut to the window [lo, hi]; those outside it dropped."""
    out = []
    for start, end in intervals:
        start, end = max(start, lo), min(end, hi)
        if end > start:
            out.append((start, end))
    return out


def gaps(intervals, lo, hi):
    """The idle stretches [(start, end), ...] of the window [lo, hi] that no
    interval covers, in time order."""
    out, cursor = [], lo
    for start, end in sorted(clipped(intervals, lo, hi)):
        if start > cursor:
            out.append((cursor, start))
        cursor = max(cursor, end)
    if hi > cursor:
        out.append((cursor, hi))
    return out


def percentile(values, q):
    """The ``q``-th percentile of ``values`` with linear interpolation
    between closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values):
    """The distance between the first and third quartiles as a share of
    the median, as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
