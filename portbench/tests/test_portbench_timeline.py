"""The interval arithmetic of the idle share and the spread statistics."""

import statistics

from hypothesis import given, settings
from hypothesis import strategies as st

from portbench.yardstick import timeline

intervals = st.lists(st.tuples(st.floats(0, 1000), st.floats(0, 100)).map(
    lambda p: (p[0], p[0] + p[1])), max_size=40)


@settings(max_examples=200, deadline=None)
@given(intervals, st.floats(0, 500), st.floats(0, 1200))
def test_union_never_exceeds_the_window(spans, lo, width):
    hi = lo + width
    busy = timeline.union_length(timeline.clipped(spans, lo, hi))
    assert 0.0 <= busy <= width + 1e-9
    idle = sum(e - s for s, e in timeline.gaps(spans, lo, hi))
    assert abs(busy + idle - width) <= 1e-6 * max(1.0, width)


def test_overlapping_records_count_once():
    spans = [(0, 10), (5, 15), (5, 8), (20, 30)]
    assert timeline.union_length(spans) == 25
    assert timeline.union_length(timeline.clipped(spans, 0, 12)) == 12
    assert timeline.gaps(spans, 0, 40) == [(15, 20), (30, 40)]


def test_percentile_and_spread():
    xs = [float(x) for x in range(1, 101)]
    assert timeline.percentile(xs, 95) == 95.05
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert timeline.spread(xs) == (q3 - q1) / q2
