"""Percentiles over all requests of a window, and the spread."""

import numpy as np
import pytest

from benchmark.harness import stats


@pytest.mark.parametrize("q", [50, 95, 99])
def test_bench_percentile_is_numpys(q):
    xs = list(np.random.default_rng(q).gamma(2.0, 30.0, size=317))
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_bench_p95_over_all_requests_not_a_median_of_chunks():
    xs = [10.0] * 90 + [100.0] * 10         # the slow tenth comes last
    chunks = [xs[i:i + 25] for i in range(0, 100, 25)]
    per_chunk = sorted(stats.percentile(c, 95) for c in chunks)
    assert stats.percentile(xs, 95) == 100.0
    assert per_chunk[1] == 10.0             # a median of chunks hides it


def test_bench_spread_uses_statistics_quartiles():
    xs = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    # statistics.quantiles(n=4), exclusive: 1.75, 3.5, 5.25
    assert stats.spread(xs) == pytest.approx((5.25 - 1.75) / 3.5)


def test_bench_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        stats.percentile([], 50)
