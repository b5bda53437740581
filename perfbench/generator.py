"""The one generator of the benchmark's inputs, driven by a traffic mix's
data file (perfbench/traffic/<mix>.json) and the run's seed: the same seed
gives the same inputs, and every seed the same sizes (only the values move).

Every draw comes from numpy's default_rng seeded with (seed, stream, index),
so a row's draw depends on neither the batch split over cards nor the
order of the calls that read it."""

from __future__ import annotations

import numpy as np

X0, SAMPLE, FRACTION = 0, 1, 2  # the streams


def _rng(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, *keys])


def x0_pool(mix: dict, seed: int, count: int, rows: slice) -> np.ndarray:
    """(count, rows, nx) initial states: entry k is x0_scale x N(0, 1) x
    x0_weights over the mix's whole batch, of which these rows are kept."""
    w = np.asarray(mix["x0_weights"], dtype=np.float64)
    return np.stack([mix["x0_scale"] * _rng(seed, X0, k).standard_normal((mix["batch"], len(w)))[rows] * w
                     for k in range(count)])


def sample(seed: int, what: int, n: int, k: int) -> np.ndarray:
    """k of range(n) without repeats (all of them where k >= n), sorted."""
    return np.sort(_rng(seed, SAMPLE, what).choice(n, size=min(k, n), replace=False))


def fractions(seed: int, what: int, k: int) -> np.ndarray:
    """k numbers in [0, 1)."""
    return _rng(seed, FRACTION, what).random(k)
