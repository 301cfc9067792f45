"""The streams of one ``--seed`` (``numpy.random.SeedSequence``), taken
whole: a seed is any whole number, reduced modulo 2^64.

- ``[seed, 1]``: the order in which the run hands the mix's lanes to the
  program, the same in every episode and in the set-up's warm-up;
- ``[seed, 2]``: the sample that the correctness check draws.

A mix draws its lanes from its own ``pool_seed``, so that every seed runs
the same work in another order: drawn from the run's seed, the lanes
changed a window's work with the seed (PERF.md).
"""

from __future__ import annotations

import numpy as np

SEED_SPACE = 2 ** 64


def seed_seq(seed: int, *path: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) % SEED_SPACE, *path])


def order_stream(seed: int) -> np.random.SeedSequence:
    return seed_seq(seed, 1)


def sample_stream(seed: int) -> np.random.SeedSequence:
    return seed_seq(seed, 2)


def order(seed: int, n: int) -> np.ndarray:
    """The run's order of ``n`` lanes."""
    return np.random.default_rng(order_stream(seed)).permutation(n)
