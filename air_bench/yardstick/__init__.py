"""The arithmetic the benchmark's numbers rest on, kept apart from the
program: seeds, weights, peak rates, FLOP and byte counts, and the
reading of a device trace."""

import numpy as np

#: Purposes a run's seed is split into, each its own stream.
STREAMS = {"weights": 1, "pool": 2, "noise": 3, "schedule": 4, "sample": 5}


def derived_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of the run seeded with ``seed``."""
    words = np.random.SeedSequence([int(seed), STREAMS[purpose]])
    return int(words.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, purpose: str) -> np.random.Generator:
    """A numpy generator for one purpose of the run."""
    return np.random.default_rng(derived_seed(seed, purpose))
