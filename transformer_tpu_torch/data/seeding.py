"""The epoch-shuffle seeding contract, copied from
``transformer_tpu/data/seeding.py`` so that batch order matches the JAX
package bit for bit: every shuffle draws from a NumPy PRNG keyed on an
integer tuple (``SeedSequence`` mixes the components, so (0, 1) and (1, 0)
land in unrelated streams)."""

from __future__ import annotations

import numpy as np


def keyed_rng(*key: int) -> np.random.Generator:
    """A deterministic PRNG keyed on an integer tuple."""
    return np.random.default_rng(key)


def epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    """The epoch-shuffle PRNG: ``default_rng`` keyed on
    ``(seed, epoch)``."""
    return keyed_rng(seed, epoch)
