"""Synthetic data generators for tests and benchmarks.

A copy of ``tchvp_tpu/data/synthetic.py``: numpy generators from
``default_rng(seed)``, so both packages yield the same batches bit for bit,
with the shapes and dtypes the CSV loaders yield.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


class SyntheticImages:
    """Yields (B, S, S, 3) uint8 batches."""

    def __init__(self, batch_size: int, image_size: int, num_batches: int, seed: int = 0):
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_batches = num_batches
        self.seed = seed

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        for _ in range(self.num_batches):
            yield rng.integers(
                0, 256, (self.batch_size, self.image_size, self.image_size, 3),
                dtype=np.uint8,
            )


class SyntheticImageMasks:
    """Yields ((B, S, S, 3) uint8, (B, S, S, 1) uint8) supervised batches."""

    def __init__(self, batch_size: int, image_size: int, num_batches: int, seed: int = 0):
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_batches = num_batches
        self.seed = seed

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        s = self.image_size
        for _ in range(self.num_batches):
            img = rng.integers(0, 256, (self.batch_size, s, s, 3), dtype=np.uint8)
            mask = (rng.random((self.batch_size, s, s, 1)) > 0.5).astype(np.uint8) * 255
            yield img, mask


class SyntheticClips:
    """Yields (B, T, S, S, 3) uint8 clip batches."""

    def __init__(
        self,
        batch_size: int,
        clip_len: int,
        image_size: int,
        num_batches: int,
        seed: int = 0,
    ):
        self.batch_size = batch_size
        self.clip_len = clip_len
        self.image_size = image_size
        self.num_batches = num_batches
        self.seed = seed

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        s = self.image_size
        for _ in range(self.num_batches):
            yield rng.integers(
                0, 256, (self.batch_size, self.clip_len, s, s, 3), dtype=np.uint8
            )
