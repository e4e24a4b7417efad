"""Dataset protocol + a small host-side data loader.

Port of ``vision_semantic_segmentation_tpu/train/datasets/base.py`` (it
replaces the reference's ``torch.utils.data.DataLoader`` /
``DistributedSampler``, ref data/build.py:87-103): shuffling reseeded by
epoch, batching with drop_last, a thread pool for decode/augment (the
reference's ``num_workers``), and shards (each shard reads its slice — the
DistributedSampler equivalent; batch_size is per shard).  The shuffle order
is the JAX package's for the same seed and epoch.
"""
from __future__ import annotations

import concurrent.futures
import os
import os.path as osp
from typing import Dict, Iterator, List, Sequence

import numpy as np


class Dataset:
    """Minimal map-style dataset protocol."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    @staticmethod
    def get_filenames(directory: str) -> List[str]:
        return [
            osp.splitext(c)[0]
            for c in os.listdir(directory)
            if osp.isfile(osp.join(directory, c))
        ]


class DataLoader:
    """Batched iteration with shuffling, worker threads, host sharding."""

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 0,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0
        self._rng = np.random.default_rng(seed)

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle per epoch (ref DistributedSampler.set_epoch)."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self._shard_indices(shuffled=False))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _shard_indices(self, shuffled: bool) -> np.ndarray:
        n = len(self.dataset)
        indices = np.arange(n)
        if shuffled:
            rng = np.random.default_rng(self._rng.bit_generator.seed_seq.entropy % (2**31) + self.epoch)
            rng.shuffle(indices)
        return indices[self.shard_index :: self.num_shards]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._shard_indices(shuffled=self.shuffle)
        nb = len(indices) // self.batch_size
        remainder = len(indices) % self.batch_size
        batches = [
            indices[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)
        ]
        if remainder and not self.drop_last:
            batches.append(indices[nb * self.batch_size :])

        if self.num_workers > 0:
            with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
                for batch_idx in batches:
                    samples = list(pool.map(self.dataset.__getitem__, batch_idx))
                    yield _collate(samples)
        else:
            for batch_idx in batches:
                yield _collate([self.dataset[i] for i in batch_idx])


def _collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        out[key] = np.stack([np.asarray(s[key]) for s in samples])
    return out
