"""Dataset protocol + a small host-side data loader.

Port of ``vision_semantic_segmentation_tpu/train/datasets/base.py`` (it
replaces the reference's ``torch.utils.data.DataLoader`` /
``DistributedSampler``, ref data/build.py:87-103): shuffling reseeded by
epoch, batching with drop_last, a thread pool for decode/augment (the
reference's ``num_workers``), and shards (each shard reads its slice — the
DistributedSampler equivalent; batch_size is per shard).  The shuffle order
is the JAX package's for the same seed and epoch.

Data-parallel training splits each batch instead (``rank``, ``world``):
every rank draws the same permutation and decodes only its contiguous
slice of each global batch of ``batch_size``, which is the JAX mesh's split
of a global batch (``shard_batch``).  With ``micro`` > 1 micro-batches
(gradient accumulation) a rank's slice is its contiguous part of each
micro-batch in turn, so that micro-batch i is the global batch's i-th
contiguous chunk on every rank together, as in the JAX step's reshape.  A
remainder batch is padded to a multiple of ``world`` with copies of its
first sample whose labels are all ``PAD_LABEL`` (JAX
``Trainer._pad_batch``): no loss and no confusion, only the training
BatchNorm statistics see them.

``sample_seed`` gives each sample's transforms a generator of its own,
seeded by (``sample_seed``, epoch, dataset index): a sample draws the same
scales, crops and flips on every rank and whatever thread decodes it.
Without it the transforms draw from Python's ``random``, in the order the
worker threads reach it.
"""
from __future__ import annotations

import concurrent.futures
import os
import os.path as osp
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..transforms import sample_random

PAD_LABEL = 255


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
        rank: int = 0,
        world: int = 1,
        micro: int = 1,
        sample_seed: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.rank = rank
        self.world = world
        self.micro = micro
        self.sample_seed = sample_seed
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
        batches = [self._rank_slice(b) for b in batches]

        if self.num_workers > 0:
            with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
                for batch_idx, pads in batches:
                    samples = list(pool.map(self._sample, batch_idx))
                    yield _collate(_padded(samples, pads))
        else:
            for batch_idx, pads in batches:
                yield _collate(_padded([self._sample(i) for i in batch_idx], pads))

    def _sample(self, index: int) -> Dict[str, np.ndarray]:
        if self.sample_seed is None:
            return self.dataset[index]
        seed = np.random.SeedSequence([self.sample_seed, self.epoch, int(index)])
        with sample_random(int(seed.generate_state(1)[0])):
            return self.dataset[index]

    def _rank_slice(self, batch_idx: np.ndarray):
        """This rank's slice of a global batch, and how many of its last
        entries are padding (copies of the batch's first sample)."""
        if self.world == 1:
            return batch_idx, 0
        n = len(batch_idx)
        total = -(-n // self.world) * self.world
        position = np.arange(total)
        chunks = self.micro if total % (self.micro * self.world) == 0 else 1
        mine = position.reshape(chunks, self.world, -1)[:, self.rank].reshape(-1)
        return np.where(mine < n, batch_idx[np.minimum(mine, n - 1)], batch_idx[0]), int(
            (mine >= n).sum())


def _padded(samples: List[Dict[str, np.ndarray]], pads: int) -> List[Dict[str, np.ndarray]]:
    """The last ``pads`` samples with every label ignored."""
    for k in range(len(samples) - pads, len(samples)):
        samples[k] = {**samples[k], "label": np.full_like(np.asarray(samples[k]["label"]),
                                                          PAD_LABEL)}
    return samples


def _collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out = {}
    for key in samples[0]:
        out[key] = np.stack([np.asarray(s[key]) for s in samples])
    return out
