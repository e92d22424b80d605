"""Data loader (copy of ``openpifpaf_tpu/datasets/loader.py``).

A plain Python iterator with optional multiprocessing workers, so that
a seeded run loads the same batches in the same order as the JAX
package; batches are numpy arrays that the trainer moves to the device.
"""

import logging

import numpy as np

LOG = logging.getLogger(__name__)


def _as_list(items):
    return items


class Loader:
    """Batching loader over an indexable dataset.

    shard_id/num_shards give each of several processes its slice (the
    ranks of data-parallel training, ``parallel.shard_loader``).
    """

    def __init__(self, dataset, *, batch_size=1, shuffle=False,
                 collate_fn=None, drop_last=False, num_workers=0,
                 seed=0, shard_id=0, num_shards=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn or _as_list
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.epoch = 0
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(indices)
        if self.num_shards > 1:
            # equal shards (drop remainder) so every host steps in sync
            per_shard = n // self.num_shards
            indices = indices[self.shard_id * per_shard:
                              (self.shard_id + 1) * per_shard]
        return indices

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        indices = self._indices()
        if self.num_workers > 0:
            yield from self._iter_workers(indices)
            return
        batch = []
        for i in indices:
            batch.append(self.dataset[int(i)])
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _iter_workers(self, indices):
        import multiprocessing as mp
        # spawn, not the JAX package's fork: this process holds threads
        # (and a CUDA context), which a forked child must not inherit
        ctx = mp.get_context('spawn')
        with ctx.Pool(self.num_workers) as pool:
            batches = [
                [int(i) for i in indices[s:s + self.batch_size]]
                for s in range(0, len(indices), self.batch_size)
            ]
            if self.drop_last and batches and len(batches[-1]) < self.batch_size:
                batches.pop()
            for items in pool.imap(self._load_items, batches, chunksize=1):
                yield self.collate_fn(items)

    def _load_items(self, index_batch):
        return [self.dataset[i] for i in index_batch]
