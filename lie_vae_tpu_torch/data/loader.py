"""Host-side batch loader.

Counterpart of the JAX package's ``data/loader.py``, with its index
semantics kept bit for bit: a shuffled epoch is the permutation
``np.random.default_rng(seed + epoch)`` draws, batches are consecutive
slices of it, ``drop_last`` drops the ragged tail, and the epoch counter
advances once per pass. Batches are single contiguous numpy arrays (uint8
images), moved to the device by the caller in one copy. The port's
datasets hold their images in memory, so there is no decode to overlap and
no prefetch thread; the JAX loader's multi-host sharding belongs to the
data-parallel path (ROADMAP.md, Queue A, A9).
"""
import numpy as np


class BatchLoader:
    def __init__(self, dataset, batch_size, shuffle=True, drop_last=True,
                 seed=0):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.prep = getattr(dataset, "prep_batch", lambda b: b)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        return [order[i:i + self.batch_size]
                for i in range(0, stop, self.batch_size)]

    def __iter__(self):
        batches = self._index_batches()
        self.epoch += 1
        for idx in batches:
            yield self.prep(self.dataset.gather(idx))
