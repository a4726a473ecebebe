"""Host-side batch loader with threaded prefetch.

Counterpart of the JAX package's ``data/loader.py``, with its index
semantics kept bit for bit: a shuffled epoch is the permutation
``np.random.default_rng(seed + epoch)`` draws, batches are consecutive
slices of it, ``drop_last`` drops the ragged tail, and the epoch counter
advances once per pass. Batches are single contiguous numpy arrays (uint8
images), moved to the device by the caller in one copy.

With ``num_threads`` > 0 (default: the dataset's ``num_workers``, 5 for
the image datasets, 0 for the toy set) the batches are gathered by a
thread pool with a bounded lookahead of ``prefetch + num_threads``
batches, so image decoding (zlib and the PNG unfilter release the GIL)
overlaps the device's work; they are yielded in the serial order.

``num_shards``/``shard_index`` shard the data over processes as the JAX
loader does: ``batch_size`` is the global batch, every process draws the
same seeded permutation, only full global batches are kept (the ragged
tail is dropped), and each process keeps its contiguous slice of each.
"""
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue

import numpy as np


class BatchLoader:
    def __init__(self, dataset, batch_size, shuffle=True, drop_last=True,
                 seed=0, num_threads=None, prefetch=4, num_shards=1,
                 shard_index=0):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if batch_size % num_shards:
            raise ValueError(f"the global batch of {batch_size} does not "
                             f"divide evenly across {num_shards} shards")
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} is outside "
                             f"0..{num_shards - 1}")
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        if num_threads is None:
            num_threads = getattr(dataset, "num_workers", 0)
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.prep = getattr(dataset, "prep_batch", lambda b: b)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last or self.num_shards > 1:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        drop_last = self.drop_last or self.num_shards > 1
        stop = (n // self.batch_size) * self.batch_size if drop_last else n
        batches = [order[i:i + self.batch_size]
                   for i in range(0, stop, self.batch_size)]
        if self.num_shards > 1:
            per = self.batch_size // self.num_shards
            batches = [b[self.shard_index * per:(self.shard_index + 1) * per]
                       for b in batches]
        return batches

    def __iter__(self):
        batches = self._index_batches()
        self.epoch += 1
        gather = self.dataset.gather

        if self.num_threads <= 0:
            for idx in batches:
                yield self.prep(gather(idx))
            return

        # bounded-lookahead threaded prefetch: a semaphore caps the number
        # of batches in flight (pool.map would gather the whole epoch
        # at once whatever the queue's bound)
        q = Queue()
        sentinel = object()
        window = threading.Semaphore(self.prefetch + self.num_threads)
        stop = threading.Event()

        def produce():
            with ThreadPoolExecutor(self.num_threads) as pool:
                for idx in batches:
                    if stop.is_set():
                        break
                    window.acquire()
                    q.put(pool.submit(gather, idx))
            q.put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                out = item.result()
                window.release()
                yield self.prep(out)
        finally:
            stop.set()
            # unblock the producer if the consumer stopped early
            window.release()
            t.join()
