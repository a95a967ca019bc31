"""Host batching with a background prefetch (counterpart of
eyoc_tpu/data/loader.py:42-109).

Items are padded raw clouds (voxelization runs on the device), collated by
`synthetic.collate_items` into a RawBatch of CPU tensors; one producer
thread keeps up to `prefetch` batches ready. When its consumer is gone
(an iteration left early, as the validation does after `val_max_iter`
pairs) the producer stops after the item in flight, and the consumer's
exit waits for it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from eyoc_tpu_torch.data.synthetic import collate_items
from eyoc_tpu_torch.training.pipeline import RawBatch


class DataLoader:
    """shuffle + drop_last batching with a 2-deep background prefetcher."""

    def __init__(self, dataset, batch_size: int, point_capacity: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.point_capacity = point_capacity
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[RawBatch]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        nb = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for i in range(nb):
                    if stop.is_set():
                        return
                    idx = order[i * self.batch_size: (i + 1) * self.batch_size]
                    items = [self.dataset[int(j)] for j in idx]
                    if not put(collate_items(items, self.point_capacity)):
                        return
            except Exception as e:  # surface worker errors to the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # at most one producer a loader touches the dataset (its
            # RandomState, its scene cache): wait out the item in flight
            stop.set()
            t.join()


def make_data_loader(config, phase: str, batch_size: int, shuffle=None,
                     device=None):
    """The reference's factory (lib/data_loaders.py:1809-1847): the
    config's dataset, augmented in train phases only. `device`: where a
    reader's ICP ground truth runs (None: the card)."""
    from eyoc_tpu_torch.data.datasets import dataset_str_mapping

    if shuffle is None:
        shuffle = phase != "test"
    Dataset = dataset_str_mapping[config.dataset]
    use_rot = config.use_random_rotation if phase in ("train", "trainval") else False
    use_scale = config.use_random_scale if phase in ("train", "trainval") else False
    dset = Dataset(phase, config, random_rotation=use_rot, random_scale=use_scale)
    dset.device = device
    return DataLoader(
        dset, batch_size, point_capacity=config.raw_point_capacity,
        shuffle=shuffle, seed=config.get("seed", 0),
    )
