"""``paddle.io`` (the port of ``paddle_tpu/io/__init__.py``): datasets,
samplers and the ``DataLoader``.

The loader builds numpy batches on the host; the batch's tensors are made in
this process, on the device ``set_device`` chose (by default the card): a
pinned host copy, then a ``non_blocking`` copy to the card on the current
stream, so fetching a batch never waits for the card.  Samplers draw from
numpy exactly as the reference's do, so index streams are the reference's.

``DataLoader.__iter__`` picks the iterator as the reference does:

- ``num_workers == 0``: one process (``_MapIterator``, ``_IterableIterator``);
- ``num_workers > 0`` (and ``use_shared_memory``, the default): fork worker
  processes that move batches through the native process-shared ring
  (``io/mp_loader.py`` over ``native/ringbuf.cc``);
- with ``FLAGS_use_native_dataloader``: worker threads over the native
  in-process ring (``io/native_loader.py``);
- worker threads (``_PrefetchIterator``) where the fork path is refused: a
  dataset that yields torch tensors, a refused ``fork`` (``OSError``) or a
  ring library that could not be built.

:data:`ITERATORS` counts which iterator served each iteration over a
``DataLoader``, so a caller can tell that a fallback was taken.
"""

from __future__ import annotations

import itertools
import math
import threading
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..core.tensor import tensor_batches

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split",
    "Sampler", "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "BatchSampler", "DistributedBatchSampler", "DataLoader",
    "get_worker_info", "default_collate_fn", "prefetch_to_device",
]

# iterations over a DataLoader, by the iterator that served them
ITERATORS: Dict[str, int] = dict.fromkeys(
    ("map", "iterable", "threads", "native", "fork_ring"), 0)


def _to_device(x) -> torch.Tensor:
    """A numpy array (or CPU tensor) as a tensor on the current device: on
    the CPU sharing its memory, on a card through a pinned host copy and a
    ``non_blocking`` copy (the pinned block is held until that copy ends)."""
    from ..device import current
    dev = current()
    t = x if torch.is_tensor(x) else \
        torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cpu" or t.device.type != "cpu":
        return t.to(dev, non_blocking=True)
    if not t.is_pinned():
        t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return t.to(dev, non_blocking=True)


def prefetch_to_device(iterable, size=2, sharding=None):
    """Yield the batches of ``iterable`` (tensors, numpy arrays, or nested
    lists / tuples / dicts of them) with their copies to the current device
    issued ``size`` batches ahead, so each copy runs beside the previous
    step's work."""
    import collections

    if sharding is not None:
        raise NotImplementedError(
            "prefetch_to_device(sharding=...) places a batch over a device "
            "mesh: that needs the port's distributed package (ROADMAP item "
            "18), not yet ported")

    def put(batch):
        if isinstance(batch, dict):
            return {k: put(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(put(v) for v in batch)
        if torch.is_tensor(batch):
            return _to_device(batch.detach())
        if isinstance(batch, (np.ndarray, np.generic)):
            return _to_device(np.asarray(batch))
        return batch

    def gen():
        queue = collections.deque()
        for batch in iterable:
            queue.append(put(batch))
            if len(queue) >= size:
                yield queue.popleft()
        while queue:
            yield queue.popleft()

    return gen()


class Dataset:
    """Map-style dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __getitem__")

    def __len__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __len__")


class IterableDataset(Dataset):
    """Iterable-style dataset."""

    def __iter__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __iter__")

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        lens = {len(t) for t in tensors}
        if len(lens) != 1:
            raise ValueError("all tensors must have the same first dimension")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        lens = {len(d) for d in datasets}
        if len(lens) != 1:
            raise ValueError("all datasets must have the same length")
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out: List[Any] = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        return itertools.chain(*self.datasets)


class ConcatDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        self.cumulative_sizes = list(itertools.accumulate(
            len(d) for d in self.datasets))

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        import bisect
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence, generator=None):
    total = len(dataset)
    lengths = list(lengths)
    if all(isinstance(n, float) and 0.0 <= n <= 1.0 for n in lengths):
        fracs = lengths
        lengths = [int(math.floor(total * f)) for f in fracs]
        for i in range(total - sum(lengths)):
            lengths[i % len(lengths)] += 1
    if sum(lengths) != total:
        raise ValueError("sum of input lengths does not equal dataset length")
    rng = np.random.default_rng(None if generator is None else generator)
    perm = rng.permutation(total)
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation (or draws with replacement) from
    ``np.random.default_rng(generator)``, as the reference draws."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None \
            else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = np.random.default_rng(self.generator)
        if self.replacement:
            return iter(rng.integers(0, n, size=self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype="float64")
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.default_rng().choice(
            len(self.weights), size=self.num_samples,
            replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = int(batch_size)
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards sample indices across data-parallel ranks.  ``num_replicas``
    and ``rank`` default to ``torch.distributed``'s world size and rank
    where a process group is up, else 1 and 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        dist = torch.distributed
        up = dist.is_available() and dist.is_initialized()
        if num_replicas is None:
            num_replicas = dist.get_world_size() if up else 1
        if rank is None:
            rank = dist.get_rank() if up else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        # repeat-pad to a multiple of the ranks (the dataset may be smaller
        # than nranks, so one slice-extend is not enough)
        while len(indices) < self.total_size:
            indices += indices[: self.total_size - len(indices)]
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_worker_tls = threading.local()


def get_worker_info():
    return getattr(_worker_tls, "info", None)


def default_collate_fn(batch: List[Any]):
    """Stack samples into batched tensors on the current device."""
    sample = batch[0]
    if torch.is_tensor(sample):
        from ..device import current
        return torch.stack([s.detach() for s in batch]).to(current())
    if isinstance(sample, np.ndarray):
        return _to_device(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return _to_device(np.asarray(batch, dtype="int64"))
    if isinstance(sample, (float, np.floating)):
        return _to_device(np.asarray(batch, dtype="float32"))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    raise TypeError(
        f"batch data can not be a batch of {type(sample).__name__}")


@tensor_batches
class _MapIterator:
    """Single-process map-style iterator."""

    def __init__(self, loader):
        self.loader = loader
        self.batch_iter = iter(loader.batch_sampler)

    def __iter__(self):
        return self

    def __next__(self):
        indices = next(self.batch_iter)
        samples = [self.loader.dataset[i] for i in indices]
        return self.loader.collate_fn(samples)


@tensor_batches
class _IterableIterator:
    def __init__(self, loader):
        self.loader = loader
        self.it = iter(loader.dataset)

    def __iter__(self):
        return self

    def __next__(self):
        samples = []
        for _ in range(self.loader.batch_size or 1):
            try:
                samples.append(next(self.it))
            except StopIteration:
                break
        if not samples:
            raise StopIteration
        if self.loader.batch_size is None:
            return samples[0]
        if len(samples) < (self.loader.batch_size or 1) and \
                self.loader.drop_last:
            raise StopIteration
        return self.loader.collate_fn(samples)


@tensor_batches
class _PrefetchIterator:
    """Worker threads pull index batches and push collated batches into a
    bounded re-order buffer, preserving batch order."""

    def __init__(self, loader, num_workers):
        self.loader = loader
        self.batches = list(iter(loader.batch_sampler))
        self.out: dict = {}
        self.next_idx = 0
        self.shutdown = False
        self.cv = threading.Condition()
        self.task_iter = iter(enumerate(self.batches))
        self.task_lock = threading.Lock()
        self.max_ready = max(2 * num_workers,
                             loader.prefetch_factor * num_workers)
        self.workers = [
            threading.Thread(target=self._work, args=(w, num_workers),
                             daemon=True)
            for w in range(num_workers)]
        self.errors: List[BaseException] = []
        for w in self.workers:
            w.start()

    def _work(self, wid, num_workers):
        _worker_tls.info = WorkerInfo(wid, num_workers, self.loader.dataset,
                                      wid)
        if self.loader.worker_init_fn is not None:
            self.loader.worker_init_fn(wid)
        while not self.shutdown:
            with self.task_lock:
                task = next(self.task_iter, None)
            if task is None:
                return
            i, indices = task
            try:
                samples = [self.loader.dataset[j] for j in indices]
                batch = self.loader.collate_fn(samples)
            except BaseException as e:  # raised in the consumer
                with self.cv:
                    self.errors.append(e)
                    self.cv.notify_all()
                return
            with self.cv:
                while i > self.next_idx + self.max_ready and \
                        not self.shutdown:
                    self.cv.wait(timeout=1.0)
                if self.shutdown:
                    return
                self.out[i] = batch
                self.cv.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
        if self.next_idx >= len(self.batches):
            raise StopIteration
        with self.cv:
            while self.next_idx not in self.out:
                if self.errors:
                    raise self.errors[0]
                self.cv.wait(timeout=1.0)
            batch = self.out.pop(self.next_idx)
            self.next_idx += 1
            self.cv.notify_all()
        return batch

    def close(self):
        with self.cv:
            self.shutdown = True
            self.cv.notify_all()

    def __del__(self):
        self.close()


class DataLoader:
    """The reference's ``DataLoader`` (``places``, ``return_list``,
    ``use_buffer_reader`` and ``persistent_workers`` are accepted and
    ignored, as there)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.use_shared_memory = use_shared_memory
        self.prefetch_factor = prefetch_factor
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.batch_size = batch_size
        self.drop_last = drop_last
        # the pids of the worker processes of the latest fork-ring
        # iteration, and why the latest iteration did not fork (or None)
        self.worker_pids: List[int] = []
        self.fork_refused = None
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            if batch_sampler is not None:
                raise ValueError(
                    "batch_sampler is not supported for IterableDataset")
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        else:
            if batch_size is None:
                raise ValueError(
                    "batch_size may only be None for IterableDataset")
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("DataLoader over IterableDataset has no len()")
        return len(self.batch_sampler)

    def _iterator(self):
        """(the path's name, the iterator), chosen as the reference
        chooses."""
        if self._iterable:
            return "iterable", _IterableIterator(self)
        if self.num_workers == 0:
            return "map", _MapIterator(self)
        from .. import flags
        if flags.flag("use_native_dataloader"):
            from .native_loader import (_NativePrefetchIterator,
                                        native_available)
            if native_available():
                return "native", _NativePrefetchIterator(self,
                                                         self.num_workers)
        if self.use_shared_memory:
            from ..native import BUILD_ERROR
            from .mp_loader import (_ForkUnsafeDataset, _MPPrefetchIterator,
                                    mp_available)
            self.fork_refused = None
            if mp_available():
                try:
                    return "fork_ring", _MPPrefetchIterator(
                        self, self.num_workers)
                except (_ForkUnsafeDataset, OSError) as e:
                    # a dataset of tensors, or fork refused: threads
                    self.fork_refused = repr(e)
            else:
                self.fork_refused = f"no fork or no ring library: " \
                    f"{BUILD_ERROR[0]}"
        return "threads", _PrefetchIterator(self, self.num_workers)

    def __iter__(self):
        path, it = self._iterator()
        ITERATORS[path] += 1
        return it

    def __call__(self):
        return self.__iter__()
