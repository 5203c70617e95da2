"""Fork worker processes over the shared-memory ring (the port of
``paddle_tpu/io/mp_loader.py``): the ``DataLoader``'s path for
``num_workers > 0``.

Workers are ``fork`` processes, so CPU-bound decode and augmentation run on
real cores.  Batches travel through one anonymous ``MAP_SHARED`` mapping
that the native process-shared ring (``native/ringbuf.cc`` ``shmrb_*``)
manages, created before the fork so every process addresses the same
pages.  The parent copies each slot out (into pinned memory where the batch
goes to a card), releases it, re-orders by batch index (so batch order is
the sampler's whatever the workers' timing) and makes the batch's tensors.

A worker never touches torch or the card: the parent may hold a CUDA
context and threads that a fork does not carry over.  It collates to numpy
(``native_loader._np_collate``) and the parent makes the tensors.  A dataset that yields
torch tensors is refused (``_ForkUnsafeDataset``), and the ``DataLoader``
takes its thread path instead.

Flow control is the ring itself: a worker blocks (in C, GIL released) on a
free slot.  Errors and batches larger than a slot travel through a side
``multiprocessing.Queue`` (an oversized batch as the path of a spool file).
"""

from __future__ import annotations

import os
import pickle
import traceback

import torch

from ..core.tensor import tensor_batches
from ..native import SharedRingBuffer, load_library
from .native_loader import (_batch_spec, _flatten_batch, _read_batch,
                            _serialized_size, _worker_collate, _write_batch)

_SENTINEL = None


class _ForkUnsafeDataset(Exception):
    """The dataset's samples hold torch tensors, which a forked worker must
    not touch."""


def _holds_tensor(sample) -> bool:
    if torch.is_tensor(sample):
        return True
    if isinstance(sample, dict):
        return any(_holds_tensor(v) for v in sample.values())
    if isinstance(sample, (list, tuple)):
        return any(_holds_tensor(v) for v in sample)
    return False


def mp_available() -> bool:
    return hasattr(os, "fork") and load_library() is not None


def _worker_main(loader, rb, task_q, side_q, wid, num_workers, seed):
    """A worker process's body: runs until the sentinel or the ring's
    close."""
    from . import WorkerInfo, _worker_tls

    _worker_tls.info = WorkerInfo(wid, num_workers, loader.dataset,
                                  seed + wid)
    collate = _worker_collate(loader)
    try:
        if loader.worker_init_fn is not None:
            loader.worker_init_fn(wid)
        while True:
            task = task_q.get()
            if task is _SENTINEL:
                return
            i, indices = task
            samples = [loader.dataset[j] for j in indices]
            batch = collate(samples)
            arrays = _flatten_batch(batch)
            spec_bytes = pickle.dumps(_batch_spec(batch))
            size = _serialized_size(arrays, spec_bytes)
            if size > rb.slot_bytes:
                # oversized: spool to a temporary file and queue its path
                # (a large pickle through the queue itself can wedge its
                # feeder thread against the pipe's buffer)
                import tempfile
                fd, path = tempfile.mkstemp(prefix="ptt_batch_",
                                            suffix=".bin")
                with os.fdopen(fd, "wb") as f:
                    pickle.dump((_batch_spec(batch), arrays), f)
                side_q.put(("big", i, path))
                continue
            slot = -1
            while slot < 0:
                if rb.is_closed():
                    return
                slot = rb.acquire_write(timeout_ms=500)
            _write_batch(rb.slot_view(slot), i, arrays, spec_bytes)
            rb.commit_write(slot, size)
    except BaseException:
        try:
            side_q.put(("err", wid, traceback.format_exc()))
        except Exception:
            pass


@tensor_batches
class _MPPrefetchIterator:
    """Order-preserving iterator over the batches that fork workers
    produce."""

    def __init__(self, loader, num_workers):
        import multiprocessing as mp
        import weakref

        self.loader = loader
        self.batches = list(iter(loader.batch_sampler))
        self.next_idx = 0
        self.pending = {}
        self.timeout = loader.timeout if loader.timeout else 120.0

        ctx = mp.get_context("fork")
        # slots sized from a sample batch probed here (before the fork);
        # a batch larger than that goes by the side queue
        slot_bytes = 1 << 16
        if self.batches:
            probe = [loader.dataset[j] for j in self.batches[0][:1]]
            if probe and _holds_tensor(probe[0]):
                raise _ForkUnsafeDataset(
                    "dataset __getitem__ returns torch tensors")
            if probe:
                arrays = _flatten_batch(_worker_collate(loader)(probe))
                per_sample = sum(a.nbytes for a in arrays)
                est = per_sample * max(len(b) for b in self.batches) + 4096
                slot_bytes = max(slot_bytes, 2 * est)
        n_slots = max(2 * num_workers, loader.prefetch_factor * num_workers,
                      4)
        self.rb = SharedRingBuffer(slot_bytes, n_slots)
        self.task_q = ctx.Queue()
        self.side_q = ctx.Queue()
        for t in enumerate(self.batches):
            self.task_q.put(t)
        for _ in range(num_workers):
            self.task_q.put(_SENTINEL)
        self.procs = [
            ctx.Process(target=_worker_main,
                        args=(loader, self.rb, self.task_q, self.side_q,
                              w, num_workers, 0),
                        daemon=True)
            for w in range(num_workers)]
        for p in self.procs:
            p.start()
        loader.worker_pids = [p.pid for p in self.procs]
        self._fin = weakref.finalize(self, _MPPrefetchIterator._shutdown,
                                     self.rb, self.procs)

    def __iter__(self):
        return self

    def _poll_side(self, block=False):
        import queue as _q
        try:
            kind, a, b = self.side_q.get(timeout=0.05 if block else 0.01)
        except (_q.Empty, OSError):
            return
        if kind == "err":
            self.close()
            raise RuntimeError(f"DataLoader worker {a} died:\n{b}")
        with open(b, "rb") as f:
            spec, arrays = pickle.load(f)
        os.unlink(b)
        self.pending[a] = (spec, arrays)

    def _take_slot(self, slot):
        used = self.rb.slot_bytes_used(slot)
        bidx, spec, arrays = _read_batch(self.rb.slot_view(slot, used))
        self.rb.release_read(slot)
        self.pending[bidx] = (spec, arrays)

    def __next__(self):
        import time

        from .native_loader import _rebuild

        if self.next_idx >= len(self.batches):
            self.close()
            raise StopIteration
        deadline = time.monotonic() + self.timeout
        while self.next_idx not in self.pending:
            self._poll_side()
            slot = self.rb.acquire_read(timeout_ms=50)
            if slot >= 0:
                self._take_slot(slot)
                continue
            if all(not p.is_alive() for p in self.procs):
                # workers gone: drain what is left in the ring and the side
                # queue
                slot = self.rb.acquire_read(timeout_ms=50)
                while slot >= 0:
                    self._take_slot(slot)
                    slot = self.rb.acquire_read(timeout_ms=50)
                for _ in range(len(self.batches) - self.next_idx):
                    before = len(self.pending)
                    self._poll_side(block=True)
                    if len(self.pending) == before:
                        break
                if self.next_idx in self.pending:
                    break
                self.close()
                raise RuntimeError(
                    "DataLoader workers exited before producing batch "
                    f"{self.next_idx}")
            if time.monotonic() > deadline:
                self.close()
                raise RuntimeError(
                    f"DataLoader timed out after {self.timeout}s waiting "
                    f"for batch {self.next_idx}")
        spec, arrays = self.pending.pop(self.next_idx)
        self.next_idx += 1
        return _rebuild(spec, arrays, pos=[0])

    @staticmethod
    def _shutdown(rb, procs):
        rb.close()
        for p in procs:
            p.join(timeout=2.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)

    def close(self):
        self._fin()
