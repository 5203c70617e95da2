"""The native-ring DataLoader path (the port of
``paddle_tpu/io/native_loader.py``), behind ``FLAGS_use_native_dataloader``.

Worker threads collate batches to numpy and serialize them into fixed-size
slots of the C++ ring buffer (``native/ringbuf.cc``); the consumer copies
each slot out (into pinned memory where the batch goes to a card), releases
it, re-orders by batch index and makes the batch's tensors.  ctypes calls
release the GIL, so slot waits and copies overlap Python work.
"""

from __future__ import annotations

import pickle
import struct
import threading
from typing import List

import numpy as np
import torch

from ..core.tensor import tensor_batches
from ..native import RingBuffer, load_library

# dtype codes of the slot format; code 3 is the reference's bfloat16, which
# numpy cannot hold without ml_dtypes (a batch here never has it)
_DTYPES = [np.dtype(x) if x != "bfloat16" else None for x in
           ("float32", "float64", "float16", "bfloat16", "int8", "int16",
            "int32", "int64", "uint8", "bool")]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES) if dt is not None}
_OVERFLOW = 0xFFFFFFFF


def native_available() -> bool:
    return load_library() is not None


def _np_collate(batch):
    """``default_collate_fn`` in numpy: what a worker collates to.  The
    batch's tensors are made by the consumer (``_rebuild``), so a worker
    never touches torch or the card (a forked worker must not)."""
    sample = batch[0]
    if torch.is_tensor(sample):
        return np.stack([s.detach().cpu().numpy() for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype="int64")
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype="float32")
    if isinstance(sample, dict):
        return {k: _np_collate([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [_np_collate(list(items)) for items in zip(*batch)]
    raise TypeError(
        f"the worker DataLoader cannot collate a batch of "
        f"{type(sample).__name__}")


def _worker_collate(loader):
    from . import default_collate_fn
    return _np_collate if loader.collate_fn is default_collate_fn \
        else loader.collate_fn


def _flatten_batch(batch) -> List[np.ndarray]:
    if isinstance(batch, (list, tuple)):
        out = []
        for b in batch:
            out.extend(_flatten_batch(b))
        return out
    if isinstance(batch, dict):
        out = []
        for k in sorted(batch):
            out.extend(_flatten_batch(batch[k]))
        return out
    if torch.is_tensor(batch):
        return [batch.detach().cpu().numpy()]
    return [np.asarray(batch)]


def _batch_spec(batch):
    """Container skeleton used to rebuild the batch from flat arrays."""
    if isinstance(batch, (list, tuple)):
        return ("L" if isinstance(batch, list) else "U",
                [_batch_spec(b) for b in batch])
    if isinstance(batch, dict):
        return ("D", [(k, _batch_spec(batch[k])) for k in sorted(batch)])
    return ("T", None)


def _rebuild(spec, arrays, pos):
    """The batch's containers around its tensors, on the current device."""
    from . import _to_device
    kind, payload = spec
    if kind == "T":
        arr = arrays[pos[0]]
        pos[0] += 1
        return _to_device(arr)
    if kind == "D":
        return {k: _rebuild(s, arrays, pos) for k, s in payload}
    vals = [_rebuild(s, arrays, pos) for s in payload]
    return vals if kind == "L" else tuple(vals)


def _copy_out(raw: np.ndarray, dtype: np.dtype, shape):
    """One copy of a field's bytes out of its slot (released next): a
    pinned tensor where the batch goes to a card, else a numpy array."""
    from ..device import current
    src = raw.view(dtype).reshape(shape)
    if current().type == "cpu":
        return src.copy()
    t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                    pin_memory=True)
    np.copyto(t.numpy(), src)
    return t


def _serialized_size(arrays: List[np.ndarray], spec_bytes: bytes) -> int:
    n = 16 + len(spec_bytes)  # idx + n_fields + spec_len
    for a in arrays:
        n += 2 + 8 * a.ndim + 8 + a.nbytes
    return n


def _write_batch(view: np.ndarray, batch_idx: int, arrays: List[np.ndarray],
                 spec_bytes: bytes) -> int:
    """A batch into a ring slot, the one slot format of both ring paths:
    its index, its field count, its pickled container spec, then each
    field's dtype code, shape and bytes.  Returns the bytes used."""
    off = 0

    def put(b: bytes):
        nonlocal off
        view[off:off + len(b)] = np.frombuffer(b, np.uint8)
        off += len(b)

    put(struct.pack("<qII", batch_idx, len(arrays), len(spec_bytes)))
    put(spec_bytes)
    for a in arrays:
        a = np.ascontiguousarray(a)
        code = _DTYPE_CODE.get(a.dtype)
        if code is None:
            raise TypeError(f"unsupported dtype {a.dtype} for a ring slot")
        put(struct.pack("<BB", code, a.ndim))
        for d in a.shape:
            put(struct.pack("<q", d))
        put(struct.pack("<q", a.nbytes))
        view[off:off + a.nbytes] = a.view(np.uint8).reshape(-1)
        off += a.nbytes
    return off


def _read_batch(view: np.ndarray):
    """(batch index, spec, arrays), each array copied out of the slot."""
    off = 0

    def take(fmt):
        nonlocal off
        n = struct.calcsize(fmt)
        vals = struct.unpack(fmt, view[off:off + n].tobytes())
        off += n
        return vals

    batch_idx, n_fields, spec_len = take("<qII")
    spec = pickle.loads(view[off:off + spec_len].tobytes())
    off += spec_len
    arrays = []
    for _ in range(n_fields):
        code, ndim = take("<BB")
        shape = tuple(take("<q")[0] for _ in range(ndim))
        (nbytes,) = take("<q")
        arrays.append(_copy_out(view[off:off + nbytes], _DTYPES[code],
                                shape))
        off += nbytes
    return batch_idx, spec, arrays


@tensor_batches
class _NativePrefetchIterator:
    """The user-facing handle.  Worker threads hold the separate
    ``_NativeImpl``; ``weakref.finalize`` on this object closes it when the
    user abandons the iterator mid-epoch, so threads and the ring are
    reclaimed."""

    def __init__(self, loader, num_workers):
        import weakref
        self._impl = _NativeImpl(loader, num_workers)
        self._fin = weakref.finalize(self, _NativeImpl.close, self._impl)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._impl)

    def close(self):
        self._fin()


def _work_entry(impl, wid, num_workers):
    while impl._work_quantum(wid, num_workers):
        pass


class _NativeImpl:
    """Order-preserving MPMC prefetch over the native ring buffer.

    Backpressure: workers do not start batch i until ``i < next_idx +
    inflight_window``, so the re-order buffer holds at most that many
    batches even behind one slow straggler.
    """

    def __init__(self, loader, num_workers):
        from . import WorkerInfo, _worker_tls

        self.loader = loader
        self.collate = _worker_collate(loader)
        self.batches = list(iter(loader.batch_sampler))
        self.next_idx = 0
        self.pending = {}        # out-of-order batches awaiting their turn
        self.overflow = {}       # batches too big for a slot
        self.errors: List[BaseException] = []
        self.shutdown = False
        self.rb = None
        self._rb_lock = threading.Lock()
        self.n_slots = max(2 * num_workers, 4)
        self.inflight_window = max(4 * num_workers, 2 * self.n_slots)
        self.task_iter = iter(enumerate(self.batches))
        self.task_lock = threading.Lock()
        self._worker_tls = _worker_tls
        self._WorkerInfo = WorkerInfo
        self._inited = [False] * num_workers
        self._cur = [None] * num_workers
        self.workers = [
            threading.Thread(target=_work_entry, args=(self, w, num_workers),
                             daemon=True)
            for w in range(num_workers)]
        for w in self.workers:
            w.start()

    def _ensure_rb(self, nbytes: int):
        with self._rb_lock:
            if self.rb is None:
                slot = max(2 * nbytes + 4096, 1 << 16)
                self.rb = RingBuffer(slot, self.n_slots)
            return self.rb

    def _work_quantum(self, wid, num_workers) -> bool:
        """Advance this worker by one bounded step (<= ~200 ms); False when
        it should exit.  What must survive between quanta (the current task
        and its arrays) lives in ``self._cur[wid]``."""
        import time

        if not self._inited[wid]:
            self._inited[wid] = True
            self._worker_tls.info = self._WorkerInfo(
                wid, num_workers, self.loader.dataset, wid)
            if self.loader.worker_init_fn is not None:
                self.loader.worker_init_fn(wid)
        if self.shutdown:
            return False
        state = self._cur[wid]
        try:
            if state is None:
                with self.task_lock:
                    task = next(self.task_iter, None)
                if task is None:
                    return False
                self._cur[wid] = state = {"task": task, "arrays": None,
                                          "spec": None}
            i, indices = state["task"]
            if state["arrays"] is None:
                deadline = time.time() + 0.2
                while i >= self.next_idx + self.inflight_window:
                    if self.shutdown:
                        return False
                    if time.time() > deadline:
                        return True  # retry next quantum
                    time.sleep(0.002)
                samples = [self.loader.dataset[j] for j in indices]
                batch = self.collate(samples)
                state["arrays"] = _flatten_batch(batch)
                state["spec"] = pickle.dumps(_batch_spec(batch))
            arrays, spec_bytes = state["arrays"], state["spec"]
            size = _serialized_size(arrays, spec_bytes)
            rb = self._ensure_rb(size)
            slot = rb.acquire_write(timeout_ms=200)
            if slot < 0:
                return not self.shutdown  # retry next quantum
            if size > rb.slot_bytes:
                # too big for a slot: the slot carries only the header
                self.overflow[i] = (pickle.loads(spec_bytes), arrays)
                used = 16
                rb.slot_view(slot)[0:used] = np.frombuffer(
                    struct.pack("<qII", i, _OVERFLOW, 0), np.uint8)
            else:
                used = _write_batch(rb.slot_view(slot), i, arrays,
                                    spec_bytes)
            rb.commit_write(slot, used)
            self._cur[wid] = None
            return True
        except BaseException as e:
            self.errors.append(e)
            if self.rb is not None:
                self.rb.close()
            return False

    def __iter__(self):
        return self

    def __next__(self):
        import time
        if self.next_idx >= len(self.batches):
            self.close()
            raise StopIteration
        while self.next_idx not in self.pending:
            if self.errors:
                raise self.errors[0]
            rb = self.rb
            if rb is None:
                time.sleep(0.001)
                continue
            slot = rb.acquire_read(timeout_ms=200)
            if slot < 0:
                continue
            used = rb.slot_bytes_used(slot)
            view = rb.slot_view(slot, used)
            bidx, nf = struct.unpack("<qI", view[0:12].tobytes())
            if nf == _OVERFLOW:
                self.pending[bidx] = self.overflow.pop(bidx)
            else:
                bidx, spec, arrays = _read_batch(view)
                self.pending[bidx] = (spec, arrays)
            rb.release_read(slot)
        spec, arrays = self.pending.pop(self.next_idx)
        self.next_idx += 1
        return _rebuild(spec, arrays, pos=[0])

    def close(self):
        self.shutdown = True
        if getattr(self, "rb", None) is not None:
            self.rb.close()

    def __del__(self):
        self.close()
