"""``paddle.io`` and the native ring of the port against the JAX package,
on the CPU: datasets, ``random_split`` and every sampler's index stream
equal to the reference's; ``default_collate_fn``; ``DataLoader`` batches
equal to the reference's at ``num_workers`` 0 and 2 over each path (one
process, threads, the fork workers' shared-memory ring, the native ring),
with the same iterator class as the reference takes and the path counted;
the fork-worker cases of the reference's ``test_io_mp.py`` and
``test_native.py`` (order, worker processes, ``worker_init_fn`` /
``get_worker_info``, an error with its traceback, oversized batches, a
tensor dataset on threads, the ring's FIFO, threads and ``gather_rows``).
No case here times anything."""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import io as jio
from paddle_tpu.io import mp_loader as jmp
from paddle_tpu.io import native_loader as jnl
import paddle_tpu_torch as T
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import native as tnative
from paddle_tpu_torch.io import mp_loader as tmp
from paddle_tpu_torch.io import native_loader as tnl

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(not tmp.mp_available(),
                                reason="fork or the ring library unavailable")


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    T.set_device("cpu")
    try:
        yield
    finally:
        tdevice._current[0] = old


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if hasattr(x, "_data"):
        return np.asarray(x._data)
    return x


def _tree(b):
    if isinstance(b, dict):
        return {k: _tree(v) for k, v in b.items()}
    if isinstance(b, (list, tuple)):
        return [_tree(v) for v in b]
    return _np(b)


def _assert_tree_equal(got, want):
    got, want = _tree(got), _tree(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _both(name):
    return getattr(jio, name), getattr(tio, name)


class _Rows:
    """A dataset of both packages' base class: sample i is (float32 [3],
    int64 label, a dict of a float and an int)."""

    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return (r.standard_normal(3).astype(np.float32), np.int64(i % 4),
                {"w": float(i) / 7, "k": i})


def _ds(pkg, cls=_Rows, **kw):
    base = jio.Dataset if pkg == "ref" else tio.Dataset
    return type(f"{cls.__name__}_{pkg}", (cls, base), {})(**kw)


# ------------------------------------------------------------ datasets ---

def test_datasets_and_random_split():
    for jcls, tcls in (_both("TensorDataset"),):
        a = np.arange(12).reshape(6, 2)
        b = np.arange(6) * 10
        jd, td = jcls([a, b]), tcls([a, b])
        assert len(jd) == len(td) == 6
        for i in range(6):
            _assert_tree_equal(list(td[i]), list(jd[i]))
    jc = jio.ComposeDataset([_ds("ref", n=5), _ds("ref", n=5)])
    tc = tio.ComposeDataset([_ds("port", n=5), _ds("port", n=5)])
    for i in range(5):
        _assert_tree_equal(list(tc[i]), list(jc[i]))
    jcat = jio.ConcatDataset([_ds("ref", n=3), _ds("ref", n=4)])
    tcat = tio.ConcatDataset([_ds("port", n=3), _ds("port", n=4)])
    assert len(jcat) == len(tcat) == 7
    for i in list(range(7)) + [-1, -7]:
        _assert_tree_equal(list(tcat[i]), list(jcat[i]))
    for lengths in ([10, 13], [0.5, 0.3, 0.2]):
        js = jio.random_split(_ds("ref"), lengths, generator=5)
        ts = tio.random_split(_ds("port"), lengths, generator=5)
        assert [s.indices for s in ts] == [s.indices for s in js]
    with pytest.raises(ValueError):
        tio.random_split(_ds("port"), [3, 4])

    class Gen:
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(range(self.n))
    jch = jio.ChainDataset([type("G", (Gen, jio.IterableDataset), {})(3),
                            type("G", (Gen, jio.IterableDataset), {})(2)])
    tch = tio.ChainDataset([type("G", (Gen, tio.IterableDataset), {})(3),
                            type("G", (Gen, tio.IterableDataset), {})(2)])
    # (no list(): len() of an iterable dataset raises, in both packages)
    assert [x for x in tch] == [x for x in jch] == [0, 1, 2, 0, 1]


# ------------------------------------------------------------ samplers ---

SAMPLERS = {
    "sequence": lambda io, d: io.SequenceSampler(d),
    "random": lambda io, d: io.RandomSampler(d, generator=7),
    "random_num_samples": lambda io, d: io.RandomSampler(
        d, num_samples=9, generator=8),
    "random_replacement": lambda io, d: io.RandomSampler(
        d, replacement=True, num_samples=30, generator=9),
    "batch": lambda io, d: io.BatchSampler(d, batch_size=4),
    "batch_drop_last": lambda io, d: io.BatchSampler(
        d, batch_size=4, drop_last=True),
    "batch_over_random": lambda io, d: io.BatchSampler(
        sampler=io.RandomSampler(d, generator=3), batch_size=5),
}


@pytest.mark.parametrize("case", list(SAMPLERS))
def test_sampler_index_streams(case):
    j = SAMPLERS[case](jio, _ds("ref"))
    t = SAMPLERS[case](tio, _ds("port"))
    assert len(t) == len(j)
    assert list(t) == list(j)
    assert list(t) == list(j)          # a second epoch draws the same


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_two_ranks(shuffle, drop_last):
    for n in (23, 1):
        for rank in (0, 1):
            kw = dict(batch_size=3, num_replicas=2, rank=rank,
                      shuffle=shuffle, drop_last=drop_last)
            j = jio.DistributedBatchSampler(_ds("ref", n=n), **kw)
            t = tio.DistributedBatchSampler(_ds("port", n=n), **kw)
            assert len(t) == len(j)
            assert list(t) == list(j)
            j.set_epoch(3)
            t.set_epoch(3)
            assert list(t) == list(j)


def test_default_collate_fn():
    samples = [_ds("port")[i] for i in range(4)]
    got = tio.default_collate_fn(samples)
    want = jio.default_collate_fn(samples)
    _assert_tree_equal(got, want)
    assert got[1].dtype == torch.int64 and got[2]["w"].dtype == torch.float32
    assert tio.default_collate_fn(["a", "b"]) == ["a", "b"]
    t = [torch.full((2,), float(i)) for i in range(3)]
    assert torch.equal(tio.default_collate_fn(t), torch.stack(t))
    with pytest.raises(TypeError):
        tio.default_collate_fn([object()])


# ------------------------------------------------------------ DataLoader ---

class _TensorRows:
    """Samples that are tensors of the package (a dataset of tensors)."""

    def __init__(self, n=10, make=None):
        self.n, self.make = n, make

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.make(np.full((4,), i, dtype=np.int64))


LOADER_PATHS = {
    # path -> (the reference's iterator class, the port's, loader kwargs)
    "map": (jio._MapIterator, tio._MapIterator, dict(num_workers=0)),
    "fork_ring": (jmp._MPPrefetchIterator, tmp._MPPrefetchIterator,
                  dict(num_workers=2)),
    "threads": (jio._PrefetchIterator, tio._PrefetchIterator,
                dict(num_workers=2, use_shared_memory=False)),
    "native": (jnl._NativePrefetchIterator, tnl._NativePrefetchIterator,
               dict(num_workers=2)),
}


@pytest.mark.parametrize("path", list(LOADER_PATHS))
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches_equal_the_reference(path, shuffle):
    jcls, tcls, kw = LOADER_PATHS[path]
    native = path == "native"
    P.set_flags({"use_native_dataloader": native})
    tflags.set_flags({"use_native_dataloader": native})
    try:
        def loader(io, pkg):
            sampler = io.BatchSampler(
                sampler=io.RandomSampler(_ds(pkg), generator=4)
                if shuffle else None, dataset=_ds(pkg), batch_size=5)
            return io.DataLoader(_ds(pkg), batch_sampler=sampler, **kw)
        jit, tit = iter(loader(jio, "ref")), None
        before = dict(tio.ITERATORS)
        tit = iter(loader(tio, "port"))
        assert type(jit) is jcls and type(tit) is tcls
        assert {k: tio.ITERATORS[k] - before[k] for k in before} == \
            {k: int(k == path) for k in before}
        want, got = list(jit), list(tit)
    finally:
        P.set_flags({"use_native_dataloader": False})
        tflags.set_flags({"use_native_dataloader": False})
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _assert_tree_equal(g, w)


def test_iterable_dataset_loader():
    class Stream:
        def __iter__(self):
            return iter(np.full((2,), i, np.float32) for i in range(7))
    jd = type("S", (Stream, jio.IterableDataset), {})()
    td = type("S", (Stream, tio.IterableDataset), {})()
    for kw in (dict(batch_size=3), dict(batch_size=3, drop_last=True),
               dict(batch_size=None)):
        before = tio.ITERATORS["iterable"]
        got = list(tio.DataLoader(td, **kw))
        assert tio.ITERATORS["iterable"] == before + 1
        want = list(jio.DataLoader(jd, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    with pytest.raises(TypeError):
        len(tio.DataLoader(td, batch_size=2))


def test_tensor_dataset_goes_to_threads():
    """A dataset that yields tensors never takes the fork path (a forked
    worker must not touch torch): the port sends a torch-tensor dataset to
    threads as the reference sends its Tensor dataset."""
    jd = _TensorRows(8, make=P.to_tensor)
    td = _TensorRows(8, make=torch.from_numpy)
    jit = iter(jio.DataLoader(jd, batch_size=2, num_workers=2))
    before = tio.ITERATORS["threads"]
    loader = tio.DataLoader(td, batch_size=2, num_workers=2)
    tit = iter(loader)
    assert type(jit) is jio._PrefetchIterator
    assert type(tit) is tio._PrefetchIterator
    assert tio.ITERATORS["threads"] == before + 1
    assert "_ForkUnsafeDataset" in loader.fork_refused
    got, want = list(tit), list(jit)
    assert len(got) == 4
    for g, w in zip(got, want):
        _assert_tree_equal(g, w)


def test_prefetch_to_device():
    batches = [{"x": np.full((8, 4), i, np.float32), "i": np.int32(i),
                "t": torch.full((2,), i), "s": "keep"} for i in range(7)]
    out = list(tio.prefetch_to_device(iter(batches), size=3))
    assert len(out) == 7
    for i, b in enumerate(out):
        assert torch.is_tensor(b["x"]) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])
        assert int(b["i"]) == i and torch.equal(b["t"], batches[i]["t"])
        assert b["s"] == "keep"
    with pytest.raises(NotImplementedError, match="distributed"):
        list(tio.prefetch_to_device(iter(batches), sharding=object()))


# --------------------------------------- fork workers (test_io_mp.py) ---

class _PidRows:
    """Sample carries (idx, worker pid, worker id)."""

    def __len__(self):
        return 24

    def __getitem__(self, i):
        info = tio.get_worker_info()
        wid = -1 if info is None else info.id
        return (np.full((4,), i, dtype=np.int64),
                np.full((1,), os.getpid(), dtype=np.int64),
                np.full((1,), wid, dtype=np.int64))


PidRows = type("PidRows", (_PidRows, tio.Dataset), {})


def test_mp_order_and_values_match_single_process():
    ref = list(tio.DataLoader(PidRows(), batch_size=4, num_workers=0))
    got = list(tio.DataLoader(PidRows(), batch_size=4, num_workers=3))
    assert len(ref) == len(got) == 6
    for r, g in zip(ref, got):
        assert torch.equal(r[0], g[0])


def test_mp_worker_processes_used():
    dl = tio.DataLoader(PidRows(), batch_size=2, num_workers=3)
    it = iter(dl)
    assert isinstance(it, tmp._MPPrefetchIterator)
    assert dl.fork_refused is None
    pids, wids = set(), set()
    for batch in it:
        pids.update(int(p) for p in batch[1].numpy().ravel())
        wids.update(int(w) for w in batch[2].numpy().ravel())
    assert os.getpid() not in pids
    assert len(pids) >= 2 and pids <= set(dl.worker_pids)
    assert len(set(dl.worker_pids)) == 3
    assert wids <= {0, 1, 2} and len(wids) >= 2 and -1 not in wids


def test_mp_worker_init_fn_runs_in_the_worker():
    seen = []

    def init(wid):
        assert tio.get_worker_info().id == wid
        seen.append(wid)  # the child's copy: the parent's stays empty

    out = list(tio.DataLoader(PidRows(), batch_size=4, num_workers=2,
                              worker_init_fn=init))
    assert len(out) == 6 and seen == []


def test_mp_error_carries_its_traceback():
    class Failing(tio.Dataset):
        def __len__(self):
            return 16

        def __getitem__(self, i):
            if i == 7:
                raise ValueError("boom at 7")
            return np.full((2,), i, dtype=np.int64)

    with pytest.raises(RuntimeError, match="(?s)Traceback.*boom at 7"):
        list(tio.DataLoader(Failing(), batch_size=4, num_workers=2))


def test_mp_oversized_batches_take_the_side_queue():
    class Ragged(tio.Dataset):
        """Sample 0 (the slot-sizing probe) is tiny; later ones overflow
        the ring's slots."""

        def __len__(self):
            return 8

        def __getitem__(self, i):
            n = 4 if i == 0 else 1 << 16
            return np.full((n,), i, dtype=np.int64)

    out = list(tio.DataLoader(Ragged(), batch_size=1, num_workers=2))
    assert len(out) == 8
    for i, b in enumerate(out):
        n = 4 if i == 0 else 1 << 16
        np.testing.assert_array_equal(b.numpy(),
                                      np.full((1, n), i, dtype=np.int64))


# ----------------------------------------- the ring (test_native.py) ---

def test_ring_buffer_fifo_and_reuse():
    rb = tnative.RingBuffer(1024, 2)
    for round_ in range(3):          # slots recycle
        s = rb.acquire_write()
        rb.slot_view(s)[0] = round_ + 1
        rb.commit_write(s, 1)
        r = rb.acquire_read()
        assert rb.slot_bytes_used(r) == 1
        assert rb.slot_view(r)[0] == round_ + 1
        rb.release_read(r)
    rb.close()
    assert rb.acquire_read(timeout_ms=10) == -1   # closed and drained
    rb.destroy()


def test_ring_buffer_threads():
    import threading
    rb = tnative.RingBuffer(64, 4)
    n = 200
    seen = []

    def producer():
        for i in range(n):
            s = rb.acquire_write()
            rb.slot_view(s)[:4] = np.frombuffer(np.int32(i).tobytes(),
                                                np.uint8)
            rb.commit_write(s, 4)

    t = threading.Thread(target=producer)
    t.start()
    for _ in range(n):
        s = rb.acquire_read()
        seen.append(int(np.frombuffer(rb.slot_view(s, 4).tobytes(),
                                      np.int32)[0]))
        rb.release_read(s)
    t.join()
    assert seen == list(range(n))
    rb.destroy()


def test_gather_rows():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((64, 17)).astype(np.float32)
    idx = rng.integers(0, 64, 20)
    dst = np.empty((20, 17), np.float32)
    tnative.gather_rows(dst, src, idx)
    np.testing.assert_array_equal(dst, src[idx])


def test_native_loader_keeps_order():
    class DS(tio.Dataset):
        def __len__(self):
            return 37

        def __getitem__(self, i):
            return (np.full((4, 4), i, np.float32), np.int64(i))

    tflags.set_flags({"use_native_dataloader": True})
    try:
        before = tio.ITERATORS["native"]
        ys = []
        for x, y in tio.DataLoader(DS(), batch_size=5, num_workers=3):
            assert x.shape[1:] == (4, 4)
            ys.extend(y.tolist())
        assert ys == list(range(37))
        assert tio.ITERATORS["native"] == before + 1
    finally:
        tflags.set_flags({"use_native_dataloader": False})


def test_native_loader_oversized_batches_bypass_the_ring():
    """A batch larger than the ring's slots (sized from the first batch
    written: one worker writes batch 0 first) passes beside the ring, in
    order, with its values."""
    class Ragged(tio.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            n = 4 if i == 0 else 1 << 16
            return {"x": np.full((n,), i, dtype=np.int64), "y": np.int64(i)}

    tflags.set_flags({"use_native_dataloader": True})
    try:
        before = tio.ITERATORS["native"]
        out = list(tio.DataLoader(Ragged(), batch_size=1, num_workers=1))
        assert tio.ITERATORS["native"] == before + 1
    finally:
        tflags.set_flags({"use_native_dataloader": False})
    assert len(out) == 6
    for i, b in enumerate(out):
        n = 4 if i == 0 else 1 << 16
        assert sorted(b) == ["x", "y"]
        np.testing.assert_array_equal(b["x"].numpy(),
                                      np.full((1, n), i, dtype=np.int64))
        assert b["y"].tolist() == [i]
