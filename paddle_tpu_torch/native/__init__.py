"""Native (C++) host components, loaded with ctypes (the port of
``paddle_tpu/native/__init__.py``): the data pipeline's ring buffers and
row gather.

``ringbuf.cc`` is the reference's source, byte for byte.  It is host C++,
not a kernel: ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` builds it at
first use into ``build/paddle_tpu_torch_kernels/`` beside the package (the
kernels' build directory, listed in ``.gitignore``), with a stamp of the
hash of the source and the command beside the library so an edit to
either rebuilds.  The source calls ``::malloc`` / ``::free`` without
including ``<cstdlib>``, which GCC 13's headers no longer pull in
transitively, so the command pre-includes it (``-include cstdlib``).  The build
and the load count as one compile each in ``observability`` (as a kernel's
do).  :func:`load_library` returns None where no toolchain can build it; the
loaders then take their thread path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

from .. import observability as _obs
from ..kernels._build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB = [None, False]  # lib handle, attempted
# why the library is unavailable (the build's or the load's error), or None
BUILD_ERROR = [None]


GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-include", "cstdlib"]


def _compile(src: str, out: str) -> bool:
    """g++ into a file of this process, then renamed into place (several
    processes may build at once)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
    except subprocess.CalledProcessError as e:
        BUILD_ERROR[0] = f"g++ exit {e.returncode}: {e.stderr[-2000:]}"
        return False
    except (subprocess.SubprocessError, OSError) as e:
        BUILD_ERROR[0] = repr(e)
        return False
    os.replace(tmp, out)
    return True


def library_path() -> str:
    return os.path.join(BUILD_DIR, "libpaddle_tpu_torch_native.so")


def load_library():
    """The native library, or None when no toolchain can build it."""
    with _LOCK:
        if _LIB[1]:
            return _LIB[0]
        _LIB[1] = True
        src = os.path.join(_DIR, "ringbuf.cc")
        out = library_path()
        with open(src, "rb") as f:
            src_hash = hashlib.sha256(
                f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()
        stamp = out + ".srchash"
        stale = True
        if os.path.exists(out) and os.path.exists(stamp):
            with open(stamp) as f:
                stale = f.read().strip() != src_hash
        t0 = time.perf_counter()
        if stale:
            if not _compile(src, out):
                return None
            with open(stamp, "w") as f:
                f.write(src_hash)
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            BUILD_ERROR[0] = repr(e)
            return None
        _obs.record_compile(time.perf_counter() - t0)
        _bind(lib)
        _LIB[0] = lib
        return lib


def _bind(lib):
    c = ctypes
    sigs = {
        "rb_create": (c.c_void_p, [c.c_size_t, c.c_int]),
        "rb_acquire_write": (c.c_int, [c.c_void_p, c.c_int]),
        "rb_commit_write": (None, [c.c_void_p, c.c_int, c.c_size_t]),
        "rb_acquire_read": (c.c_int, [c.c_void_p, c.c_int]),
        "rb_release_read": (None, [c.c_void_p, c.c_int]),
        "rb_slot_ptr": (c.c_void_p, [c.c_void_p, c.c_int]),
        "rb_slot_bytes": (c.c_size_t, [c.c_void_p, c.c_int]),
        "rb_slot_capacity": (c.c_size_t, [c.c_void_p]),
        "rb_ready_count": (c.c_int, [c.c_void_p]),
        "rb_close": (None, [c.c_void_p]),
        "rb_destroy": (None, [c.c_void_p]),
        "rb_gather_rows": (None, [c.c_char_p, c.c_char_p,
                                  c.POINTER(c.c_int64), c.c_int,
                                  c.c_size_t]),
        # the process-shared ring (the fork-worker DataLoader's transport)
        "shmrb_required_bytes": (c.c_size_t, [c.c_size_t, c.c_uint32]),
        "shmrb_init": (c.c_int, [c.c_void_p, c.c_size_t, c.c_uint32]),
        "shmrb_acquire_write": (c.c_int, [c.c_void_p, c.c_int]),
        "shmrb_commit_write": (None, [c.c_void_p, c.c_int, c.c_size_t]),
        "shmrb_acquire_read": (c.c_int, [c.c_void_p, c.c_int]),
        "shmrb_release_read": (None, [c.c_void_p, c.c_int]),
        "shmrb_slot_used": (c.c_size_t, [c.c_void_p, c.c_int]),
        "shmrb_slot_capacity": (c.c_size_t, [c.c_void_p]),
        "shmrb_slot_ptr": (c.c_void_p, [c.c_void_p, c.c_int]),
        "shmrb_close": (None, [c.c_void_p]),
        "shmrb_is_closed": (c.c_int, [c.c_void_p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def _view(ptr, n):
    import numpy as np
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), (n,))


class RingBuffer:
    """MPMC slot ring over the native library (see ``ringbuf.cc``)."""

    def __init__(self, slot_bytes: int, n_slots: int):
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.rb_create(slot_bytes, n_slots)
        if not self._h:
            raise MemoryError("ring buffer allocation failed")
        self.slot_bytes = slot_bytes
        self.n_slots = n_slots

    def acquire_write(self, timeout_ms: int = -1) -> int:
        return self._lib.rb_acquire_write(self._h, timeout_ms)

    def commit_write(self, slot: int, nbytes: int):
        self._lib.rb_commit_write(self._h, slot, nbytes)

    def acquire_read(self, timeout_ms: int = -1) -> int:
        return self._lib.rb_acquire_read(self._h, timeout_ms)

    def release_read(self, slot: int):
        self._lib.rb_release_read(self._h, slot)

    def slot_view(self, slot: int, nbytes: int = None):
        n = self.slot_bytes if nbytes is None else nbytes
        return _view(self._lib.rb_slot_ptr(self._h, slot), n)

    def slot_bytes_used(self, slot: int) -> int:
        return self._lib.rb_slot_bytes(self._h, slot)

    def ready_count(self) -> int:
        return self._lib.rb_ready_count(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.rb_close(self._h)

    def destroy(self):
        if getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self.destroy()


class SharedRingBuffer:
    """Process-shared slot ring inside an anonymous ``MAP_SHARED`` mapping.

    Create it in the parent before forking workers: children inherit the
    mapping (the same pages at the same address), so a slot crosses the
    process boundary with no copy beyond writing and reading it.  See
    ``shmrb_*`` in ``ringbuf.cc``.  The mapping lives until the last
    process holding it lets it go (there is no destroy).
    """

    def __init__(self, slot_bytes: int, n_slots: int):
        import mmap

        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        total = self._lib.shmrb_required_bytes(slot_bytes, n_slots)
        self._mm = mmap.mmap(-1, total)  # MAP_SHARED | MAP_ANONYMOUS
        self._buf = ctypes.c_char.from_buffer(self._mm)
        self._base = ctypes.addressof(self._buf)
        if self._lib.shmrb_init(self._base, slot_bytes, n_slots) != 0:
            raise RuntimeError("shmrb_init failed")
        self.slot_bytes = slot_bytes
        self.n_slots = n_slots

    def acquire_write(self, timeout_ms: int = -1) -> int:
        return self._lib.shmrb_acquire_write(self._base, timeout_ms)

    def commit_write(self, slot: int, nbytes: int):
        self._lib.shmrb_commit_write(self._base, slot, nbytes)

    def acquire_read(self, timeout_ms: int = -1) -> int:
        return self._lib.shmrb_acquire_read(self._base, timeout_ms)

    def release_read(self, slot: int):
        self._lib.shmrb_release_read(self._base, slot)

    def slot_view(self, slot: int, nbytes: int = None):
        n = self.slot_bytes if nbytes is None else nbytes
        return _view(self._lib.shmrb_slot_ptr(self._base, slot), n)

    def slot_bytes_used(self, slot: int) -> int:
        return self._lib.shmrb_slot_used(self._base, slot)

    def close(self):
        if getattr(self, "_base", None):
            self._lib.shmrb_close(self._base)

    def is_closed(self) -> bool:
        return bool(self._lib.shmrb_is_closed(self._base))


def gather_rows(dst, src, idx):
    """C++ row gather: ``dst[i] = src[idx[i]]`` (C-contiguous arrays)."""
    import numpy as np
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if not (dst.flags["C_CONTIGUOUS"] and src.flags["C_CONTIGUOUS"]):
        raise ValueError("gather_rows needs C-contiguous arrays")
    idx64 = np.ascontiguousarray(idx, dtype=np.int64)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:]))
    lib.rb_gather_rows(
        dst.ctypes.data_as(ctypes.c_char_p),
        src.ctypes.data_as(ctypes.c_char_p),
        idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(idx64), row_bytes)
    return dst
