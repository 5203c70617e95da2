"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for sm_90a into its own
shared library with a plain C interface and loaded with ``ctypes`` (the
``hopper-kernels`` route (b): seconds per source, where building against
PyTorch's headers takes minutes).  Libraries land in
``build/paddle_tpu_torch_kernels/`` beside the package (listed in
``.gitignore``), in a file named by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags, so a changed source or header
rebuilds and an unchanged one loads at once.

A *generated* build (:func:`load_generated`) compiles one source with a
header pre-included (``nvcc -include``): the primitive generators write a
caller's function into that header.  The header lands beside the library,
and both are named by a hash of the source, the header and the flags, so an
unchanged function loads at once and a changed one rebuilds.  Several
generated libraries export the same C names; each is its own ``CDLL``
(``RTLD_LOCAL``) and is built with ``-fno-gnu-unique``, so their symbols,
and the statics of their templates, never meet.

Nothing here runs at import time: :func:`load` builds on first use, and
:func:`build_all` starts one ``nvcc`` per source (and per generated header
it is given), all at once.

These builds and loads are the port's compiles: each nvcc run and each
library load counts once in ``jit.backend_compiles`` (with its duration in
``jit.backend_compile_ms``), so ``observability.assert_overhead`` and the
sentinel see a kernel built after warm-up.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from .. import observability as _obs

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch_kernels"
# -fno-gnu-unique: a static inside a template or inline function (a
# kernel's one-time attribute setting) stays the library's own; with GCC's
# default STB_GNU_UNIQUE binding the dynamic linker would share it between
# the generated libraries of one source, loaded RTLD_LOCAL or not, and the
# second library's kernel would never get its attribute set
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC,-fno-gnu-unique", "-Xptxas",
              "-v"]

_LIBS: Dict[Tuple[str, str], ctypes.CDLL] = {}   # (name, header)
_LOCK = threading.Lock()


def sources() -> List[str]:
    """Kernel names: one per ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str, header: str = "") -> Path:
    """The library of ``csrc/<name>.cu``, compiled alone or, given a
    ``header``, with that header pre-included.  Its name hashes the source,
    every ``csrc/*.cuh`` (a source may include any of them), the header and
    the flags, so an edit to any of them rebuilds."""
    src = (CSRC / f"{name}.cu").read_bytes()
    shared = b"".join(p.name.encode() + p.read_bytes()
                      for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + shared + header.encode() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = f"lib{name}-gen-{digest}" if header else f"lib{name}-{digest}"
    return BUILD_DIR / f"{stem}.so"


def _start(name: str, header: str = ""):
    """Start nvcc for one source into a temporary file; None if built."""
    out = _target(name, header)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS]
    if header:
        inc = out.with_suffix(".h")
        inc.write_text(header)
        cmd += ["-include", str(inc)]
    cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(generated: Sequence[Tuple[str, str]] = ()) -> Dict[str, dict]:
    """Build every source, one nvcc each, and each ``(name, header)`` of
    ``generated``, all started together.  Returns ``{key: {"seconds": s,
    "log": ptxas output, "library": path}}`` (the key of a generated build
    is its library's file name); raises on a failure."""
    with _LOCK:
        t0 = time.perf_counter()
        jobs = {n: (n, "") for n in sources()}
        jobs.update((_target(n, h).name, (n, h)) for n, h in generated)
        started = [(key, n, h, _start(n, h)) for key, (n, h) in jobs.items()]
        out = {}
        for key, n, h, st in started:
            log = _finish(n, st)
            seconds = time.perf_counter() - t0
            if st is not None:
                _obs.record_compile(seconds)
            out[key] = {"seconds": seconds, "log": log,
                        "library": str(_target(n, h))}
        return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return load_generated(name, "")


def load_generated(name: str, header: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` compiled with ``header``
    pre-included (alone for an empty header), built on first use; one
    ``CDLL`` per library.  Wrappers call this on every launch, so a loaded
    library is found without reading or hashing the source."""
    key = (name, header)
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            t0 = time.perf_counter()
            _finish(name, _start(name, header))
            lib = ctypes.CDLL(str(_target(name, header)))
            _LIBS[key] = lib
            _obs.record_compile(time.perf_counter() - t0)
        return lib
