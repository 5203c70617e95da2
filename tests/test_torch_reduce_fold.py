"""The reduce fold's staged walk (``csrc/primitives.cu`` ``reduce_kernel``) on
the CPU.

The CUDA kernel cannot run here; what surrounds it can.  This file holds

- the route rule ``_reduce_route``: "vec16" (16-byte ``cp.async`` copies)
  where a row is a whole number of 16-byte chunks and the data pointer is
  16-byte aligned, else "scalar" (element by element), on contiguous,
  offset and row-sliced inputs of each dtype;
- a test-side emulation of the kernel's walk: a warp owns 32 rows (the last
  block ragged), stages tiles of [32 rows, 128 bytes] into a swizzled
  shared-memory tile (chunk c of row r at c ^ (r % 8)) by either route's
  copy mapping, chunks and elements past the rows or columns zero, and each
  lane folds its row from the tile, 16 bytes at a time for a whole tile,
  element by element for the first tile (acc = x[:, 0]) and a ragged last
  one.  The bytes are moved as the kernel moves them, so a lane that reads
  another row's chunk, or a column twice, shows.

The emulation is held bit for bit against the port's plain
``_reduce_reference`` and the JAX package's ``reduce_kernel`` in interpret
mode (the reference's left fold: each step in fp32, rounded to x's dtype),
with the ``max`` / ``min`` functors that propagate NaN and with NaNs in
some rows.

The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``
kernel_primitives.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import primitives as jp
from paddle_tpu_torch.kernels import primitives as tp

torch.set_num_threads(2)

ROWS, TILE_BYTES = 32, 128          # a warp's rows; bytes of a row per tile
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
FNS = {  # the CUDA bodies propagate NaN as torch.maximum / minimum do
    "max": (tp.KernelFn(torch.maximum, "float m = fmaxf(a, b); "
                        "m = b != b ? b : m; return a != a ? a : m;"),
            jnp.maximum),
    "min": (tp.KernelFn(torch.minimum, "float m = fminf(a, b); "
                        "m = b != b ? b : m; return a != a ? a : m;"),
            jnp.minimum),
    "add": (tp.KernelFn(torch.add, "return a + b;"), jnp.add),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_reduce_route(dtype):
    td = DTYPES[dtype][0]
    item = torch.empty((), dtype=td).element_size()
    per16 = 16 // item                      # elements in 16 bytes
    buf = torch.zeros((64 * 32 + 8,), dtype=td)
    x = buf[:64 * 4 * per16].view(64, 4 * per16)
    assert x.data_ptr() % 16 == 0
    assert tp._reduce_route(x) == "vec16"
    # a row slice keeps whole 16-byte rows: still aligned
    assert tp._reduce_route(x[3:10]) == "vec16"
    # one element into the buffer: the same shape off the alignment
    off = buf[1:1 + 64 * 4 * per16].view(64, 4 * per16)
    assert tp._reduce_route(off) == "scalar"
    # rows that are not a whole number of chunks
    assert tp._reduce_route(buf[:64 * 19].view(64, 19)) == "scalar"
    assert tp._reduce_route(buf[:1 * per16].view(1, per16)) == "vec16"
    # a row slice of rows that are not 16-byte multiples lands off the
    # alignment even when the first row was on it
    odd = buf[:8 * (per16 + 1)].view(8, per16 + 1)
    assert tp._reduce_route(odd[1:]) == "scalar"


def _chunk_at(r, c):
    return r * TILE_BYTES + ((c ^ (r & 7)) << 4)


def _stage(raw, r0, nr, c0, cols, item, vec):
    """One tile as the kernel stages it: ``raw`` [rows, cols * item] bytes
    of x; returns the 4 KB tile."""
    tile = np.zeros(ROWS * TILE_BYTES, dtype=np.uint8)
    per, per_tile = 16 // item, TILE_BYTES // item
    if vec:
        for i in range(ROWS * TILE_BYTES // 16 // 32):
            for lane in range(32):
                r, c = (lane >> 3) + 4 * i, lane & 7
                col = c0 + c * per
                if r < nr and col < cols:       # else zero-filled
                    b = col * item
                    tile[_chunk_at(r, c):_chunk_at(r, c) + 16] = \
                        raw[r0 + r, b:b + 16]
    else:
        for r in range(ROWS):
            for j in range(per_tile):
                col = c0 + j
                if r < nr and col < cols:
                    at = _chunk_at(r, j // per) + (j % per) * item
                    tile[at:at + item] = raw[r0 + r, col * item:
                                             (col + 1) * item]
    return tile


def _visit(tile, lane, first, cn, item, td):
    """The elements lane ``lane`` folds from a tile, in the order it folds
    them: 16 bytes a chunk for a whole tile, element by element otherwise
    (from column 1 on the first tile)."""
    per, per_tile = 16 // item, TILE_BYTES // item
    if not first and cn == per_tile:
        data = b"".join(tile[_chunk_at(lane, c):_chunk_at(lane, c) + 16]
                        .tobytes() for c in range(TILE_BYTES // 16))
    else:
        data = b"".join(tile[_chunk_at(lane, j // per) + (j % per) * item:
                             _chunk_at(lane, j // per) + (j % per) * item +
                             item].tobytes() for j in range(cn))
    return torch.frombuffer(bytearray(data), dtype=td)


def reduce_emulation(fn, x):
    """What the reduce kernel computes, block by block and tile by tile, on
    the route ``_reduce_route(x)`` names."""
    rows, cols = x.shape
    td, item = x.dtype, x.element_size()
    vec = tp._reduce_route(x) == "vec16"
    raw = x.contiguous().view(torch.uint8).numpy().reshape(rows, -1)
    per_tile = TILE_BYTES // item
    out = torch.empty((rows,), dtype=td)
    for r0 in range(0, rows, ROWS):
        nr = min(ROWS, rows - r0)
        seq = [[] for _ in range(ROWS)]          # each lane's visited values
        for t in range(-(-cols // per_tile)):
            c0 = t * per_tile
            tile = _stage(raw, r0, nr, c0, cols, item, vec)
            cn = min(per_tile, cols - c0)
            for lane in range(ROWS):
                seq[lane].append(_visit(tile, lane, t == 0, cn, item, td))
        visited = torch.stack([torch.cat(s) for s in seq]).float()
        acc = visited[:, 0]
        for i in range(1, cols):                 # the fold, lanes together
            acc = fn.torch(acc, visited[:, i])
            if td != torch.float32:
                acc = acc.to(td).float()
        out[r0:r0 + nr] = acc[:nr].to(td)
    return out


def _bits(t):
    iv = torch.int32 if t.dtype == torch.float32 else torch.int16
    return t.view(iv)


def _case(dtype, rows, cols, offset, nans, seed):
    td = DTYPES[dtype][0]
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.standard_normal(
        rows * cols + offset).astype(np.float32)).to(td)
    x = buf[offset:].view(rows, cols)
    if nans and rows > 9:
        x[3, cols // 2] = float("nan")
        x[5, 0] = float("nan")
        x[7, cols - 1] = float("nan")
        x[9] = float("nan")
    return x


@pytest.mark.parametrize("op", list(FNS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,cols,offset", [
    (45, 64, 0),       # bf16 one whole tile (fp32 two); a ragged block
    (33, 200, 0),      # a ragged last tile on either route
    (40, 19, 0),       # rows off 16 bytes: scalar
    (70, 96, 1),       # an offset view: scalar
])
def test_staged_walk_matches_plain_fold(op, dtype, rows, cols, offset):
    fn = FNS[op][0]
    x = _case(dtype, rows, cols, offset, op != "add", rows + cols)
    got = reduce_emulation(fn, x)
    want = tp._reduce_reference(fn, x)
    assert torch.equal(_bits(got), _bits(want))
    if op != "add":
        assert bool(torch.isnan(got[9]))


@pytest.mark.parametrize("op,dtype,rows,cols,offset", [
    ("max", "bfloat16", 45, 130, 0),
    ("add", "float32", 33, 72, 0),
    ("min", "float16", 40, 50, 1),
    ("add", "bfloat16", 70, 19, 0),
])
def test_staged_walk_matches_the_reference_kernel(op, dtype, rows, cols,
                                                  offset):
    """Against the JAX ``reduce_kernel`` in interpret mode (finite data:
    NaN bits are each framework's own)."""
    fn, jfn = FNS[op]
    x = _case(dtype, rows, cols, offset, False, cols)
    got = reduce_emulation(fn, x)
    jx = jnp.asarray(x.float().numpy()).astype(DTYPES[dtype][1])
    want = jp.reduce_kernel(jfn, 0.0, block_rows=64, interpret=True)(jx)
    want = np.asarray(want)
    assert np.array_equal(_bits(got).numpy(),
                          want.view(np.dtype(f"i{want.dtype.itemsize}")))
