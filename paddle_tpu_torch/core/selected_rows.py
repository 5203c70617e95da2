"""Row-sparse gradients (the port of ``paddle_tpu/core/selected_rows.py``,
the reference's ``SelectedRows``).

``Embedding(sparse=True)`` gives its weight a gradient that holds only the
rows its ids touched.  In the port ``p.grad`` stays torch's own sparse COO
tensor (torch accumulates it across backwards: sparse plus sparse
concatenates, sparse plus dense is dense, as the reference's rules say);
the Paddle API reads it as a :class:`SelectedRowsTensor`, coalesced: rows
unique and sorted, duplicates summed.

**Coalescing reads nothing on the host.**  The ids are sorted, segment
heads marked where an id differs from the one before it, a cumsum gives
each id its segment, and the values are summed by ``index_add_`` into a
buffer of the ids' count ``n``.  The first ``count`` rows of the buffer are
the unique rows; ``count`` stays a 0-d tensor on the device.  The tail
repeats the first row with zero values, so a sum over the buffer (a norm,
``to_dense``, an ``index_add_``) is the coalesced one, and
:meth:`SelectedRowsTensor._update_rows` gives each tail entry entry 0's row
and values, so an update that writes rows (``index_copy_``) writes the
same bits twice.  Only the public ``rows`` / ``values`` trim the buffer to
``count``: one marked sync on the card.
"""

from __future__ import annotations

import torch

from .tensor import _DISABLE, wrap


def coalesce(rows, values, drop=None, num_rows=None):
    """``(rows, values, count)``: ``rows`` ``[n]`` and ``values`` ``[n,
    ...]`` with duplicates summed into the first ``count`` entries (rows
    sorted), the tail as the module says.  Entries whose row is ``drop``
    (the padding index) are left out; ``num_rows`` (the dense first dim)
    must be given with ``drop``."""
    row_shape = tuple(values.shape[rows.dim():])
    rows = rows.reshape(-1).long()
    n = rows.numel()
    values = values.reshape((n,) + row_shape)
    dev = rows.device
    if n == 0:
        return rows, values, torch.zeros((), dtype=torch.long, device=dev)
    key = rows
    if drop is not None:
        key = torch.where(rows == drop, num_rows, rows)
    s, perm = torch.sort(key, stable=True)
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = s[1:] != s[:-1]
    seg = torch.cumsum(head, 0) - 1
    live = head if drop is None else head & (s != num_rows)
    count = live.sum()
    summed = torch.zeros_like(values).index_add_(
        0, seg, values.index_select(0, perm))
    uniq = torch.zeros(n, dtype=torch.long, device=dev).scatter_(0, seg, s)
    tail = torch.arange(n, device=dev) >= count
    first = torch.where(count > 0, uniq[0], 0)
    uniq = torch.where(tail, first, uniq)
    summed = torch.where(tail.reshape((n,) + (1,) * (summed.dim() - 1)),
                         0, summed)
    return uniq, summed, count


class SelectedRowsTensor:
    """A gradient of dense shape ``shape`` whose only nonzero rows are
    ``rows``, holding ``values`` (the reference's ``SelectedRowsTensor``
    surface: ``rows``, ``values``, ``shape``, ``dtype``,
    ``is_selected_rows()``, ``to_dense()``)."""

    __slots__ = ("_rows", "_values", "_count", "_dense_shape")

    def __init__(self, rows, values, dense_shape, count=None):
        self._rows = rows
        self._values = values
        self._count = torch.tensor(rows.numel(), device=rows.device) \
            if count is None else count
        self._dense_shape = tuple(dense_shape)

    # -- the reference's surface ---------------------------------------
    def _trimmed(self, t):
        if t.device.type != "cpu":
            from ..observability import count_sync
            count_sync()
        return wrap(t[:int(self._count)])

    @property
    def rows(self):
        """The unique rows, sorted (one marked sync on the card)."""
        return self._trimmed(self._rows)

    @property
    def values(self):
        """The rows' summed values (one marked sync on the card)."""
        return self._trimmed(self._values)

    def is_selected_rows(self) -> bool:
        return True

    @property
    def shape(self):
        return list(self._dense_shape)

    @property
    def dtype(self):
        return self._values.dtype

    def to_dense(self):
        with _DISABLE():
            return wrap(self._dense())

    def _dense(self):
        return torch.zeros(self._dense_shape, dtype=self._values.dtype,
                           device=self._values.device).index_add_(
            0, self._rows, self._values)

    def _with_values(self, values):
        return SelectedRowsTensor(self._rows, values, self._dense_shape,
                                  self._count)

    def _update_rows(self):
        """``(rows, values, live)`` with every tail entry a copy of entry 0
        (rows and values), for updates that write rows; ``live`` (0-d bool)
        is false when no row is held."""
        n = self._rows.numel()
        idx = torch.arange(n, device=self._rows.device)
        idx = torch.where(idx < self._count, idx, 0)
        return (self._rows.index_select(0, idx),
                self._values.index_select(0, idx), self._count > 0)

    def __repr__(self):
        return (f"SelectedRowsTensor(shape={list(self._dense_shape)}, "
                f"rows<={self._rows.numel()}, dtype={self.dtype})")


def make_sparse_grad(ids, cot, dense_shape, padding_idx=None):
    """The coalesced gradient of ``embedding(ids, w)`` for cotangent
    ``cot`` (``[..., d]``); ids equal to ``padding_idx`` are left out (a
    negative one matches no id, as in the reference)."""
    d = cot.shape[-1]
    rows, values, count = coalesce(ids.reshape(-1), cot.reshape(-1, d),
                                   padding_idx, dense_shape[0])
    return SelectedRowsTensor(rows, values, dense_shape, count)


def add_sparse(a, b):
    """``a + b`` of two row-sparse gradients, coalesced."""
    rows, values, count = coalesce(torch.cat([a._rows, b._rows]),
                                   torch.cat([a._values, b._values]))
    return SelectedRowsTensor(rows, values, a._dense_shape, count)


def from_torch(g):
    """torch's sparse COO gradient ``g`` as a coalesced
    :class:`SelectedRowsTensor` (no host read)."""
    with _DISABLE():
        rows, values, count = coalesce(g._indices()[0], g._values())
    return SelectedRowsTensor(rows, values, tuple(g.shape), count)


def to_torch(sr):
    """A :class:`SelectedRowsTensor` as torch's sparse COO tensor (the
    buffer as it is: not marked coalesced)."""
    return torch.sparse_coo_tensor(sr._rows[None], sr._values,
                                   sr._dense_shape, check_invariants=False)


def grad_of(p):
    """``p``'s gradient for the optimizer: a row-sparse one as a
    :class:`SelectedRowsTensor`, a dense one as the float32 value
    ``amp.float32_grad`` keeps for it (or ``.grad``)."""
    with _DISABLE():
        g = torch.Tensor.grad.__get__(p)
    if g is not None and g.layout is torch.sparse_coo:
        return from_torch(g)
    from ..amp import float32_grad
    return float32_grad(p)


class _SparseEmbedding(torch.autograd.Function):
    """``embedding(ids, weight)`` whose weight gradient is torch's sparse
    COO tensor over the coalesced rows (``padding_idx`` left out)."""

    @staticmethod
    def forward(ctx, ids, weight, padding_idx):
        ctx.save_for_backward(ids)
        ctx.shape = tuple(weight.shape)
        ctx.padding_idx = padding_idx
        return torch.nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, cot):
        (ids,) = ctx.saved_tensors
        sr = make_sparse_grad(ids, cot, ctx.shape, ctx.padding_idx)
        return None, to_torch(sr), None


def sparse_embedding(ids, weight, padding_idx=None):
    return _SparseEmbedding.apply(ids, weight, padding_idx)
