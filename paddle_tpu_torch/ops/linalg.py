"""Linear algebra (the port of ``paddle_tpu/ops/linalg.py``).  The
decompositions are torch's (``torch.linalg``), equal to the reference's up
to the sign or phase freedom of their factors.  ``histogram`` with no
range reads the range from the card (one marked sync)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import boundary_module
from ._generated import _float
from ._prim import autocast_module, t_


def _sync(t):
    if t.device.type != "cpu":
        from ..observability import count_sync
        count_sync()


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = t_(x), t_(y)
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(x, y, name=None):
    return matmul(x, y)


def dot(x, y, name=None):
    return torch.sum(t_(x) * t_(y), dim=-1)


def inner(x, y, name=None):
    return torch.inner(t_(x), t_(y))


def outer(x, y, name=None):
    return torch.outer(t_(x).reshape(-1), t_(y).reshape(-1))


def bmm(x, y, name=None):
    return matmul(x, y)


def mv(x, vec, name=None):
    return matmul(x, vec)


def t(x, name=None):
    x = t_(x)
    return x if x.ndim < 2 else x.transpose(0, 1)


def cross(x, y, axis=9, name=None):
    x, y = t_(x), t_(y)
    ax = axis if axis != 9 else next(
        (i for i, s in enumerate(x.shape) if s == 3), 0)
    return torch.linalg.cross(x, y, dim=ax)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """The reference's rule: no axis (or a pair) and no ``p`` is the
    Frobenius norm; one axis and no ``p`` is the 2-norm; ``p`` may be
    "fro", "nuc", inf, -inf, 0, 1 or any float."""
    x = _float(t_(x))
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
    if p is None:
        p = "fro" if axis is None or isinstance(axis, tuple) else 2
    if axis is None:
        flat = x.reshape(-1)
        if p in ("fro", 2):
            out = torch.sqrt(torch.sum(flat * flat))
            return out.reshape([1] * x.ndim) if keepdim else out
        if p == np.inf:
            return flat.abs().max()
        if p == -np.inf:
            return flat.abs().min()
        if p == 1:
            return flat.abs().sum()
        if p == 0:
            return (flat != 0).to(x.dtype).sum()
        return flat.abs().pow(p).sum().pow(1.0 / p)
    if p == "fro":
        return torch.sqrt(torch.sum(x * x, dim=axis, keepdim=keepdim))
    if p == "nuc":
        return torch.linalg.svdvals(x).sum(-1, keepdim=keepdim)
    if isinstance(axis, tuple):
        return torch.linalg.matrix_norm(x, ord=p, dim=axis, keepdim=keepdim)
    return torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=keepdim)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return torch.linalg.vector_norm(_float(t_(x)), ord=p, dim=ax,
                                    keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return torch.linalg.matrix_norm(_float(t_(x)), ord=p, dim=(-2, -1),
                                    keepdim=keepdim)


def dist(x, y, p=2, name=None):
    return norm(t_(x) - t_(y), p=p)


def transpose(x, perm, name=None):
    return t_(x).permute([int(v) for v in perm])


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    x = _float(t_(input))
    if min == 0 and max == 0:
        lo, hi = torch.aminmax(x)
        _sync(x)
        lo, hi = float(lo), float(hi)
    else:
        lo, hi = float(min), float(max)
    return torch.histc(x, bins=bins, min=lo, max=hi).to(torch.int64)


def histogramdd(sample, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """torch's ``histogramdd`` runs on the CPU: a card's sample is read
    back (one marked sync) and the result moved to its device."""
    s = t_(sample)
    dev = s.device
    _sync(s)
    w = None if weights is None else t_(weights).cpu()
    rng = None if ranges is None else [float(v) for v in np.ravel(ranges)]
    h, edges = torch.histogramdd(s.cpu(), bins=bins, range=rng,
                                 density=density, weight=w)
    if w is None and not density:
        h = h.to(torch.int64)      # counts, as the reference's
    return h.to(dev), [e.to(dev) for e in edges]


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(t_(x), int(n))


def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(t_(x), mode=mode)
    return r if mode == "r" else (q, r)


def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(t_(x), full_matrices=full_matrices))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    a = t_(x)
    if center:
        a = a - a.mean(dim=-2, keepdim=True)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    k = q or min(a.shape[-2:])
    return u[..., :k], s[..., :k], vh.transpose(-1, -2)[..., :k]


def eig(x, name=None):
    return tuple(torch.linalg.eig(t_(x)))


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(t_(x), UPLO=UPLO))


def eigvals(x, name=None):
    return torch.linalg.eigvals(t_(x))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(t_(x), UPLO=UPLO)


def det(x, name=None):
    return torch.linalg.det(t_(x))


def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(t_(x))
    return torch.stack([sign, logdet])


def inv(x, name=None):
    return torch.linalg.inv(t_(x))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(t_(x), rtol=rcond, hermitian=hermitian)


def solve(x, y, name=None):
    return torch.linalg.solve(t_(x), t_(y))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a, b = t_(x), t_(y)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper, left=True,
                                         unitriangular=unitriangular)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(t_(x), upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    return torch.cholesky_solve(t_(x), t_(y), upper=upper)


def lu(x, pivot=True, get_infos=False, name=None):
    """The packed factors and LAPACK's 1-based int32 pivots (and a zero
    info when ``get_infos``)."""
    lu_, piv, info = torch.linalg.lu_factor_ex(t_(x))
    if get_infos:
        return lu_, piv.to(torch.int32), info.to(torch.int32)
    return lu_, piv.to(torch.int32)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(t_(x), rtol=tol, hermitian=hermitian)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values) by the SVD, as numpy's
    ``lstsq`` defines them (residuals only for a full-rank tall ``x``)."""
    a, b = t_(x), t_(y)
    m, n = a.shape[-2:]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    cut = s > rcond * s.max()
    s_inv = torch.where(cut, 1.0 / torch.where(cut, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    b2 = b if b.ndim == a.ndim else b.unsqueeze(-1)
    sol = vh.transpose(-1, -2) @ (s_inv.unsqueeze(-1) *
                                  (u.transpose(-1, -2) @ b2))
    rank = cut.sum(-1)
    if b.ndim != a.ndim:
        sol = sol.squeeze(-1)
    full = bool(int(rank.min()) == n) and m > n
    _sync(a)
    if full:
        res = ((b2 - a @ (sol if b.ndim == a.ndim else sol.unsqueeze(-1)))
               ** 2).sum(-2)
        res = res if b.ndim == a.ndim else res.squeeze(-1)
    else:
        res = torch.zeros((0,), dtype=a.dtype, device=a.device)
    return sol, res, rank, s


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = _float(t_(x))
    return torch.cov(x if rowvar else x.transpose(0, 1),
                     correction=1 if ddof else 0,
                     fweights=None if fweights is None else t_(fweights),
                     aweights=None if aweights is None else t_(aweights))


def corrcoef(x, rowvar=True, name=None):
    x = _float(t_(x))
    return torch.corrcoef(x if rowvar else x.transpose(0, 1))


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(t_(x), offset, axis1, axis2).sum(-1)


def einsum(equation, *operands):
    return torch.einsum(equation, *[t_(o) for o in operands])


def multi_dot(x, name=None):
    return torch.linalg.multi_dot([t_(v) for v in x])


def cond(x, p=None, name=None):
    return torch.linalg.cond(t_(x), p)


def ormqr(x, tau, other, left=True, transpose=False, name=None):
    return torch.ormqr(t_(x), t_(tau), t_(other), left=left,
                       transpose=transpose)


def householder_product(x, tau, name=None):
    return torch.linalg.householder_product(t_(x), t_(tau))


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) of packed factors ``x`` and 1-based pivots ``y``."""
    return tuple(torch.lu_unpack(t_(x), t_(y).to(torch.int32)))


__all__ = ["matmul", "mm", "dot", "inner", "outer", "bmm", "mv", "t",
           "cross", "norm", "vector_norm", "matrix_norm", "dist", "transpose",
           "histogram", "histogramdd", "matrix_power", "qr", "svd",
           "pca_lowrank", "eig", "eigh", "eigvals", "eigvalsh", "det",
           "slogdet", "inv", "pinv", "solve", "triangular_solve", "cholesky",
           "cholesky_solve", "lu", "matrix_rank", "lstsq", "cov", "corrcoef",
           "trace", "einsum", "multi_dot", "cond", "ormqr",
           "householder_product", "lu_unpack"]
autocast_module(globals())
boundary_module(globals(), __all__)
