"""Row-sparse gradients (``Embedding(sparse=True)``) in the port against
the JAX package, on the CPU (``set_device("cpu")``).

- The probe: ``Embedding(12, 4, sparse=True)`` with the same weights, the
  loss ``(emb(ids) ** 2).sum()``, step 1 on ids ``[[1, 2, 3]]``, step 2 on
  ``[[5, 6, 2]]``, lr 0.1, under lazy Adam, lazy AdamW, SGD with weight
  decay and exact Adam: the gradient is row-sparse with the reference's
  rows and values, and the weights after each step are within PROBE_TOL of
  the reference's; lazy Adam leaves the rows touched only in step 1 where
  step 1 put them, and SGD decays no untouched row.
- Coalescing (duplicates summed, rows sorted, ``padding_idx`` left out)
  equals the reference's ``make_sparse_grad``; accumulation across two
  backwards, sparse + sparse and sparse + dense, as the reference's.
- The clips: ``ClipGradByGlobalNorm`` keeps the rows, ``ClipGradByNorm``
  and ``ClipGradByValue`` densify; the sparse branch is taken only where
  the reference takes it (no regularizer, no master weights), and every
  other optimizer densifies; each case's weights against the reference's.
"""

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.selected_rows import make_sparse_grad as j_make_sparse
from paddle_tpu.core.tensor import Tensor as JT
import paddle_tpu_torch as T
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import selected_rows as tsr

torch.set_num_threads(2)

PROBE_TOL = 1e-6


@contextlib.contextmanager
def _cpu():
    old = tdevice._current[0]
    T.set_device("cpu")
    try:
        yield
    finally:
        tdevice._current[0] = old


@pytest.fixture(autouse=True)
def on_cpu():
    with _cpu():
        yield


def _np(t):
    return np.array(t._data if hasattr(t, "_data") else
                    t.detach().numpy(), np.float32)


def _pair(vocab=12, dim=4, padding_idx=None, seed=0):
    """A reference and a port ``Embedding(sparse=True)`` with the same
    weights."""
    P.seed(seed)
    je = jnn.Embedding(vocab, dim, padding_idx=padding_idx, sparse=True)
    te = tnn.Embedding(vocab, dim, padding_idx=padding_idx, sparse=True)
    te.set_state_dict({k: np.asarray(v._data)
                       for k, v in je.state_dict().items()})
    return je, te


PROBE = {
    "adam_lazy": lambda o, ps: o.Adam(0.1, parameters=ps, lazy_mode=True),
    "adamw_lazy": lambda o, ps: o.AdamW(0.1, parameters=ps, lazy_mode=True,
                                        weight_decay=0.01),
    "sgd_wd": lambda o, ps: o.SGD(0.1, parameters=ps, weight_decay=0.1),
    "adam_exact": lambda o, ps: o.Adam(0.1, parameters=ps, lazy_mode=False),
}
PROBE_IDS = ([[1, 2, 3]], [[5, 6, 2]])


def _probe_step(emb, opt, ids, pkg):
    x = P.to_tensor(np.asarray(ids, np.int64)) if pkg == "ref" else \
        T.to_tensor(np.asarray(ids, np.int64))
    (emb(x) ** 2).sum().backward()
    g = emb.weight.grad
    opt.step()
    opt.clear_grad()
    return g


@pytest.mark.parametrize("case", list(PROBE))
def test_probe_matches_the_reference(case):
    je, te = _pair()
    jo, to = PROBE[case](jopt, je.parameters()), \
        PROBE[case](topt, te.parameters())
    w0 = _np(te.weight)
    after = []
    for ids in PROBE_IDS:
        jg = _probe_step(je, jo, ids, "ref")
        tg = _probe_step(te, to, ids, "port")
        assert tg.is_selected_rows()
        np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg._rows))
        np.testing.assert_allclose(tg.values.numpy(), np.asarray(jg._values),
                                   rtol=0, atol=PROBE_TOL)
        np.testing.assert_allclose(_np(te.weight), _np(je.weight), rtol=0,
                                   atol=PROBE_TOL)
        after.append(_np(te.weight))
    untouched = [r for r in range(12) if r not in (1, 2, 3, 5, 6)]
    np.testing.assert_array_equal(after[1][untouched], w0[untouched])
    if case in ("adam_lazy", "adamw_lazy"):
        # rows 1 and 3 were touched only in step 1: lazy mode keeps them
        np.testing.assert_array_equal(after[1][[1, 3]], after[0][[1, 3]])
    if case == "adam_exact":
        # exact mode: step 1's moments move rows 1 and 3 again
        assert not np.array_equal(after[1][[1, 3]], after[0][[1, 3]])


@pytest.mark.parametrize("ids,padding_idx", [
    ([[3, 1, 3, 7], [1, 1, 0, 9]], None),
    ([[3, 1, 3, 7], [1, 1, 0, 9]], 1),
    ([[2, 2, 2]], 2),
    ([[0, 11, 5, 11, 4, 0, 4]], -1),
])
def test_coalesced_gradient_equals_the_reference(ids, padding_idx):
    ids = np.asarray(ids, np.int64)
    rng = np.random.default_rng(7)
    cot = rng.standard_normal(ids.shape + (4,)).astype(np.float32)
    want = j_make_sparse(ids, cot, (12, 4), padding_idx)
    got = tsr.make_sparse_grad(torch.from_numpy(ids), torch.from_numpy(cot),
                               (12, 4), padding_idx)
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want._rows))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want._values),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.to_dense().numpy(), _np(want), rtol=0,
                               atol=1e-6)
    assert got.shape == [12, 4] and got.dtype == torch.float32


def test_embedding_backward_gives_the_reference_gradient():
    je, te = _pair(padding_idx=4)
    ids = np.asarray([[4, 2, 9, 2], [0, 4, 9, 9]], np.int64)
    w = np.random.default_rng(3).standard_normal((2, 4, 4)).astype(
        np.float32)
    (je(P.to_tensor(ids)) * P.to_tensor(w)).sum().backward()
    (te(T.to_tensor(ids)) * T.to_tensor(w)).sum().backward()
    jg, tg = je.weight.grad, te.weight.grad
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg._rows))
    assert 4 not in tg.rows.numpy().tolist()
    np.testing.assert_allclose(tg.values.numpy(), np.asarray(jg._values),
                               rtol=0, atol=1e-6)


def test_accumulation_across_backwards():
    je, te = _pair()
    for ids in ([[1, 5, 1]], [[5, 7]]):
        (je(P.to_tensor(np.asarray(ids))) ** 2).sum().backward()
        (te(T.to_tensor(np.asarray(ids))) ** 2).sum().backward()
    jg, tg = je.weight.grad, te.weight.grad
    assert tg.is_selected_rows()
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg._rows))
    np.testing.assert_allclose(tg.values.numpy(), np.asarray(jg._values),
                               rtol=0, atol=1e-6)
    # add_sparse of the two gradients, as the reference's
    from paddle_tpu.core.selected_rows import add_sparse as j_add
    ids = [np.asarray(i, np.int64) for i in ([[1, 5, 1]], [[5, 7]])]
    cots = [np.random.default_rng(k).standard_normal(i.shape + (4,)).astype(
        np.float32) for k, i in enumerate(ids)]
    want = j_add(*(j_make_sparse(i, c, (12, 4)) for i, c in zip(ids, cots)))
    got = tsr.add_sparse(*(tsr.make_sparse_grad(
        torch.from_numpy(i), torch.from_numpy(c), (12, 4))
        for i, c in zip(ids, cots)))
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want._rows))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want._values),
                               rtol=0, atol=1e-6)
    # a dense gradient on top: the sum is dense
    (je.weight * 2.0).sum().backward()
    (te.weight * 2.0).sum().backward()
    assert not te.weight.grad.is_selected_rows()
    np.testing.assert_allclose(_np(te.weight.grad), _np(je.weight.grad),
                               rtol=0, atol=1e-6)


def test_dense_gradient_off_the_sparse_conditions():
    """A weight that is not a leaf, or grad off: the dense op, as the
    reference's ``_sparse_embedding`` returns None there."""
    _, te = _pair()
    ids = T.to_tensor(np.asarray([[1, 2]]))
    w = te.weight * 1.0
    out = tnn.functional.embedding(ids, w, sparse=True)
    (out ** 2).sum().backward()
    assert te.weight.grad.layout == torch.strided
    with torch.no_grad():
        out = te(ids)
    assert not out.requires_grad


CLIPS = {
    "global_norm": lambda nn: nn.ClipGradByGlobalNorm(0.5),
    "norm": lambda nn: nn.ClipGradByNorm(0.5),
    "value": lambda nn: nn.ClipGradByValue(0.3, -0.2),
}


@pytest.mark.parametrize("clip", list(CLIPS))
def test_clips(clip):
    ids = np.asarray([[3, 1, 3, 8]], np.int64)
    cot = np.random.default_rng(2).standard_normal((1, 4, 4)).astype(
        np.float32)
    jg = j_make_sparse(ids, cot, (12, 4))
    tg = tsr.make_sparse_grad(torch.from_numpy(ids), torch.from_numpy(cot),
                              (12, 4))
    jp, tp = jnn.Linear(12, 4).weight, tnn.Linear(12, 4).weight
    dense = np.random.default_rng(5).standard_normal((12, 4)).astype(
        np.float32)
    (_, jw), (_, jd) = CLIPS[clip](jnn)([(jp, jg), (jp, JT(dense))])
    (_, tw), (_, td) = CLIPS[clip](tnn)([(tp, tg), (tp,
                                                     torch.tensor(dense))])
    if clip == "global_norm":
        assert isinstance(tw, tsr.SelectedRowsTensor)
        np.testing.assert_allclose(tw.values.numpy(), np.asarray(jw._values),
                                   rtol=0, atol=1e-6)
    else:
        assert torch.is_tensor(tw) and tw.layout == torch.strided
    np.testing.assert_allclose(
        tw.to_dense().numpy() if clip == "global_norm" else tw.numpy(),
        _np(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), _np(jd), rtol=0, atol=1e-6)


def _regularized(o, ps, reg):
    ps[0].regularizer = reg.L2Decay(0.05)
    return o.SGD(0.1, parameters=ps, weight_decay=0.2)


BRANCHES = {
    # a parameter's regularizer: the dense path (and it replaces wd)
    "sgd_regularizer": lambda o, ps, reg: _regularized(o, ps, reg),
    # other optimizers densify (a dense update of every row)
    "momentum": lambda o, ps, reg: o.Momentum(0.1, 0.9, parameters=ps,
                                              weight_decay=0.01),
    "rmsprop": lambda o, ps, reg: o.RMSProp(0.1, parameters=ps),
    # plain Adam's L2 decay in exact mode densifies; lazy decays touched
    "adam_exact_wd": lambda o, ps, reg: o.Adam(0.1, parameters=ps,
                                               weight_decay=0.05),
    "adam_lazy_wd": lambda o, ps, reg: o.Adam(0.1, parameters=ps,
                                              weight_decay=0.05,
                                              lazy_mode=True),
    "adamw_lr_ratio": lambda o, ps, reg: o.AdamW(
        0.1, parameters=ps, weight_decay=0.05, lazy_mode=True,
        lr_ratio=lambda p: 0.5),
    "adamw_exact_clip": lambda o, ps, reg: o.AdamW(
        0.1, parameters=ps, weight_decay=0.05,
        grad_clip=(jnn if o is jopt else tnn).ClipGradByGlobalNorm(0.3)),
}


@pytest.mark.parametrize("case", list(BRANCHES))
def test_sparse_branch_conditions(case):
    from paddle_tpu import regularizer as jreg
    from paddle_tpu_torch import regularizer as treg
    je, te = _pair()
    jo = BRANCHES[case](jopt, je.parameters(), jreg)
    to = BRANCHES[case](topt, te.parameters(), treg)
    for ids in ([[1, 2, 2, 8]], [[8, 0, 1]], [[4]]):
        _probe_step(je, jo, ids, "ref")
        _probe_step(te, to, ids, "port")
        np.testing.assert_allclose(_np(te.weight), _np(je.weight), rtol=0,
                                   atol=PROBE_TOL)


def test_master_weights_densify():
    """With master weights on, the reference densifies (:110-118); so does
    the port, through the float32 master."""
    je, te = _pair()
    jo = jopt.Adam(0.1, parameters=je.parameters(), lazy_mode=True)
    to = topt.Adam(0.1, parameters=te.parameters(), lazy_mode=True)
    jo._use_master_weights = to._use_master_weights = True
    for ids in PROBE_IDS:
        _probe_step(je, jo, ids, "ref")
        _probe_step(te, to, ids, "port")
    np.testing.assert_allclose(_np(te.weight), _np(je.weight), rtol=0,
                               atol=PROBE_TOL)


def test_grad_scaler_densifies_a_row_sparse_gradient():
    """``GradScaler.unscale_`` densifies a row-sparse gradient in the
    reference (``p.grad._data``); the clipped sparse SGD step after it is
    then the dense one."""
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp as tamp
    je, te = _pair()
    jo = jopt.SGD(0.1, parameters=je.parameters(), weight_decay=0.1)
    to = topt.SGD(0.1, parameters=te.parameters(), weight_decay=0.1)
    js = jamp.GradScaler(init_loss_scaling=1024.0)
    ts = tamp.GradScaler(init_loss_scaling=1024.0)
    for ids in PROBE_IDS:
        for emb, opt, sc, mk in ((je, jo, js, P.to_tensor),
                                 (te, to, ts, T.to_tensor)):
            loss = (emb(mk(np.asarray(ids, np.int64))) ** 2).sum()
            sc.scale(loss).backward()
            sc.step(opt)
            opt.clear_grad()
        np.testing.assert_allclose(_np(te.weight), _np(je.weight), rtol=0,
                                   atol=PROBE_TOL)
