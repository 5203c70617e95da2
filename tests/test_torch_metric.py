"""``paddle.metric`` of the port against the JAX package, on the CPU: on
the same seeded inputs every metric's ``update`` and ``accumulate()``
equal the reference's exactly (both keep numpy arithmetic there), and
``Accuracy.compute`` (top-k on the tensors' device) equals the
reference's."""

import numpy as np
import pytest
import torch

from paddle_tpu import metric as jm
from paddle_tpu.core.tensor import Tensor as JT
import paddle_tpu_torch as T
from paddle_tpu_torch import metric as tm

torch.set_num_threads(2)


def _logits(rng, n, c):
    return rng.standard_normal((n, c)).astype(np.float32)


@pytest.mark.parametrize("topk", [(1,), (1, 2), (1, 2, 5), 3])
@pytest.mark.parametrize("label_shape", ["flat", "column"])
def test_accuracy(topk, label_shape):
    rng = np.random.default_rng(0)
    j, t = jm.Accuracy(topk=topk), tm.Accuracy(topk=topk)
    assert t.name() == j.name()
    for _ in range(4):
        pred = _logits(rng, 33, 7)
        label = rng.integers(0, 7, (33,)).astype(np.int64)
        if label_shape == "column":
            label = label[:, None]
        jc = j.compute(JT(pred), JT(label))
        tc = t.compute(torch.tensor(pred), torch.tensor(label))
        assert tc.dtype == torch.float32
        np.testing.assert_array_equal(tc.numpy(), jc)
        ju, tu = j.update(jc), t.update(tc.numpy())
        np.testing.assert_array_equal(np.asarray(tu), np.asarray(ju))
    assert t.accumulate() == j.accumulate()
    t.reset()
    j.reset()
    assert t.accumulate() == j.accumulate()


def test_accuracy_top_k_past_the_classes():
    rng = np.random.default_rng(1)
    pred, label = _logits(rng, 8, 3), rng.integers(0, 3, (8,))
    j, t = jm.Accuracy(topk=(1, 5)), tm.Accuracy(topk=(1, 5))
    j.update(j.compute(JT(pred), JT(label)))
    t.update(t.compute(torch.tensor(pred), torch.tensor(label)).numpy())
    assert t.accumulate() == j.accumulate()


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall(cls):
    rng = np.random.default_rng(2)
    j, t = getattr(jm, cls)(), getattr(tm, cls)()
    assert t.name() == j.name()
    assert t.accumulate() == j.accumulate() == 0.0
    for _ in range(3):
        preds = rng.uniform(0, 1, (50,)).astype(np.float32)
        labels = rng.integers(0, 2, (50,)).astype(np.int64)
        j.update(JT(preds), JT(labels))
        t.update(torch.tensor(preds), torch.tensor(labels))
    assert t.accumulate() == j.accumulate()


@pytest.mark.parametrize("two_columns", [False, True])
def test_auc_4095_thresholds(two_columns):
    rng = np.random.default_rng(3)
    j, t = jm.Auc(num_thresholds=4095), tm.Auc(num_thresholds=4095)
    for _ in range(3):
        p = rng.uniform(0, 1, (64,)).astype(np.float32)
        preds = np.stack([1 - p, p], 1) if two_columns else p
        labels = (rng.uniform(0, 1, (64,)) < p).astype(np.int64)
        j.update(JT(preds), JT(labels))
        t.update(torch.tensor(preds), torch.tensor(labels))
    np.testing.assert_array_equal(t._stat_pos, j._stat_pos)
    assert t.accumulate() == j.accumulate()
    assert 0.5 < t.accumulate() < 1.0


def _tags(rng, scheme, n_types, shape):
    width = {"plain": 1, "iob": 2, "ioe": 2, "iobes": 4}[scheme]
    return rng.integers(0, n_types * width + 1, shape).astype(np.int64)


@pytest.mark.parametrize("scheme", ["plain", "IOB", "IOE", "IOBES"])
def test_chunk_eval_and_evaluator(scheme):
    rng = np.random.default_rng(4)
    n_types = 3
    je = jm.ChunkEvaluator(scheme, n_types)
    te = tm.ChunkEvaluator(scheme, n_types)
    for _ in range(3):
        inf = _tags(rng, scheme.lower(), n_types, (5, 20))
        lab = inf.copy()
        flip = rng.uniform(0, 1, lab.shape) < 0.3
        lab[flip] = _tags(rng, scheme.lower(), n_types, lab.shape)[flip]
        lens = rng.integers(5, 21, (5,))
        want = jm.chunk_eval(JT(inf), JT(lab), scheme, n_types,
                             seq_lens=lens, excluded_chunk_types=[1])
        got = tm.chunk_eval(torch.tensor(inf), torch.tensor(lab), scheme,
                            n_types, seq_lens=lens,
                            excluded_chunk_types=[1])
        assert got == want and want[3] > 0
        assert tm.chunk_eval(inf[0], lab[0], scheme, n_types) == \
            jm.chunk_eval(inf[0], lab[0], scheme, n_types)
        je.update(JT(inf), JT(lab), lens)
        te.update(torch.tensor(inf), torch.tensor(lab), lens)
    assert te.accumulate() == je.accumulate()
    assert te.name() == je.name()


def test_metric_base_and_package_names():
    assert T.metric is tm
    m = tm.Metric()
    assert m.compute(1, 2) == (1, 2)
    for name in ("reset", "accumulate", "name"):
        with pytest.raises(NotImplementedError):
            getattr(m, name)()
