"""``paddle.Model`` of the port against the JAX package, on the CPU.

The scenario of ``tests/test_ecosystem.py::test_hapi_fit_eval_predict`` (a
Linear-ReLU-Linear classifier on a seeded dataset, Adam, cross-entropy,
``Accuracy``) runs through both packages from the reference's weights
(``load_reference_state``) with ``shuffle=False``:

- ``fit``'s history, ``evaluate``'s logs and ``predict``'s outputs agree
  within FIT_TOL (fp32, relative to the largest value compared), and the
  accuracies are equal;
- a recording callback sees the reference's sequence of events;
- ``ModelCheckpoint`` writes the reference's file names;
- ``save`` -> ``load`` into a fresh model -> one more epoch equals the
  reference's continued run;
- ``EarlyStopping``, the ``LRScheduler`` callback by step and by epoch,
  ``accumulate_grad_batches=2`` with ``num_iters``;
- ``summary``'s rows and totals, and ``flops``, equal the reference's;
- ``fit`` at ``num_workers=2`` (the fork workers' ring) equals ``fit`` at
  0, and a training step marks exactly ``1 + len(metrics)`` syncs.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.hapi import callbacks as jcb
import paddle_tpu_torch as T
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)

FIT_TOL = 2e-5


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    T.set_device("cpu")
    try:
        yield
    finally:
        tdevice._current[0] = old


_W = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)


class DS:
    """64 samples: x ~ N(0, 1) in 8 dims from the sample's seed, the
    label the argmax of a fixed projection."""

    def __init__(self, n=64):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        x = np.random.default_rng(i).standard_normal(8).astype(np.float32)
        return x, np.int64((x @ _W).argmax())


EVENTS = ("on_train_begin", "on_train_end", "on_epoch_begin", "on_epoch_end",
          "on_train_batch_begin", "on_train_batch_end", "on_eval_begin",
          "on_eval_end", "on_eval_batch_begin", "on_eval_batch_end")


def _recorder(base):
    """A callback of ``base``'s package recording (event, the int
    argument if any, the logs' keys)."""
    def make(name):
        def hook(self, *args, **kw):
            ints = [a for a in args if isinstance(a, int)]
            logs = [a for a in args if isinstance(a, dict)]
            self.events.append((name, ints[0] if ints else None,
                                sorted(logs[0]) if logs else None))
        return hook
    body = {n: make(n) for n in EVENTS}
    body["__init__"] = lambda self: (base.__init__(self),
                                     setattr(self, "events", []))[0]
    return type("Recorder", (base,), body)


def _pair(opt="adam", sched=None, seed=0):
    """(reference net, port net with its weights, reference optimizer,
    port optimizer)."""
    P.seed(seed)
    jnet = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 3))
    tnet = tnn.Sequential(tnn.Linear(8, 32), tnn.ReLU(), tnn.Linear(32, 3))
    load_reference_state(tnet, {k: np.asarray(v._data).copy()
                                for k, v in jnet.state_dict().items()})
    if opt == "adam":
        jo = jopt.Adam(5e-3, parameters=jnet.parameters())
        to = topt.Adam(5e-3, parameters=tnet.parameters())
    else:
        jo = jopt.SGD(jopt.lr.StepDecay(0.2, step_size=3, gamma=0.5),
                      parameters=jnet.parameters())
        to = topt.SGD(topt.lr.StepDecay(0.2, step_size=3, gamma=0.5),
                      parameters=tnet.parameters())
    return jnet, tnet, jo, to


def _models(**kw):
    jnet, tnet, jo, to = _pair(**kw)
    jmodel = P.Model(jnet).prepare(jo, jnn.CrossEntropyLoss(),
                                   P.metric.Accuracy())
    tmodel = T.Model(tnet).prepare(to, tnn.CrossEntropyLoss(),
                                   T.metric.Accuracy())
    return jmodel, tmodel


def _close_logs(got, want):
    assert list(got) == list(want)
    for k in want:
        if "acc" in k:
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=FIT_TOL,
                                       atol=FIT_TOL, err_msg=k)


def _close_history(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close_logs(g, w)


def _state_close(tnet, jnet):
    want = jnet.state_dict()
    got = tnet.state_dict()
    for k, w in want.items():
        w = np.asarray(w._data)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=FIT_TOL,
                                   atol=FIT_TOL * max(1.0, np.abs(w).max()),
                                   err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages through fit (2 epochs, eval each epoch, checkpoints),
    evaluate, predict, save, load into a fresh model and one more epoch."""
    old = tdevice._current[0]
    T.set_device("cpu")
    out = {}
    try:
        for pkg in ("ref", "port"):
            jm, tm = _models()
            model = jm if pkg == "ref" else tm
            rec = _recorder(jcb.Callback if pkg == "ref" else tcb.Callback)()
            d = tmp_path_factory.mktemp(pkg)
            r = {"model": model}
            r["history"] = model.fit(DS(), eval_data=DS(32), epochs=2,
                                     batch_size=16, verbose=0,
                                     shuffle=False, callbacks=[rec],
                                     save_dir=str(d / "ck"))
            r["events"] = rec.events
            r["files"] = sorted(os.listdir(d / "ck"))
            r["eval"] = model.evaluate(DS(), batch_size=16, verbose=0)
            preds = model.predict(DS(), batch_size=16, stack_outputs=True)
            r["preds"] = [np.asarray(p._data) if hasattr(p, "_data")
                          else p.numpy() for p in preds]
            r["per_batch"] = model.predict(DS(), batch_size=16)
            model.save(str(d / "saved"))
            fresh_j, fresh_t = _models(seed=5)
            fresh = fresh_j if pkg == "ref" else fresh_t
            fresh.load(str(d / "saved"))
            r["fresh"] = fresh
            r["continued"] = fresh.fit(DS(), epochs=1, batch_size=16,
                                       verbose=0, shuffle=False)
            out[pkg] = r
    finally:
        tdevice._current[0] = old
    return out


def test_fit_history_matches_the_reference(runs):
    _close_history(runs["port"]["history"], runs["ref"]["history"])
    _state_close(runs["port"]["model"].network, runs["ref"]["model"].network)


def test_callback_events_match_the_reference(runs):
    got, want = runs["port"]["events"], runs["ref"]["events"]
    assert got == want
    assert want[0][0] == "on_train_begin" and want[-1][0] == "on_train_end"
    assert sum(e[0] == "on_eval_end" for e in want) == 2


def test_model_checkpoint_file_names(runs):
    assert runs["port"]["files"] == runs["ref"]["files"] == [
        "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams", "final.pdopt",
        "final.pdparams"]


def test_evaluate_and_predict_match_the_reference(runs):
    _close_logs(runs["port"]["eval"], runs["ref"]["eval"])
    assert runs["ref"]["eval"]["eval_acc"] > 0.6
    (got,), (want,) = runs["port"]["preds"], runs["ref"]["preds"]
    assert got.shape == want.shape == (64, 3)
    np.testing.assert_allclose(got, want, rtol=FIT_TOL,
                               atol=FIT_TOL * np.abs(want).max())
    per = runs["port"]["per_batch"]
    assert len(per) == 4 and torch.is_tensor(per[0])
    assert torch.equal(torch.cat(per), torch.tensor(got))


def test_save_load_continued_fit_matches_the_reference(runs):
    _close_history(runs["port"]["continued"], runs["ref"]["continued"])
    _state_close(runs["port"]["fresh"].network, runs["ref"]["fresh"].network)


def test_save_load_round_trip_is_exact(tmp_path):
    _, tm = _models()
    tm.fit(DS(), epochs=1, batch_size=16, verbose=0, shuffle=False)
    tm.save(str(tmp_path / "m"))
    _, fresh = _models(seed=9)
    fresh.load(str(tmp_path / "m"))
    for (k, a), (k2, b) in zip(tm.network.state_dict().items(),
                               fresh.network.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
    sa, sb = tm._optimizer.state_dict(), fresh._optimizer.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        if torch.is_tensor(sa[k]):
            assert torch.equal(sa[k], sb[k]), k
        else:
            assert sa[k] == sb[k], k
    params = T.load(str(tmp_path / "m.pdparams"))
    assert all(isinstance(v, T.Parameter) for v in params.values())
    x = torch.tensor(np.stack([DS()[i][0] for i in range(16)]))
    assert torch.equal(tm.predict_batch([x]), fresh.predict_batch([x]))


def test_early_stopping_matches_the_reference():
    hist = {}
    for pkg in ("ref", "port"):
        jm, tm = _models()
        model, cb = (jm, jcb) if pkg == "ref" else (tm, tcb)
        es = cb.EarlyStopping(monitor="eval_acc", mode="max", patience=1,
                              min_delta=0.5)
        hist[pkg] = (model.fit(DS(), eval_data=DS(32), epochs=5,
                               batch_size=16, verbose=0, shuffle=False,
                               callbacks=[es]), es.wait, es.best)
    assert len(hist["ref"][0]) == 2
    _close_history(hist["port"][0], hist["ref"][0])
    assert hist["port"][1:] == hist["ref"][1:]


@pytest.mark.parametrize("by", ["step", "epoch"])
def test_lr_scheduler_callback(by):
    out = {}
    for pkg in ("ref", "port"):
        jm, tm = _models(opt="sgd")
        model, cb = (jm, jcb) if pkg == "ref" else (tm, tcb)
        sched = cb.LRScheduler(by_step=by == "step", by_epoch=by == "epoch")
        hist = model.fit(DS(), epochs=3, batch_size=16, verbose=0,
                         shuffle=False, callbacks=[sched])
        out[pkg] = (hist, model._optimizer.get_lr())
    _close_history(out["port"][0], out["ref"][0])
    assert out["port"][1] == out["ref"][1]
    # 12 steps or 3 epochs of StepDecay(0.2, step_size=3, gamma=0.5)
    assert out["ref"][1] == (0.2 * 0.5 ** 4 if by == "step" else 0.1)


def test_accumulate_grad_batches_and_num_iters():
    out = {}
    for pkg in ("ref", "port"):
        jm, tm = _models()
        model = jm if pkg == "ref" else tm
        hist = model.fit(DS(), epochs=3, batch_size=16, verbose=0,
                         shuffle=False, accumulate_grad_batches=2,
                         num_iters=6)
        out[pkg] = (hist, model)
    assert len(out["ref"][0]) == 2
    _close_history(out["port"][0], out["ref"][0])
    _state_close(out["port"][1].network, out["ref"][1].network)


def test_summary_and_flops_match_the_reference(capsys):
    def conv_net(nn):
        return nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.BatchNorm2D(8),
                             nn.ReLU(), nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                             nn.Linear(8, 4))
    P.seed(0)
    jnet, tnet = conv_net(jnn), conv_net(tnn)
    want = P.summary(jnet, (1, 3, 16, 16))
    want_out = capsys.readouterr().out
    got = T.summary(tnet, (1, 3, 16, 16))
    got_out = capsys.readouterr().out
    assert got == want and got["total_params"] == 8 * 27 + 8 + 16 + 36
    assert got_out == want_out
    assert "BatchNorm2D-1" in got_out
    assert T.flops(tnet, [2, 3, 16, 16]) == P.flops(jnet, [2, 3, 16, 16])
    _, tm = _models()
    assert tm.summary((1, 8)) == P.Model(_pair()[0]).summary((1, 8))
    assert tnet.training


def test_fit_with_fork_workers_equals_fit_in_process():
    """``fit`` over the fork workers' ring (``num_workers=2``) gives the
    same history and weights as in one process; every training step marks
    exactly 1 + len(metrics) syncs (the loss and the accuracy's read)."""
    per_step = []

    class Syncs(tcb.Callback):
        def on_train_batch_begin(self, step, logs=None):
            self.s0 = tobs.device_syncs()

        def on_train_batch_end(self, step, logs=None):
            per_step.append(tobs.device_syncs() - self.s0)

    out = {}
    for workers in (0, 2):
        _, tm = _models()
        before = dict(tio.ITERATORS)
        out[workers] = (tm.fit(DS(), epochs=2, batch_size=16, verbose=0,
                               shuffle=False, num_workers=workers,
                               callbacks=[Syncs()]), tm)
        used = {k: tio.ITERATORS[k] - before[k] for k in before}
        assert used == {k: (2 if k == ("fork_ring" if workers else "map")
                            else 0) for k in before}
    assert out[0][0] == out[2][0]
    for a, b in zip(out[0][1].parameters(), out[2][1].parameters()):
        assert torch.equal(a, b)
    assert per_step == [2] * 16


def test_amp_configs_accepted_and_ignored():
    _, tm = _models()
    tm.prepare(tm._optimizer, tnn.CrossEntropyLoss(), None,
               amp_configs={"level": "O2"})
    x, y = DS()[0]
    loss = tm.train_batch([x[None]], [np.asarray([y])])
    assert len(loss) == 1 and np.isfinite(loss[0])
