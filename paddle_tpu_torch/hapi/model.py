"""``paddle.Model`` (the port of ``paddle_tpu/hapi/model.py``): ``prepare``,
``train_batch`` / ``eval_batch`` / ``predict_batch``, the ``fit`` /
``evaluate`` / ``predict`` loops with callbacks, ``save`` / ``load`` and
``summary``, over the port's eager (dygraph) path.

The API returns host values: a step's loss as a Python float and each
metric's ``accumulate()``.  Those are the loop's only reads from the card,
one for the loss and one for each metric's ``compute`` outputs, each marked
with ``observability.count_sync`` (``torch.cuda.set_sync_debug_mode`` lets
a marked read through).  The forward, the backward, the optimizer step and
the batch's copy to the card (``io``'s pinned ``non_blocking`` copy) read
nothing back.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..core.tensor import boundary

from .. import observability as _obs
from ..io import DataLoader, _to_device
from .callbacks import CallbackList, ModelCheckpoint, ProgBarLogger


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


@contextlib.contextmanager
def _sync_allowed(on_card: bool):
    """A marked read: ``torch.cuda.set_sync_debug_mode`` off for it."""
    mode = torch.cuda.get_sync_debug_mode() if on_card else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


def _host_read(values):
    """``values`` as numpy, the tensors among them read back in one marked
    sync."""
    tensors = [v for v in values if torch.is_tensor(v)]
    if not tensors:
        return [np.asarray(v) for v in values]
    _obs.count_sync()
    on_card = any(t.is_cuda for t in tensors)
    with _sync_allowed(on_card):
        host = [v.detach().to("cpu", non_blocking=True)
                if torch.is_tensor(v) else v for v in values]
        if on_card:
            torch.cuda.current_stream().synchronize()
    return [v.numpy() if torch.is_tensor(v) else np.asarray(v)
            for v in host]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    # ---- configuration ----
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """``amp_configs`` is accepted and ignored, as in the reference."""
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        return self

    # ---- single steps ----
    @boundary
    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = _to_list(inputs)
        labels = _to_list(labels)
        outputs = self.network(*[_t(i) for i in inputs])
        losses = self._compute_loss(outputs, labels)
        losses.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        return [float(_host_read([losses])[0])] + metrics

    @boundary
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        with torch.no_grad():
            inputs = _to_list(inputs)
            labels = _to_list(labels)
            outputs = self.network(*[_t(i) for i in inputs])
            losses = self._compute_loss(outputs, labels)
            metrics = self._update_metrics(outputs, labels)
        return [float(_host_read([losses])[0])] + metrics

    @boundary
    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            outputs = self.network(*[_t(i) for i in _to_list(inputs)])
        return outputs

    def _compute_loss(self, outputs, labels):
        outs = _to_list(outputs)
        if self._loss is None:
            return outs[0]
        return self._loss(*(outs + [_t(lab) for lab in labels]))

    def _update_metrics(self, outputs, labels):
        vals = []
        outs = _to_list(outputs)
        for m in self._metrics:
            corr = m.compute(*(outs + [_t(lab) for lab in labels]))
            m.update(*_host_read(_to_list(corr)))
            vals.extend(_to_list(m.accumulate()))
        return [float(v) for v in vals]

    # ---- loops ----
    @boundary
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        train_loader = self._loader(train_data, batch_size, shuffle,
                                    drop_last, num_workers)
        eval_loader = self._loader(eval_data, batch_size, False, False,
                                   num_workers) \
            if eval_data is not None else None

        cbks = _to_list(callbacks)
        if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
            cbks.append(ProgBarLogger(log_freq, verbose=verbose))
        if save_dir:
            cbks.append(ModelCheckpoint(save_freq, save_dir))
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cb = CallbackList(cbks, self, {"epochs": epochs, "steps": steps,
                                       "verbose": verbose})

        self.stop_training = False
        cb.call("on_train_begin")
        history = []
        it_count = 0
        for epoch in range(epochs):
            cb.call("on_epoch_begin", epoch)
            self._reset_metrics()
            logs = {}
            for step, batch in enumerate(train_loader):
                cb.call("on_train_batch_begin", step)
                ins, labs = _split_batch(batch)
                update = (step + 1) % accumulate_grad_batches == 0
                vals = self.train_batch(ins, labs, update=update)
                logs = self._named_logs(vals)
                cb.call("on_train_batch_end", step, logs)
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    self.stop_training = True
                    break
            cb.call("on_epoch_end", epoch, logs)
            history.append(logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, callbacks=cbks, verbose=verbose)
            if self.stop_training:
                break
        cb.call("on_train_end")
        return history

    @boundary
    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._loader(eval_data, batch_size, False, False,
                              num_workers)
        cb = CallbackList(_to_list(callbacks), self, {"verbose": verbose})
        self._reset_metrics()
        cb.call("on_eval_begin")
        logs = {}
        total, n = 0.0, 0
        for step, batch in enumerate(loader):
            cb.call("on_eval_batch_begin", step)
            ins, labs = _split_batch(batch)
            vals = self.eval_batch(ins, labs)
            total += vals[0]
            n += 1
            logs = self._named_logs(vals, prefix="eval_")
            cb.call("on_eval_batch_end", step, logs)
        logs["eval_loss"] = total / max(n, 1)
        cb.call("on_eval_end", logs)
        return logs

    @boundary
    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        import inspect

        loader = self._loader(test_data, batch_size, False, False,
                              num_workers)
        # datasets often yield (inputs..., label) even for predict: trim the
        # batch to the network's forward arity
        try:
            sig = inspect.signature(self.network.forward)
            n_pos = len([p for p in sig.parameters.values()
                         if p.kind in (p.POSITIONAL_ONLY,
                                       p.POSITIONAL_OR_KEYWORD)
                         and p.default is p.empty])
        except (TypeError, ValueError):
            n_pos = None
        outputs = []
        for batch in loader:
            ins, _ = _split_batch(batch, has_labels=False)
            if n_pos is not None and len(ins) > n_pos >= 1:
                ins = ins[:n_pos]
            outputs.append(self.predict_batch(ins))
        if stack_outputs:
            flat = [o if isinstance(o, (list, tuple)) else [o]
                    for o in outputs]
            return [torch.cat([f[i] for f in flat], dim=0)
                    for i in range(len(flat[0]))]
        return outputs

    # ---- persistence ----
    def save(self, path, training=True):
        """``path + ".pdparams"`` (the network's parameters, as
        ``Parameter``s with their names, and buffers) and, with
        ``training``, ``path + ".pdopt"`` (the optimizer's state)."""
        from ..framework import io as fio
        fio.save(self.network.state_dict(keep_vars=True), path + ".pdparams")
        if training and self._optimizer is not None:
            fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework import io as fio
        self.network.set_state_dict(fio.load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(fio.load(opt_path))
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtypes=dtype)

    # ---- helpers ----
    def _loader(self, data, batch_size, shuffle, drop_last, num_workers):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)

    def _reset_metrics(self):
        for m in self._metrics:
            m.reset()

    def _named_logs(self, vals, prefix=""):
        logs = {prefix + "loss": vals[0]}
        i = 1
        for m in self._metrics:
            for name in _to_list(m.name()):
                if i < len(vals):
                    logs[prefix + name] = vals[i]
                    i += 1
        return logs


def _t(x):
    """A tensor as it is; anything else as a tensor on the current
    device."""
    return x if torch.is_tensor(x) else _to_device(np.asarray(x))


def _split_batch(batch, has_labels=True):
    if isinstance(batch, (list, tuple)):
        if has_labels and len(batch) >= 2:
            return list(batch[:-1]), [batch[-1]]
        return list(batch), []
    return [batch], []
