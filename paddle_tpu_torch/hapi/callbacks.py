"""The ``Model`` callbacks (the port of ``paddle_tpu/hapi/callbacks.py``):
``Callback``, ``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``
(every N epochs and at the end), ``LRScheduler`` and ``EarlyStopping``."""

from __future__ import annotations

import os
import time
from typing import List, Optional


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        # merge: fit() and evaluate() share callback objects, so a later
        # CallbackList must not clobber params (e.g. 'steps') set earlier
        self.params = {**self.params, **(params or {})}

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: List[Callback], model, params):
        self.callbacks = callbacks
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def call(self, name, *args, **kwargs):
        for c in self.callbacks:
            getattr(c, name)(*args, **kwargs)


class ProgBarLogger(Callback):
    """Prints the logs every ``log_freq`` steps and at each epoch's end."""

    def __init__(self, log_freq: int = 10, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            logs = logs or {}
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                               for k, v in logs.items())
            total = f"/{self.steps}" if self.steps else ""
            print(f"Epoch {self.epoch}: step {step}{total} - {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            items = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                               for k, v in (logs or {}).items())
            print(f"Epoch {epoch} done ({dt:.1f}s) - {items}")


class ModelCheckpoint(Callback):
    """Saves the model every ``save_freq`` epochs and at the end."""

    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's lr schedule by step and/or by epoch."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        from ..optimizer.lr import LRScheduler as Sched
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    """Stops ``fit`` when the monitored eval log stops improving."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = baseline  # runs must improve past the baseline to reset
        self.stopped_epoch = 0
        self.stop_training = False
        if mode == "auto":
            mode = "min" if "loss" in monitor else "max"
        self.mode = mode

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
                if self.model is not None:
                    self.model.stop_training = True
