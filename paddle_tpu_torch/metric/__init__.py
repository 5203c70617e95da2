"""``paddle.metric`` (the port of ``paddle_tpu/metric/__init__.py``):
``Metric``, ``Accuracy``, ``Precision``, ``Recall``, ``Auc``,
``chunk_eval`` and ``ChunkEvaluator``.

``Accuracy.compute`` runs on the tensors' device (top-k there); ``update``
and ``accumulate`` keep the reference's numpy arithmetic, so on the same
inputs their results equal the reference's.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy."""

    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = [name] if isinstance(name, str) else \
            (name or [f"acc_top{k}" for k in self.topk]
             if len(self.topk) > 1 else [name or "acc"])
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        """Whether each of the top ``maxk`` classes is the label: float32
        ``[..., maxk]`` on ``pred``'s device."""
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        k = min(self.maxk, pred.shape[-1])
        idx = torch.topk(pred, k, dim=-1).indices
        if label.ndim == pred.ndim and label.shape[-1] == 1:
            label = label[..., 0]
        return (idx == label.unsqueeze(-1)).to(torch.float32)

    def update(self, correct, *args):
        correct = np.asarray(correct)
        n = correct[..., 0].size
        for i, k in enumerate(self.topk):
            self.total[i] += correct[..., :k].sum()
            self.count[i] += n
        accs = self.total / np.maximum(self.count, 1)
        return accs[0] if len(self.topk) == 1 else accs

    def accumulate(self):
        accs = (self.total / np.maximum(self.count, 1)).tolist()
        return accs[0] if len(self.topk) == 1 else accs

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (np.asarray(_np(preds)) > 0.5).astype("int32").reshape(-1)
        labels = np.asarray(_np(labels)).astype("int32").reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (np.asarray(_np(preds)) > 0.5).astype("int32").reshape(-1)
        labels = np.asarray(_np(labels)).astype("int32").reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC by threshold buckets."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(_np(preds))
        if preds.ndim == 2:
            preds = preds[:, -1]
        labels = np.asarray(_np(labels)).reshape(-1)
        buckets = np.round(preds * self.num_thresholds).astype("int64")
        buckets = np.clip(buckets, 0, self.num_thresholds)
        for b, l in zip(buckets, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = tot_neg = auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            pos, neg = self._stat_pos[i], self._stat_neg[i]
            auc += neg * (tot_pos + pos + tot_pos) / 2.0
            tot_pos += pos
            tot_neg += neg
        return float(auc / (tot_pos * tot_neg)) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name


def _extract_chunks(tags, scheme, num_chunk_types):
    """Decode (chunk_type, begin, end) spans from a tag sequence.

    Tag encoding follows the reference chunk_eval op
    (paddle/fluid/operators/chunk_eval_op.cc): for IOB each chunk type t
    owns tags (2t = B-t, 2t+1 = I-t); IOE uses (I-t, E-t); IOBES uses
    (B, I, E, S) per type; ``plain`` gives one tag per type.  The 'O'
    (outside) tag is the largest id.
    """
    scheme = scheme.lower()
    width = {"plain": 1, "iob": 2, "ioe": 2, "iobes": 4}[scheme]
    outside = num_chunk_types * width
    chunks = []
    start = None
    cur_type = None

    def flush(end):
        nonlocal start, cur_type
        if start is not None:
            chunks.append((cur_type, start, end))
        start, cur_type = None, None

    for i, tag in enumerate(list(tags)):
        tag = int(tag)
        if tag >= outside or tag < 0:
            flush(i - 1)
            continue
        ctype, pos = tag // width, tag % width
        if scheme == "plain":
            if cur_type != ctype:
                flush(i - 1)
                start, cur_type = i, ctype
        elif scheme == "iob":
            if pos == 0:                      # B: always starts a chunk
                flush(i - 1)
                start, cur_type = i, ctype
            elif cur_type != ctype:           # I of a different type
                flush(i - 1)
                start, cur_type = i, ctype
        elif scheme == "ioe":
            if cur_type != ctype:
                flush(i - 1)
                start, cur_type = i, ctype
            if pos == 1:                      # E: ends the chunk
                flush(i)
        else:                                  # iobes
            if pos == 0:                      # B
                flush(i - 1)
                start, cur_type = i, ctype
            elif pos == 3:                    # S: single-token chunk
                flush(i - 1)
                chunks.append((ctype, i, i))
            elif pos == 2:                    # E
                if cur_type != ctype:
                    flush(i - 1)
                    start, cur_type = i, ctype
                flush(i)
            else:                             # I
                if cur_type != ctype:
                    flush(i - 1)
                    start, cur_type = i, ctype
    flush(len(list(tags)) - 1)
    return set(chunks)


def chunk_eval(inference, label, chunk_scheme, num_chunk_types,
               seq_lens=None, excluded_chunk_types=None):
    """Chunk-detection precision/recall/F1 (reference ops.yaml: chunk_eval —
    paddle/fluid/operators/chunk_eval_op.cc; sequence-labeling NER metric).

    inference/label: [B, T] int tag matrices; seq_lens: [B] valid lengths.
    Returns (precision, recall, f1, num_infer_chunks, num_label_chunks,
    num_correct_chunks) — host-side numpy (a metric, not a jitted op).
    """
    inference, label = _np(inference), _np(label)
    if inference.ndim == 1:
        inference, label = inference[None], label[None]
    B = inference.shape[0]
    excluded = set(excluded_chunk_types or ())
    n_inf = n_lab = n_cor = 0
    for b in range(B):
        ln = int(seq_lens[b]) if seq_lens is not None else inference.shape[1]
        inf = _extract_chunks(inference[b, :ln], chunk_scheme, num_chunk_types)
        lab = _extract_chunks(label[b, :ln], chunk_scheme, num_chunk_types)
        inf = {c for c in inf if c[0] not in excluded}
        lab = {c for c in lab if c[0] not in excluded}
        n_inf += len(inf)
        n_lab += len(lab)
        n_cor += len(inf & lab)
    precision = n_cor / n_inf if n_inf else 0.0
    recall = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * precision * recall / (precision + recall) \
        if precision + recall else 0.0
    return precision, recall, f1, n_inf, n_lab, n_cor


class ChunkEvaluator(Metric):
    """Streaming chunk F1 over ``chunk_eval``."""

    def __init__(self, chunk_scheme, num_chunk_types, name="chunk"):
        self._scheme = chunk_scheme
        self._n = num_chunk_types
        self._name = name
        self.reset()

    def reset(self):
        self._inf = self._lab = self._cor = 0

    def update(self, inference, label, seq_lens=None):
        _, _, _, i, l, c = chunk_eval(inference, label, self._scheme,
                                      self._n, seq_lens)
        self._inf += i
        self._lab += l
        self._cor += c

    def accumulate(self):
        p = self._cor / self._inf if self._inf else 0.0
        r = self._cor / self._lab if self._lab else 0.0
        return 2 * p * r / (p + r) if p + r else 0.0

    def name(self):
        return self._name
