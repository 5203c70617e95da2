"""Seq2seq beam search (the port of ``paddle_tpu/nn/decode.py``):
``BeamSearchDecoder`` over any cell and ``dynamic_decode``.

The loop is the reference's host loop: each step runs the cell, takes the
top ``beam`` of ``beam x vocab`` totals and gathers the states of the
chosen parents, all on the tensors' device; between steps the host reads
``all(finished)`` to stop early, as the reference does.  That read is a
blocking one and is counted as a marked sync (``observability.count_sync``,
one a step), so a block under ``assert_overhead(max_syncs=0)`` cannot hold
this loop: the no-sync gate of the training steps does not cover it.  The
backtrace through the parents and the lengths run on the device.
"""

from __future__ import annotations

import torch

from ..core.tensor import boundary
from ..observability import count_sync

__all__ = ["BeamSearchDecoder", "dynamic_decode"]


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, (tuple, list, dict)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


class BeamSearchDecoder:
    """Beam search over ``cell(inputs, states) -> (outputs, new_states)``
    (reference decode.py:26): ``embedding_fn`` maps ids to the cell's
    inputs, ``output_fn`` its outputs to vocabulary logits."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[b, ...] -> [b * beam, ...]``, each batch row repeated."""
        return torch.repeat_interleave(x, beam_size, dim=0)

    def initialize(self, initial_cell_states):
        """(ids, states, log_probs, finished) of the first step: every
        beam's state is its batch row's, ids are ``start_token``, and beam 0
        alone is live (the others start at -1e9), so the first step seeds
        distinct paths."""
        states = _tree_map(lambda s: torch.repeat_interleave(
            s, self.beam_size, dim=0), initial_cell_states)
        ref = _first_leaf(states)
        n = ref.shape[0]
        dev = ref.device
        ids = torch.full((n,), self.start_token, dtype=torch.int32,
                         device=dev)
        first = torch.full((self.beam_size,), -1e9, dtype=torch.float32,
                           device=dev)
        first[0] = 0.0
        log_probs = first.repeat(n // self.beam_size)
        finished = torch.zeros((n,), dtype=torch.bool, device=dev)
        return ids, states, log_probs, finished

    def step(self, time, ids, states, log_probs, finished):
        """One step: the cell, log-softmax in float32, finished beams
        extended only by ``end_token`` at cost 0, the top ``beam`` of each
        batch row's ``beam x vocab`` totals.  Returns (ids, states,
        log_probs, finished, parents as flat rows)."""
        inputs = ids if self.embedding_fn is None else self.embedding_fn(ids)
        cell_out, new_states = self.cell(inputs, states)
        logits = cell_out if self.output_fn is None else \
            self.output_fn(cell_out)
        logp = torch.log_softmax(logits.float(), dim=-1)
        vocab = logp.shape[-1]
        fin_row = torch.full((vocab,), -1e9, device=logp.device)
        fin_row[self.end_token] = 0.0
        logp = torch.where(finished[:, None], fin_row, logp)
        batch = ids.shape[0] // self.beam_size
        total = (log_probs[:, None] + logp).reshape(batch, -1)
        top_val, top_idx = self._select(total)
        beam_idx = torch.div(top_idx, vocab, rounding_mode="floor")
        flat_src = (torch.arange(batch, device=ids.device)[:, None] *
                    self.beam_size + beam_idx).reshape(-1)
        new_ids = (top_idx % vocab).to(torch.int32).reshape(-1)
        new_states = _tree_map(lambda s: s[flat_src], new_states)
        new_finished = finished[flat_src] | (new_ids == self.end_token)
        return (new_ids, new_states, top_val.reshape(-1), new_finished,
                flat_src)

    def _select(self, total):
        """The top ``beam`` of each row of ``total`` ``[batch, beam x
        vocab]``, best first: (values, flat indices)."""
        return torch.topk(total, self.beam_size, dim=-1)


@boundary
def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` until every beam has finished or ``max_step_num``
    (default 32) steps (reference decode.py:102).  Returns (ids ``[b,
    beam, T]`` int32 through the parents, final log-probs ``[b, beam]``)
    and, with ``return_length``, each beam's length up to and including
    its first ``end_token`` (T where it has none).  ``output_time_major``,
    ``impute_finished`` and ``is_test`` are accepted and ignored, as in the
    reference.  Each step's stop check reads the device: one marked sync a
    step (module docstring)."""
    max_steps = int(max_step_num or 32)
    ids, states, log_probs, finished = decoder.initialize(inits)
    W = decoder.beam_size
    n = ids.shape[0]
    steps, parents = [], []
    t = 0
    while t < max_steps:
        count_sync()
        if bool(finished.all()):
            break
        ids, states, log_probs, finished, src = decoder.step(
            t, ids, states, log_probs, finished)
        steps.append(ids)
        parents.append(src)
        t += 1
    T = len(steps)
    dev = ids.device
    cols = [None] * T
    ptr = torch.arange(n, device=dev)
    for k in range(T - 1, -1, -1):
        cols[k] = steps[k][ptr]
        ptr = parents[k][ptr]
    seqs = torch.stack(cols, dim=1) if T else \
        torch.zeros((n, 0), dtype=torch.int32, device=dev)
    seqs = seqs.reshape(n // W, W, T)
    out = (seqs, log_probs.reshape(n // W, W))
    if not return_length:
        return out
    hits = seqs == decoder.end_token
    first = torch.argmax(hits.to(torch.int32), dim=-1)
    lengths = torch.where(hits.any(dim=-1), first + 1, T).to(torch.int32)
    return out + (lengths,)
