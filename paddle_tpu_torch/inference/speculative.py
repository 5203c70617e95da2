"""Speculative decoding for the serving engine: n-gram drafting and the
fused multi-step decode (port of ``paddle_tpu/inference/speculative.py``).

The mixed-mode ragged paged-attention kernel already scores T > 1 query
tokens per sequence under a causal mask, so verifying K draft tokens is the
same call as a prefill chunk: one step runs the model over ``[B, K]`` query
tokens against the paged KV history and emits logits at every position.

- **``fused`` mode**: K sequential T=1 decode steps in ONE engine dispatch,
  so the host pays one dispatch per K tokens (every "draft" is the model's
  own sample; all are committed).
- **``ngram`` mode** (prompt lookup): a drafter proposes K-1 tokens by
  matching the sequence's recent n-gram context against its own
  prompt+output history, and the engine verifies all of them in ONE step at
  T=K.  Draft j is accepted iff it equals the verifier's own token for
  position j-1 (the longest-accepted-prefix rule), computed on the device,
  so a spec step commits between 1 and K tokens with no host read.

The host owns the *history table* (a per-slot ``[max_seq_len]`` token row:
the prompt plus every drained output token) and uploads it only at
admission and at the engine's drains.  The matching runs on the device
(:func:`lookup_drafts`) against a device-resident ``recent`` ring of the
last ``ngram_max`` committed tokens that every step maintains
(:func:`shift_append`).  Warm spec steps read nothing back to the host.

**KV rollback**: the verify step writes KV rows for all K positions before
acceptance is known.  Rejected positions do not advance ``positions``; the
kernel masks reads by context length, so stale rows are never read and are
overwritten when the cursor reaches them.  Prefix sharing is page-aligned
over full prompt pages and a fully cached prompt privatizes its last page
copy-on-write before the first decode write, so draft writes only touch
pages the sequence owns alone.  Pages grown for tokens that were then
rejected are released at the drain by ``PageAllocator.truncate``.

Greedy spec-on outputs (both modes) equal the spec-off engine's: a draft is
accepted only when it equals the verifier's own argmax.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import flags

# Three distinct pads, so padding can never produce a false n-gram match:
# history rows pad with HIST_PAD past their length, the recent ring pads
# with CTX_PAD before enough tokens were committed, and the shifted history
# views pad with _SHIFT_PAD at the left edge.  Token ids are >= 0.
HIST_PAD = np.int32(-1)
CTX_PAD = np.int32(-2)
_SHIFT_PAD = np.int32(-3)

MODES = ("ngram", "fused")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Resolved speculative-decoding configuration (fixed per engine)."""

    mode: str          # "ngram" | "fused"
    k: int             # tokens per speculative dispatch (the T=k step)
    ngram_max: int     # longest drafter context (ngram mode only)


def resolve_spec_config(spec_decode=None, k: Optional[int] = None,
                        ngram_max: Optional[int] = None
                        ) -> Optional[SpecConfig]:
    """Engine argument / flag resolution: ``None`` defers to the
    ``spec_decode`` flag ('' = off), ``True`` means 'ngram', ``False``
    forces off."""
    mode = spec_decode
    if mode is None:
        mode = flags.flag("spec_decode")
    if mode is True:
        mode = "ngram"
    if not mode:
        return None
    if mode not in MODES:
        raise ValueError(
            f"spec_decode must be one of {MODES} (or ''/False for off), "
            f"got {mode!r}")
    k = int(k if k is not None else flags.flag("spec_k"))
    if k < 2:
        raise ValueError(f"spec_k must be >= 2 (got {k}); K=1 is just the "
                         "plain decode step")
    n = int(ngram_max if ngram_max is not None
            else flags.flag("spec_ngram_max"))
    return SpecConfig(mode, k, max(1, n))


# ---------------------------------------------------------------------------
# the drafter and the acceptance rule: tensor code, run inside the verify
# step on the step's device (no host read, no branch on a device value)
# ---------------------------------------------------------------------------

def lookup_drafts(hist, hist_len, recent, k: int, nmax: int):
    """Prompt-lookup draft proposal.

    For every position ``p`` of each row's history the drafter scores the
    longest suffix of ``recent`` (the last ``nmax`` committed tokens,
    right-aligned) that matches ``hist[p-L:p]``; the longest match wins,
    the most recent occurrence breaks ties, and the draft is the
    continuation ``hist[p : p+k-1]``.

    hist [B, S] int32 (``HIST_PAD`` past ``hist_len``), hist_len [B] int32,
    recent [B, nmax] int32 (``CTX_PAD`` on the left).  Returns (drafts
    [B, k-1] int32, draft_len [B] int32); rows with no match get draft_len
    0 and ride the verify step as plain decode rows.
    """
    B, S = hist.shape
    dev = hist.device
    i32 = torch.int32
    pos = torch.arange(S, dtype=i32, device=dev)[None, :]
    match_len = torch.zeros((B, S), dtype=i32, device=dev)
    run = torch.ones((B, S), dtype=torch.bool, device=dev)
    for i in range(1, nmax + 1):
        # shifted[b, p] = hist[b, p-i]  (left edge -> _SHIFT_PAD)
        shifted = torch.cat(
            [torch.full((B, i), int(_SHIFT_PAD), dtype=hist.dtype,
                        device=dev), hist[:, :S - i]], dim=1)
        run = run & (shifted == recent[:, nmax - i][:, None])
        match_len = match_len + run.to(i32)
    valid = (pos < hist_len[:, None]) & (match_len > 0)
    score = torch.where(valid, match_len * S + pos,
                        torch.full_like(match_len, -1))
    best = torch.argmax(score, dim=1).to(i32)
    found = score.amax(dim=1) >= 0
    draft_len = torch.where(
        found, torch.clamp(hist_len.to(i32) - best, max=k - 1),
        torch.zeros_like(best))
    idx = torch.clamp(best[:, None] + torch.arange(k - 1, dtype=i32,
                                                   device=dev)[None, :],
                      max=S - 1)
    drafts = torch.gather(hist, 1, idx.long())
    return drafts, draft_len


def shift_append(recent, out_tokens, n_commit):
    """Slide each row's recent ring forward by its committed count:
    ``recent[b]`` becomes the last ``nmax`` tokens of
    ``recent[b] ++ out_tokens[b, :n_commit[b]]`` (n_commit 0 = no change)."""
    nmax = recent.shape[1]
    cat = torch.cat([recent, out_tokens.to(recent.dtype)], dim=1)
    idx = n_commit[:, None].to(torch.int64) + \
        torch.arange(nmax, dtype=torch.int64, device=recent.device)[None, :]
    return torch.gather(cat, 1, idx)


def accept_length(tokens, sampled, q_lens):
    """Longest-accepted-prefix rule.

    tokens [B, K]: column 0 is the row's last committed token, columns 1..
    the drafts; sampled [B, K]: the verifier's own token for each position;
    q_lens [B]: 1 + draft_len (0 = inert row).  Draft j is accepted iff it
    equals ``sampled[:, j-1]``.  Returns the commit count per row: accepted
    drafts plus the one bonus token from the first unaccepted position (an
    active row commits >= 1), 0 for inert rows.
    """
    B, K = tokens.shape
    i32 = torch.int32
    if K > 1:
        j = torch.arange(K - 1, dtype=i32, device=tokens.device)[None, :]
        match = (tokens[:, 1:] == sampled[:, :-1]) & (j < (q_lens[:, None] - 1))
        a = torch.cumprod(match.to(i32), dim=1).sum(dim=1).to(i32)
    else:
        a = torch.zeros((B,), dtype=i32, device=tokens.device)
    return torch.where(q_lens > 0, a + 1, torch.zeros_like(a))


def eos_clamp(sampled, n_commit, eos_id: int):
    """Cut each row's commit count at its first committed EOS (kept:
    sequential decoding emits the EOS token too).  Returns (clamped
    n_commit, hit_eos [B] bool)."""
    B, K = sampled.shape
    j = torch.arange(K, dtype=torch.int32, device=sampled.device)[None, :]
    is_eos = (sampled == eos_id) & (j < n_commit[:, None])
    first = torch.where(is_eos, j, torch.full_like(j, K)).amin(dim=1)
    hit = first < n_commit
    return torch.where(hit, first + 1, n_commit).to(torch.int32), hit


# ---------------------------------------------------------------------------
# host-side history table (rebuilt at admission and drains only)
# ---------------------------------------------------------------------------

def recent_window(tokens: Sequence[int], nmax: int) -> np.ndarray:
    """Right-aligned ``[nmax]`` int32 tail of ``tokens`` (CTX_PAD fill): the
    admission-time seed of a row's recent ring."""
    out = np.full((nmax,), int(CTX_PAD), np.int32)
    tail = list(tokens)[-nmax:]
    if tail:
        out[nmax - len(tail):] = np.asarray(tail, np.int32)
    return out


def _copy_up(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).clone()


class SpecHistory:
    """The drafter's n-gram table: per-slot prompt+output token history.

    A host numpy mirror and a lazily refreshed device copy: ``reset_row``
    runs at admission, ``extend_row`` at the engine drain with the tokens
    that just left the pending window, and ``device_arrays`` uploads only
    when a row changed (``upload`` is the engine's host-to-device copy, not
    a sync), so warm spec steps between drains touch nothing here.
    """

    def __init__(self, max_batch: int, max_seq_len: int,
                 upload: Callable[[np.ndarray], torch.Tensor] = _copy_up):
        self._np = np.full((max_batch, max_seq_len), int(HIST_PAD), np.int32)
        self._len = np.zeros((max_batch,), np.int32)
        self._upload = upload
        self._dirty = True
        self._dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def reset_row(self, b: int, tokens: Sequence[int]) -> None:
        """Seed slot ``b`` with a freshly admitted prompt."""
        row = self._np[b]
        row[:] = int(HIST_PAD)
        n = min(len(tokens), row.shape[0])
        if n:
            row[:n] = np.asarray(list(tokens)[:n], np.int32)
        self._len[b] = n
        self._dirty = True

    def extend_row(self, b: int, tokens: Sequence[int]) -> None:
        """Append drained output tokens to slot ``b``'s history."""
        if not len(tokens):
            return
        row = self._np[b]
        n = int(self._len[b])
        m = min(len(tokens), row.shape[0] - n)
        if m > 0:
            row[n:n + m] = np.asarray(list(tokens)[:m], np.int32)
            self._len[b] = n + m
            self._dirty = True

    def length(self, b: int) -> int:
        return int(self._len[b])

    def device_arrays(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hist [B, S], hist_len [B]) on the device, refreshed iff dirty."""
        if self._dirty or self._dev is None:
            self._dev = (self._upload(self._np), self._upload(self._len))
            self._dirty = False
        return self._dev
