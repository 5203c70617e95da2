"""Per-request replay journal: the router's failover-resume memory (port of
``paddle_tpu/router/journal.py``).

Without it an unplanned replica death mid-stream can only terminate the
client's SSE stream with a synthesized ``finish_reason: "error"``.  With it,
for every proxied completion the router keeps the prompt ids, the emitted
token ids it has actually relayed to the client, the declared budget and the
``X-Session-Id``: everything needed to RE-PLAY the session on a survivor as
a prefill (cheap when the survivor holds the prefix, which drain migration
arranges) and keep emitting from the next token.  Greedy sessions replay
bit-exactly, so the client's stream is unbroken and identical to a no-fault
run.  The same entry carries a disaggregated handoff: the prefill leg's
capped body (``capped_body``) and the decode leg's replay (``resume_body``).

Bounded on both axes: ``FLAGS_router_journal_cap`` entries (LRU: an evicted
entry's stream falls back to the synthesized-error contract) and
``FLAGS_router_journal_max_tokens`` emitted tokens per entry (an over-long
stream is marked non-resumable rather than growing without bound).
"""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import List, Optional, Sequence

from .. import flags
from .. import observability as _obs

__all__ = ["JournalEntry", "SessionJournal"]


class JournalEntry:
    """One in-flight proxied request's replay state."""

    __slots__ = ("trace_id", "session_id", "prompt", "emitted",
                 "max_tokens", "payload", "resumable", "resumes",
                 "sampling")

    def __init__(self, trace_id: str, session_id: Optional[str],
                 prompt: Sequence[int], payload: dict,
                 max_tokens: Optional[int]):
        self.trace_id = trace_id
        self.session_id = session_id
        self.prompt = list(prompt)
        self.emitted: List[int] = []
        self.payload = payload
        self.max_tokens = max_tokens
        # replay needs the prompt ids; an unparseable prompt was placed
        # by load only and cannot be resumed
        self.resumable = bool(self.prompt)
        self.resumes = 0                 # times this entry resumed
        # the serving replica's advertised sampling config, stamped at
        # dispatch: resume eligibility is no longer
        # greedy-only — a survivor with the IDENTICAL seeded positional
        # sampling config replays bit-exactly too
        self.sampling: Optional[dict] = None

    @property
    def full_tokens(self) -> List[int]:
        """Prompt + every token the client has received: the replay
        prefill."""
        return self.prompt + self.emitted

    def remaining(self) -> Optional[int]:
        """Budget left after the emitted tokens; None when the request
        did not declare ``max_tokens`` (the replica default is unknown
        to the router, so a stream resume cannot bound itself)."""
        if self.max_tokens is None:
            return None
        return self.max_tokens - len(self.emitted)

    def resume_body(self) -> bytes:
        """The replay request: the original payload with the full token
        history as prompt and the remaining budget as max_tokens."""
        doc = dict(self.payload)
        doc["prompt"] = self.full_tokens
        doc["max_tokens"] = max(1, self.remaining() or 1)
        return json.dumps(doc).encode()

    def capped_body(self, max_tokens: int) -> bytes:
        """The prefill leg of a disaggregated handoff: the
        original request with its budget capped — the prefill replica
        emits exactly ``max_tokens`` token(s) and frees its slot; the
        journal carries the rest to a decode successor via
        :meth:`resume_body`."""
        doc = dict(self.payload)
        doc["prompt"] = list(self.prompt)
        doc["max_tokens"] = int(max_tokens)
        return json.dumps(doc).encode()


class SessionJournal:
    """LRU-bounded map of trace id -> :class:`JournalEntry`."""

    def __init__(self, cap: Optional[int] = None,
                 max_tokens: Optional[int] = None):
        f = flags.flag
        self.cap = int(f("router_journal_cap") if cap is None else cap)
        self.max_tokens = int(f("router_journal_max_tokens")
                              if max_tokens is None else max_tokens)
        self._entries: "OrderedDict[str, JournalEntry]" = OrderedDict()
        m = _obs.metrics
        self._evictions = m.counter("router.journal_evictions")
        self._size = m.gauge("router.journal_entries")

    def __len__(self) -> int:
        return len(self._entries)

    def begin(self, trace_id: str, session_id: Optional[str],
              prompt: Sequence[int], payload: dict) -> JournalEntry:
        mt = payload.get("max_tokens")
        if not isinstance(mt, int) or isinstance(mt, bool) or mt < 1:
            mt = None
        e = JournalEntry(trace_id, session_id, prompt, payload, mt)
        self._entries[trace_id] = e
        self._entries.move_to_end(trace_id)
        while len(self._entries) > self.cap:
            _, old = self._entries.popitem(last=False)
            old.resumable = False        # evicted: synthesized-error contract applies
            self._evictions.inc()
        self._size.set(len(self._entries))
        return e

    def record(self, entry: JournalEntry,
               token_ids: Sequence[int]) -> None:
        """Append tokens the client has actually received.  Overflow
        past the per-entry cap marks the entry non-resumable AND stops
        recording (bounded memory beats a replay nobody sized for — a
        100k-token stream must not journal 100k ids)."""
        if not entry.resumable:
            return
        entry.emitted.extend(int(t) for t in token_ids)
        if len(entry.emitted) > self.max_tokens:
            entry.resumable = False
            entry.emitted.clear()        # replay is off: release the ids

    def finish(self, entry: Optional[JournalEntry]) -> None:
        if entry is None:
            return
        self._entries.pop(entry.trace_id, None)
        self._size.set(len(self._entries))
