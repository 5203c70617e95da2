"""Cross-replica KV session migration (port of
``paddle_tpu/inference/migration.py``).

A session's KV becomes a transferable artifact:

- **Export** serializes a session's pages exactly as the pool stores them:
  int8 page bytes with their fp32 absmax scale rows (a migration moves
  quantized bytes, never a dequantize round trip), float pools their raw
  rows.  An in-flight session exports the full pages its block table
  covers (one marked host<->device readback a page, on the control path);
  a *parked* session (between turns, its history in the prefix-cache
  index) exports its radix chain, and a spilled chain node ships its
  pinned host-ring bytes directly, with no swap-in.
- **Import** installs pages on the successor through the existing seams:
  ``PageAllocator.acquire_page()`` (which reclaims idle cached pages under
  pressure, so an import can evict but never deadlock), one copy a plane
  into the page through ``PagedKVCache.install_page`` on the current
  stream (as the spill tier swaps a page in), then a READY idle
  prefix-cache node.  The resumed
  request (``resume=True``) admits with a near-full prefix hit: only the
  partial-page tail (and the final token's copy-on-write re-prefill)
  computes.
- **Abort safety**: a transfer interrupted at any point leaves no
  allocator reference behind: pages already linked are complete cache
  entries, the one in-flight page is released, and a truncated snapshot
  imports a shorter, still contiguous chain.

The wire codec (``to_wire``/``from_wire``) is JSON with base64 plane
payloads, the reference's format byte for byte: a plane is ``{"dtype",
"shape", "b64"}`` with the dtype named as numpy names it (``"bfloat16"``,
``"float32"``, ``"int8"``), so snapshots cross between the two packages and
hash to the same ``snapshot_digest``.  Live planes are CPU tensors; a bf16
plane is encoded and hashed from its raw bytes.  Planes are host-global
under tensor parallelism (every shard's heads, joined in shard order), so
a snapshot and its digest are the same at any shard count, and an import
re-shards.

Export and import run on the engine's thread (the server's
``run_on_engine``), between steps; the codec touches no engine state, so
the server decodes an import body on a worker thread first.  An import
installs pages with plain tensor copies and builds no kernel, so it needs
no warm-up.  What a bad snapshot raises
(``MigrationError``, ``KeyError``, ``ValueError``, a decode error) is
isolated per session by the bulk paths; an error from a device copy
propagates.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import observability as _obs

__all__ = ["MigrationError", "export_session", "export_all",
           "import_session", "import_sessions", "record_handoff",
           "to_wire", "from_wire", "snapshot_digest", "SNAP_VERSION"]

SNAP_VERSION = 1

# plane dtype names on the wire (numpy's names, the reference's format)
_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
           torch.float16: "float16", torch.int8: "int8"}
_TORCH = {v: k for k, v in _DTYPES.items()}


class MigrationError(RuntimeError):
    """A snapshot this engine cannot produce or install (geometry or dtype
    mismatch, prefix cache off, unknown session, failed integrity
    check)."""


# what a bad snapshot raises: isolated per session by the bulk paths (an
# error from a device copy is none of these and propagates)
SNAPSHOT_ERRORS = (MigrationError, KeyError, ValueError, TypeError,
                   IndexError, MemoryError, binascii.Error)


class _MigrationMetrics:
    """Registry handles, resolved once per process."""

    _instance = None

    def __init__(self):
        m = _obs.metrics
        self.exports = m.counter("serving.kv.migration_exports")
        self.imports = m.counter("serving.kv.migration_imports")
        self.pages_out = m.counter("serving.kv.migration_pages",
                                   direction="out")
        self.pages_in = m.counter("serving.kv.migration_pages",
                                  direction="in")
        self.aborts = m.counter("serving.kv.migration_aborts")
        self.rejected = m.counter("serving.kv.migration_rejected")
        # outcome is one of two literals: a bounded label set
        self.handoff_sessions = lambda o: m.counter(
            "serving.kv.handoff_sessions", outcome=o)
        self.handoff_reprefill = m.counter(
            "serving.kv.handoff_reprefill_tokens")

    @classmethod
    def get(cls) -> "_MigrationMetrics":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance


def record_handoff(sessions: Sequence[dict], result: dict) -> None:
    """Account one prefill->decode handoff import: compare the full pages
    the shipped snapshots cover with the pages this import installed (or
    found indexed) and count the shortfall as re-prefill debt.
    ``sessions`` are wire snapshots; ``result`` the bulk import totals."""
    mm = _MigrationMetrics.get()
    full_pages = 0
    page = 0
    for s in sessions:
        geo = s.get("geometry") or {}
        page = int(geo.get("page_size", 0) or 0) or page
        toks = s.get("tokens") or ()
        if page > 0:
            full_pages += len(toks) // page
    covered = int(result.get("imported", 0)) + \
        int(result.get("skipped", 0))
    short = max(0, full_pages - covered)
    n = int(result.get("sessions", len(sessions)))
    mm.handoff_sessions("ok" if short == 0 else "partial").inc(n)
    if short and page > 0:
        mm.handoff_reprefill.inc(short * page)


def _engine_counts(engine) -> Dict[str, int]:
    mc = getattr(engine, "_migration_counts", None)
    if mc is None:
        mc = {"migration_exports": 0, "migration_imports": 0,
              "migration_exported_pages": 0, "migration_imported_pages": 0,
              "migration_aborts": 0, "migration_rejected": 0}
        engine._migration_counts = mc
    return mc


# ---------------------------------------------------------------------------
# geometry / codec
# ---------------------------------------------------------------------------

def _geometry(engine) -> Dict[str, object]:
    cache = engine.g.cache
    return {"layers": cache.num_layers,
            "kv_heads": cache.num_kv_heads,
            "page_size": cache.page_size,
            "head_dim": cache.head_dim,
            "dtype": "int8" if cache.quantized else _DTYPES[cache.kv_dtype]}


def _check_geometry(engine, snap: dict) -> None:
    mine = _geometry(engine)
    theirs = snap.get("geometry")
    if theirs != mine:
        raise MigrationError(
            f"snapshot geometry {theirs} does not match this engine's "
            f"{mine}; migration moves raw pool bytes and cannot convert")


def _page_planes(engine, page_id: int) -> Tuple[torch.Tensor, ...]:
    """One pool page's host-global planes as fresh CPU tensors (``[L, kvh,
    page, d]`` for K and V, ``[L, kvh]`` for the int8 scales).  The
    readback is a marked intentional sync on the migration path."""
    _obs.count_sync()
    return engine.g.cache.page_planes(page_id, device="cpu")


def _plane_label(p) -> str:
    if isinstance(p, torch.Tensor):
        return _DTYPES[p.dtype]
    return str(p.dtype)


def _plane_bytes(p) -> bytes:
    """A plane's raw bytes: a CPU tensor's (bf16 by its 16-bit patterns)
    or a numpy array's."""
    if isinstance(p, torch.Tensor):
        p = p.contiguous()
        if p.dtype == torch.bfloat16:
            p = p.view(torch.int16)
        return p.numpy().tobytes()
    return np.ascontiguousarray(p).tobytes()


def _encode_planes(planes) -> List[dict]:
    return [{"dtype": _plane_label(p), "shape": list(p.shape),
             "b64": base64.b64encode(_plane_bytes(p)).decode("ascii")}
            for p in planes]


def _decode_plane(p: dict) -> torch.Tensor:
    dtype = _TORCH.get(p["dtype"])
    if dtype is None:
        raise MigrationError(f"unknown plane dtype {p['dtype']!r}")
    raw = bytearray(base64.b64decode(p["b64"], validate=True))
    shape = [int(n) for n in p["shape"]]
    size = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    if len(raw) != size:
        raise MigrationError(f"plane of {len(raw)} bytes does not hold "
                             f"{p['dtype']} {shape}")
    return torch.frombuffer(raw, dtype=dtype).reshape(shape)


def _decode_planes(planes) -> Tuple[torch.Tensor, ...]:
    """Accept live planes (CPU tensors, or numpy arrays of a numpy dtype)
    or their wire encoding (``{"dtype", "shape", "b64"}`` dicts)."""
    out = []
    for p in planes:
        if isinstance(p, torch.Tensor):
            out.append(p)
        elif isinstance(p, np.ndarray):
            out.append(torch.from_numpy(np.ascontiguousarray(p)))
        else:
            out.append(_decode_plane(p))
    return tuple(out)


def snapshot_digest(snap: dict) -> str:
    """Canonical blake2b digest of a snapshot's content: version, tokens,
    and every page's index and source plus each plane's dtype, shape and
    raw bytes.  The same value whether the planes are live or
    wire-encoded, and the same as the reference's for the same bytes, so a
    digest stamped at export survives the codec and any corruption or
    truncation on the way is caught at import."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"v{snap.get('version')}".encode())
    h.update(b"|t")
    h.update(",".join(str(int(t)) for t in snap.get("tokens", ()))
             .encode())
    pages = sorted(snap.get("pages", ()), key=lambda p: int(p["index"]))
    for pg in pages:
        h.update(f"|p{int(pg['index'])}:{pg.get('source', '')}"
                 .encode())
        for plane in pg["planes"]:
            if isinstance(plane, dict):
                label, shape = plane["dtype"], [int(n) for n in
                                                plane["shape"]]
                raw = base64.b64decode(plane["b64"])
            else:
                label, shape = _plane_label(plane), list(plane.shape)
                raw = _plane_bytes(plane)
            h.update(f"{label}{shape}".encode())
            h.update(raw)
    return h.hexdigest()


def to_wire(snap: dict) -> dict:
    """A JSON-serializable copy of a snapshot (planes base64-encoded),
    stamped with its ``digest`` when it has none."""
    out = dict(snap)
    if "digest" not in out:
        out["digest"] = snapshot_digest(snap)
    out["pages"] = [{**pg, "planes": _encode_planes(pg["planes"])}
                    for pg in snap["pages"]]
    return out


def from_wire(snap: dict) -> dict:
    """Decode a wire snapshot back to live CPU-tensor planes (idempotent
    on a live snapshot)."""
    out = dict(snap)
    out["pages"] = [{**pg, "planes": _decode_planes(pg["planes"])}
                    for pg in snap.get("pages", ())]
    return out


def _sampling(engine) -> dict:
    gc = engine.gen_cfg
    return {"do_sample": bool(gc.do_sample), "seed": int(gc.seed),
            "temperature": float(gc.temperature), "top_k": int(gc.top_k),
            "top_p": float(gc.top_p), "positional": True}


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def export_session(engine, req_id: Optional[int] = None,
                   tokens: Optional[Sequence[int]] = None) -> dict:
    """Serialize one session's KV as a migration snapshot.

    ``req_id``: an IN-FLIGHT request.  Its pages come from its block table
    (the full pages its write cursor has covered), its tokens are prompt +
    drained output, and the snapshot carries the remaining budget so the
    successor resumes at the exact token offset.  Drains the pending window
    first, so the books are current.

    ``tokens``: a PARKED session.  Its pages come from the prefix-cache
    chain matching the tokens; spilled nodes ship their host-ring bytes.
    """
    if (req_id is None) == (tokens is None):
        raise ValueError("export_session takes exactly one of "
                         "req_id= or tokens=")
    mm = _MigrationMetrics.get()
    snap = {"version": SNAP_VERSION, "geometry": _geometry(engine),
            "pages": []}
    page = engine.g.page_size
    if req_id is not None:
        if engine._pending:
            engine._drain()
        slot = next((b for b in range(engine.B)
                     if engine.slot_req[b] is not None
                     and engine.slot_req[b].req_id == req_id), None)
        if slot is None:
            raise MigrationError(f"request {req_id} is not in-flight")
        req = engine.slot_req[slot]
        # positions: tokens whose KV is written (the device's write cursor;
        # the last emitted token's KV is always pending)
        _obs.count_sync()
        n_ctx = int(engine.positions[slot])
        toks = list(req.prompt) + list(req.output)
        n_full = min(n_ctx, len(toks)) // page
        pages = engine.g.cache.allocator.page_list(req_id)[:n_full]
        for i, pid in enumerate(pages):
            snap["pages"].append({"index": i, "source": "device",
                                  "planes": _page_planes(engine, pid)})
        snap.update(tokens=toks, prompt_len=len(req.prompt),
                    emitted=list(req.output),
                    max_new_tokens=req.max_new_tokens,
                    n_ctx=n_ctx, trace_id=req.trace_id)
    else:
        cache = engine.prefix_cache
        if cache is None:
            raise MigrationError("token-chain export needs the prefix "
                                 "cache (FLAGS_prefix_cache)")
        toks = [int(t) for t in tokens]
        for i, node in enumerate(cache.chain(toks)):
            if node.spill is not None:
                # the bytes already live in the pinned ring: ship them
                planes = tuple(p.clone() for p in
                               engine.spill.peek(node.spill))
                snap["pages"].append({"index": i, "source": "spill",
                                      "planes": planes})
            elif node.ready:
                snap["pages"].append({"index": i, "source": "device",
                                      "planes": _page_planes(engine,
                                                             node.page)})
            else:
                break                # pending: its producer still writes
        n_full = len(snap["pages"])
        snap.update(tokens=toks, prompt_len=len(toks), emitted=[],
                    max_new_tokens=0, n_ctx=n_full * page, trace_id=None)
    # the sampling config: draws are positional (a pure function of seed
    # and token index), so an identical config resumes the sampled stream
    # from the exact offset
    snap["sampling"] = _sampling(engine)
    snap["digest"] = snapshot_digest(snap)
    mm.exports.inc()
    mm.pages_out.inc(len(snap["pages"]))
    mc = _engine_counts(engine)
    mc["migration_exports"] += 1
    mc["migration_exported_pages"] += len(snap["pages"])
    return snap


def export_all(engine) -> List[dict]:
    """Snapshot every in-flight session (the drain-migration bulk path).
    A session whose export fails as a bad request is counted and
    skipped."""
    if engine._pending:
        engine._drain()
    snaps = []
    for b in range(engine.B):
        req = engine.slot_req[b]
        if req is None or req.done:
            continue
        try:
            snaps.append(export_session(engine, req_id=req.req_id))
        except SNAPSHOT_ERRORS:
            _MigrationMetrics.get().aborts.inc()
            _engine_counts(engine)["migration_aborts"] += 1
    return snaps


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------

def _check_planes(engine, planes) -> None:
    shapes = engine.g.cache.page_shapes()
    if len(planes) != len(shapes):
        raise MigrationError(f"page has {len(planes)} planes, the pool "
                             f"{len(shapes)}")
    for p, (want, dt) in zip(planes, shapes):
        if tuple(p.shape) != want or p.dtype != dt:
            raise MigrationError(f"plane {p.dtype} {tuple(p.shape)} does "
                                 f"not fit the pool's {dt} {want}")


def _install_page(engine, page_id: int, planes) -> None:
    """Copy one page's planes into pool page ``page_id`` on the current
    stream.  The source is pageable host memory, so each copy is a
    blocking one (a marked sync): the host buffer is consumed before the
    call returns, and stream order puts the page ahead of any later step's
    read."""
    _obs.count_sync()
    engine.g.cache.install_page(page_id, planes)


def import_session(engine, snap: dict, resume: bool = False) -> dict:
    """Install one snapshot's pages into this engine's prefix-cache index.
    Each page either already exists on the chain (skipped) or is acquired
    fresh (``acquire_page`` reclaims idle cached pages under pressure),
    copied in, and indexed as a READY idle node.  On a failure mid-transfer
    the in-flight page's reference is released and the pages already
    linked stay as valid cache entries.

    ``resume=True`` also submits the continuation (the full token history
    as the prompt, the remaining budget as max_new_tokens): its admission
    rides the imported chain.  Returns ``{"imported", "skipped", "pages",
    "resume_req_id"}``."""
    cache = engine.prefix_cache
    if cache is None:
        raise MigrationError("import needs the prefix cache "
                             "(FLAGS_prefix_cache) on the successor")
    if snap.get("version") != SNAP_VERSION:
        raise MigrationError(f"unknown snapshot version "
                             f"{snap.get('version')!r}")
    _check_geometry(engine, snap)
    mm = _MigrationMetrics.get()
    mc = _engine_counts(engine)
    snap = from_wire(snap)           # decode the planes once
    want = snap.get("digest")
    if want is not None and snapshot_digest(snap) != want:
        # corrupt or truncated: rejected before the allocator is touched
        mm.rejected.inc()
        mc["migration_rejected"] += 1
        raise MigrationError(
            "snapshot integrity digest mismatch: the transfer was "
            "corrupted or truncated in flight; nothing was installed")
    alloc = engine.g.cache.allocator
    page = engine.g.page_size
    toks = [int(t) for t in snap["tokens"]]
    imported = skipped = 0
    node = None                      # None = chain root
    pages = sorted(snap.get("pages", ()), key=lambda p: int(p["index"]))
    try:
        for pg in pages:
            i = int(pg["index"])
            if i != imported + skipped:
                break                # non-contiguous: the chain ends
            key = tuple(toks[i * page:(i + 1) * page])
            if len(key) < page:
                break
            parent = node if node is not None else cache._root
            child = parent.children.get(key)
            if child is not None:
                node = child         # already indexed: keep walking
                skipped += 1
                continue
            planes = pg["planes"]
            _check_planes(engine, planes)
            pid = alloc.acquire_page()
            try:
                _install_page(engine, pid, planes)
                node = cache.install_node(node, key, pid)
            except BaseException:
                # the one in-flight page: give its reference back
                alloc.release_page(pid)
                raise
            imported += 1
    except Exception:
        mm.aborts.inc()
        mc["migration_aborts"] += 1
        mm.pages_in.inc(imported)
        mc["migration_imported_pages"] += imported
        raise
    mm.imports.inc()
    mm.pages_in.inc(imported)
    mc["migration_imports"] += 1
    mc["migration_imported_pages"] += imported
    out = {"imported": imported, "skipped": skipped,
           "pages": len(pages), "resume_req_id": None}
    remaining = int(snap.get("max_new_tokens", 0) or 0) \
        - len(snap.get("emitted") or ())
    if resume and remaining >= 1:
        samp = snap.get("sampling")
        if isinstance(samp, dict) and samp.get("do_sample") \
                and _sampling(engine) != samp:
            # a sampled stream resumes seed for seed only under the
            # exporter's exact config: keep the pages, skip the
            # continuation rather than fork the stream
            out["resume_skipped"] = "sampling-mismatch"
            return out
        req = engine.submit(toks, max_new_tokens=remaining,
                            trace_id=snap.get("trace_id"))
        out["resume_req_id"] = req.req_id
    return out


def import_sessions(engine, snaps: Sequence[dict],
                    resume: bool = False) -> dict:
    """Bulk import with per-snapshot isolation (the drain-migration receive
    path): a malformed, corrupt or oversized snapshot counts as aborted and
    the rest still install."""
    total = {"sessions": 0, "imported": 0, "skipped": 0, "aborted": 0}
    for snap in snaps:
        try:
            r = import_session(engine, snap, resume=resume)
        except SNAPSHOT_ERRORS:
            total["aborted"] += 1
            continue
        total["sessions"] += 1
        total["imported"] += r["imported"]
        total["skipped"] += r["skipped"]
    return total
