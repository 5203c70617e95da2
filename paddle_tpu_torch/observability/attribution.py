"""Per-phase engine step cost attribution (port of
``paddle_tpu/observability/attribution.py``).

Every engine dispatch is one of a few program shapes: a prefill chunk at
T=prefill_bucket, a decode step at T=1, a speculative verify at T=K, a
fused K-step decode, a copy-on-write page copy, or the drain's
host<->device transfer.  Each dispatch's host-stamped wall time and token
count fold into

- ``serving.step_ms{phase=...}``: per-phase dispatch-to-dispatch wall time
  histograms (they converge to the true step time in any steady loop whose
  caller drains), and
- ``serving.tokens_per_sec{phase=...}``: per-phase throughput of the last
  drained window,

plus per-(phase, bucket) EWMA baselines (mean and absolute deviation) that
the regression sentinel and ``/statusz`` read.

Overhead: ``stamp()`` is one list append on the step path; every duration,
histogram observe and EWMA fold happens in ``fold()`` at the engine's
existing drain.  Nothing here reads a device tensor.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from .. import flags
from . import metrics as _metrics

__all__ = ["StepAttribution", "Ewma", "PHASES"]

# the closed phase vocabulary (also the bounded label set of step_ms)
PHASES = ("prefill", "decode", "spec_verify", "fused_k", "cow_copy",
          "drain")

# step_ms bucket ladder: finer than the default one in the 0.1 ms .. 1 s
# band where engine dispatches live
_STEP_BOUNDS = (0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                100.0, 200.0, 500.0, 1000.0, 2000.0, 5000.0, 10000.0)


class Ewma:
    """EWMA mean and EWMA absolute deviation of one scalar series: the
    baseline recurrence shared by the cost table and the sentinel's drift
    detectors."""

    __slots__ = ("mean", "dev", "n", "alpha")

    def __init__(self, alpha: float):
        self.mean = 0.0
        self.dev = 0.0
        self.n = 0
        self.alpha = alpha

    def update(self, v: float) -> None:
        if self.n == 0:
            self.mean = v
        else:
            a = self.alpha
            self.dev = (1 - a) * self.dev + a * abs(v - self.mean)
            self.mean = (1 - a) * self.mean + a * v
        self.n += 1


class StepAttribution:
    """Fold per-dispatch stamps into per-phase registry series.

    Engine wiring::

        attr.stamp(phase, bucket, t_dispatch, tokens)   # per step: append
        attr.credit_tokens("spec_verify", n_committed)  # at the drain
        attr.fold(t_drain_start)                        # at the drain
        attr.observe_host("drain", drain_seconds)       # timed host block

    Durations are dispatch-to-dispatch: stamp ``i`` costs the gap to stamp
    ``i+1`` (the window's last stamp closes against the drain's entry), so
    an asynchronous dispatch's cost lands where the host waited for it.
    Token counts known only at the drain (the speculative lanes' commit
    counts) arrive through ``credit_tokens`` before the fold."""

    def __init__(self, registry=_metrics.REGISTRY,
                 alpha: Optional[float] = None):
        self._alpha = float(flags.flag("sentinel_alpha")
                            if alpha is None else alpha)
        self._step_ms = {}
        self._tps = {}
        for phase in PHASES:
            self._step_ms[phase] = registry.histogram(
                "serving.step_ms", bounds=_STEP_BOUNDS, phase=phase)
            self._tps[phase] = registry.gauge(
                "serving.tokens_per_sec", phase=phase)
        self._baselines: Dict[Tuple[str, int], Ewma] = {}
        # (phase, bucket, t_dispatch, tokens) since the last fold
        self._pending: List[tuple] = []
        self._credits: Dict[str, int] = {}

    # ------------------------------------------------------------ hot path
    def stamp(self, phase: str, bucket: int, t: Optional[float] = None,
              tokens: int = 0) -> None:
        """Record one dispatch (one append; the arithmetic waits for
        ``fold``)."""
        self._pending.append(
            (phase, bucket, time.perf_counter() if t is None else t,
             tokens))

    # ------------------------------------------------------------- drain
    def credit_tokens(self, phase: str, tokens: int) -> None:
        """Attribute token counts resolved at the drain."""
        if tokens:
            self._credits[phase] = self._credits.get(phase, 0) + tokens

    def fold(self, t_end: Optional[float] = None) -> None:
        """Fold the window: dispatch-to-dispatch durations into the
        per-phase histograms and baselines, the window's throughput into
        the per-phase gauges.  Called at the drain only."""
        pending = self._pending
        if not pending:
            self._credits.clear()
            return
        self._pending = []
        t_end = time.perf_counter() if t_end is None else t_end
        dur: Dict[str, float] = {}
        tok: Dict[str, int] = {}
        for i, (phase, bucket, t, tokens) in enumerate(pending):
            t_next = pending[i + 1][2] if i + 1 < len(pending) else t_end
            dt_ms = max(t_next - t, 0.0) * 1e3
            self._step_ms[phase].observe(dt_ms)
            base = self._baselines.get((phase, bucket))
            if base is None:
                base = self._baselines[(phase, bucket)] = \
                    Ewma(self._alpha)
            base.update(dt_ms)
            dur[phase] = dur.get(phase, 0.0) + dt_ms
            if tokens:
                tok[phase] = tok.get(phase, 0) + tokens
        for phase, n in self._credits.items():
            tok[phase] = tok.get(phase, 0) + n
        self._credits.clear()
        # every phase's gauge is THIS window's: an idle phase drops to 0
        for phase in PHASES:
            n = tok.get(phase, 0)
            ms = dur.get(phase, 0.0)
            self._tps[phase].set(n * 1e3 / ms if n and ms > 0 else 0.0)

    def observe_host(self, phase: str, dur_s: float,
                     tokens: int = 0) -> None:
        """Attribute a host block timed directly (the drain's transfer is
        blocking, so its duration is known where it ran)."""
        ms = max(dur_s, 0.0) * 1e3
        self._step_ms[phase].observe(ms)
        base = self._baselines.get((phase, 0))
        if base is None:
            base = self._baselines[(phase, 0)] = Ewma(self._alpha)
        base.update(ms)
        if tokens and ms > 0:
            self._tps[phase].set(tokens * 1e3 / ms)

    # ------------------------------------------------------------- export
    def baselines(self) -> Dict[str, dict]:
        """Per-(phase, bucket) EWMA cost table for /statusz and the
        sentinel: ``{"decode/T1": {"ewma_ms", "dev_ms", "n"}, ...}``."""
        return {f"{phase}/T{bucket}": {"ewma_ms": round(b.mean, 4),
                                       "dev_ms": round(b.dev, 4),
                                       "n": b.n}
                for (phase, bucket), b in
                sorted(dict(self._baselines).items())}
