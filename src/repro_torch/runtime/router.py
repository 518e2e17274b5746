"""Per-template backend routing from measured latencies.

S2RDF picks the cheapest physical *table* per triple pattern from
statistics (paper §4/§6); this module applies the same discipline one
level up, to the execution substrate itself: whether the host engine or
the card wins is a property of the template (a short star query is all
launch overhead on the card, a large join is all bandwidth), so the
router keys on the template signature.

Lifecycle of a signature:

1. **warmup** — the first ``router_warmup`` measured executions on each
   eligible backend, round-robin (fewest-samples-first, deterministic).
   The first ``router_discard`` samples per backend are excluded from
   the latency estimate: they carry trace/compile time.
2. **measured** — traffic routes to the backend with the lowest latency
   EWMA.  A winner that degrades raises its own EWMA and loses the seat
   on a later request — no special drift machinery needed.
3. **probe** — every ``router_probe_every``-th request re-measures a
   non-winning backend (rotating), so a loser that *improved* can win
   the seat back.  Probes are real requests: the answer is correct
   either way, only its latency differs.
4. **fallback / failed** — a backend whose ``prepare`` raised, or whose
   prepared query silently fell back to the eager host path
   (``PreparedQuery.fallback``), is excluded for that signature and the
   router deterministically re-routes; routing to a device backend that
   would run eager code adds overhead and pollutes the estimates.
   Fallback exclusions are **re-admitted** every
   ``router_readmit_every`` requests: a fallback records a *coverage*
   limit of the prepared program, and coverage grows (the device path
   now compiles OPTIONAL/UNION and unbound predicates that used to bail
   out), so formerly-excluded signatures must become routable again
   without a process restart.  ``failed`` exclusions (prepare raised)
   stay permanent.

Every decision is pure bookkeeping over observed latencies — inject a
clock / scripted latencies and the whole history is reproducible.  A
copy of the reference package's module: the same observation stream
gives the same decisions, log and report.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Set, Tuple

from repro_torch.runtime.config import RuntimeConfig

__all__ = ["BackendRouter", "RouteDecision"]


@dataclass(frozen=True)
class RouteDecision:
    """One routing choice: where the request goes and why."""

    backend: str
    #: "forced" (single-backend engine), "warmup", "measured", or "probe"
    reason: str


@dataclass
class _SigState:
    """Mutable routing state of one template signature."""

    ewma_ms: Dict[str, float] = field(default_factory=dict)
    samples: Dict[str, int] = field(default_factory=dict)
    failed: Set[str] = field(default_factory=set)     # prepare raised
    fallback: Set[str] = field(default_factory=set)   # prepared eager-fellback
    requests: int = 0
    probes: int = 0
    switches: int = 0
    readmits: int = 0
    choice: Optional[str] = None
    reason: str = "warmup"


class BackendRouter:
    """Route each template signature to its measured-fastest backend.

    ``backends`` is the candidate list in priority order (ties and
    warmup rotation follow it; ``"eager"`` should come first — it is the
    backend that can never fail or fall back).  With a single candidate
    the router degenerates to a pass-through that still answers
    :meth:`peek` / :meth:`report` (so ``Engine.explain`` and
    ``runtime_report`` behave uniformly on static engines).
    """

    def __init__(self, backends: Tuple[str, ...], config: RuntimeConfig):
        if not backends:
            raise ValueError("router needs at least one backend")
        self.backends: Tuple[str, ...] = tuple(backends)
        self.config = config
        self._sigs: Dict[str, _SigState] = {}
        self.log: Deque[Dict[str, object]] = deque(
            maxlen=max(1, config.router_log_size))

    # -- state access ----------------------------------------------------------
    def _state(self, sig: str) -> _SigState:
        st = self._sigs.get(sig)
        if st is None:
            st = self._sigs[sig] = _SigState()
        return st

    def eligible(self, sig: str) -> List[str]:
        st = self._state(sig)
        out = [b for b in self.backends
               if b not in st.failed and b not in st.fallback]
        # every candidate eliminated (a pathological registration order):
        # eager semantics still demand an answer — route to the first
        # candidate anyway rather than deadlock
        return out or [self.backends[0]]

    # -- exclusion -------------------------------------------------------------
    def mark_failed(self, sig: str, backend: str) -> None:
        """``prepare`` raised on this backend for this template: never
        route there again for this signature."""
        self._state(sig).failed.add(backend)

    def mark_fallback(self, sig: str, backend: str) -> None:
        """The backend prepared this template as an eager fallback:
        routing there would measure eager latency under the wrong label."""
        self._state(sig).fallback.add(backend)

    # -- decisions -------------------------------------------------------------
    def _pick(self, sig: str, probe_ok: bool) -> RouteDecision:
        st = self._state(sig)
        elig = self.eligible(sig)
        if len(self.backends) == 1:
            return RouteDecision(self.backends[0], "forced")
        if len(elig) == 1:
            # everything else failed / fell back — deterministic fallback
            return RouteDecision(elig[0], "measured" if st.samples.get(
                elig[0]) else "warmup")
        # each backend owes `discard` compile-heavy executions plus
        # `warmup` counted ones before it can be judged
        warmup = self.config.router_warmup + self.config.router_discard
        pending = [b for b in elig if st.samples.get(b, 0) < warmup]
        if pending:
            # fewest-samples-first keeps the rotation fair and
            # deterministic under serial execution
            b = min(pending, key=lambda b: (st.samples.get(b, 0),
                                            self.backends.index(b)))
            return RouteDecision(b, "warmup")
        winner = min(elig, key=lambda b: (st.ewma_ms.get(b, float("inf")),
                                          self.backends.index(b)))
        if probe_ok:
            others = [b for b in elig if b != winner]
            if others:
                b = others[st.probes % len(others)]
                st.probes += 1
                return RouteDecision(b, "probe")
        return RouteDecision(winner, "measured")

    def decide(self, sig: str, n: int = 1) -> RouteDecision:
        """The routing decision for the next ``n`` same-signature
        requests — a micro-batch group decides ONCE, so a probe measures
        the loser on a realistic batched launch (and per-request router
        overhead stays off the batched fast path).  The request counter
        paces probing: a probe fires whenever it crosses a multiple of
        ``router_probe_every``."""
        st = self._state(sig)
        before = st.requests
        st.requests += n
        every = self.config.router_probe_every
        crossed = every > 0 and (before // every) != (st.requests // every)
        readmit = self.config.router_readmit_every
        if st.fallback and readmit > 0 and \
                (before // readmit) != (st.requests // readmit):
            # periodic coverage re-check: the next prepare of a cleared
            # backend either compiles for real now or marks it fallback
            # again — one extra prepare per window, not per request
            st.fallback.clear()
            st.readmits += 1
        d = self._pick(sig, probe_ok=crossed)
        if d.reason != "probe":
            # a switch is a *measured* change of seat — warmup rotation
            # is exploration, not a decision reversal
            if d.reason == "measured" and st.reason == "measured" and \
                    st.choice is not None and d.backend != st.choice:
                st.switches += 1
            st.choice = d.backend
            st.reason = d.reason
        return d

    def peek(self, sig: str) -> RouteDecision:
        """What :meth:`decide` would choose, without consuming a request
        (used by ``Engine.explain``)."""
        return self._pick(sig, probe_ok=False)

    # -- observations ----------------------------------------------------------
    def observe(self, sig: str, backend: str, latency_ms: float,
                reason: str = "measured", weight: int = 1) -> None:
        """Record one measured execution.  ``weight`` counts the requests
        the measurement covered (a micro-batch launch observes its
        per-request latency once, weighted by the batch)."""
        st = self._state(sig)
        n = st.samples.get(backend, 0)
        st.samples[backend] = n + 1
        self.log.append({"t": self.config.clock(), "sig": sig,
                         "backend": backend, "reason": reason,
                         "ms": latency_ms, "weight": weight})
        if n < self.config.router_discard:
            return                      # compile-heavy first sample(s)
        prev = st.ewma_ms.get(backend)
        alpha = self.config.router_alpha
        st.ewma_ms[backend] = latency_ms if prev is None else \
            (1.0 - alpha) * prev + alpha * latency_ms

    # -- observability ---------------------------------------------------------
    def estimates(self, sig: str) -> Dict[str, float]:
        """Per-backend latency EWMAs for one signature — what a routing
        decision was judged against (the trace stream attaches these to
        every ``router.decide`` event, so ``tools/trace_inspect.py`` can
        answer "why eager?" from the trace alone)."""
        st = self._sigs.get(sig)
        if st is None:
            return {}
        return {b: round(v, 4) for b, v in st.ewma_ms.items()}

    def routed_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for entry in self.log:
            b = entry["backend"]  # type: ignore[assignment]
            out[b] = out.get(b, 0) + int(entry["weight"])  # type: ignore
        return out

    def report(self) -> Dict[str, object]:
        """JSON-friendly snapshot: per-signature estimates, choices and
        exclusions, plus the tail of the decision log."""
        sigs = {}
        for sig, st in self._sigs.items():
            sigs[sig] = {
                "choice": st.choice,
                "reason": st.reason,
                "requests": st.requests,
                "probes": st.probes,
                "switches": st.switches,
                "readmits": st.readmits,
                "ewma_ms": {b: round(v, 4) for b, v in st.ewma_ms.items()},
                "samples": dict(st.samples),
                "failed": sorted(st.failed),
                "fallback": sorted(st.fallback),
            }
        return {"backends": list(self.backends), "signatures": sigs,
                "decisions": list(self.log)}
