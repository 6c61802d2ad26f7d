"""Admission control / backpressure for the multi-DAG workload engine.

Role
----
The paper's schedulers assume every admitted DAG deserves resources; a
multi-tenant pool serving online arrival streams cannot — one tenant's
burst would blow every other tenant's sojourn latency.  This module is the
pluggable gate that sits *between* `Workload` arrival generation and
``SchedulerCore.admit``: each ``DagArrival`` is presented to an
:class:`AdmissionGate`, which answers admit / delay / reject.  Both
execution vehicles (:meth:`repro.core.simulator.Simulator.run_workload`
and :meth:`repro.core.runtime.ThreadedRuntime.run_workload`) route
arrivals through the same gate object, so sim and threaded runs of one
stream stay comparable.  Extending the adaptive-threshold idea of
arXiv:1905.00673 from *where* a TAO runs to *whether/when* a DAG enters
at all, the gate is policy-pluggable (arXiv:1711.06433 argues against
hard-coding one heuristic for heterogeneous platforms):

* ``none``         — :class:`NoAdmission`: admit everything immediately
                     (the pre-admission seed behavior, and the default).
* ``token-bucket`` — :class:`TokenBucketGate`: per-tenant rate + burst
                     caps; arrivals beyond the burst are delayed until
                     their reserved token refills, or rejected once the
                     required wait exceeds ``max_delay``.
* ``slo-adaptive`` — :class:`SloAdaptiveGate`: tracks per-tenant sojourn
                     EWMAs against a declared SLO and delays/rejects new
                     DAGs of a tenant whose p99 estimate degraded (or who
                     dominates an overloaded pool), releasing queued DAGs
                     as the pool's in-flight load drains.

Empty DAGs (zero TAOs) bypass the gate on both vehicles: they consume no
resources and are "done" on arrival, so charging tokens or delaying them
would only skew accounting.

Gate feedback to preemption: a DELAY verdict is the gate saying "this
tenant is harming the pool right now" — both vehicles forward it to the
optional :class:`~repro.core.preemption.PreemptionController`
(``on_gate_feedback``), which may then displace that tenant's *running*
TAOs at chunk boundaries: the admission layer throttles arrivals, the
preemption layer drains the in-flight work that got them throttled.

Thread-safety contract
----------------------
``decide`` / ``on_admit`` / ``on_reject`` are only ever called from a
single admission context at a time (the simulator event loop, or the
threaded runtime's admitter thread) — they need no internal locking for
that path.  ``on_dag_done`` however is invoked from *worker threads* on
the threaded vehicle, concurrently with ``decide``; gates that read
completion statistics inside ``decide`` (``slo-adaptive``) therefore
guard their mutable statistics with ``self._lock``.  Gates are NOT
shareable across concurrently-running workloads: one gate == one stream.

Determinism / parity invariants
-------------------------------
:class:`TokenBucketGate` decisions are a pure function of the arrival
*trace* (``AdmissionRequest.arrival`` timestamps, evaluated in arrival
order) — ``now`` is deliberately ignored — so a fixed trace produces
byte-identical admit/delay/reject decisions on the simulator (virtual
time) and the threaded runtime (wall-clock jitter included), and a seeded
random stream gates identically run after run.  :class:`SloAdaptiveGate`
feeds on *observed* sojourns, which are vehicle-dependent by nature; its
decisions are deterministic on the simulator and best-effort on threads.
"""
from __future__ import annotations

import dataclasses
import math
import threading

ADMIT = "admit"
DELAY = "delay"
REJECT = "reject"


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """Verdict of one gate evaluation.

    ``retry_at`` is only meaningful for ``DELAY``: the earliest time (same
    clock as ``now`` handed to :meth:`AdmissionGate.decide`) at which the
    vehicle re-presents the request.  ``reason`` is a short human string
    surfaced by benchmarks/examples, never parsed.  ``dominant`` is the
    structured signal the preemption layer keys on: ``True`` when the
    verdict was driven by the tenant *dominating the pool's backlog*
    (it is harming others), ``False`` when the tenant is merely degraded
    itself — only dominance-throttled tenants are eligible for
    running-work displacement.
    """

    action: str
    retry_at: float = 0.0
    reason: str = ""
    dominant: bool = False


_ADMIT_NOW = AdmissionDecision(ADMIT)


@dataclasses.dataclass
class AdmissionRequest:
    """One DAG asking to enter the system (vehicles build one per arrival).

    ``arrival`` is the stream timestamp (``DagArrival.at``), NOT the time
    of the current evaluation; ``attempts`` counts prior DELAY verdicts so
    gates can distinguish a fresh arrival from a queued re-presentation.
    """

    dag_id: int
    tenant: str
    n_taos: int
    arrival: float
    attempts: int = 0


@dataclasses.dataclass(frozen=True)
class LoadSignals:
    """Scheduler-side load snapshot gates may read (one per evaluation).

    Produced by :meth:`repro.core.scheduler.SchedulerCore.admission_signals`;
    every field is internally consistent (taken under the core lock).
    """

    in_flight: int          # ready+running TAOs across all namespaces
    active_namespaces: int  # DAG namespaces with >= 1 ready/running TAO
    n_workers: int          # *surviving* capacity (dead workers subtracted)
    completed: int          # TAOs committed so far this run
    n_failed: int = 0       # workers currently dead (chaos KILL)


class AdmissionGate:
    """Base gate: the interface both execution vehicles drive."""

    name = "abstract"

    def decide(self, req: AdmissionRequest, now: float,
               signals: LoadSignals) -> AdmissionDecision:
        raise NotImplementedError

    # -- lifecycle callbacks (default no-ops) -------------------------------
    def on_admit(self, req: AdmissionRequest, now: float) -> None:
        """The vehicle committed to executing this DAG."""

    def on_reject(self, req: AdmissionRequest, now: float) -> None:
        """The vehicle dropped this DAG (it will never execute)."""

    def on_dag_done(self, tenant: str, sojourn: float, now: float,
                    n_taos: int = 0) -> None:
        """A DAG of ``tenant`` (``n_taos`` TAOs) completed with the given
        sojourn.

        On the threaded vehicle this arrives from worker threads —
        implementations that also read the fed state in ``decide`` must
        lock (see the module docstring's thread-safety contract)."""

    def reset(self) -> None:
        """Clear per-stream state so one gate instance can be reused."""


class NoAdmission(AdmissionGate):
    """Seed behavior: every arrival is admitted the moment it occurs."""

    name = "none"

    def decide(self, req: AdmissionRequest, now: float,
               signals: LoadSignals) -> AdmissionDecision:
        return _ADMIT_NOW


class TokenBucketGate(AdmissionGate):
    """Per-tenant token bucket: ``rate`` DAGs/s sustained, ``burst`` cap.

    Each tenant owns an independent bucket holding at most ``burst``
    tokens, refilled continuously at ``rate``; admitting a DAG costs one
    token.  An arrival finding the bucket empty *reserves* the next token
    (the level goes negative, queueing later arrivals FIFO behind it) and
    is delayed until its reservation refills — unless that wait exceeds
    ``max_delay``, in which case it is rejected without charging the
    bucket.  A re-presented request (``attempts > 0``) is always admitted:
    its token was reserved at first sight.

    All bucket arithmetic uses ``req.arrival`` (the stream timestamp), so
    decisions depend only on the trace — see the module docstring's
    determinism invariant.
    """

    name = "token-bucket"

    def __init__(self, rate: float = 4.0, burst: int = 2,
                 max_delay: float = math.inf):
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.max_delay = float(max_delay)
        self._level: dict[str, float] = {}   # tenant -> tokens (may be < 0)
        self._last: dict[str, float] = {}    # tenant -> last refill timestamp

    def reset(self) -> None:
        self._level.clear()
        self._last.clear()

    def decide(self, req: AdmissionRequest, now: float,
               signals: LoadSignals) -> AdmissionDecision:
        if req.attempts:                     # token reserved at first sight
            return _ADMIT_NOW
        t = req.arrival
        level = self._level.get(req.tenant, self.burst)
        last = self._last.get(req.tenant, t)
        level = min(self.burst, level + (t - last) * self.rate)
        if level >= 1.0:
            self._level[req.tenant] = level - 1.0
            self._last[req.tenant] = t
            return _ADMIT_NOW
        wait = (1.0 - level) / self.rate
        if wait > self.max_delay:
            # rejected DAGs do not consume the reservation: the bucket
            # state is left exactly as the refill found it
            self._level[req.tenant] = level
            self._last[req.tenant] = t
            return AdmissionDecision(
                REJECT, reason=f"token wait {wait:.3f}s > "
                               f"max_delay {self.max_delay:.3f}s")
        self._level[req.tenant] = level - 1.0    # reserve -> FIFO queue
        self._last[req.tenant] = t
        return AdmissionDecision(DELAY, retry_at=t + wait,
                                 reason=f"bucket empty, token at +{wait:.3f}s")


class _SojournEwma:
    """EWMA mean + mean-absolute-deviation of one tenant's sojourns."""

    __slots__ = ("mean", "dev", "n")

    def __init__(self) -> None:
        self.mean = 0.0
        self.dev = 0.0
        self.n = 0

    def update(self, x: float, alpha: float) -> None:
        if self.n == 0:
            self.mean = x
        else:
            self.dev += alpha * (abs(x - self.mean) - self.dev)
            self.mean += alpha * (x - self.mean)
        self.n += 1


class SloAdaptiveGate(AdmissionGate):
    """SLO-aware backpressure: self-throttle tenants whose p99 degrades.

    Two signals drive the verdict for a fresh arrival from tenant T:

    * **degraded** (feedback) — per tenant the gate keeps an EWMA mean and
      mean-absolute-deviation of completed-DAG sojourns (fed by
      ``on_dag_done``) and estimates T's p99 as ``mean + z * dev``; with
      >= ``min_samples`` completions and the estimate above T's SLO, T's
      own queue is backing up and admitting more would push the whole
      pool's latency up.
    * **dominant under backlog** (instant) — the gate tracks the pool's
      *work backlog*: TAOs admitted through it minus TAOs the scheduler
      has committed (``LoadSignals.completed``).  Instantaneous
      ready+running counts stay low even under a huge burst (a layered
      DAG only exposes a frontier of ready TAOs), but backlog is exactly
      the queued work that inflates every later arrival's sojourn.  When
      backlog exceeds ``headroom x n_workers`` TAOs and T holds at least
      half of it, T is throttled before a single completion reports back.

    Delayed DAGs are re-presented every ``delay_quantum`` seconds and
    released as load drains: a queued request is admitted once the
    backlog falls to ``drain_frac x headroom x n_workers``, even if the
    (slow-moving) EWMA still looks degraded.  A DAG still blocked after
    ``max_delay`` of cumulative waiting is rejected, bounding the gate
    queue.  SLOs are declared per tenant (``slo_per_tenant``) with
    ``slo`` as the default for unlisted tenants.
    """

    name = "slo-adaptive"

    def __init__(self, slo: float = 1.0,
                 slo_per_tenant: dict | None = None,
                 alpha: float = 0.25, z: float = 3.0,
                 min_samples: int = 3,
                 delay_quantum: float | None = None,
                 max_delay: float | None = None,
                 headroom: float = 2.0, drain_frac: float = 0.5):
        if slo <= 0:
            raise ValueError(f"slo must be positive, got {slo}")
        self.slo = float(slo)
        self.slo_per_tenant = dict(slo_per_tenant or {})
        self.alpha = alpha
        self.z = z
        self.min_samples = min_samples
        self.delay_quantum = delay_quantum if delay_quantum is not None \
            else slo / 4.0
        self.max_delay = max_delay if max_delay is not None else 4.0 * slo
        self.headroom = headroom
        self.drain_frac = drain_frac
        self._lock = threading.Lock()        # decide vs worker on_dag_done
        self._ewma: dict[str, _SojournEwma] = {}
        self._admitted_taos = 0              # TAOs let through the gate
        self._done_taos: dict[str, int] = {} # tenant -> TAOs of finished DAGs
        self._tenant_taos: dict[str, int] = {}  # tenant -> TAOs admitted

    def reset(self) -> None:
        with self._lock:
            self._ewma.clear()
            self._admitted_taos = 0
            self._done_taos.clear()
            self._tenant_taos.clear()

    # -- observable state (examples/benchmarks print these) -----------------
    def slo_for(self, tenant: str) -> float:
        return self.slo_per_tenant.get(tenant, self.slo)

    def p99_estimate(self, tenant: str) -> float:
        """Current p99 sojourn estimate for ``tenant`` (nan = no data)."""
        with self._lock:
            ew = self._ewma.get(tenant)
            if ew is None or ew.n == 0:
                return float("nan")
            return ew.mean + self.z * ew.dev

    # -- gate interface ------------------------------------------------------
    def decide(self, req: AdmissionRequest, now: float,
               signals: LoadSignals) -> AdmissionDecision:
        slo_t = self.slo_for(req.tenant)
        with self._lock:
            # total backlog: TAOs admitted but not yet committed.  The
            # per-tenant view is conservative — a tenant's TAOs only leave
            # its backlog when the whole DAG completes (the scheduler's
            # committed count is not split by tenant).
            backlog = self._admitted_taos - signals.completed
            mine = self._tenant_taos.get(req.tenant, 0) \
                - self._done_taos.get(req.tenant, 0)
            # the EWMA fields must be read under the lock too: a worker
            # thread's on_dag_done mutates dev then mean, and a torn pair
            # could flip the degraded verdict
            ew = self._ewma.get(req.tenant)
            degraded = (ew is not None and ew.n >= self.min_samples
                        and ew.mean + self.z * ew.dev > slo_t)
        limit = self.headroom * signals.n_workers
        # load-drain release: a queued DAG enters once the backlog has
        # genuinely drained, even before completions move the (slow) EWMA
        if req.attempts and backlog <= self.drain_frac * limit:
            return AdmissionDecision(ADMIT, reason="backlog drained")
        dominant = backlog > limit and 2 * mine >= backlog
        if not degraded and not dominant:
            return _ADMIT_NOW
        waited = max(0.0, now - req.arrival)
        why = "p99 degraded" if degraded else "dominant backlog"
        if waited + self.delay_quantum > self.max_delay:
            return AdmissionDecision(
                REJECT, reason=f"{why} after {waited:.3f}s queued",
                dominant=dominant)
        return AdmissionDecision(DELAY, retry_at=now + self.delay_quantum,
                                 reason=why, dominant=dominant)

    def on_admit(self, req: AdmissionRequest, now: float) -> None:
        with self._lock:
            self._admitted_taos += req.n_taos
            self._tenant_taos[req.tenant] = \
                self._tenant_taos.get(req.tenant, 0) + req.n_taos

    def on_dag_done(self, tenant: str, sojourn: float, now: float,
                    n_taos: int = 0) -> None:
        with self._lock:
            self._done_taos[tenant] = \
                self._done_taos.get(tenant, 0) + n_taos
            ew = self._ewma.get(tenant)
            if ew is None:
                ew = self._ewma[tenant] = _SojournEwma()
            ew.update(sojourn, self.alpha)


# ---------------------------------------------------------------------------
# registry used by benchmarks / CLI
# ---------------------------------------------------------------------------
ALL_GATE_NAMES = ("none", "token-bucket", "slo-adaptive")

_GATES = {
    "none": NoAdmission,
    "token-bucket": TokenBucketGate,
    "slo-adaptive": SloAdaptiveGate,
}


def make_gate(name: str, **kwargs) -> AdmissionGate:
    """Factory for ``--admission <name>``: any of :data:`ALL_GATE_NAMES`.

    ``kwargs`` forward to the gate constructor (``none`` accepts none).
    """
    try:
        cls = _GATES[name]
    except KeyError:
        raise ValueError(f"unknown admission gate: {name!r} "
                         f"(choose from: {', '.join(ALL_GATE_NAMES)})") \
            from None
    return cls(**kwargs)
