"""Prometheus-style metrics: one registry for every FastMPS counter.

Queue depths and admission backpressure (``api/service``), straggler and
transport fault counters (``runtime/transport``, ``runtime/stragglers``)
and broadcast and per-walk I/O bytes (the engine's stats) each have their
own ``stats()`` dict.  This module consolidates them: a dependency-free
metrics registry (:class:`Counter` / :class:`Gauge` / :class:`Histogram`)
with the Prometheus text exposition (format 0.0.4), and two bind points:

* **events** — producers expose an ``observer`` callback seam
  (``observer(event, **fields)``):
  :class:`~repro_torch.api.service.SamplingService` emits job, batch,
  queue and straggler events, a
  :class:`~repro_torch.runtime.transport.WorkerPool` spawn, reap, fault
  and dispatch events.  :func:`instrument_service` turns those into counter
  increments and histogram observations.  The producers never import this
  module — the seam is one optional callable, so the runtime layers stay
  dependency-free.
* **snapshots** — current-state numbers (queue depth, admission
  backpressure, live workers) are *collected at scrape time* from the
  stable ``stats()`` schemas, via registry collectors — no polling thread,
  no stale gauges.

The JAX package's ``instrument_dispatch`` (gauges over its run-time block
autotuner) has no counterpart: the port's kernels choose no block
configuration at run time, so there is nothing to read.

Minimal use::

    from repro_torch.obs import MetricsRegistry, instrument_service

    reg = MetricsRegistry()
    instrument_service(svc, reg)        # events + scrape-time gauges
    print(reg.render())                 # Prometheus text exposition
"""
from __future__ import annotations

import math
import re
import threading
from typing import Callable, Iterable, Optional, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# histogram default: batch/request latencies from ~1 ms to ~100 s
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   30.0, 60.0, 120.0)


def _escape_label(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n",
                                                                   r"\n")


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats shortest."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class _Metric:
    """Base: one named metric family with 0+ label dimensions.  Children
    (one per label-value tuple) hold the actual numbers; the unlabelled
    family is its own single child."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, "_Metric"] = {}

    def labels(self, *values, **kv) -> "_Metric":
        """The child for one label-value combination (created on first
        use).  Accepts positional values in ``labelnames`` order or
        keywords.  An unlabelled metric is its own child."""
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            values = tuple(kv[ln] for ln in self.labelnames)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {values}")
        if not self.labelnames:
            return self
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._make_child()
            return child

    def _make_child(self) -> "_Metric":
        raise NotImplementedError

    def _ensure_unlabelled(self) -> "_Metric":
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames} — "
                             f"use .labels(...)")
        return self

    # -- exposition ----------------------------------------------------------
    def _samples(self) -> Iterable[tuple[str, tuple, float]]:
        """Yield (name-suffix, ((label, value), ...), sample) triples."""
        raise NotImplementedError

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for suffix, labels, value in self._samples():
            label_str = ",".join(
                f'{n}="{_escape_label(v)}"' for n, v in labels)
            body = f"{{{label_str}}}" if label_str else ""
            lines.append(f"{self.name}{suffix}{body} {_fmt(value)}")
        return "\n".join(lines)


class Counter(_Metric):
    """Monotonically increasing count (events, bytes, faults)."""

    kind = "counter"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def _make_child(self) -> "Counter":
        return Counter(self.name, self.help)

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        child = self._ensure_unlabelled()
        with child._lock:
            child._value += amount

    @property
    def value(self) -> float:
        child = self._ensure_unlabelled()
        with child._lock:
            return child._value

    # sample emission is driven from the family: an unlabelled family
    # reports its own value, a labelled one walks its children
    def _samples(self):
        if not self.labelnames:
            with self._lock:
                yield "", (), self._value
            return
        with self._lock:
            items = list(self._children.items())
        for values, child in items:
            with child._lock:
                v = child._value
            yield "", tuple(zip(self.labelnames, values)), v


class Gauge(_Metric):
    """Point-in-time value.  ``set_function`` makes it scrape-time lazy."""

    kind = "gauge"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def _make_child(self) -> "Gauge":
        return Gauge(self.name, self.help)

    def set(self, value: float) -> None:
        child = self._ensure_unlabelled()
        with child._lock:
            child._value = float(value)
            child._fn = None

    def inc(self, amount: float = 1.0) -> None:
        child = self._ensure_unlabelled()
        with child._lock:
            child._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Evaluate ``fn()`` at every scrape instead of storing a value —
        current-state gauges (queue depth, live workers) never go stale."""
        child = self._ensure_unlabelled()
        with child._lock:
            child._fn = fn

    @property
    def value(self) -> float:
        child = self._ensure_unlabelled()
        with child._lock:
            return float(child._fn()) if child._fn is not None \
                else child._value

    def _samples(self):
        if not self.labelnames:
            items = [((), self)]
        else:
            with self._lock:
                items = list(self._children.items())
        for values, child in items:
            with child._lock:
                fn = child._fn
                v = child._value
            if fn is not None:
                try:
                    v = float(fn())
                except Exception:          # noqa: BLE001 — a broken callback
                    continue               # must not take down the scrape
            yield "", tuple(zip(self.labelnames, values)), v


class Histogram(_Metric):
    """Cumulative-bucket histogram (the Prometheus layout: ``_bucket``
    per upper bound incl. +Inf, plus ``_sum`` and ``_count``)."""

    kind = "histogram"

    def __init__(self, name, help, labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)   # +Inf last
        self._sum = 0.0
        self._count = 0

    def _make_child(self) -> "Histogram":
        return Histogram(self.name, self.help, buckets=self.buckets)

    def observe(self, value: float) -> None:
        child = self._ensure_unlabelled()
        with child._lock:
            child._sum += value
            child._count += 1
            for i, b in enumerate(child.buckets):
                if value <= b:
                    child._counts[i] += 1
                    break
            else:
                child._counts[-1] += 1

    @property
    def count(self) -> int:
        child = self._ensure_unlabelled()
        with child._lock:
            return child._count

    @property
    def sum(self) -> float:
        child = self._ensure_unlabelled()
        with child._lock:
            return child._sum

    def _samples(self):
        if not self.labelnames:
            items = [((), self)]
        else:
            with self._lock:
                items = list(self._children.items())
        for values, child in items:
            with child._lock:
                counts = list(child._counts)
                total, s = child._count, child._sum
            labels = tuple(zip(self.labelnames, values))
            cum = 0
            for b, c in zip(child.buckets, counts):
                cum += c
                yield "_bucket", labels + (("le", _fmt(b)),), cum
            yield "_bucket", labels + (("le", "+Inf"),), total
            yield "_sum", labels, s
            yield "_count", labels, total


class MetricsRegistry:
    """A named set of metrics + scrape-time collectors.

    ``counter``/``gauge``/``histogram`` are get-or-create (re-requesting a
    name returns the existing instrument; a *kind* mismatch raises), so
    independent subsystems can share one registry without coordination.
    ``add_collector(fn)`` registers a callable run at the top of every
    :meth:`render` — the hook snapshot-style sources (``service.stats()``)
    use to refresh their gauges lazily.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}{m.labelnames}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def add_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def render(self) -> str:
        """The Prometheus text exposition (format 0.0.4) of every metric,
        collectors run first.  A failing collector is skipped — a scrape
        must never 500 because one subsystem's snapshot raced a close."""
        with self._lock:
            collectors = list(self._collectors)
            metrics = list(self._metrics.values())
        for fn in collectors:
            try:
                fn()
            except Exception:              # noqa: BLE001 — see docstring
                pass
        return "\n".join(m.expose() for m in metrics) + "\n"

    def snapshot(self) -> dict:
        """A plain-dict view (name → {labels-tuple: value}) for tests and
        JSON stats endpoints."""
        self.render()                      # run collectors
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict[str, dict] = {}
        for m in metrics:
            fam: dict = {}
            for suffix, labels, value in m._samples():
                fam[(suffix, labels)] = value
            out[m.name] = fam
        return out


# ---------------------------------------------------------------------------
# instrumentation binders
# ---------------------------------------------------------------------------

class _ServiceObserver:
    """The event half of :func:`instrument_service`: translate
    ``observer(event, **fields)`` emissions from the service / queue /
    transport layers into registry updates."""

    def __init__(self, registry: MetricsRegistry, prefix: str):
        p = prefix
        self.jobs_submitted = registry.counter(
            f"{p}_jobs_submitted_total", "Jobs accepted by submit()")
        self.jobs_finished = registry.counter(
            f"{p}_jobs_finished_total", "Jobs by terminal state", ["state"])
        self.batches = registry.counter(
            f"{p}_batches_total", "Macro batches completed (counted once)")
        self.batch_seconds = registry.histogram(
            f"{p}_batch_seconds", "Wall time of one macro batch")
        self.queue_events = registry.counter(
            f"{p}_queue_events_total",
            "WorkQueue events (claim/requeue/complete/steal)", ["event"])
        self.straggler_steals = registry.counter(
            f"{p}_straggler_steals_total", "Straggler reclaims handed out")
        self.rejected_results = registry.counter(
            f"{p}_rejected_results_total",
            "Late completions discarded by the ownership check")
        self.transport_events = registry.counter(
            f"{p}_transport_events_total",
            "WorkerPool events (spawn/reap/fault/dispatch)", ["event"])
        self.transport_lane_faults = registry.counter(
            f"{p}_transport_lane_faults_total",
            "Transport faults absorbed as lane faults (batch requeued)")
        self.dispatch_bytes = registry.counter(
            f"{p}_transport_dispatch_bytes_total",
            "Serialized job-batch payload bytes dispatched to workers")
        self.walk_io = registry.counter(
            f"{p}_walk_io_bytes_total",
            "Per-walk engine byte counters", ["channel"])
        self.faults = registry.counter(
            f"{p}_faults_total",
            "Faults recorded by the service, by taxonomy kind "
            "(corruption/transport/poison/timeout/resource)", ["kind"])
        self.lane_quarantines = registry.counter(
            f"{p}_lane_quarantines_total",
            "Crash-looping lanes placed on cooldown quarantine")
        self.lane_readmits = registry.counter(
            f"{p}_lane_readmits_total",
            "Quarantined lanes readmitted after cooldown")

    def __call__(self, event: str, **fields) -> None:
        if event == "job_submit":
            self.jobs_submitted.inc()
        elif event == "job_finished":
            self.jobs_finished.labels(state=fields.get("state",
                                                       "unknown")).inc()
        elif event == "batch_done":
            self.batches.inc()
            if "duration_s" in fields:
                self.batch_seconds.observe(fields["duration_s"])
            stats = fields.get("stats") or {}
            for channel in ("io_bytes", "broadcast_send_bytes",
                            "broadcast_recv_bytes", "dispatch_bytes"):
                v = stats.get(channel)
                if v:
                    self.walk_io.labels(channel=channel).inc(float(v))
        elif event.startswith("queue_"):
            self.queue_events.labels(event=event[len("queue_"):]).inc()
        elif event == "steal":
            self.straggler_steals.inc()
        elif event == "rejected_result":
            self.rejected_results.inc()
        elif event == "lane_fault":
            self.transport_lane_faults.inc()
        elif event == "fault":
            self.faults.labels(kind=fields.get("kind", "unknown")).inc()
        elif event == "lane_quarantine":
            self.lane_quarantines.inc()
        elif event == "lane_readmit":
            self.lane_readmits.inc()
        elif event.startswith("transport_"):
            self.transport_events.labels(event=event[len("transport_"):]
                                         ).inc()
            if event == "transport_dispatch" and "nbytes" in fields:
                self.dispatch_bytes.inc(float(fields["nbytes"]))


def instrument_service(service, registry: MetricsRegistry,
                       prefix: str = "fastmps") -> _ServiceObserver:
    """Wire a :class:`~repro_torch.api.service.SamplingService` into
    ``registry``.

    Two halves (see module docstring): the service's ``observer`` seam is
    bound for events (counters/histograms), and a scrape-time collector
    reads the stable :meth:`SamplingService.stats` schema into gauges —
    queue depth, lane count, job states, admission backpressure, straggler
    and transport totals.  Returns the observer (also installed as
    ``service.observer``) so callers can chain additional sinks.
    """
    obs = _ServiceObserver(registry, prefix)
    service.observer = obs
    pool = getattr(service, "pool", None)
    if pool is not None:
        pool.observer = obs

    p = prefix
    g_jobs = registry.gauge(f"{p}_jobs", "Jobs in the service table by "
                            "state", ["state"])
    g_queue = registry.gauge(f"{p}_queue_depth",
                             "Macro batches not yet completed across "
                             "pending/running jobs")
    g_workers = registry.gauge(f"{p}_workers", "Live service lanes")
    g_sessions = registry.gauge(f"{p}_sessions",
                                "Coalesced sessions owned by the service")
    g_active = registry.gauge(f"{p}_admission_active_model_bytes",
                              "Modeled resident bytes of admitted jobs "
                              "(perfmodel Eq. 3)")
    g_queued = registry.gauge(f"{p}_admission_queued_jobs",
                              "Jobs held PENDING by the admission budget")
    g_bp = registry.gauge(f"{p}_admission_backpressure",
                          "1 when admission control is holding jobs back")
    g_budget = registry.gauge(f"{p}_admission_budget_bytes",
                              "Admission byte budget (0 = unlimited)")
    g_dup = registry.gauge(f"{p}_straggler_duplicates",
                           "Duplicated batches from straggler reclaims")
    g_tworkers = registry.gauge(f"{p}_transport_workers",
                                "Live persistent worker processes")
    g_quar = registry.gauge(f"{p}_quarantined_lanes",
                            "Lanes currently on crash-loop cooldown")
    g_dl = registry.gauge(f"{p}_dead_letters",
                          "Jobs failed by the bounded-retry dead-letter "
                          "policy")

    def collect() -> None:
        st = service.stats()
        for state, n in st["jobs"].items():
            g_jobs.labels(state=state).set(n)
        g_queue.set(st["queue_depth"])
        g_workers.set(st["workers"])
        g_sessions.set(st["sessions"])
        adm = st["admission"]
        g_active.set(adm["active_model_bytes"])
        g_queued.set(adm["queued_jobs"])
        g_bp.set(1.0 if adm["backpressure"] else 0.0)
        g_budget.set(adm["budget_bytes"] or 0)
        g_dup.set(st["stragglers"]["duplicates"])
        g_tworkers.set(st["transport"]["workers"])
        g_quar.set(len(st["transport"].get("quarantined", ())))
        g_dl.set(st.get("dead_letters", 0))

    registry.add_collector(collect)
    return obs

