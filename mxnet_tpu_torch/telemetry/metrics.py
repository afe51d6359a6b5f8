"""Metrics registry + Prometheus text rendering (ref:
``mxnet_tpu/telemetry/metrics.py``).

One :class:`Registry` unifies every counter surface in the tree behind
a single scrape: the profiler's section registry (cachedGraph /
trainerStep / dataPipeline / resilience / telemetry) is exported by a
built-in collector, ``ModelServer`` instances self-register via
:func:`register_server`, and subsystems can create explicit
counters/gauges/histograms.  ``render()`` emits Prometheus text
exposition format 0.0.4 — what the stdlib-http ``/metrics`` endpoint
(:mod:`.httpd`) serves.

Two kinds of sources:

- **metric objects** — ``registry.counter/gauge/histogram(name)``
  create owned instruments mutated imperatively (``inc``/``set``/
  ``observe``).
- **collectors** — callables returning ``(name, mtype, help, samples)``
  families computed at scrape time from an existing stats surface
  (``samples`` = iterable of ``(labels_dict, value)``, or for
  histograms ``(labels_dict, {"buckets": [(le, cumulative_count),
  ...], "sum": s, "count": n})``).  Collectors keep the existing
  per-subsystem counter code authoritative: a scrape reads the same
  numbers ``profiler.dumps()`` reports, by construction.

Metric names follow Prometheus conventions (``mxtpu_`` prefix,
snake_case), the JAX package's names, so one scrape config reads both.
"""
from __future__ import annotations

import itertools
import re
import threading
import weakref

from ..base import MXNetError

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

DEFAULT_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, float("inf"))


def _escape(value):
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v):
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class Metric:
    """One metric family (counter | gauge | histogram), label-aware."""

    def __init__(self, name, mtype, help="", buckets=None):
        if not _NAME_RE.match(name):
            raise MXNetError(f"invalid metric name {name!r}")
        if mtype not in ("counter", "gauge", "histogram"):
            raise MXNetError(f"invalid metric type {mtype!r}")
        self.name = name
        self.mtype = mtype
        self.help = help
        self._lock = threading.Lock()
        self._values = {}       # labels tuple -> float | [counts, sum, n]
        self._buckets = None
        if mtype == "histogram":
            bs = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS_MS))
            if bs[-1] != float("inf"):
                bs = bs + (float("inf"),)
            self._buckets = bs

    def _key(self, labels):
        for k in labels:
            if not _LABEL_RE.match(k):
                raise MXNetError(f"invalid label name {k!r}")
        return tuple(sorted(labels.items()))

    def inc(self, n=1, **labels):
        if self.mtype not in ("counter", "gauge"):
            raise MXNetError(f"{self.name}: inc() on a {self.mtype}")
        if self.mtype == "counter" and n < 0:
            raise MXNetError(f"{self.name}: counters only go up")
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + n

    def set(self, value, **labels):
        if self.mtype != "gauge":
            raise MXNetError(f"{self.name}: set() on a {self.mtype}")
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def observe(self, value, **labels):
        if self.mtype != "histogram":
            raise MXNetError(f"{self.name}: observe() on a {self.mtype}")
        k = self._key(labels)
        with self._lock:
            slot = self._values.get(k)
            if slot is None:
                slot = self._values[k] = [
                    [0] * len(self._buckets), 0.0, 0]
            counts, _s, _n = slot
            for i, le in enumerate(self._buckets):
                if value <= le:
                    counts[i] += 1
                    break
            slot[1] += float(value)
            slot[2] += 1

    def value(self, **labels):
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def samples(self):
        """((labels_dict, payload)) pairs; histogram payloads are the
        collector-shaped dict with CUMULATIVE bucket counts."""
        with self._lock:
            items = list(self._values.items())
        out = []
        for k, v in items:
            labels = dict(k)
            if self.mtype == "histogram":
                counts, total, n = v
                cum, acc = [], 0
                for le, c in zip(self._buckets, counts):
                    acc += c
                    cum.append((le, acc))
                out.append((labels, {"buckets": cum, "sum": total,
                                     "count": n}))
            else:
                out.append((labels, v))
        return out


class Registry:
    """Metric families + scrape-time collectors, rendered as one
    Prometheus text page."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}
        self._collectors = []

    # -- instruments --------------------------------------------------------

    def _make(self, name, mtype, help, buckets=None):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.mtype != mtype:
                    raise MXNetError(
                        f"metric {name} already registered as {m.mtype}")
                return m
            m = self._metrics[name] = Metric(name, mtype, help,
                                             buckets=buckets)
            return m

    def counter(self, name, help=""):
        return self._make(name, "counter", help)

    def gauge(self, name, help=""):
        return self._make(name, "gauge", help)

    def histogram(self, name, help="", buckets=None):
        return self._make(name, "histogram", help, buckets=buckets)

    # -- collectors ---------------------------------------------------------

    def register_collector(self, fn):
        """``fn()`` -> iterable of ``(name, mtype, help, samples)``
        families, evaluated per scrape."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)
        return fn

    def unregister_collector(self, fn):
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    # -- scrape -------------------------------------------------------------

    def collect(self):
        """Every family as ``(name, mtype, help, [(labels, payload)])``,
        metrics first, then collectors in registration order."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        out = [(m.name, m.mtype, m.help, m.samples()) for m in metrics]
        for fn in collectors:
            fams = fn()
            if fams:
                out.extend((n, t, h, list(s)) for n, t, h, s in fams)
        return out

    def render(self):
        """Prometheus text exposition format 0.0.4."""
        lines = []
        for name, mtype, help, samples in self.collect():
            if help:
                lines.append(f"# HELP {name} {_escape(help)}")
            lines.append(f"# TYPE {name} {mtype}")
            for labels, payload in samples:
                if mtype == "histogram":
                    for le, c in payload["buckets"]:
                        bl = dict(labels, le=_fmt_value(le))
                        lines.append(
                            f"{name}_bucket{_fmt_labels(bl)} {int(c)}")
                    lines.append(f"{name}_sum{_fmt_labels(labels)} "
                                 f"{_fmt_value(payload['sum'])}")
                    lines.append(f"{name}_count{_fmt_labels(labels)} "
                                 f"{int(payload['count'])}")
                else:
                    lines.append(f"{name}{_fmt_labels(labels)} "
                                 f"{_fmt_value(payload)}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# The default registry and its built-in collectors.


_default = Registry()


def default_registry():
    return _default


def _snake(name):
    return re.sub(r"(?<=[a-z0-9])([A-Z])",
                  lambda m: "_" + m.group(1).lower(), name)


def _profiler_sections_collector():
    """Every profiler section (cachedGraph/trainerStep/dataPipeline/
    resilience/telemetry/...) as ``mxtpu_<section>_<key>`` gauges —
    gauges, not counters, because ``profiler.dumps(reset=True)``
    legitimately rewinds the window.  Nested dicts (retries by fault
    class, bucket hits) become labeled samples.  Reads the same
    providers ``dumps()`` reads, so a scrape and a dump always agree.
    """
    import sys

    root = __package__.rsplit(".", 1)[0]
    profiler = sys.modules.get(root + ".profiler")
    if profiler is None:
        return []
    fams = []
    for section, stats in profiler.sections().items():
        base = "mxtpu_" + _snake(section)
        for key, val in sorted(stats.items()):
            if isinstance(val, bool) or val is None:
                continue
            if isinstance(val, (int, float)):
                fams.append((f"{base}_{_snake(key)}", "gauge",
                             f"profiler section {section}.{key}",
                             [({}, float(val))]))
            elif isinstance(val, dict):
                samples = [({"key": str(k)}, float(v))
                           for k, v in sorted(val.items())
                           if isinstance(v, (int, float))
                           and not isinstance(v, bool)]
                if samples:
                    fams.append((f"{base}_{_snake(key)}", "gauge",
                                 f"profiler section {section}.{key}",
                                 samples))
    return fams


_default.register_collector(_profiler_sections_collector)

# explicit built-ins
_scrapes = _default.counter(
    "mxtpu_metrics_scrapes_total",
    "scrapes served by the /metrics endpoint")
_flight_dumps = _default.counter(
    "mxtpu_flight_dumps_total",
    "flight-recorder files written (process lifetime)")


def count_scrape():
    """Book one scrape (called by the endpoint per /metrics render)."""
    from . import tracer

    _scrapes.inc()
    tracer.bump("scrapes")


# -- ModelServer export ------------------------------------------------------

_server_ids = itertools.count(0)
_TALLY_KEYS = ("submitted", "served", "rejected_overload",
               "expired_deadline", "failed", "cancelled", "batches",
               "warmup_batches", "reloads")
_GAUGE_KEYS = ("queue_depth", "in_flight", "batch_fill_ratio",
               "padding_overhead")


def register_server(server, registry=None):
    """Export a ``ModelServer``'s ``stats()`` under
    ``mxtpu_serve_*{server="<id>"}``; holds only a weak reference (a
    collected server silently drops out of the scrape).  Returns the
    collector (pass to ``unregister_collector`` to remove early).

    Everything is exported as a GAUGE, never a Prometheus counter:
    ``stats(reset=True)`` legitimately rewinds the accounting window
    (the same reason the profiler-section collector exports gauges),
    and a monotonic-counter type would make ``rate()`` misread every
    window reset as a process restart."""
    reg = registry or _default
    ref = weakref.ref(server)
    sid = str(next(_server_ids))

    def _collect():
        s = ref()
        if s is None:
            reg.unregister_collector(_collect)
            return []
        snap = s.stats()
        lab = {"server": sid}
        fams = []
        for k in _TALLY_KEYS:
            fams.append((f"mxtpu_serve_{k}", "gauge",
                         f"serve {k} (current accounting window)",
                         [(lab, float(snap.get(k, 0)))]))
        for k in _GAUGE_KEYS:
            v = snap.get(k)
            if v is not None:
                fams.append((f"mxtpu_serve_{k}", "gauge", f"serve {k}",
                             [(lab, float(v))]))
        hits = snap.get("bucket_hits") or {}
        if hits:
            fams.append(("mxtpu_serve_bucket_hits", "gauge",
                         "batches per bucket shape (current window)",
                         [(dict(lab, bucket=str(b)), float(n))
                          for b, n in sorted(hits.items())]))
        # per-bucket traffic quality: where padding waste actually
        # lands, beside the aggregate fill ratio
        fill = snap.get("bucket_fill_ratio") or {}
        if fill:
            fams.append(("mxtpu_serve_bucket_fill_ratio", "gauge",
                         "real requests / padded rows per bucket "
                         "(current window)",
                         [(dict(lab, bucket=str(b)), float(v))
                          for b, v in sorted(fill.items())]))
        pad = snap.get("bucket_padding_overhead") or {}
        if pad:
            fams.append(("mxtpu_serve_bucket_padding_overhead", "gauge",
                         "padded/real elements - 1 per bucket "
                         "(current window)",
                         [(dict(lab, bucket=str(b)), float(v))
                          for b, v in sorted(pad.items())]))
        hist = (snap.get("latency") or {}).get("histogram")
        if hist:
            fams.append(("mxtpu_serve_latency_ms", "histogram",
                         "request latency (submit to resolve)",
                         [(lab, {"buckets": [(b, c) for b, c in
                                             hist["buckets"]],
                                 "sum": hist["sum_ms"],
                                 "count": hist["count"]})]))
        graph = snap.get("graph") or {}
        for k, v in sorted(graph.items()):
            fams.append((f"mxtpu_serve_graph_{k}", "gauge",
                         f"serve compiled-graph {k}",
                         [(lab, float(v))]))
        return fams

    reg.register_collector(_collect)
    return _collect


# -- Router and DecodeServer export ------------------------------------------


def register_router(router, registry=None):
    """Export a ``serve.Router``'s ``stats()`` under
    ``mxtpu_router_*{router="<id>"}`` (ref: ``mxnet_tpu/telemetry/
    metrics.py:392``): weakly held, gauges throughout
    (``stats(reset=True)`` rewinds the window), as
    :func:`register_server`.  Per-replica health and attribution are
    ``{replica=}``-labelled samples, so a dashboard can watch one sick
    replica get evicted and its warm replacement join."""
    from ..serve.router import ROUTER_COUNTERS

    reg = registry or _default
    ref = weakref.ref(router)
    sid = str(next(_server_ids))

    def _collect():
        r = ref()
        if r is None:
            reg.unregister_collector(_collect)
            return []
        snap = r.stats()
        lab = {"router": sid}
        fams = []
        for k in ROUTER_COUNTERS:
            fams.append((f"mxtpu_router_{k}", "gauge",
                         f"router {k} (current accounting window)",
                         [(lab, float(snap.get(k, 0)))]))
        for k in ("requests_lost", "pool_size", "healthy",
                  "queue_depth", "in_flight"):
            fams.append((f"mxtpu_router_{k}", "gauge", f"router {k}",
                         [(lab, float(snap.get(k) or 0))]))
        if snap.get("last_recovery_ms") is not None:
            fams.append(("mxtpu_router_last_recovery_ms", "gauge",
                         "eviction -> warm replacement admitted, ms",
                         [(lab, float(snap["last_recovery_ms"]))]))
        reps = snap.get("replicas") or {}
        if reps:
            fams.append(("mxtpu_router_replica_healthy", "gauge",
                         "1 = replica in rotation",
                         [(dict(lab, replica=str(i)),
                           1.0 if info["state"] == "healthy" else 0.0)
                          for i, info in sorted(reps.items())]))
            fams.append(("mxtpu_router_replica_pending", "gauge",
                         "queued + in-flight requests per replica",
                         [(dict(lab, replica=str(i)),
                           float(info["pending"]))
                          for i, info in sorted(reps.items())]))
            fams.append(("mxtpu_router_replica_ewma_ms", "gauge",
                         "EWMA service time per replica, ms",
                         [(dict(lab, replica=str(i)),
                           float(info["ewma_ms"]))
                          for i, info in sorted(reps.items())]))
        hist = (snap.get("latency") or {}).get("histogram")
        if hist:
            fams.append(("mxtpu_router_latency_ms", "histogram",
                         "request latency through the pool (submit to "
                         "resolve, re-dispatches included)",
                         [(lab, {"buckets": [(b, c) for b, c in
                                             hist["buckets"]],
                                 "sum": hist["sum_ms"],
                                 "count": hist["count"]})]))
        return fams

    reg.register_collector(_collect)
    return _collect


def register_decode_server(server, registry=None):
    """Export a ``DecodeServer``'s ``stats()`` under
    ``mxtpu_decode_*{server="<id>"}`` (ref: ``mxnet_tpu/telemetry/
    metrics.py:461``): weakly held, gauges throughout
    (``stats(reset=True)`` rewinds the window), as
    :func:`register_server`."""
    # the decode tier defines its counter set once; imported here (lazily:
    # decode.py imports this module) so the export cannot drift from it
    from ..serve.decode import DECODE_COUNTERS

    reg = registry or _default
    ref = weakref.ref(server)
    sid = str(next(_server_ids))

    def _collect():
        s = ref()
        if s is None:
            reg.unregister_collector(_collect)
            return []
        snap = s.stats()
        lab = {"server": sid}
        fams = []
        for k in DECODE_COUNTERS:
            fams.append((f"mxtpu_decode_{k}", "gauge",
                         f"decode serve {k} (current accounting window)",
                         [(lab, float(snap.get(k, 0)))]))
        fams.append(("mxtpu_decode_queue_depth", "gauge",
                     "queued admissions",
                     [(lab, float(snap.get("queue_depth", 0)))]))
        slots = snap.get("slots") or {}
        fams.append(("mxtpu_decode_slots_live", "gauge",
                     "occupied decode slots",
                     [(lab, float(slots.get("live", 0)))]))
        if slots.get("occupancy") is not None:
            fams.append(("mxtpu_decode_slot_occupancy", "gauge",
                         "token-step-weighted mean live/max_slots",
                         [(lab, float(slots["occupancy"]))]))
        for name, key in (("mxtpu_decode_ttft_ms", "ttft"),
                          ("mxtpu_decode_token_ms", "token_latency"),
                          ("mxtpu_decode_latency_ms", "latency")):
            hist = (snap.get(key) or {}).get("histogram")
            if hist:
                fams.append((name, "histogram", f"decode serve {key}",
                             [(lab, {"buckets": [(b, c) for b, c in
                                                 hist["buckets"]],
                                     "sum": hist["sum_ms"],
                                     "count": hist["count"]})]))
        graph = snap.get("graph") or {}
        for k, v in sorted(graph.items()):
            fams.append((f"mxtpu_decode_graph_{k}", "gauge",
                         f"decode serve compiled-graph {k}",
                         [(lab, float(v))]))
        pages = snap.get("pages")
        if pages:
            for name, key, help_ in (
                    ("mxtpu_decode_page_in_flight", "in_flight",
                     "physical cache pages currently referenced"),
                    ("mxtpu_decode_page_free", "free",
                     "physical cache pages on the free list"),
                    ("mxtpu_decode_page_committed", "committed",
                     "worst-case pages committed to admitted requests"),
                    ("mxtpu_decode_page_deferred", "deferred",
                     "admissions deferred on the page budget"),
                    ("mxtpu_decode_page_hbm_bytes", "hbm_bytes",
                     "paged KV-cache pool bytes (incl. trash page)")):
                fams.append((name, "gauge", help_,
                             [(lab, float(pages.get(key, 0)))]))
        spec = snap.get("spec")
        if spec:
            fams.append(("mxtpu_decode_spec_proposed", "gauge",
                         "draft tokens proposed (window)",
                         [(lab, float(spec.get("proposed", 0)))]))
            fams.append(("mxtpu_decode_spec_accepted", "gauge",
                         "draft tokens accepted (window)",
                         [(lab, float(spec.get("accepted", 0)))]))
            if spec.get("accept_rate") is not None:
                fams.append(("mxtpu_decode_spec_accept_rate", "gauge",
                             "accepted/proposed draft tokens (window)",
                             [(lab, float(spec["accept_rate"]))]))
        return fams

    reg.register_collector(_collect)
    return _collect
