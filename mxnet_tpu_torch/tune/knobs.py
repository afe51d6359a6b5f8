"""The typed knob registry: the tuner's live control surface (ref:
mxnet_tpu/tune/knobs.py).

Every performance-critical setting in the stack that a human used to
hand-set is one :class:`Knob` here — name, backing env var, value
domain, restart-cost class, and apply/read hooks.  The registry is what
the search (:mod:`.tuner`) iterates, what the trial runner applies, and
what the MXA50x analysis pass cross-checks against docs/ENV_VARS.md:
a knob whose env var is undocumented, or that declares no bounds, is a
CI finding, not a reviewer catch.

Restart-cost classes (the *when may this move* contract):

``free``
    Applies at the next step boundary / next batch with no new
    capture (pipeline prefetch depth, batcher linger).  The tuner may
    move these any time.
``recompile``
    Changes the shape surface of the captured graphs (gradient bucket
    capacity, fused-update group size, ZeRO sharding) — moving it costs
    warmup compiles, which the trial runner debits.  The tuner never
    moves these mid-serving-burst.
``restart``
    Requires tearing down and re-warming a serving component (the
    BucketSpec grid, the decode slot arena).  Moved only between
    bursts, and only when the search decided the re-warm pays for
    itself.

Knobs default to *env application*: ``apply`` writes the canonical
``MXTPU_`` spelling via :func:`base.setenv`, ``read`` goes through
:func:`base.getenv` — so every component that reads its config at
construction time picks the new value up on the next (re)build, and a
live object can opt in by binding a setter (:meth:`Knob.bind`).
"""
from __future__ import annotations

import re

from ..base import MXNetError, getenv, setenv

__all__ = ["Knob", "KnobRegistry", "default_registry",
           "RESTART_CLASSES"]

RESTART_CLASSES = ("free", "recompile", "restart")

# numeric-ish domains are tuples of allowed values; "choice" knobs
# (bucket-grid strings) enumerate candidates that the geometry layer
# may extend at runtime with a traffic-derived entry
_KINDS = ("int", "float", "bool", "choice")


class Knob:
    """One tunable setting.

    Parameters
    ----------
    name : str
        Registry-unique identifier (``kvstore_bucket_mb``).
    env : str
        Backing env var WITHOUT the ``MXTPU_`` prefix — the spelling
        ``base.getenv`` reads.  Every knob must have one (the MXA501
        rule): env application is what makes a recommendation
        reproducible outside the tuner's process.
    kind : str
        ``int`` | ``float`` | ``bool`` | ``choice``.
    domain : tuple, optional
        The explicit candidate set the search walks.  Required for
        ``choice``; for numeric kinds either ``domain`` or ``bounds``
        must be given (``domain`` implies its min/max as bounds).
    bounds : (lo, hi), optional
        Inclusive numeric validity range; with no ``domain`` the
        search derives a geometric ladder between the bounds.
    default :
        The shipped hand-tuned default (what "escaping a bad config"
        is measured against).
    restart : str
        Restart-cost class, one of :data:`RESTART_CLASSES`.
    apply, read : callable, optional
        Override the env-backed hooks (``apply(value)`` /
        ``read() -> value``).  Tests inject fakes here.
    doc : str
        One-line human description for the evidence trail.
    """

    def __init__(self, name, env=None, kind="int", domain=None,
                 bounds=None, default=None, restart="free", apply=None,
                 read=None, doc=""):
        self.name = str(name)
        if not re.fullmatch(r"[a-z][a-z0-9_]*", self.name):
            raise MXNetError(
                f"knob name {name!r} must be lower_snake_case")
        if not env or not isinstance(env, str):
            raise MXNetError(
                f"knob {self.name}: every knob needs an env= var (the "
                f"MXTPU_-prefixed spelling documented in ENV_VARS.md)")
        if not re.fullmatch(r"[A-Z][A-Z0-9_]*", env):
            raise MXNetError(
                f"knob {self.name}: env {env!r} is not an UPPER_SNAKE "
                f"env-var suffix (write KVSTORE_BUCKET_MB, not "
                f"MXTPU_KVSTORE_BUCKET_MB)")
        if kind not in _KINDS:
            raise MXNetError(
                f"knob {self.name}: kind {kind!r} not in {_KINDS}")
        if restart not in RESTART_CLASSES:
            raise MXNetError(
                f"knob {self.name}: restart class {restart!r} not in "
                f"{RESTART_CLASSES}")
        self.env = env
        self.kind = kind
        self.restart = restart
        self.doc = doc
        self._apply = apply
        self._read = read
        self._setter = None

        self.domain = tuple(domain) if domain is not None else None
        if kind == "bool":
            self.domain = (False, True)
            bounds = (0, 1)
        if kind == "choice":
            if not self.domain:
                raise MXNetError(
                    f"knob {self.name}: choice knobs need a non-empty "
                    f"domain= candidate set")
            self.bounds = (0, len(self.domain) - 1)
        else:
            if self.domain is not None:
                if not self.domain:
                    raise MXNetError(
                        f"knob {self.name}: empty domain")
                vals = sorted(float(v) for v in self.domain)
                self.bounds = (bounds if bounds is not None
                               else (vals[0], vals[-1]))
            elif bounds is not None:
                self.bounds = bounds
            else:
                raise MXNetError(
                    f"knob {self.name}: declare domain= or bounds= — "
                    f"an unbounded knob is untunable (MXA502)")
            lo, hi = (float(self.bounds[0]), float(self.bounds[1]))
            if not lo < hi and kind != "bool":
                raise MXNetError(
                    f"knob {self.name}: bad bounds {self.bounds} "
                    f"(need lo < hi)")
            self.bounds = (lo, hi)
            if self.domain is not None:
                for v in self.domain:
                    if not lo <= float(v) <= hi:
                        raise MXNetError(
                            f"knob {self.name}: domain value {v} "
                            f"outside bounds {self.bounds}")
        self.default = default
        if default is not None:
            self.check(default)

    # -- values --------------------------------------------------------------

    def check(self, value):
        """Validate one value against the domain/bounds; returns the
        coerced value or raises."""
        if self.kind == "bool":
            return bool(value)
        if self.kind == "choice":
            if value not in self.domain:
                raise MXNetError(
                    f"knob {self.name}: {value!r} not in domain "
                    f"{self.domain}")
            return value
        v = float(value)
        lo, hi = self.bounds
        if not lo <= v <= hi:
            raise MXNetError(
                f"knob {self.name}: {value} outside bounds "
                f"[{lo}, {hi}]")
        if self.domain is not None and v not in [float(d) for d
                                                 in self.domain]:
            raise MXNetError(
                f"knob {self.name}: {value} not in domain "
                f"{self.domain}")
        return int(v) if self.kind == "int" else v

    def candidates(self):
        """The candidate values the search walks, in ascending order
        (a geometric ladder between the bounds when no explicit domain
        was declared)."""
        if self.domain is not None:
            return tuple(self.domain)
        lo, hi = self.bounds
        out, v = [], max(lo, 1e-9)
        while v < hi:
            out.append(int(v) if self.kind == "int" else v)
            v *= 2
        out.append(int(hi) if self.kind == "int" else hi)
        return tuple(dict.fromkeys(out))

    def extend_domain(self, value):
        """Add a runtime-derived candidate (the geometry layer's
        traffic-derived bucket grid) to a choice knob's domain."""
        if self.kind != "choice":
            raise MXNetError(
                f"knob {self.name}: extend_domain on a {self.kind} "
                f"knob — only choice domains grow at runtime")
        if value not in self.domain:
            self.domain = self.domain + (value,)
            self.bounds = (0, len(self.domain) - 1)
        return self

    # -- application ---------------------------------------------------------

    def bind(self, setter):
        """Attach a live-object setter called (in addition to the env
        write) on apply — e.g. ``lambda v: setattr(opt,
        'aggregate_num', v)``.  Returns self (chainable)."""
        self._setter = setter
        return self

    def apply(self, value):
        """Apply one validated value: env write (canonical MXTPU_
        spelling) + any bound live setter, or the injected override."""
        value = self.check(value)
        if self._apply is not None:
            self._apply(value)
        else:
            setenv(self.env, value)
        if self._setter is not None:
            self._setter(value)
        return value

    def read(self):
        """Current effective value (env-backed unless overridden);
        falls back to the declared default when unset."""
        if self._read is not None:
            return self._read()
        if self.kind == "bool":
            return getenv(self.env, self.default, bool)
        if self.kind == "choice":
            return getenv(self.env, self.default, str)
        dtype = int if self.kind == "int" else float
        v = getenv(self.env, None, float)
        if v is None:
            return self.default
        return dtype(v)

    def __repr__(self):
        return (f"Knob({self.name}: MXTPU_{self.env} {self.kind} "
                f"bounds={self.bounds} restart={self.restart})")


class KnobRegistry:
    """Ordered, name-unique collection of knobs — the tuner's search
    space and the trial runner's application surface."""

    def __init__(self, knobs=None):
        self._knobs = {}
        for k in (knobs or ()):
            self.register(k)

    def register(self, knob):
        if not isinstance(knob, Knob):
            raise MXNetError("register() takes a Knob")
        if knob.name in self._knobs:
            raise MXNetError(
                f"knob {knob.name!r} already registered")
        self._knobs[knob.name] = knob
        return knob

    def get(self, name):
        try:
            return self._knobs[name]
        except KeyError:
            raise MXNetError(
                f"unknown knob {name!r}; registered: "
                f"{sorted(self._knobs)}") from None

    def names(self):
        return list(self._knobs)

    def __iter__(self):
        return iter(self._knobs.values())

    def __len__(self):
        return len(self._knobs)

    def __contains__(self, name):
        return name in self._knobs

    # -- validation ----------------------------------------------------------

    def validate(self, documented_env=None):
        """Loud registry validation (knob constructors already validate
        bounds/domains; this re-checks the collection-level rules).

        ``documented_env``: the set of documented env-var names
        (``MXTPU_``-prefixed spellings).  When given, a knob whose
        ``MXTPU_<env>`` is not in the set raises — the runtime
        counterpart of the MXA501 static finding, for registries built
        outside the shipped defaults.
        """
        envs = {}
        for k in self:
            if k.env in envs:
                raise MXNetError(
                    f"knobs {envs[k.env]!r} and {k.name!r} both claim "
                    f"env MXTPU_{k.env}")
            envs[k.env] = k.name
            if documented_env is not None and \
                    "MXTPU_" + k.env not in documented_env:
                raise MXNetError(
                    f"knob {k.name}: env MXTPU_{k.env} is not in the "
                    f"documented set — add it to docs/ENV_VARS.md")
        return self

    # -- configs -------------------------------------------------------------

    def current(self, names=None):
        """``{knob name: effective value}`` for the named subset (all
        knobs by default)."""
        return {n: self.get(n).read()
                for n in (names or self.names())}

    def defaults(self, names=None):
        """The shipped hand-tuned config: ``{name: default}``."""
        return {n: self.get(n).default
                for n in (names or self.names())}

    def apply(self, config, allow_restart=True):
        """Apply a ``{name: value}`` config.  ``allow_restart=False``
        refuses (loudly) any non-``free`` knob — the caller is mid
        serving burst and a recompile-forcing move would stall live
        traffic."""
        applied = {}
        for name, value in config.items():
            knob = self.get(name)
            if not allow_restart and knob.restart != "free":
                raise MXNetError(
                    f"knob {name} has restart class {knob.restart!r} "
                    f"and may not move mid-burst")
            applied[name] = knob.apply(value)
        return applied


# ---------------------------------------------------------------------------
# The shipped registry: every hand-set performance knob in the stack.
# Literal env=/domain= kwargs on purpose — the MXA50x analysis pass
# reads them straight off this module's AST and cross-checks
# docs/ENV_VARS.md, so registry<->docs drift is a CI finding.

def default_registry():
    """Build the shipped knob registry (a fresh instance per call:
    tuners/tests mutate bindings and choice domains freely)."""
    reg = KnobRegistry()
    reg.register(Knob(
        "kvstore_bucket_mb", env="KVSTORE_BUCKET_MB", kind="float",
        domain=(1.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0), default=32.0,
        restart="recompile",
        doc="flat gradient-bucket size cap for multi-key pushpull "
            "allreduces (small = many collective launches, big = less "
            "compute/comm overlap)"))
    reg.register(Knob(
        "aggregate_num", env="OPTIMIZER_AGGREGATION_SIZE", kind="int",
        domain=(1, 4, 16, 64, 256), default=64, restart="recompile",
        doc="max params per fused multi-tensor optimizer update call "
            "(1 = one dispatch per parameter)"))
    reg.register(Knob(
        "mesh_shape", env="MESH_SHAPE", kind="choice",
        domain=("", "dp=8", "dp=4,mp=2", "dp=2,mp=4", "dp=2,mp=2"),
        default="", restart="restart",
        doc="spmd mesh shape ('axis=size,...' over dcn/dp/mp/pp; "
            "empty = single-axis data parallel): routes "
            "Trainer.whole_step through the multi-axis GSPMD compiler "
            "(params shard over 'mp', batch over 'dp'); changing the "
            "shape repartitions every live array, hence restart — the "
            "domain is a seed grid, deployments extend it with shapes "
            "matching their device count"))
    reg.register(Knob(
        "pp_microbatches", env="PP_MICROBATCHES", kind="int",
        domain=(0, 2, 4, 8, 16, 32), default=0, restart="recompile",
        doc="pipeline-parallel microbatches per step for the 'pp' "
            "schedule (0 = one per stage): more microbatches shrink "
            "the GPipe bubble (n/(n+P-1) efficiency) but shrink the "
            "per-microbatch batch; a static loop bound, so changing "
            "it recompiles the step"))
    reg.register(Knob(
        "pipeline_prefetch", env="PIPELINE_PREFETCH", kind="int",
        domain=(0, 1, 2, 4, 8), default=2, restart="free",
        doc="prefetch_to_device depth — batches staged on device "
            "ahead of the consumer"))
    reg.register(Knob(
        "pipeline_map_inflight", env="PIPELINE_MAP_INFLIGHT",
        kind="int", domain=(1, 2, 4, 8, 16), default=4, restart="free",
        doc="map-stage in-flight window on the host pool"))
    reg.register(Knob(
        "serve_linger_ms", env="SERVE_LINGER_MS", kind="float",
        domain=(0.0, 0.5, 1.0, 2.0, 5.0, 10.0), default=2.0,
        restart="free",
        doc="batcher coalescing window — how long the first request "
            "of a batch waits for company"))
    reg.register(Knob(
        "serve_buckets", env="SERVE_BUCKETS", kind="choice",
        domain=("1,2,4,8x32,64,128",
                "1,4,8x64,128",
                "1,2,4,8,16x16,32,64,128"),
        default="1,2,4,8x32,64,128", restart="restart",
        doc="ModelServer BucketSpec grid ('batches x lengths'); "
            "changing it re-warms every bucket executable — "
            "geometry.derive_bucket_spec extends this domain at "
            "runtime with the traffic-derived grid"))
    reg.register(Knob(
        "decode_max_slots", env="DECODE_SLOTS", kind="int",
        domain=(1, 2, 4, 8, 16, 32), default=8, restart="restart",
        doc="DecodeServer slot-arena capacity (concurrent sequences "
            "per fixed-shape decode step)"))
    reg.register(Knob(
        "decode_max_len", env="DECODE_MAX_LEN", kind="int",
        domain=(32, 64, 128, 256, 512), default=128, restart="restart",
        doc="per-slot decode cache length (prompt + generated)"))
    reg.register(Knob(
        "decode_page_tokens", env="DECODE_PAGE_TOKENS", kind="int",
        domain=(0, 8, 16, 32, 64), default=0, restart="recompile",
        doc="tokens per paged-KV cache page (0 = contiguous slot "
            "arena); > 0 switches DecodeServer to the paged arena with "
            "token-budget admission and prefix sharing — changes the "
            "pool shapes, so the decode executables re-warm"))
    reg.register(Knob(
        "decode_spec_k", env="DECODE_SPEC_K", kind="int",
        domain=(1, 2, 4, 8), default=1, restart="recompile",
        doc="speculative decoding block size: draft proposes k-1 "
            "tokens per round, target verifies the block in one step "
            "(1 = off; needs the paged arena and a draft model); k is "
            "a static arg of the verify executable, so changing it "
            "recompiles"))
    reg.register(Knob(
        "decode_draft", env="DECODE_DRAFT", kind="bool", default=False,
        restart="recompile",
        doc="attach the serving stack's draft model for speculative "
            "decoding (serve.decode.TinyDraft for the reference "
            "decoder); adds the proposal executable to the warmup "
            "surface"))
    reg.register(Knob(
        "ctrl_scale_up_occupancy", env="CTRL_SCALE_UP_OCCUPANCY",
        kind="float", domain=(0.5, 0.6, 0.75, 0.85, 0.95),
        default=0.75, restart="free",
        doc="control-plane autoscaler scale-UP threshold: mean replica "
            "occupancy (queue depth / capacity hint) that counts as "
            "pressure; re-read every tick, so the tuner steers a live "
            "pool"))
    reg.register(Knob(
        "ctrl_scale_down_occupancy", env="CTRL_SCALE_DOWN_OCCUPANCY",
        kind="float", domain=(0.05, 0.1, 0.25, 0.4), default=0.25,
        restart="free",
        doc="control-plane autoscaler scale-DOWN threshold: mean "
            "occupancy below which sustained idle drains a replica"))
    reg.register(Knob(
        "ctrl_cooldown_sec", env="CTRL_COOLDOWN_SEC", kind="float",
        domain=(5.0, 15.0, 30.0, 60.0, 120.0), default=30.0,
        restart="free",
        doc="minimum seconds between autoscaler actions — the "
            "hysteresis guard against spawn/drain thrash"))
    reg.register(Knob(
        "zero_shard", env="ZERO_SHARD", kind="bool", default=False,
        restart="recompile",
        doc="ZeRO-1 optimizer-state sharding on/off (recompiles the "
            "whole-step executable)"))
    return reg
