"""Closed-loop autotuner: measured trials + cost-model search over the
live knob surface (ref: mxnet_tpu/tune/, a host-side copy).

The sensor layer (health windows, profiler sections, ``/metrics``)
already reports how fast the system runs; this package moves the knobs
itself.  ``knobs`` is the typed registry of everything tunable,
``trials`` the seeded measured-window protocol, ``cost_model`` the
cheap ranking filter in front of expensive real trials, ``geometry``
the traffic-derived serving shapes, and ``tuner`` the coordinate
descent that ties them into ``Tuner.recommend()`` — a config plus the
evidence trail that earned it.

On the card a knob of restart class ``recompile`` means new captures
(CUDA graphs) at the next warm-up; the trial runner debits them
(``trials.profiler_compiles``).  Score serving trials by the measured
window's wall time: the health monitor's step time is the host's
enqueue time of a replay.
"""
from .knobs import (Knob, KnobRegistry, default_registry,
                    RESTART_CLASSES)
from .trials import (TrialRunner, default_objective, tune_stats,
                     reset_tune_stats)
from .cost_model import CostModel
from .geometry import (parse_grid, format_grid, padding_overhead,
                       derive_lengths, derive_batches,
                       derive_bucket_spec, derive_decode_geometry)
from .tuner import Tuner, Recommendation

__all__ = [
    "Knob", "KnobRegistry", "default_registry", "RESTART_CLASSES",
    "TrialRunner", "default_objective", "tune_stats",
    "reset_tune_stats", "CostModel", "parse_grid", "format_grid",
    "padding_overhead", "derive_lengths", "derive_batches",
    "derive_bucket_spec", "derive_decode_geometry", "Tuner",
    "Recommendation",
]
