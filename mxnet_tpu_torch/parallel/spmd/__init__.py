"""Multi-axis meshes (ref: ``mxnet_tpu/parallel/spmd/``): the shape rules
of :mod:`.mesh`, the :class:`ShardingPlan` of :mod:`.plan`, the
:class:`SpmdStepCompiler` behind ``Trainer(mesh_shape=...)`` of
:mod:`.lowering`, and the products split over ``mp`` of :mod:`.products`
(slice 7, part 2b, piece 2).  ``stage_partition``, ``pipeline_apply``,
``default_microbatches`` and ``PipelineTrainStep`` (the ``pp`` axis) come
with piece 3 of part 2b and raise naming it; ``pick_mesh_shape`` (elastic
resizing) with part 3."""
from ...base import MXNetError
from . import products  # noqa: F401
from .lowering import SpmdStepCompiler
from .mesh import (AXIS_ORDER, format_mesh_shape, make_spmd_mesh,
                   mesh_shape_from_env, model_axes, parse_mesh_shape,
                   pick_mesh_shape)
from .plan import ShardingPlan


def _later(what):
    return MXNetError(f"parallel.spmd: {what} is not ported yet; it comes "
                      "with piece 3 of part 2b of the distributed slice (the "
                      "pp axis: slice 7, part 2b, piece 3; ROADMAP.md queue "
                      "1)")


class PipelineTrainStep:
    def __init__(self, *args, **kwargs):
        raise _later("PipelineTrainStep")


def stage_partition(*args, **kwargs):
    raise _later("stage_partition")


def pipeline_apply(*args, **kwargs):
    raise _later("pipeline_apply")


def default_microbatches(*args, **kwargs):
    raise _later("default_microbatches")


__all__ = [
    "AXIS_ORDER", "parse_mesh_shape", "format_mesh_shape",
    "mesh_shape_from_env", "make_spmd_mesh", "model_axes",
    "pick_mesh_shape", "ShardingPlan", "SpmdStepCompiler",
    "stage_partition", "default_microbatches", "pipeline_apply",
    "PipelineTrainStep",
]
