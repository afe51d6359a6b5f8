"""Multi-axis meshes (ref: ``mxnet_tpu/parallel/spmd/``): the shape rules
of :mod:`.mesh`.  ``ShardingPlan``, ``SpmdStepCompiler`` (the sharded
whole step), ``stage_partition``, ``pipeline_apply`` and
``PipelineTrainStep`` come with part 2b of the distributed slice and raise
naming it; ``pick_mesh_shape`` (elastic resizing) with part 3."""
from ...base import MXNetError
from .mesh import (AXIS_ORDER, format_mesh_shape, make_spmd_mesh,
                   mesh_shape_from_env, model_axes, parse_mesh_shape,
                   pick_mesh_shape)


def _later(what):
    return MXNetError(f"parallel.spmd: {what} is not ported yet; it comes "
                      "with part 2b of the distributed slice (slice 7, part "
                      "2b; ROADMAP.md queue 1)")


class ShardingPlan:
    def __init__(self, *args, **kwargs):
        raise _later("ShardingPlan (layouts of Dense, Conv and attention "
                     "parameters)")


class SpmdStepCompiler:
    def __init__(self, *args, **kwargs):
        raise _later("SpmdStepCompiler (the sharded whole step)")


class PipelineTrainStep:
    def __init__(self, *args, **kwargs):
        raise _later("PipelineTrainStep (the pp axis)")


def stage_partition(*args, **kwargs):
    raise _later("stage_partition (the pp axis)")


def pipeline_apply(*args, **kwargs):
    raise _later("pipeline_apply (the pp axis)")


def default_microbatches(*args, **kwargs):
    raise _later("default_microbatches (the pp axis)")


__all__ = [
    "AXIS_ORDER", "parse_mesh_shape", "format_mesh_shape",
    "mesh_shape_from_env", "make_spmd_mesh", "model_axes",
    "pick_mesh_shape", "ShardingPlan", "SpmdStepCompiler",
    "stage_partition", "default_microbatches", "pipeline_apply",
    "PipelineTrainStep",
]
