"""Multi-axis meshes (ref: ``mxnet_tpu/parallel/spmd/``): the shape rules
of :mod:`.mesh`, the :class:`ShardingPlan` of :mod:`.plan`, the
:class:`SpmdStepCompiler` behind ``Trainer(mesh_shape=...)`` of
:mod:`.lowering`, the products split over ``mp`` of :mod:`.products`
(slice 7, part 2b, piece 2), and the ``pp`` axis of :mod:`.schedule`:
:func:`stage_partition`, :func:`default_microbatches`,
:func:`pipeline_apply` and :class:`PipelineTrainStep` (piece 3).
``pick_mesh_shape`` (elastic resizing) comes with part 3."""
from . import products  # noqa: F401
from .lowering import SpmdStepCompiler
from .mesh import (AXIS_ORDER, format_mesh_shape, make_spmd_mesh,
                   mesh_shape_from_env, model_axes, parse_mesh_shape,
                   pick_mesh_shape)
from .plan import ShardingPlan
from .schedule import (PipelineTrainStep, default_microbatches,
                       pipeline_apply, stage_partition)

__all__ = [
    "AXIS_ORDER", "parse_mesh_shape", "format_mesh_shape",
    "mesh_shape_from_env", "make_spmd_mesh", "model_axes",
    "pick_mesh_shape", "ShardingPlan", "SpmdStepCompiler",
    "stage_partition", "default_microbatches", "pipeline_apply",
    "PipelineTrainStep",
]
