"""Parallel training (ref: ``mxnet_tpu/parallel/``): ``dist``, the process
group and its collectives on ``torch.distributed`` (slice 7, part 1);
``mesh``, meshes of one rank per device, and ``spmd``'s mesh-shape rules;
and ``DataParallelTrainer`` over a mesh (dp, dcn, tp, ZeRO-1 states,
remat; part 2a).  The Trainer's ZeRO runs over several contexts
(``gluon.trainer``) and over the ranks of the process group
(``gluon.whole_step.WorldStep``; part 2b, piece 1).  ``Trainer(mesh_shape=,
sharding_plan=)`` runs on ``spmd``'s plan, lowering and the products split
over ``mp`` (piece 2).  The ``pp`` axis is ``spmd``'s schedule
(``stage_partition``, ``pipeline_apply``, ``PipelineTrainStep``; the old
path ``pipeline``) and ``pipeline_lm``'s ``PipelineLMTrainer`` over dp x
sp x tp x pp; the ``sp`` axis's standalone entries are ``ring_attention``
and ``ulysses`` (piece 3).  The captured step with collectives (piece 4)
comes last; ``moe``, ``ps`` and elastic resizing with part 3 (ROADMAP
queue 1)."""
from . import data_parallel, dist, mesh, spmd  # noqa: F401
from . import pipeline, pipeline_lm, ring_attention, ulysses  # noqa: F401
from .data_parallel import DataParallelTrainer  # noqa: F401
