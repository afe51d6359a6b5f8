"""Parallel training (ref: ``mxnet_tpu/parallel/``): ``dist``, the process
group and its collectives on ``torch.distributed`` (slice 7, part 1);
``mesh``, meshes of one rank per device, and ``spmd``'s mesh-shape rules;
and ``DataParallelTrainer`` over a mesh (dp, dcn, tp, ZeRO-1 states,
remat; part 2a).  The Trainer's ZeRO runs over several contexts
(``gluon.trainer``) and over the ranks of the process group
(``gluon.whole_step.WorldStep``; part 2b, piece 1).  ``Trainer(mesh_shape=,
sharding_plan=)`` runs on ``spmd``'s plan, lowering and the products split
over ``mp`` (piece 2).  ``spmd``'s schedule (the ``pp`` axis, piece 3) and
the captured step with collectives (piece 4) come with part 2b's later
pieces; ``ring_attention``, ``ulysses``, ``moe``, ``pipeline_lm``, ``ps`` and
elastic resizing with part 3 (ROADMAP queue 1)."""
from . import data_parallel, dist, mesh, spmd  # noqa: F401
from .data_parallel import DataParallelTrainer  # noqa: F401
