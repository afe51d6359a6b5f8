"""The old import path of the pipeline schedule (ref:
``mxnet_tpu/parallel/pipeline.py``), which lives in
``parallel.spmd.schedule``: :func:`pipeline_apply` and
:func:`stage_partition`; see also
:class:`~mxnet_tpu_torch.parallel.spmd.schedule.PipelineTrainStep`."""
from .spmd.schedule import pipeline_apply, stage_partition  # noqa: F401

__all__ = ["pipeline_apply", "stage_partition"]
