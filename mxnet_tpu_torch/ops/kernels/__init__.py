"""The port's hand-written Hopper kernels.

``KERNEL_LIBRARIES`` lists every compiled library (one per CUDA source)
and ``KERNEL_COUNTS`` every kernel's launch counters, by kernel name.
"""
from . import flash_attention
from .build import build_all

#: every kernel library of the port, one per source under ``csrc/``
KERNEL_LIBRARIES = (flash_attention.library, flash_attention.bwd_library)

#: every kernel's launch counters (:class:`~.flash_attention.KernelCounts`)
KERNEL_COUNTS = {
    "flash_attention_fwd": flash_attention.counts,
    "flash_attention_bwd_dq": flash_attention.dq_counts,
    "flash_attention_bwd_dkv": flash_attention.dkv_counts,
}


def build_all_kernels():
    """Build and load every kernel library, one nvcc per source in parallel."""
    build_all(KERNEL_LIBRARIES)


def reset_counts():
    for c in KERNEL_COUNTS.values():
        c.reset()
