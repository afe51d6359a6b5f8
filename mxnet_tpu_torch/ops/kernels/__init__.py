"""The port's hand-written Hopper kernels.

Every kernel module here has ``library`` (its
:class:`~.build.KernelLibrary`) and ``counts`` (its launch counters).
"""
from . import flash_attention
from .build import build_all

#: every kernel module of the port
KERNEL_MODULES = (flash_attention,)


def build_all_kernels():
    """Build and load every kernel library, one nvcc per source in parallel."""
    build_all([m.library for m in KERNEL_MODULES])


def reset_counts():
    for m in KERNEL_MODULES:
        m.counts.reset()
