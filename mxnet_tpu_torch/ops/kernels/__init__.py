"""The port's hand-written Hopper kernels.

``KERNEL_LIBRARIES`` lists every compiled library (one per CUDA source)
and ``KERNEL_COUNTS`` every kernel's launch counters, by kernel name.
"""
from . import batch_norm, conv_fused, flash_attention, rnn
from .build import build_all

#: every kernel library of the port, one per source under ``csrc/``
KERNEL_LIBRARIES = (flash_attention.library, flash_attention.bwd_library,
                    batch_norm.library, conv_fused.library, rnn.library)

#: every kernel's launch counters (:class:`~.build.KernelCounts`)
KERNEL_COUNTS = {
    "flash_attention_fwd": flash_attention.counts,
    "flash_attention_bwd_dq": flash_attention.dq_counts,
    "flash_attention_bwd_dkv": flash_attention.dkv_counts,
    "bn_stats": batch_norm.counts,
    "matmul_bn_stats": conv_fused.matmul_bn_stats_counts,
    "bn_act_matmul": conv_fused.bn_act_matmul_counts,
    "bn_act_matmul_stats": conv_fused.bn_act_matmul_stats_counts,
    "lstm_fwd": rnn.lstm_fwd_counts,
    "lstm_bwd": rnn.lstm_bwd_counts,
    "gru_fwd": rnn.gru_fwd_counts,
    "gru_bwd": rnn.gru_bwd_counts,
}


def build_all_kernels():
    """Build and load every kernel library, one nvcc per source in parallel."""
    build_all(KERNEL_LIBRARIES)


def reset_counts():
    for c in KERNEL_COUNTS.values():
        c.reset()
