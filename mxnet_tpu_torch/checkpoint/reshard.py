"""Checkpoint resharding: a checkpoint saved at world size N restored by a
job at world size M (ref: ``mxnet_tpu/checkpoint/reshard.py:47-210``).

One leg per kind of saved file:

- **Parameters and RNG** (``params-shard<r>.params``, ``rng-shard<r>.json``):
  data-parallel training replicates them across the ranks, so resharding
  is a remap: rank ``r`` of the new world reads the saved shard
  :func:`source_rank`\\ ``(r, saved_world)``.
- **ZeRO-1 optimizer shards** (the ``"zero"`` entry of
  ``trainer-shard<r>.states``), 1/world a rank:
  :func:`reshard_zero_snapshot` gathers each chunk's shards on the host,
  drops the old pad, pads to the new world's ``zero_padded_size`` and
  slices again.  It only moves bytes, so N -> M -> N gives the same bytes.
- **Input-pipeline cursors** (``pipeline-shard<r>.state``):
  :func:`merge_pipeline_states` comes with the input pipelines of slice 8
  and raises naming it.

``CheckpointManager.restore(strict_topology=True)`` turns all of this off
and refuses a checkpoint of another world size.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..base import MXNetError

_log = logging.getLogger("mxnet_tpu_torch.checkpoint")


def source_rank(rank, saved_world):
    """The saved shard file that rank ``rank`` of the new world reads: its
    own where the saved world has it, else ``rank % saved_world`` (the
    shards are rank-replicated)."""
    saved_world = max(int(saved_world), 1)
    rank = int(rank)
    return rank if rank < saved_world else rank % saved_world


def _book_reshard_ms(dt_s):
    """Report the time a reshard took.  The JAX package books it into its
    resilience telemetry (``reshard_ms``); that tier comes with slice 8, so
    the port logs it."""
    _log.info("checkpoint: resharding took %.3f ms", float(dt_s) * 1e3)


# -- ZeRO-1 optimizer shards --------------------------------------------------


def _shard_np(s):
    """A shard slot as numpy (a live tensor, an NDArray or numpy after a
    pickle); bfloat16 widened to float32, which holds it exactly."""
    if hasattr(s, "asnumpy"):
        return s.asnumpy()
    if isinstance(s, torch.Tensor):
        s = s.detach()
        return (s.float() if s.dtype == torch.bfloat16 else s).cpu().numpy()
    return np.asarray(s)


def _chunk_of(rank_chunks, c):
    """Chunk ``c`` of one rank's shards (int or str keys: JSON round trips
    make them strings)."""
    if c in rank_chunks:
        return rank_chunks[c]
    return rank_chunks[str(c)]


def reshard_zero_snapshot(zero, new_world):
    """A ZeRO-1 snapshot (``Trainer.states_dict()["zero"]``: world, chunks,
    per-rank flat shards) repartitioned from its world onto ``new_world``
    ranks: each chunk's shards concatenated, cut at ``total``, padded to
    the new world's ``zero_padded_size`` and sliced into ``new_world``
    equal shards, the layout a ``new_world`` job's plan makes, so
    ``Trainer.load_states_dict`` adopts them as they are.  Exact: N -> M ->
    N gives the same bytes.  Needs every saved rank's shards
    (``CheckpointManager`` gathers the per-rank files first)."""
    from ..kvstore import zero_padded_size

    old_world = int(zero["world"])
    new_world = int(new_world)
    if new_world < 1:
        raise MXNetError(f"cannot reshard ZeRO snapshot onto "
                         f"{new_world} rank(s)")
    if old_world == new_world:
        return zero
    shards = {int(r): v for r, v in zero["shards"].items()}
    have = set(shards)
    if have != set(range(old_world)):
        raise MXNetError(
            f"ZeRO snapshot is sharded across {old_world} rank(s) but "
            f"only rank(s) {sorted(have)} are present — gather every "
            "trainer-shard<r>.states first (CheckpointManager does)")
    new_chunks, new_shards = [], {r: {} for r in range(new_world)}
    for c, chunk in enumerate(zero["chunks"]):
        total = int(chunk["total"])
        padded = zero_padded_size(total, new_world)
        shard_n = padded // new_world
        new_chunks.append(dict(chunk, padded=padded))
        per_rank = [[] for _ in range(new_world)]
        for slot in range(int(chunk["n_states"])):
            full = np.concatenate(
                [_shard_np(_chunk_of(shards[r], c)[slot])
                 for r in range(old_world)])[:total]
            if padded > total:
                full = np.concatenate(
                    [full, np.zeros(padded - total, dtype=full.dtype)])
            for r in range(new_world):
                per_rank[r].append(full[r * shard_n:(r + 1) * shard_n])
        for r in range(new_world):
            new_shards[r][c] = per_rank[r]
    return {"world": new_world, "chunks": new_chunks, "shards": new_shards}


def reshard_states_blob(blob, new_world):
    """One trainer states blob repartitioned for a ``new_world``-rank job:
    its ZeRO snapshot by :func:`reshard_zero_snapshot`.  Returns the blob, a
    new one where it changed.  (The JAX package's ``check_mesh_change``, the
    check of states saved on an spmd mesh, comes with the ``mesh_shape``
    restore of slice 7, part 2b, piece 2.)"""
    if not isinstance(blob, dict):
        return blob
    if blob.get("zero"):
        zero = blob["zero"]
        if int(zero.get("world", new_world)) != int(new_world):
            blob = dict(blob)
            blob["zero"] = reshard_zero_snapshot(zero, new_world)
    return blob


def merge_pipeline_states(blobs, where="<checkpoint>"):
    """The per-rank input-pipeline cursors merged for a resized job: the
    pipelines come with slice 8 of the port."""
    raise MXNetError(
        f"{where}: merge_pipeline_states (resharding input-pipeline "
        "cursors) is not ported yet; it comes with slice 8 of the port, "
        "with the input pipelines (ROADMAP.md queue 1)")
