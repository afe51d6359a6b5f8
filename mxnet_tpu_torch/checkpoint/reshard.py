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
- **Mesh shapes** (the ``"mesh_shape"`` of a ``Trainer(mesh_shape=...)``
  states blob): the leaves are full arrays, so any mesh change is a remap
  that the next step makes; :func:`check_mesh_change` validates it and
  logs it, loudly where the model axes change.
- **Input-pipeline cursors** (``pipeline-shard<r>.state``): the
  ``shard(num_replicas, rank)`` contract makes every rank's state equal,
  so :func:`merge_pipeline_states` checks that they agree and returns the
  common one.

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
    """Book the time a reshard took into the resilience telemetry
    (``reshard_ms`` in the profiler's ``resilience`` section; ref:
    ``mxnet_tpu/checkpoint/reshard.py:57-65``) and log it."""
    from ..resilience import stats as _rstats

    _rstats.add("reshard_ms", float(dt_s) * 1e3)
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
    new one where it changed.  (States saved on a mesh hold full arrays:
    ``Trainer.load_states_dict`` checks their ``"mesh_shape"`` with
    :func:`check_mesh_change`.)"""
    if not isinstance(blob, dict):
        return blob
    if blob.get("zero"):
        zero = blob["zero"]
        if int(zero.get("world", new_world)) != int(new_world):
            blob = dict(blob)
            blob["zero"] = reshard_zero_snapshot(zero, new_world)
    return blob


# -- multi-axis mesh shapes ----------------------------------------------------


def check_mesh_change(saved_shape, new_shape, source="<checkpoint>"):
    """Validate restoring states saved on mesh ``saved_shape`` into a
    trainer on ``new_shape`` (ref: ``check_mesh_change``, reshard.py:
    144-190); either side a spec string, a shape dict or None (no mesh).

    The saved leaves are full arrays, so any change is representationally
    fine: the first step at the new shape slices every array by the new
    plan.  A change of the model-axis product (``mp`` * ``pp``) is a
    deliberate change of model parallelism: allowed, and logged as a
    warning; a change of the data axes alone is logged at INFO.  Returns
    the parsed new shape (or None)."""
    from ..parallel.spmd.mesh import (format_mesh_shape, model_axes,
                                      parse_mesh_shape)

    saved = parse_mesh_shape(saved_shape) if saved_shape else None
    new = parse_mesh_shape(new_shape) if new_shape else None
    if saved == new:
        return new
    saved_txt = format_mesh_shape(saved) if saved else "<single-axis>"
    new_txt = format_mesh_shape(new) if new else "<single-axis>"
    if new is None:
        _log.warning(
            "%s: snapshot was saved on spmd mesh %s but this trainer "
            "has no mesh_shape — restoring onto the single-axis path "
            "(full arrays; valid, the tensor-parallel layout is "
            "dropped)", source, saved_txt)
        return new
    old_model = int(np.prod(list(model_axes(saved or {}).values()) or [1]))
    new_model = int(np.prod(list(model_axes(new).values()) or [1]))
    if old_model != new_model:
        _log.warning(
            "%s: restoring across a MODEL-parallelism change: saved "
            "mesh %s (mp*pp=%d) -> new mesh %s (mp*pp=%d). Valid "
            "(snapshots hold full arrays) but deliberate-only: the "
            "collective pattern and per-device memory change.",
            source, saved_txt, old_model, new_txt, new_model)
    else:
        _log.info(
            "%s: elastic mesh reshape on restore: %s -> %s (data axes "
            "only; model axes preserved)", source, saved_txt, new_txt)
    return new


# -- pipeline state ---------------------------------------------------------


def _tree_equal(a, b):
    """Structural equality over the host trees pipeline states are made
    of (dicts/lists/tuples/numpy/scalars)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.shape == b.shape and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            _tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            _tree_equal(x, y) for x, y in zip(a, b))
    try:
        return bool(a == b)
    except Exception:  # exotic leaf: identity is the best we can do
        return a is b


def merge_pipeline_states(blobs, where="<checkpoint>"):
    """Merge the per-rank ``pipeline-shard<r>.state`` blobs of a saved
    world into the ONE rank-symmetric state a resized job loads.

    The ``shard(num_replicas, rank)`` contract makes every rank's
    state identical by construction (same source cursor, same shuffle
    ring + RNG, same rollover) — so the merge is agreement
    VERIFICATION: stage by stage, every rank's saved state must be
    equal; the common value is the merged cursor.  A disagreeing stage
    means per-rank in-flight data that cannot be repartitioned across
    a different world — that raises loudly, naming the stage."""
    if not blobs:
        raise MXNetError(f"{where}: no pipeline shard states to merge")
    first = blobs[0]
    stages0 = (first or {}).get("stages")
    if stages0 is None:
        raise MXNetError(
            f"{where}: unrecognized pipeline state (no stages) — was "
            "it saved by a newer build?")
    for r, blob in enumerate(blobs[1:], start=1):
        stages = (blob or {}).get("stages")
        if stages is None or len(stages) != len(stages0) or any(
                s["type"] != s0["type"]
                for s, s0 in zip(stages, stages0)):
            raise MXNetError(
                f"{where}: pipeline compositions differ across saved "
                f"ranks (rank 0 vs rank {r}) — the per-rank pipelines "
                "of one job must be built identically to reshard")
        for s, s0 in zip(stages, stages0):
            if not _tree_equal(s["state"], s0["state"]):
                raise MXNetError(
                    f"{where}: pipeline stage {s['type']} state "
                    f"differs between saved rank 0 and rank {r} — "
                    "per-rank in-flight data cannot be repartitioned "
                    "across world sizes. Checkpoint at a shard-group "
                    "boundary, or rebuild the input pipeline from "
                    "the epoch start (restore with pipeline=None and "
                    "re-create it). strict_topology=True restores the "
                    "plain world-size rejection.")
    return first
