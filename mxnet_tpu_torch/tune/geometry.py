"""Traffic-derived serving geometry: stop guessing the bucket grid (ref:
mxnet_tpu/tune/geometry.py).

A ``BucketSpec`` grid is a bet about future traffic: every request pads
up to the smallest compiled shape that covers it, so a grid that
mismatches the real length distribution burns flops on padding, and a
grid with too many entries burns warmup compiles on shapes nobody
sends.  ``ServerStats`` already tallies the actual distributions —
``request_lengths`` (variable-axis length of every submitted request)
and ``group_sizes`` (real size of every executed batch group).  This
module turns those histograms into geometry:

* :func:`derive_lengths` — optimal ≤k-entry length ladder for a
  measured histogram (exact dynamic program minimising padded
  elements, O(n²k) over n distinct observed lengths);
* :func:`derive_batches` — batch-size ladder covering the observed
  group sizes;
* :func:`derive_bucket_spec` — both of the above as a ready
  ``BucketSpec``;
* :func:`derive_decode_geometry` — decode arena ``max_len`` (covers
  p99 prompt + generation budget) and ``max_slots`` (sized to measured
  slot occupancy); with ``paged=True`` also the page-pool geometry
  (``page_tokens`` / ``num_pages`` sized to MEAN tokens in flight,
  not the worst case);
* :func:`parse_grid` / :func:`format_grid` — the
  ``"1,2,4,8x32,64,128"`` string form the ``serve_buckets`` env knob
  carries, so a derived grid can ride an env var into a fresh server.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..serve.buckets import BucketSpec

__all__ = ["parse_grid", "format_grid", "padding_overhead",
           "derive_lengths", "derive_batches", "derive_bucket_spec",
           "derive_decode_geometry"]


# ---------------------------------------------------------------------------
# grid string form (the serve_buckets knob's value)


def parse_grid(s):
    """``"1,2,4,8x32,64,128" -> ((1,2,4,8), (32,64,128))``; the length
    side may be empty (``"1,2,4x"`` = fixed-shape spec)."""
    try:
        batch_s, _, len_s = str(s).partition("x")
        batches = tuple(sorted({int(b) for b in batch_s.split(",") if b}))
        lengths = tuple(sorted({int(l) for l in len_s.split(",") if l}))
    except ValueError:
        raise MXNetError(
            f"bad bucket grid {s!r}; want 'b1,b2,..xl1,l2,..'") from None
    if not batches:
        raise MXNetError(f"bucket grid {s!r} has no batch sizes")
    return batches, lengths or None


def format_grid(batches, lengths=None):
    """Inverse of :func:`parse_grid` (canonical ascending order)."""
    b = ",".join(str(int(x)) for x in sorted(set(batches)))
    l = ",".join(str(int(x)) for x in sorted(set(lengths or ())))
    return f"{b}x{l}"


# ---------------------------------------------------------------------------
# padding accounting


def _align_up(v, align):
    return int(-(-int(v) // align) * align)


def padding_overhead(lengths, hist):
    """Padded-elements overhead of a length ladder over a measured
    ``{length: count}`` histogram: ``padded/real - 1`` (0.0 = no
    waste).  Lengths beyond the top bucket pad to the top bucket (the
    server would reject them; charging the top keeps comparisons
    total)."""
    ladder = sorted(int(l) for l in lengths)
    if not ladder or not hist:
        raise MXNetError("padding_overhead needs a ladder and a "
                         "non-empty histogram")
    real = padded = 0
    for length, count in hist.items():
        length, count = int(length), int(count)
        bucket = next((b for b in ladder if b >= length), ladder[-1])
        real += length * count
        padded += bucket * count
    return padded / real - 1.0


def derive_lengths(hist, max_buckets=4, align=8):
    """Optimal ≤``max_buckets`` length ladder for a measured
    ``{length: count}`` histogram — exact DP minimising total padded
    elements.  Bucket boundaries are observed lengths rounded up to
    ``align`` (tile alignment; odd boundaries waste tiles)."""
    if not hist:
        raise MXNetError("derive_lengths: empty length histogram — "
                         "serve some traffic first")
    max_buckets = max(1, int(max_buckets))
    items = sorted((int(l), int(c)) for l, c in hist.items() if c > 0)
    lengths = [l for l, _c in items]
    counts = [c for _l, c in items]
    cand = [_align_up(l, align) for l in lengths]
    n = len(items)

    # seg[i][j] = padded elements covering items i..j with one bucket
    # at cand[j]
    pre = np.cumsum([0] + counts)
    def seg(i, j):
        return cand[j] * (pre[j + 1] - pre[i])

    INF = float("inf")
    k = min(max_buckets, n)
    # dp[m][j] = min padded elements covering items 0..j with m buckets,
    # the m-th ending at item j
    dp = [[INF] * n for _ in range(k + 1)]
    back = [[-1] * n for _ in range(k + 1)]
    for j in range(n):
        dp[1][j] = seg(0, j)
    for m in range(2, k + 1):
        for j in range(m - 1, n):
            for i in range(m - 2, j):
                c = dp[m - 1][i] + seg(i + 1, j)
                if c < dp[m][j]:
                    dp[m][j] = c
                    back[m][j] = i
    best_m = min(range(1, k + 1), key=lambda m: dp[m][n - 1])
    ladder, j, m = [], n - 1, best_m
    while m >= 1:
        ladder.append(cand[j])
        j, m = back[m][j], m - 1
    return tuple(sorted(set(ladder)))


def derive_batches(group_hist, max_batch=None):
    """Batch-size ladder from the measured ``{group size: batches}``
    histogram: 1 plus powers of two up to the observed (or capped)
    maximum — group sizes are coalescing outcomes, not a stable
    distribution, so a dense optimal ladder would overfit one burst."""
    if not group_hist:
        raise MXNetError("derive_batches: empty group-size histogram")
    top = max(int(g) for g, c in group_hist.items() if c > 0)
    if max_batch is not None:
        top = min(top, int(max_batch))
    out, b = [1], 1
    while b < top:
        b *= 2
        out.append(b)
    return tuple(out)


def derive_bucket_spec(snapshot, example_shape, max_buckets=4,
                       align=8, max_batch=None, pad_value=0.0,
                       dtype="float32"):
    """Build a traffic-derived :class:`BucketSpec` from a
    ``ModelServer.stats()`` snapshot (needs its ``request_lengths`` /
    ``group_sizes`` histograms)."""
    lengths = None
    if any(s is None for s in tuple(example_shape)):
        lengths = derive_lengths(snapshot.get("request_lengths") or {},
                                 max_buckets=max_buckets, align=align)
    batches = derive_batches(snapshot.get("group_sizes") or {},
                             max_batch=max_batch)
    return BucketSpec(batches, example_shape, lengths=lengths,
                      pad_value=pad_value, dtype=dtype)


def derive_decode_geometry(request_lengths, max_new_tokens=32,
                           slot_occupancy=None, max_slots=8, align=8,
                           paged=False, page_tokens=16):
    """Decode arena geometry from measured traffic.

    ``max_len`` covers the p99 observed prompt length plus the
    generation budget, aligned up — big enough that long requests
    don't overflow, no bigger (cache memory is ``max_slots x max_len``
    per layer).  ``max_slots`` resizes toward the measured
    ``slot_occupancy`` (token-step-weighted mean live/max from the
    ``decodeServe`` section): sustained >75% occupancy doubles the
    arena (admission is queuing), <25% halves it (cache memory idles).
    Returns ``{"max_len": ..., "max_slots": ...}``.

    With ``paged=True`` the dict also carries page-pool geometry for
    the paged arena (``DecodeServer(page_tokens=...)``): the per-slot
    worst case stays ``max_len`` (the logical range still has to cover
    the p99 request), but the PHYSICAL pool is sized to the MEAN
    length plus budget — tokens actually in flight — instead of
    ``max_slots x max_len``: ``num_pages = max_slots *
    ceil((mean_len + max_new_tokens) / page_tokens)`` (floored at one
    slot's worst case so a lone p99 request still fits).  That is the
    whole point of paging: heavy-tailed traffic pays device memory for its
    mean, not its tail.
    """
    if not request_lengths:
        raise MXNetError("derive_decode_geometry: empty length "
                         "histogram")
    lens = np.repeat([int(l) for l in sorted(request_lengths)],
                     [int(request_lengths[l]) for l
                      in sorted(request_lengths)])
    p99 = float(np.percentile(lens, 99))
    max_len = _align_up(int(np.ceil(p99)) + int(max_new_tokens), align)
    slots = int(max_slots)
    if slot_occupancy is not None:
        if slot_occupancy > 0.75:
            slots = max_slots * 2
        elif slot_occupancy < 0.25:
            slots = max(1, max_slots // 2)
    out = {"max_len": max_len, "max_slots": slots}
    if paged:
        t = int(page_tokens)
        if t < 1:
            raise MXNetError("derive_decode_geometry: page_tokens "
                             "must be >= 1 when paged=True")
        pages_per_slot = -(-max_len // t)
        mean_span = -(-int(np.ceil(float(np.mean(lens)))
                           + int(max_new_tokens)) // t)
        out["page_tokens"] = t
        out["num_pages"] = max(slots * mean_span, pages_per_slot)
        out["pages_per_slot"] = pages_per_slot
    return out
