"""Continuous batching: token-level decode scheduling over a slot arena
(ref: mxnet_tpu/serve/decode.py).

:class:`DecodeServer` schedules autoregressive decode at token
granularity (iteration-level scheduling) with the serve tier's closed
capture surface:

- The decode state is a fixed-capacity **slot arena**: the model's cache
  buffers of shape ``(max_slots, max_len, ...)`` on the device, plus host
  cursors, last-token ids and an active mask.  The per-token step is ONE
  captured CUDA graph (``gluon.block.CachedStepOp``) of fixed shapes that
  reads and writes the arena buffers in place; inactive slots are masked.
  Steady traffic captures nothing new.
- New requests are **admitted between tokens** into free slots: the
  group's prompts run through the prefill :class:`BucketSpec` grid with
  the slot scatter in the same graph, one replay per admission group.
  Finished, expired and cancelled requests free their slot at the next
  token boundary.
- The serve substrate is reused: the bounded :class:`~.batcher.Batcher`
  admission queue (``ServerOverloadedError`` backpressure), deadlines
  checked at token boundaries, graceful drain, ``reload_weights()``
  between tokens, a :class:`DecodeHandle` token stream beside the
  ``Future``, ``ServerStats`` (TTFT and per-token latency windows, slot
  occupancy), the ``decodeServe`` profiler section and the
  ``serve.decode.request`` tracer spans.

Decode model contract (``TinyDecoder`` is the reference), on tensors::

    model.prefill(prompts, lengths) -> (first_tokens, *cache_rows)
        prompts : (batch, L) int32, padded to a prefill bucket
        lengths : (batch,) int32 real prompt lengths
        first_tokens : (batch,) int32, the first generated token
        cache_rows   : (batch, L, ...) per-position state for the slot

    model.decode_step(tokens, cursors, active, *cache)
        -> (next_tokens, *new_cache)
        tokens, cursors : (max_slots,) int32; active : (max_slots,) bool
        cache : (max_slots, max_len, ...) buffers; inactive slots carry
        garbage and must be masked out of writes and kept NaN-safe

Both run inside the captured steps, so parameters are read where they
live: a reload that copies new values in needs no new capture.

**Paged mode** (``page_tokens > 0``): the cache buffers are
``(num_pages + 1, page_tokens, ...)`` pools, and each slot's logical
range maps onto physical pages through a ``(max_slots, pages_per_slot)``
int32 page table, an input of the same fixed-shape steps (the gather,
the model step and the scatter back are inside the graph).  Admission
hashes the prompt at page granularity (``serve.paging.PrefixIndex``):
hits share resident pages with a refcount, and the first write into a
shared page copies it first, inside the step (a host-computed
(src, dst) pair a slot).  Admission is a token-budget check against free
pages.

**Speculative decoding** (paged mode + ``draft=``): the draft proposes
``spec_k - 1`` tokens a round (one replay each) and the target verifies
the block in one step (``static_kwargs={"k": spec_k}``).  Greedy
acceptance (accept while the draft token equals the target's argmax,
then emit the target's correction) makes speculative output identical to
non-speculative output.  The draft keeps a position-free state row a
slot, re-synced to the committed tokens inside the verify step.

Deliberate difference: the JAX package donates the arena to each step
and takes the new buffers back; here the steps write the arena in place.
"""
from __future__ import annotations

import queue as _queue_mod
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout

import numpy as np
import torch

from .. import engine, profiler
from .. import random as _random
from ..base import MXNetError, getenv
from ..context import current_context
from ..gluon.block import Block, CachedStepOp
from ..ndarray.ndarray import NDArray
from ..telemetry import tracer as _tracer
from .batcher import (Batcher, DeadlineExceededError, _Request,
                      ServerClosedError, ServerOverloadedError)
from .buckets import BucketSpec
from .paging import PageAllocator, PrefixIndex, chunk_keys, pages_spanned
from .server import _int8_batch_hook
from .stats import LatencyWindow, ServerStats

#: the decode tier's counters (``batches`` counts admission groups, one
#: replay each; ``decode_steps`` counts verify steps under speculation and
#: ``spec_draft_steps`` the proposal steps, so the dispatches are
#: ``decode_steps + spec_draft_steps + batches``)
DECODE_COUNTERS = ("submitted", "served", "rejected_overload",
                   "expired_deadline", "failed", "cancelled", "admitted",
                   "batches", "decode_steps", "tokens",
                   "warmup_batches", "reloads",
                   "page_allocs", "page_frees", "page_cow",
                   "page_prefix_hits", "spec_rounds", "spec_draft_steps")

_DONE = object()          # stream sentinel: generation finished cleanly
#: public alias: sinks compare their terminal item against it
STREAM_DONE = _DONE


# -- window-scoped module counters: the profiler's `decodeServe` section ------

_sec_lock = threading.Lock()
_sec = {"steps": 0, "tokens": 0, "prefill_batches": 0, "admitted": 0,
        "finished": 0, "expired_deadlines": 0, "occ_ratio_sum": 0.0,
        "pages_in_flight": 0, "cow_copies": 0, "prefix_hit_pages": 0,
        "draft_steps": 0, "spec_proposed": 0, "spec_accepted": 0}


def _sec_bump(live_ratio=None, pages_in_flight=None, **deltas):
    with _sec_lock:
        for k, n in deltas.items():
            _sec[k] += n
        if live_ratio is not None:
            _sec["occ_ratio_sum"] += live_ratio
        if pages_in_flight is not None:
            # a level gauge: the latest count of live pages
            _sec["pages_in_flight"] = pages_in_flight


def decode_serve_stats():
    """Window snapshot of the continuous-batching counters;
    ``slot_occupancy`` is the token-step-weighted mean live/max_slots,
    ``accept_rate`` the accepted/proposed draft-token ratio."""
    with _sec_lock:
        d = dict(_sec)
    occ = d.pop("occ_ratio_sum")
    d["slot_occupancy"] = round(occ / d["steps"], 4) if d["steps"] else 0.0
    d["accept_rate"] = (round(d["spec_accepted"] / d["spec_proposed"], 4)
                        if d["spec_proposed"] else 0.0)
    return d


def reset_decode_serve_stats():
    with _sec_lock:
        for k in _sec:
            _sec[k] = 0.0 if k == "occ_ratio_sum" else 0


# -- request / handle ---------------------------------------------------------


class _DecodeRequest(_Request):
    __slots__ = ("max_new_tokens", "generated", "slot", "stream",
                 "cancelled", "admitted_at", "sinks", "sink_lock",
                 "terminal")

    def __init__(self, prompt, length, future, max_new_tokens,
                 deadline_ms=None):
        super().__init__(prompt, length, future, deadline_ms=deadline_ms)
        self.max_new_tokens = int(max_new_tokens)
        self.generated = []
        self.slot = None
        self.stream = _queue_mod.Queue()
        self.cancelled = False
        self.admitted_at = None
        self.sinks = []
        self.sink_lock = threading.Lock()
        self.terminal = None

    def fanout(self, item):
        """Deliver one stream item (token, STREAM_DONE or an exception) to
        every sink; the lock keeps a concurrent ``add_sink`` replay
        exactly-once."""
        with self.sink_lock:
            if item is not _DONE and not isinstance(item, BaseException):
                self.generated.append(item)
            else:
                self.terminal = item
            sinks = list(self.sinks)
        for s in sinks:
            try:
                s(item)
            except Exception:  # noqa: BLE001 -- a broken tap must never
                # kill the decode loop
                with self.sink_lock:
                    if s in self.sinks:
                        self.sinks.remove(s)


class DecodeHandle:
    """A request's streaming handle: iterate its tokens as they are
    generated, or wait on :attr:`future` for the whole sequence.
    Iteration ends with ``StopIteration`` on a clean finish and re-raises
    the terminal error (deadline, cancellation, shutdown, model failure)
    otherwise."""

    def __init__(self, req):
        self._req = req
        self.future = req.future

    def __iter__(self):
        return self

    def __next__(self):
        item = self._req.stream.get()
        if item is _DONE:
            self._req.stream.put(_DONE)   # stays consumable
            raise StopIteration
        if isinstance(item, BaseException):
            self._req.stream.put(item)
            raise item
        return item

    def result(self, timeout=None):
        """The full generated token sequence (np.int32 array)."""
        return self.future.result(timeout)

    def cancel(self):
        """Give up: voided at dequeue if still queued, freed at the next
        token boundary if decoding."""
        self._req.cancelled = True
        self._req.future.cancel()

    def add_sink(self, sink):
        """Register a callable that receives every stream item of this
        request, then exactly one terminal (STREAM_DONE or the exception);
        the history so far is replayed first.  A raising sink is
        dropped."""
        req = self._req
        with req.sink_lock:
            for t in req.generated:
                sink(t)
            if req.terminal is not None:
                sink(req.terminal)
            req.sinks.append(sink)


# -- step adapters: the bodies of the CachedStepOps ---------------------------


def _model_out(out, what):
    if not isinstance(out, (tuple, list)) or len(out) < 2:
        raise MXNetError(f"{what} must return (tokens, *state)")
    return out


def _scatter_rows(buf, rows, slots):
    """Write ``rows[i]`` into ``buf[slots[i], :L]``, row by row in reverse:
    padding rows carry ``slots[0]`` and land first, and row 0's own write
    (last) overwrites them, so a dead row never reaches a live slot.  The
    writes are sequential launches: an indexed write with repeated indices
    has no defined order on CUDA."""
    view = buf.narrow(1, 0, rows.shape[1])
    rows = rows.to(buf.dtype)
    slots = slots.long()
    for i in reversed(range(rows.shape[0])):
        view.index_copy_(0, slots[i:i + 1], rows[i:i + 1])


class _AdmitAdapter(Block):
    """One admission group: ``model.prefill`` and the scatter of every
    admitted request's cache rows into its slot, one graph a prefill
    bucket."""

    def __init__(self, model, n_cache):
        super().__init__()
        self.model = model
        self._n_cache = int(n_cache)

    def forward(self, prompts, lengths, slots, *cache):
        out = _model_out(self.model.prefill(prompts, lengths),
                         "model.prefill")
        for c, r in zip(cache, out[1:self._n_cache + 1]):
            _scatter_rows(c, r, slots)
        return (out[0],)


class _StepAdapter(Block):
    """``model.decode_step``: with ``inplace`` (the target's step) the new
    cache is written into the arena and only the tokens return; without
    (the draft's proposal steps) the new state returns too."""

    def __init__(self, model, inplace=True):
        super().__init__()
        self.model = model
        self._inplace = bool(inplace)

    def forward(self, tokens, cursors, active, *cache):
        out = _model_out(self.model.decode_step(tokens, cursors, active,
                                                *cache),
                         "model.decode_step")
        if not self._inplace:
            return tuple(out)
        for c, new in zip(cache, out[1:]):
            if new is not c:
                c.copy_(new)
        return (out[0],)


class _PagedAdmitAdapter(Block):
    """Admission into the paged arena: ``model.prefill`` and the scatter of
    the cache rows into the freshly allocated pages (``admit_pt`` maps
    prefix hits and padding rows to the trash page, so resident shared
    pages keep their bytes).  With a draft, ``draft.prefill`` runs in the
    same graph and each row's last real position seeds the slot's draft
    state."""

    def __init__(self, model, n_cache, page_tokens, draft=None, n_draft=0):
        super().__init__()
        self.model = model
        self._n_cache = int(n_cache)
        self._t = int(page_tokens)
        self.draft = draft
        self._n_draft = int(n_draft)

    def forward(self, prompts, lengths, admit_pt, *rest):
        if self.draft is not None:
            slots, rest = rest[0], rest[1:]
        pools = rest[:self._n_cache]
        dstate = rest[self._n_cache:]
        out = _model_out(self.model.prefill(prompts, lengths),
                         "model.prefill")
        for c, r in zip(pools, out[1:self._n_cache + 1]):
            b, lb = r.shape[0], r.shape[1]
            nb = -(-lb // self._t)
            pad = nb * self._t - lb
            if pad:
                r = torch.nn.functional.pad(
                    r, [0, 0] * (r.dim() - 2) + [0, pad])
            pages = r.reshape((b * nb, self._t) + tuple(r.shape[2:]))
            c.index_copy_(0, admit_pt[:, :nb].reshape(-1).long(),
                          pages.to(c.dtype))
        if self.draft is not None:
            dout = _model_out(self.draft.prefill(prompts, lengths),
                              "draft.prefill")
            idx = torch.clamp(lengths.long() - 1, min=0)
            for a, r in zip(dstate, dout[1:self._n_draft + 1]):
                last = r[torch.arange(r.shape[0], device=r.device), idx]
                _scatter_rows(a, last.unsqueeze(1), slots)
        return (out[0],)


class _PagedStepAdapter(Block):
    """The paged decode/verify step, one fixed-shape graph: (1) the
    pending copy-on-write page copies, (2) each slot's logical view
    gathered through its page table, (3) ``k`` chained
    ``model.decode_step`` calls over the block of candidate tokens (k == 1
    is plain paged decode), (4) the logical views scattered back, and (5)
    with a draft, the accepted tokens folded into the draft state.

    Lane ``j`` of the unroll is active for a slot only while ``j <
    depths[slot]``, so a slot never writes past its committed page span.
    Shared pages are never written (copy-on-write moves the write frontier
    first), so the scatter back rewrites their identical bytes; repeated
    trash entries may take any row's garbage."""

    def __init__(self, model, n_cache, page_tokens, draft=None, n_draft=0):
        super().__init__()
        self.model = model
        self._n_cache = int(n_cache)
        self._t = int(page_tokens)
        self.draft = draft
        self._n_draft = int(n_draft)

    def forward(self, tok_block, cursors, depths, active, page_table,
                cow_src, cow_dst, *cache, k=1):
        pools = cache[:self._n_cache]
        dstate = cache[self._n_cache:]
        s_n, p_n = page_table.shape
        length = p_n * self._t
        # (1) copy-on-write: no-op lanes copy page 0 onto the trash page
        cow_dst = cow_dst.long()
        for p in pools:
            p.index_copy_(0, cow_dst, p.index_select(0, cow_src))
        # (2) the logical views
        flat = page_table.reshape(-1).long()
        state = [p.index_select(0, flat).reshape(
            (s_n, length) + tuple(p.shape[2:])) for p in pools]
        # (3) k chained model steps
        outs = []
        cur = cursors
        for j in range(k):
            lane = active & (j < depths)
            o = _model_out(self.model.decode_step(tok_block[:, j], cur, lane,
                                                  *state),
                           "model.decode_step")
            outs.append(o[0].to(torch.int32))
            state = list(o[1:])
            # masked lanes may run past the logical range: keep indexable
            cur = torch.clamp(cur + 1, max=length - 1)
        ob = torch.stack(outs, dim=1)          # (S, k)
        # (4) scatter back
        for p, lg in zip(pools, state):
            p.index_copy_(0, flat, lg.reshape(
                (s_n * p_n, self._t) + tuple(p.shape[2:])).to(p.dtype))
        # (5) the draft state, re-synced on the accepted prefix
        if self.draft is not None:
            if k > 1:
                m = tok_block[:, 1:] == ob[:, :-1]
                jidx = torch.arange(1, k, device=ob.device)[None, :]
                m = m & (jidx < depths[:, None])
                acc = 1 + torch.cumprod(m.to(torch.int32), dim=1).sum(dim=1)
            else:
                acc = torch.ones(s_n, dtype=torch.int32, device=ob.device)
            nd = self.draft.accept(tok_block, acc.to(torch.int32), active,
                                   *dstate)
            nd = nd if isinstance(nd, (tuple, list)) else (nd,)
            for a, new in zip(dstate, nd):
                a.copy_(new)
        return (ob,)


# -- the server ---------------------------------------------------------------


class DecodeServer:
    """Continuous-batching autoregressive decode server.

    Parameters
    ----------
    model : Block implementing the decode model contract (module doc).
    spec : BucketSpec
        The prefill grid: ``example_shape=(None,)`` int token prompts,
        ``lengths`` the padded prompt lengths (each within ``max_len``).
    max_slots : int, optional
        Arena capacity; default ``MXTPU_DECODE_SLOTS`` (8).
    max_len : int, optional
        Cache length a slot; default ``MXTPU_DECODE_MAX_LEN`` (128).  A
        request needs ``prompt_len + max_new_tokens <= max_len``.
    eos_id : int, optional
        Token id that ends a sequence early.
    max_new_tokens : int
        Default generation budget (``submit()`` overrides).
    max_queue : int
        Bound on queued admissions before submit() fails fast.
    admission : "continuous" | "batch"
        ``"continuous"`` backfills free slots between tokens; ``"batch"``
        admits only into an empty arena (whole-batch decode, the baseline
        of the parity tests).
    ctx : Context, optional
        The device of the arena and the steps (default: the current
        context, ``gpu(0)``).
    checkpoint : CheckpointManager or str, optional
        Source for ``reload_weights()``.
    page_tokens : int, optional
        ``> 0`` switches to the paged arena with this many tokens a page;
        default ``MXTPU_DECODE_PAGE_TOKENS`` (0, contiguous).
    num_pages : int, optional
        Physical pages; default ``MXTPU_DECODE_NUM_PAGES`` or ``max_slots *
        ceil(max_len / page_tokens)``.
    draft : Block, optional
        Draft model for speculative decoding (``TinyDraft`` is the
        reference); needs the paged arena and ``spec_k >= 2``.
    spec_k : int, optional
        Speculation block size; default ``MXTPU_DECODE_SPEC_K`` (1, off).

    On the card the warm-up runs every step twice (eager, then captured),
    so traffic after ``start()`` is replays only, on the server's own CUDA
    stream, one replay a token step, a draft proposal and an admission
    group.  The host inputs of a step (tokens, cursors, active mask, page
    table, copy-on-write pairs) are copied from pageable memory into the
    graph's static buffers before each replay: such a copy has left the
    host array before it returns, so the loop may rewrite the array at
    once.
    """

    def __init__(self, model, spec, max_slots=None, max_len=None,
                 eos_id=None, max_new_tokens=32, max_queue=256,
                 admission="continuous", ctx=None, checkpoint=None,
                 page_tokens=None, num_pages=None, draft=None,
                 spec_k=None):
        if not isinstance(spec, BucketSpec):
            raise MXNetError("spec must be a serve.BucketSpec")
        if spec.var_axis is None or len(spec.example_shape) != 1:
            raise MXNetError(
                "DecodeServer prompts are 1-D token sequences: use "
                "BucketSpec(example_shape=(None,), lengths=...)")
        if admission not in ("continuous", "batch"):
            raise MXNetError(
                f"admission must be 'continuous' or 'batch', "
                f"got {admission!r}")
        self._model = model
        self._spec = spec
        # an int8 model books its admission groups and token steps into
        # the `quantize` section; reload_weights() re-quantizes float32
        # checkpoints
        self._int8 = bool(getattr(model, "_int8_quantized", False))
        self._note_int8 = _int8_batch_hook(model)
        if self._int8:
            _check_calibrated(model, "")
        self._slots = int(max_slots if max_slots is not None
                          else getenv("DECODE_SLOTS", 8, int))
        self._max_len = int(max_len if max_len is not None
                            else getenv("DECODE_MAX_LEN", 128, int))
        if self._slots < 1 or self._max_len < 2:
            raise MXNetError("max_slots must be >= 1 and max_len >= 2")
        if spec.lengths[-1] > self._max_len:
            raise MXNetError(
                f"prefill bucket length {spec.lengths[-1]} exceeds the "
                f"slot cache max_len {self._max_len}")
        self._page_tokens = int(
            page_tokens if page_tokens is not None
            else getenv("DECODE_PAGE_TOKENS", 0, int))
        self._paged = self._page_tokens > 0
        self._draft = draft
        self._spec_k = int(spec_k if spec_k is not None
                           else getenv("DECODE_SPEC_K", 1, int))
        if self._spec_k < 1:
            raise MXNetError("spec_k must be >= 1")
        if self._paged:
            self._pages_per_slot = pages_spanned(self._max_len,
                                                 self._page_tokens)
            self._num_pages = int(
                num_pages if num_pages is not None
                else (getenv("DECODE_NUM_PAGES", 0, int)
                      or self._slots * self._pages_per_slot))
            if self._num_pages < 1:
                raise MXNetError("num_pages must be >= 1")
            self._alloc = PageAllocator(self._num_pages, self._page_tokens)
            self._prefix = PrefixIndex()
            self._page_table = np.full(
                (self._slots, self._pages_per_slot), self._alloc.trash,
                np.int32)
            self._slot_pages = [[] for _ in range(self._slots)]
            self._slot_commit = [0] * self._slots
            self._committed = 0
        elif self._draft is not None or self._spec_k > 1:
            raise MXNetError(
                "speculative decoding needs the paged arena: pass "
                "page_tokens= (or MXTPU_DECODE_PAGE_TOKENS) alongside "
                "draft=/spec_k=")
        if self._draft is not None:
            if self._spec_k < 2:
                raise MXNetError(
                    "a draft model without spec_k >= 2 proposes nothing: "
                    "pass spec_k= (or MXTPU_DECODE_SPEC_K)")
            tv = getattr(model, "vocab", None)
            dv = getattr(draft, "vocab", None)
            if tv is not None and dv is not None and int(tv) != int(dv):
                raise MXNetError(
                    f"draft/target vocab mismatch ({int(dv)} vs {int(tv)}):"
                    " speculative acceptance compares token ids, so draft "
                    "and target must share one tokenizer")
            if bool(getattr(draft, "_int8_quantized", False)):
                _check_calibrated(draft, "draft model ")
        elif self._spec_k > 1:
            raise MXNetError(
                "spec_k > 1 needs a draft= model to propose tokens")
        self._overflow = []        # paged: admissions deferred on pages
        self._eos_id = None if eos_id is None else int(eos_id)
        self._default_mnt = int(max_new_tokens)
        self._admission = admission
        self._ctx = ctx if ctx is not None else current_context()
        self._device = self._ctx.torch_device()
        self._stream = None          # the server's CUDA stream (warm-up)
        self._batcher = Batcher(max_queue=max_queue, linger_ms=0.0)
        self._stats = ServerStats(counters=DECODE_COUNTERS)
        self._ttft = LatencyWindow()
        self._token_lat = LatencyWindow()
        self._occ_lock = threading.Lock()
        self._occ_sum = 0.0
        self._occ_steps = 0
        self._exec_lock = threading.Lock()   # token step XOR reload
        self._admit_op = None                # built at start() (they
        self._step_op = None                 # need the cache layout)
        self._draft_op = None                # spec: the proposal step
        self._n_cache = None
        self._cache_meta = None              # [(tail shape, dtype)]
        self._cache = None                   # the arena, device tensors
        self._draft_meta = None
        self._draft_cache = []               # draft state (S, 1, ...)
        self._n_draft = 0
        self._spec_proposed = 0              # window-scoped, _occ_lock
        self._spec_accepted = 0
        self._tokens = np.zeros(self._slots, np.int32)
        self._cursors = np.zeros(self._slots, np.int32)
        self._active = np.zeros(self._slots, bool)
        self._slot_req = [None] * self._slots
        self._step_count = 0
        self._started = False
        self._closing = False
        self._abort = False
        self._worker = None
        self._warmup_compiles = 0
        self._metrics_collector = None
        if isinstance(checkpoint, str):
            from ..checkpoint import CheckpointManager

            checkpoint = CheckpointManager(checkpoint)
        self._ckpt = checkpoint

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        """Warm the whole capture surface (one admission graph a prompt
        bucket, the decode step, the draft's proposal step), then start the
        token loop.  A drained server restarts with no new capture."""
        if self._started:
            raise MXNetError("DecodeServer already started")
        self._abort = False
        self._batcher.reopen()
        if self._cache is None:
            if self._device.type == "cuda":
                self._stream = torch.cuda.Stream(self._device)
            with _random.capture_lock, self._on_stream():
                self._warmup()   # one warm-up at a time
        self._warmup_compiles = self._graph_stats_raw()["compiles"]
        self._started = True
        self._closing = False
        if self._metrics_collector is None:
            from ..telemetry import metrics as _metrics

            self._metrics_collector = _metrics.register_decode_server(self)
        self._worker = threading.Thread(target=self._loop,
                                        name="mxtt-decode-loop",
                                        daemon=True)
        self._worker.start()
        return self

    def _on_stream(self):
        """The server's CUDA stream as the current one (the warm-up and the
        loop thread launch there), or nothing on the CPU."""
        if self._stream is None:
            import contextlib

            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _warm_calls(self):
        """Calls a warm-up makes of each step signature: on the card the
        first runs eagerly and the second captures the graph."""
        return 2 if self._device.type == "cuda" else 1

    def _probe(self, model):
        """One eager prefill of the smallest bucket: the model's state
        layout, ``[(tail shape, dtype)]``, before any arena exists."""
        min_len = self._spec.lengths[0]
        with torch.no_grad():
            out = model.prefill(
                torch.zeros((1, min_len), dtype=torch.int32,
                            device=self._device),
                torch.full((1,), min_len, dtype=torch.int32,
                           device=self._device))
        rows = [o for o in out[1:] if isinstance(o, torch.Tensor)]
        if not rows:
            raise MXNetError(f"{type(model).__name__}.prefill returned no "
                             "state rows")
        return [(tuple(r.shape[2:]), r.dtype) for r in rows]

    def _warmup(self):
        if self._paged:
            self._warmup_paged()
            return
        with profiler.op_scope("serve.decode.warmup", cat="serve"):
            self._cache_meta = self._probe(self._model)
            self._n_cache = n = len(self._cache_meta)
            self._cache = self._zero_arena()
            self._admit_op = CachedStepOp(
                _AdmitAdapter(self._model, n),
                inplace_inputs=range(3, 3 + n))
            self._step_op = CachedStepOp(
                _StepAdapter(self._model), inplace_inputs=range(3, 3 + n))
            for shape in self._spec.bucket_shapes():
                b, length = shape[0], shape[1]
                for _ in range(self._warm_calls()):
                    outs = self._admit_op(
                        np.zeros((b, length), np.int32),
                        np.full(b, length, np.int32),
                        np.zeros(b, np.int32), *self._cache)
                    outs[0].cpu()   # fail in the warm-up, not mid-token
                self._stats.incr("warmup_batches")
            for _ in range(self._warm_calls()):
                outs = self._step_op(self._tokens, self._cursors,
                                     self._active, *self._cache)
                outs[0].cpu()
            # the warm-up wrote zero rows into slot 0: clean arena, in
            # place (the graphs hold these buffers)
            self._clear_arena()

    def _warmup_paged(self):
        """The paged surface: one admission graph a prompt bucket, the one
        verify step and (with a draft) the proposal step; page tables are
        inputs, so page churn captures nothing new."""
        with profiler.op_scope("serve.decode.warmup", cat="serve"):
            self._cache_meta = self._probe(self._model)
            self._n_cache = n = len(self._cache_meta)
            nd = 0
            if self._draft is not None:
                self._draft_meta = self._probe(self._draft)
                self._n_draft = nd = len(self._draft_meta)
            self._cache = self._zero_arena()
            self._draft_cache = self._zero_draft()
            base = 3 if self._draft is None else 4
            self._admit_op = CachedStepOp(
                _PagedAdmitAdapter(self._model, n, self._page_tokens,
                                   self._draft, nd),
                inplace_inputs=range(base, base + n + nd))
            self._step_op = CachedStepOp(
                _PagedStepAdapter(self._model, n, self._page_tokens,
                                  self._draft, nd),
                inplace_inputs=range(7, 7 + n + nd),
                static_kwargs={"k": self._spec_k})
            if self._draft is not None:
                # proposals leave the persistent draft state alone: only
                # the verify step advances it, by the accepted prefix
                self._draft_op = CachedStepOp(
                    _StepAdapter(self._draft, inplace=False))
            trash = self._alloc.trash
            p_n = self._pages_per_slot
            for shape in self._spec.bucket_shapes():
                b, length = shape[0], shape[1]
                args = [np.zeros((b, length), np.int32),
                        np.full(b, length, np.int32),
                        np.full((b, p_n), trash, np.int32)]
                if self._draft is not None:
                    args.append(np.zeros(b, np.int32))
                for _ in range(self._warm_calls()):
                    outs = self._admit_op(*args, *self._cache,
                                          *self._draft_cache)
                    outs[0].cpu()
                self._stats.incr("warmup_batches")
            for _ in range(self._warm_calls()):
                if self._draft_op is not None:
                    outs = self._draft_op(self._tokens, self._cursors,
                                          self._active, *self._draft_cache)
                    outs[0].cpu()
                outs = self._step_op(
                    np.zeros((self._slots, self._spec_k), np.int32),
                    self._cursors, np.zeros(self._slots, np.int32),
                    self._active,
                    np.full((self._slots, p_n), trash, np.int32),
                    np.zeros(self._slots, np.int32),
                    np.full(self._slots, trash, np.int32),
                    *self._cache, *self._draft_cache)
                outs[0].cpu()
            self._clear_arena()

    def __enter__(self):
        if not self._started:
            self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc == (None, None, None))
        return False

    def drain(self, timeout=None):
        """Stop admissions and block until every admitted sequence has
        finished; ends with no queued work and no live slot."""
        self._closing = True
        self._batcher.close()
        if self._worker is not None:
            self._worker.join(timeout)
            if self._worker.is_alive():
                raise MXNetError("drain timed out with live decode slots")
            self._worker = None
        self._started = False

    def shutdown(self, drain=True, timeout=None):
        if not self._started and self._worker is None:
            return
        if drain:
            self.drain(timeout)
            return
        self._closing = True
        self._abort = True
        self._batcher.close()
        if self._worker is not None:
            self._worker.join(timeout)
            self._worker = None
        self._started = False
        for slot in np.flatnonzero(self._active):
            self._finish_slot(int(slot), "cancelled",
                              ServerClosedError("server shut down"))
        for req in self._overflow:
            self._resolve(req, "cancelled",
                          ServerClosedError("server shut down"))
        self._overflow = []
        while True:
            group, expired = self._batcher.next_group(self._slots,
                                                      timeout=0)
            if not group and not expired:
                break
            for req in group + expired:
                self._resolve(req, "cancelled",
                              ServerClosedError("server shut down"))

    # -- request path -------------------------------------------------------

    def submit(self, prompt, max_new_tokens=None, deadline_ms=None):
        """Queue one prompt (1-D int tokens); returns a
        :class:`DecodeHandle`."""
        if not self._started or self._closing:
            raise ServerClosedError(
                "DecodeServer is not accepting requests (not started, "
                "draining, or shut down)")
        if isinstance(prompt, NDArray):
            prompt = prompt.asnumpy()
        prompt = np.asarray(prompt, dtype=np.int32)
        length = self._spec.validate(prompt)
        mnt = int(max_new_tokens if max_new_tokens is not None
                  else self._default_mnt)
        if mnt < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if self._paged:
            # a request fits if its worst-case page span fits the slot's
            # logical range and the physical pool
            span = pages_spanned(length + mnt, self._page_tokens)
            logical = self._pages_per_slot * self._page_tokens
            pool = self._num_pages * self._page_tokens
            if length + mnt > logical or span > self._num_pages:
                raise MXNetError(
                    f"prompt_len {length} + max_new_tokens {mnt} "
                    f"({span} pages of {self._page_tokens} tokens) can "
                    f"NEVER fit: per-slot logical budget is {logical} "
                    f"tokens ({self._pages_per_slot} pages, from "
                    f"max_len={self._max_len}) and the page pool holds "
                    f"{pool} tokens ({self._num_pages} pages); truncate "
                    f"the prompt, lower the budget, or raise "
                    f"MXTPU_DECODE_MAX_LEN / MXTPU_DECODE_NUM_PAGES")
        elif length + mnt > self._max_len:
            raise MXNetError(
                f"prompt_len {length} + max_new_tokens {mnt} exceeds the "
                f"slot cache max_len {self._max_len}; truncate the "
                f"prompt, lower the budget, or raise MXTPU_DECODE_MAX_LEN")
        req = _DecodeRequest(prompt, length, Future(), mnt,
                             deadline_ms=deadline_ms)
        req.trace_id = _tracer.request_begin(
            "serve.decode.request", cat="serve", prompt_len=length,
            max_new_tokens=mnt,
            deadline_ms=deadline_ms if deadline_ms is not None else -1)
        self._stats.incr("submitted")
        try:
            self._batcher.put(req)
        except MXNetError as e:
            self._stats.incr("submitted", -1)
            if isinstance(e, ServerOverloadedError):
                self._stats.incr("rejected_overload")
            _tracer.request_end("serve.decode.request", req.trace_id,
                                cat="serve", outcome="rejected")
            raise
        return DecodeHandle(req)

    def generate(self, prompt, max_new_tokens=None, deadline_ms=None,
                 timeout=None):
        """Synchronous submit(): the full token sequence.  A
        deadline-only call waits ``deadline_ms/1e3 + PREDICT_GRACE_S`` at
        most; a caller-side timeout cancels the request."""
        handle = self.submit(prompt, max_new_tokens=max_new_tokens,
                             deadline_ms=deadline_ms)
        if timeout is None and deadline_ms is not None:
            from .server import PREDICT_GRACE_S

            timeout = deadline_ms / 1e3 + PREDICT_GRACE_S
        try:
            return handle.result(timeout)
        except _FutureTimeout:
            handle.cancel()
            raise

    # -- the token loop -----------------------------------------------------

    def _loop(self):
        try:
            with self._on_stream():
                self._loop_body()
        except Exception as e:  # noqa: BLE001 -- a dead loop thread would
            # strand every future: fail them all
            for slot in np.flatnonzero(self._active):
                self._finish_slot(int(slot), "failed", e)
            for req in self._overflow:
                self._resolve(req, "failed", e)
            self._overflow = []
            while True:
                group, expired = self._batcher.next_group(self._slots,
                                                          timeout=0)
                if not group and not expired:
                    return
                for req in group + expired:
                    self._resolve(req, "failed", e)

    def _loop_body(self):
        while not self._abort:
            live = int(self._active.sum())
            self._admit(timeout=0.05 if live == 0 else 0.0)
            live = int(self._active.sum())
            if live == 0:
                if self._batcher.drained() and not self._overflow:
                    return
                continue
            with self._exec_lock:
                self._boundary_and_step()

    def _free_slots(self):
        return [i for i in range(self._slots) if not self._active[i]]

    def _sweep_overflow(self):
        """Deadline and cancel sweep over page-deferred admissions (they
        left the batcher, whose dequeue sweep cannot see them)."""
        if not self._overflow:
            return
        now = time.monotonic()
        keep = []
        for req in self._overflow:
            if req.cancelled or req.future.cancelled():
                self._resolve(req, "cancelled",
                              ServerClosedError("request cancelled"))
            elif req.expired(now):
                self._resolve(req, "expired", DeadlineExceededError(
                    "deadline passed while queued"))
            else:
                keep.append(req)
        self._overflow = keep

    def _page_commit_bound(self, req):
        """Worst-case exclusive pages a request may hold: the span of
        prompt + budget, less the full prompt pages already resident."""
        span = pages_spanned(req.length + req.max_new_tokens,
                             self._page_tokens)
        credit = 0
        for key in chunk_keys(req.example, req.length, self._page_tokens):
            if key[0] == "F" and self._prefix.lookup(key) is not None:
                credit += 1
        return span - credit

    def _admit(self, timeout):
        self._sweep_overflow()
        free = self._free_slots()
        if not free:
            return
        if self._admission == "batch" and len(free) < self._slots:
            return   # whole-batch mode: admit into an empty arena only
        want = min(len(free), self._spec.max_batch)
        # page-deferred admissions keep their place ahead of the queue
        cand = self._overflow[:want]
        del self._overflow[:len(cand)]
        if len(cand) < want:
            group, expired = self._batcher.next_group(
                want - len(cand), timeout=0 if cand else timeout)
            for req in expired:
                self._resolve(req, "expired", DeadlineExceededError(
                    "deadline passed while queued"))
            for req in (group or ()):
                if req.cancelled or req.future.cancelled():
                    self._resolve(req, "cancelled",
                                  ServerClosedError("request cancelled"))
                else:
                    cand.append(req)
        if not cand:
            return
        if self._paged:
            # admit what the pool covers in the worst case; defer the rest
            live, defer, promised = [], [], 0
            for req in cand:
                commit = self._page_commit_bound(req)
                if self._committed + promised + commit <= self._num_pages:
                    live.append(req)
                    promised += commit
                else:
                    defer.append(req)
            self._overflow = defer + self._overflow
            if not live:
                return
        else:
            live = cand
        try:
            self._prefill_group(live, free)
        except Exception as e:  # noqa: BLE001 -- fail this group; the
            # loop and the live slots go on (the arena was written in
            # place only by a step that completed)
            for req in live:
                if req.slot is None:
                    self._resolve(req, "failed", e)

    def _prefill_group(self, group, free):
        spec = self._spec
        batch, length = spec.pick(len(group), max(r.length for r in group))
        key = spec.key(batch, length)
        slots = [free.pop(0) for _ in group]
        if self._paged:
            self._prefill_group_paged(group, slots, batch, length, key)
            return
        with profiler.op_scope("serve.decode.admit", cat="serve"):
            padded = spec.pad_batch([r.example for r in group], batch,
                                    length)
            lengths = np.ones(batch, np.int32)
            lengths[:len(group)] = [r.length for r in group]
            # padding rows target slots[0] and are overwritten by row 0
            slot_vec = np.full(batch, slots[0], np.int32)
            slot_vec[:len(group)] = slots
            # the exec lock keeps reload_weights() out of this replay
            with self._exec_lock, \
                    profiler.op_scope("serve.prefill", cat="serve"):
                outs = self._admit_op(padded, lengths, slot_vec,
                                      *self._cache)
                first = outs[0].cpu().numpy()
        _sec_bump(prefill_batches=1)
        self._booked_admission(group, slots, key, batch, length, first)

    def _booked_admission(self, group, slots, key, batch, length, first):
        self._stats.record_batch(
            key, n_real=len(group), n_rows=batch,
            real_elems=sum(r.length for r in group),
            padded_elems=batch * length)
        if self._int8:
            self._note_int8()
        now = time.monotonic()
        for i, req in enumerate(group):
            slot = slots[i]
            req.slot = slot
            req.admitted_at = now
            self._slot_req[slot] = req
            self._tokens[slot] = first[i]
            self._cursors[slot] = req.length
            self._active[slot] = True
            self._stats.incr("admitted")
            _sec_bump(admitted=1)
            _tracer.request_instant("serve.decode.admitted", req.trace_id,
                                    cat="serve", slot=slot, bucket=key)
            self._emit_token(req, int(first[i]), now)
            # a 1-token budget (or an immediate EOS) ends at admission
            self._maybe_finish(req, now)

    def _prefill_group_paged(self, group, slots, batch, length, key):
        """Map every prompt onto pages (prefix hits retain the resident
        page, misses allocate), then one admission replay: fresh pages
        take the new rows, hit pages keep their bytes."""
        spec = self._spec
        trash = self._alloc.trash
        t = self._page_tokens
        admit_pt = np.full((batch, self._pages_per_slot), trash, np.int32)
        mapped = []              # per request (pages, commit)
        claimed = []             # undo log: every reference taken
        n_alloc0 = self._alloc.allocs
        n_hits = 0

        def _rollback():
            for pg in reversed(claimed):
                if self._alloc.release(pg):
                    self._prefix.drop_page(pg)

        try:
            for i, req in enumerate(group):
                pages, shared = [], []
                for ck in chunk_keys(req.example, req.length, t):
                    pg = self._prefix.lookup(ck)
                    if pg is not None:
                        self._alloc.retain(pg)
                        shared.append(True)
                    else:
                        pg = self._alloc.alloc()
                        self._prefix.register(ck, pg)
                        shared.append(False)
                        admit_pt[i, len(pages)] = pg
                    pages.append(pg)
                    claimed.append(pg)
                full = req.length // t
                credit = sum(1 for j in range(min(full, len(pages)))
                             if shared[j])
                commit = pages_spanned(req.length + req.max_new_tokens,
                                       t) - credit
                n_hits += sum(shared)
                mapped.append((pages, commit))
        except Exception:
            _rollback()
            raise
        with profiler.op_scope("serve.decode.admit", cat="serve"):
            padded = spec.pad_batch([r.example for r in group], batch,
                                    length)
            lengths = np.ones(batch, np.int32)
            lengths[:len(group)] = [r.length for r in group]
            args = [padded, lengths, admit_pt]
            if self._draft is not None:
                slot_vec = np.full(batch, slots[0], np.int32)
                slot_vec[:len(group)] = slots
                args.append(slot_vec)
            try:
                with self._exec_lock, \
                        profiler.op_scope("serve.prefill", cat="serve"):
                    outs = self._admit_op(*args, *self._cache,
                                          *self._draft_cache)
                    first = outs[0].cpu().numpy()
            except Exception:
                _rollback()
                raise
        n_new = self._alloc.allocs - n_alloc0
        if n_new:
            self._stats.incr("page_allocs", n_new)
        if n_hits:
            self._stats.incr("page_prefix_hits", n_hits)
        _sec_bump(prefill_batches=1, prefix_hit_pages=n_hits,
                  pages_in_flight=self._alloc.live_count())
        for i, slot in enumerate(slots):
            pages, commit = mapped[i]
            self._page_table[slot, :] = trash
            self._page_table[slot, :len(pages)] = pages
            self._slot_pages[slot] = list(pages)
            self._slot_commit[slot] = commit
            self._committed += commit
        self._booked_admission(group, slots, key, batch, length, first)

    def _emit_token(self, req, token, now):
        if not req.generated:
            ttft_ms = (now - req.enqueued_at) * 1e3
            with self._occ_lock:
                self._ttft.record(ttft_ms)
            _tracer.request_instant("serve.decode.first_token",
                                    req.trace_id, cat="serve",
                                    ttft_ms=round(ttft_ms, 3))
        req.fanout(token)
        req.stream.put(token)
        self._stats.incr("tokens")
        _sec_bump(tokens=1)

    def _boundary_and_step(self):
        """One token boundary: expire or cancel live slots, then run the
        decode step and fan its tokens out."""
        now = time.monotonic()
        for slot in np.flatnonzero(self._active):
            req = self._slot_req[int(slot)]
            if req.cancelled:
                self._finish_slot(int(slot), "cancelled",
                                  ServerClosedError("request cancelled"))
            elif req.expired(now):
                self._finish_slot(int(slot), "expired",
                                  DeadlineExceededError(
                                      "deadline passed mid-decode"))
        live = int(self._active.sum())
        if live == 0:
            return
        if self._paged:
            self._paged_round(live)
            return
        t0 = time.monotonic()
        try:
            engine.fault_point("serve.decode", step=self._step_count,
                               live=live)
            with profiler.op_scope("serve.decode.step", cat="serve"):
                outs = self._step_op(self._tokens, self._cursors,
                                     self._active, *self._cache)
                nxt = outs[0].cpu().numpy()
        except Exception as e:  # noqa: BLE001 -- fail every live sequence
            # (their state is unknowable), reset the arena, keep serving
            for slot in np.flatnonzero(self._active):
                self._finish_slot(int(slot), "failed", e)
            self._reset_arena()
            return
        now = self._booked_step(live, t0)
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            req = self._slot_req[slot]
            self._cursors[slot] += 1
            self._tokens[slot] = nxt[slot]
            self._emit_token(req, int(nxt[slot]), now)
            self._maybe_finish(req, now)

    def _booked_step(self, live, t0, **extra):
        now = time.monotonic()
        step_ms = (now - t0) * 1e3
        self._step_count += 1
        self._stats.incr("decode_steps")
        if self._int8:
            self._note_int8()
        with self._occ_lock:
            self._token_lat.record(step_ms)
            self._occ_sum += live / self._slots
            self._occ_steps += 1
        _sec_bump(live_ratio=live / self._slots, steps=1, **extra)
        return now

    def _paged_round(self, live):
        """One paged round: extend or copy-on-write the write-frontier
        pages, ``spec_k - 1`` draft proposals (with a draft), one
        verify/decode step, then the accepted tokens."""
        t0 = time.monotonic()
        k = self._spec_k
        t = self._page_tokens
        trash = self._alloc.trash
        depths = np.zeros(self._slots, np.int32)
        cow_src = np.zeros(self._slots, np.int32)
        cow_dst = np.full(self._slots, trash, np.int32)
        n_alloc0 = self._alloc.allocs
        n_cow = 0
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            req = self._slot_req[slot]
            remaining = req.max_new_tokens - len(req.generated)
            d = int(min(k, max(remaining, 1)))
            depths[slot] = d
            cur = int(self._cursors[slot])
            # every page the block [cur, cur+d-1] writes must be private
            # before the step: map unmapped pages, copy shared ones
            for pi in range(cur // t, (cur + d - 1) // t + 1):
                pte = int(self._page_table[slot, pi])
                if pte == trash:
                    pg = self._alloc.alloc()
                    self._page_table[slot, pi] = pg
                    self._slot_pages[slot].append(pg)
                elif self._alloc.ref(pte) > 1:
                    pg = self._alloc.alloc()
                    cow_src[slot] = pte
                    cow_dst[slot] = pg
                    self._alloc.release(pte)  # ref > 1: never frees
                    self._slot_pages[slot].remove(pte)
                    self._slot_pages[slot].append(pg)
                    self._page_table[slot, pi] = pg
                    n_cow += 1
        tok_block = np.zeros((self._slots, k), np.int32)
        tok_block[:, 0] = self._tokens
        draft_rounds = 0
        try:
            engine.fault_point("serve.decode", step=self._step_count,
                               live=live)
            if self._draft is not None and k > 1:
                dt = self._tokens.copy()
                dcur = self._cursors.copy()
                state = list(self._draft_cache)
                with profiler.op_scope("serve.decode.draft", cat="serve"):
                    for _ in range(1, k):
                        outs = self._draft_op(dt, dcur, self._active,
                                              *state)
                        dt = outs[0].cpu().numpy().astype(np.int32)
                        state = list(outs[1:])
                        dcur = dcur + 1
                        tok_block[:, draft_rounds + 1] = dt
                        draft_rounds += 1
            with profiler.op_scope("serve.decode.step", cat="serve"):
                outs = self._step_op(tok_block, self._cursors, depths,
                                     self._active, self._page_table,
                                     cow_src, cow_dst, *self._cache,
                                     *self._draft_cache)
                ob = outs[0].cpu().numpy()
        except Exception as e:  # noqa: BLE001 -- fail every live sequence,
            # reset the arena, keep serving
            for slot in np.flatnonzero(self._active):
                self._finish_slot(int(slot), "failed", e)
            self._reset_arena()
            return
        if draft_rounds:
            self._stats.incr("spec_rounds")
            self._stats.incr("spec_draft_steps", draft_rounds)
        n_new = self._alloc.allocs - n_alloc0
        if n_new:
            self._stats.incr("page_allocs", n_new)
        if n_cow:
            self._stats.incr("page_cow", n_cow)
        now = self._booked_step(live, t0, draft_steps=draft_rounds,
                                cow_copies=n_cow)
        _sec_bump(pages_in_flight=self._alloc.live_count())
        round_prop = 0
        round_acc = 0
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            req = self._slot_req[slot]
            d = int(depths[slot])
            emitted = 0
            for j in range(d):
                tok = int(ob[slot, j])
                self._cursors[slot] += 1
                self._tokens[slot] = tok
                self._emit_token(req, tok, now)
                emitted += 1
                self._maybe_finish(req, now)
                if not self._active[slot]:
                    break
                if j < d - 1 and int(tok_block[slot, j + 1]) != tok:
                    break   # the proposal diverged: tok is the correction
            if draft_rounds:
                round_prop += d - 1
                round_acc += max(emitted - 1, 0)
        if draft_rounds:
            _sec_bump(spec_proposed=round_prop, spec_accepted=round_acc)
            with self._occ_lock:
                self._spec_proposed += round_prop
                self._spec_accepted += round_acc

    def _maybe_finish(self, req, now):
        if (len(req.generated) >= req.max_new_tokens
                or (self._eos_id is not None
                    and req.generated[-1] == self._eos_id)):
            self._finish_slot(req.slot, "served")

    def _finish_slot(self, slot, outcome, error=None):
        req = self._slot_req[slot]
        self._active[slot] = False
        self._tokens[slot] = 0
        self._cursors[slot] = 0
        self._slot_req[slot] = None
        if self._paged:
            # drop every page reference; a page is evicted (freed, its
            # prefix keys dropped) when its count reaches zero
            freed = 0
            for pg in self._slot_pages[slot]:
                if self._alloc.release(pg):
                    self._prefix.drop_page(pg)
                    freed += 1
            self._slot_pages[slot] = []
            self._page_table[slot, :] = self._alloc.trash
            self._committed -= self._slot_commit[slot]
            self._slot_commit[slot] = 0
            if freed:
                self._stats.incr("page_frees", freed)
            _sec_bump(pages_in_flight=self._alloc.live_count())
        self._resolve(req, outcome, error)

    def _resolve(self, req, outcome, error=None):
        now = time.monotonic()
        counter = {"served": "served", "expired": "expired_deadline",
                   "cancelled": "cancelled", "failed": "failed"}[outcome]
        self._stats.incr(counter)
        if outcome == "served":
            self._stats.record_latency((now - req.enqueued_at) * 1e3)
            _sec_bump(finished=1)
        elif outcome == "expired":
            _sec_bump(expired_deadlines=1)
        decode_ms = ((now - req.admitted_at) * 1e3
                     if req.admitted_at is not None else -1)
        _tracer.request_end(
            "serve.decode.request", req.trace_id, cat="serve",
            outcome=outcome, tokens=len(req.generated),
            slot=req.slot if req.slot is not None else -1,
            queue_ms=round(((req.admitted_at or now)
                            - req.enqueued_at) * 1e3, 3),
            decode_ms=round(decode_ms, 3))
        if error is None:
            req.stream.put(_DONE)
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(np.asarray(req.generated, np.int32))
        else:
            req.stream.put(error)
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(error)
        # sinks see the terminal after the future resolved
        req.fanout(_DONE if error is None else error)

    def _zero_arena(self):
        """The arena's cache buffers on the device, zeroed: ``(num_pages +
        1, page_tokens, ...)`` pools (the extra one is the trash page) or
        ``(max_slots, max_len, ...)`` rows."""
        lead = ((self._num_pages + 1, self._page_tokens) if self._paged
                else (self._slots, self._max_len))
        return [torch.zeros(lead + tuple(tail), dtype=dtype,
                            device=self._device)
                for tail, dtype in self._cache_meta]

    def _zero_draft(self):
        if self._draft is None:
            return []
        return [torch.zeros((self._slots, 1) + tuple(tail), dtype=dtype,
                            device=self._device)
                for tail, dtype in self._draft_meta]

    def _clear_arena(self):
        """Zero the arena in place: the captured steps hold its buffers."""
        for buf in list(self._cache) + list(self._draft_cache):
            buf.zero_()

    def _reset_arena(self):
        self._clear_arena()
        self._tokens[:] = 0
        self._cursors[:] = 0
        self._active[:] = False
        if self._paged:
            self._alloc = PageAllocator(self._num_pages, self._page_tokens)
            self._prefix = PrefixIndex()
            self._page_table[:] = self._alloc.trash
            self._slot_pages = [[] for _ in range(self._slots)]
            self._slot_commit = [0] * self._slots
            self._committed = 0
            _sec_bump(pages_in_flight=0)

    # -- hot reload ---------------------------------------------------------

    def reload_weights(self, step=None):
        """Copy parameters from the checkpoint manager into the model
        between token boundaries: live sequences finish their token on the
        old weights and go on with the new, with no new capture (the steps
        read the parameters in place).  A quantized model takes int8-native
        and float32 checkpoints (``load_serving_params``)."""
        if self._ckpt is None:
            raise MXNetError(
                "no checkpoint manager: construct DecodeServer("
                "checkpoint=...) to enable reload_weights()")
        with self._exec_lock, self._on_stream():
            with profiler.op_scope("serve.reload", cat="serve"):
                if self._int8:
                    meta = self._ckpt.restore(step=step, restore_rng=False)
                    from ..contrib.quantization import load_serving_params

                    load_serving_params(self._model,
                                        meta.get("params") or {})
                else:
                    meta = self._ckpt.restore(step=step, params=self._model,
                                              restore_rng=False)
        self._stats.incr("reloads")
        return {"step": meta["step"], "epoch": meta.get("epoch")}

    # -- observability ------------------------------------------------------

    def _graph_stats_raw(self):
        agg = {"compiles": 0, "reuses": 0}
        for op in (self._admit_op, self._step_op, self._draft_op):
            if op is not None:
                agg["compiles"] += op.stats.get("compiles", 0)
                agg["reuses"] += op.stats.get("reuses", 0)
        return agg

    def live_slots(self):
        return int(self._active.sum())

    def pending(self):
        """Queued admissions (page-deferred ones too) + occupied slots."""
        return len(self._batcher) + len(self._overflow) + self.live_slots()

    def probe_example(self):
        """A minimal valid prompt (the smallest bucket's shape)."""
        shape = self._spec.bucket_shapes()[0][1:]
        return np.full(shape, 0, dtype=self._spec.dtype)

    def stats(self, reset=False):
        """One snapshot of the decode tier, ``ModelServer.stats``'s
        window contract; when quiescent::

            submitted == served + expired_deadline + failed + cancelled
                         + queue_depth + live_slots
        """
        g = self._graph_stats_raw()
        graph = dict(g, post_warmup_compiles=g["compiles"]
                     - self._warmup_compiles)
        with self._occ_lock:
            occ = (round(self._occ_sum / self._occ_steps, 4)
                   if self._occ_steps else None)
            ttft = self._ttft.snapshot()
            token = self._token_lat.snapshot()
            proposed, accepted = self._spec_proposed, self._spec_accepted
            if reset:
                self._occ_sum = 0.0
                self._occ_steps = 0
                self._ttft.reset()
                self._token_lat.reset()
                self._spec_proposed = 0
                self._spec_accepted = 0
        extra = {"graph": graph, "buckets": repr(self._spec),
                 "slots": {"max": self._slots, "live": self.live_slots(),
                           "occupancy": occ, "max_len": self._max_len},
                 "ttft": ttft, "token_latency": token}
        if self._paged:
            nbytes = 0
            for tail, dtype in (self._cache_meta or ()):
                elems = (self._num_pages + 1) * self._page_tokens
                for s in tail:
                    elems *= int(s)
                nbytes += elems * torch.empty((), dtype=dtype).element_size()
            extra["pages"] = {
                "num": self._num_pages,
                "page_tokens": self._page_tokens,
                "per_slot": self._pages_per_slot,
                "free": self._alloc.free_count(),
                "in_flight": self._alloc.live_count(),
                "committed": self._committed,
                "deferred": len(self._overflow),
                "hbm_bytes": nbytes}
        if self._spec_k > 1:
            extra["spec"] = {
                "k": self._spec_k,
                "draft": self._draft is not None,
                "proposed": proposed, "accepted": accepted,
                "accept_rate": (round(accepted / proposed, 4)
                                if proposed else None)}
        return self._stats.snapshot(
            queue_depth=len(self._batcher) + len(self._overflow),
            in_flight=self.live_slots(), reset=reset, extra=extra)


def _check_calibrated(model, what):
    """A quantized decode model needs calibrated ranges: a dynamic range
    reduces over the whole slot arena and would couple independent
    requests (and break continuous == whole-batch)."""
    from ..contrib.quantization import _iter_quantized

    uncal = [w.name for _, w in _iter_quantized(model) if not w._calibrated]
    if uncal:
        raise MXNetError(
            f"DecodeServer needs CALIBRATED quantization: {what}layer(s) "
            f"{uncal} quantize with dynamic per-batch ranges, which reduce "
            "over the whole slot arena and couple independent requests; "
            "re-run quantize_net with calib_data=")


# -- reference decode models --------------------------------------------------


class TinyDecoder(Block):
    """Minimal runnable decode model: greedy argmax over a cumulative mean
    of token embeddings.  Its per-slot state is a real ``(slots, max_len,
    embed)`` cache of per-position embeddings, so it exercises the arena
    as a transformer KV cache would.  Every per-slot quantity depends on
    that slot's row alone (continuous == whole-batch by construction), and
    inactive slots are masked out of writes and divide by
    ``max(cursor+1, 1)``.

    With ``proj_block=True`` the output projection is an ``nn.Dense``
    child instead of a raw parameter, so ``quantize_net`` can make it
    int8 (the int8 decode path)."""

    def __init__(self, vocab=64, embed=16, proj_block=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self.vocab = int(vocab)
        self.embed_dim = int(embed)
        self._proj_block = bool(proj_block)
        self.embedding = self.params.get("embedding", shape=(vocab, embed))
        if proj_block:
            from ..gluon import nn as _gnn

            self.proj = _gnn.Dense(vocab, use_bias=False, flatten=False,
                                   in_units=embed)
        else:
            self.proj = self.params.get("proj", shape=(embed, vocab))

    def _logits(self, h):
        if self._proj_block:
            return self.proj(h)
        return h @ self.proj.data()

    def _embed(self, tokens):
        E = self.embedding.data()
        return E.index_select(0, tokens.reshape(-1)).reshape(
            tuple(tokens.shape) + (E.shape[1],))

    def prefill(self, prompts, lengths):
        emb = self._embed(prompts)                     # (B, L, d)
        m = torch.arange(emb.shape[1], device=emb.device)[None, :] \
            < lengths[:, None]
        h = (emb * m[..., None].to(emb.dtype)).sum(dim=1) \
            / torch.clamp(lengths, min=1).to(emb.dtype)[:, None]
        first = self._logits(h).argmax(dim=-1).to(torch.int32)
        return first, emb

    def decode_step(self, tokens, cursors, active, cache):
        e = self._embed(tokens)                        # (S, d)
        pos = torch.arange(cache.shape[1], device=cache.device)[None, :]
        write = (pos == cursors[:, None]) & active[:, None]
        c = torch.where(write[..., None], e[:, None, :], cache)
        seen = pos <= cursors[:, None]
        h = (c * seen[..., None].to(c.dtype)).sum(dim=1) \
            / torch.clamp(cursors + 1, min=1).to(c.dtype)[:, None]
        nxt = self._logits(h).argmax(dim=-1).to(torch.int32)
        return nxt, c


class TinyDraft(Block):
    """Reference draft model for speculative decoding: the running-sum
    form of :class:`TinyDecoder`, sharing its parameters.  It keeps one
    ``(slots, 1, embed)`` running-sum row a slot (an O(embed) step) and
    predicts the same argmax as the target up to float summation order,
    which is why the target's verification decides every emitted token.

    Draft contract::

        prefill(prompts, lengths) -> (first_tokens, *state_rows)
            state_rows : (batch, L, ...); row ``lengths[i] - 1`` seeds
            slot i's position-free state at admission
        decode_step(tokens, cursors, active, *state) -> (next, *new_state)
            state : (max_slots, 1, ...) running rows
        accept(tok_block, accepted, active, *state) -> (*new_state,)
            fold the first ``accepted[i]`` tokens of ``tok_block[i]``
            into slot i's state (inside the verify step)
    """

    def __init__(self, target, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if not isinstance(target, Block):
            raise MXNetError("TinyDraft wraps a TinyDecoder target")
        self.model = target
        self.vocab = target.vocab
        self.embed_dim = target.embed_dim

    def prefill(self, prompts, lengths):
        emb = self.model._embed(prompts)               # (B, L, d)
        m = torch.arange(emb.shape[1], device=emb.device)[None, :] \
            < lengths[:, None]
        cum = torch.cumsum(emb * m[..., None].to(emb.dtype), dim=1)
        idx = torch.clamp(lengths.long() - 1, min=0)
        h = cum[torch.arange(cum.shape[0], device=cum.device), idx] \
            / torch.clamp(lengths, min=1).to(emb.dtype)[:, None]
        first = self.model._logits(h).argmax(dim=-1).to(torch.int32)
        return first, cum

    def decode_step(self, tokens, cursors, active, state):
        s2 = state[:, 0] + self.model._embed(tokens)
        h = s2 / torch.clamp(cursors + 1, min=1).to(state.dtype)[:, None]
        nxt = self.model._logits(h).argmax(dim=-1).to(torch.int32)
        ns = torch.where(active[:, None, None], s2[:, None, :], state)
        return nxt, ns

    def accept(self, tok_block, accepted, active, state):
        e = self.model._embed(tok_block)               # (S, k, d)
        m = (torch.arange(tok_block.shape[1], device=e.device)[None, :]
             < accepted[:, None]) & active[:, None]
        s2 = state[:, 0] + (e * m[..., None].to(e.dtype)).sum(dim=1)
        return (torch.where(active[:, None, None], s2[:, None, :], state),)
