"""The paged arena and speculative decoding of the PyTorch port's
``DecodeServer``, on the CPU, against the JAX package.

With the JAX package's ``TinyDecoder`` weights carried across, the paged
and the speculative (``TinyDraft``, ``spec_k``) servers emit the JAX
package's tokens, one for one, and its contiguous arena's; the draft's
proposals are accepted at the same rate.  ``_no_near_ties`` (from
``tests/test_torch_decode.py``) names any decision whose top two logits
lie within ``TIE_GAP`` (none at these seeds).  The host bookkeeping
(``serve.paging``) is a copy of the JAX package's and is held to it.  Then
the port's contracts: paged continuous == whole-batch, speculative ==
non-speculative greedy, exact dispatches, prefix pages stored once with
copy-on-write, eviction at refcount zero, no leaked page under churn, and
token-budget admission.
"""
import time

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _imperative, serve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve.paging import (PageAllocator, PrefixIndex,
                                          chunk_keys, pages_spanned)

from test_torch_decode import (_jax_model, _no_near_ties, _port_model,
                               _prompts, _spec)

VOCAB = 64
CPU = tmx.cpu()


def _server(model, **kwargs):
    kwargs.setdefault("max_slots", 4)
    kwargs.setdefault("max_len", 32)
    kwargs.setdefault("page_tokens", 4)
    kwargs.setdefault("ctx", CPU)
    return serve.DecodeServer(model, kwargs.pop("spec", _spec()), **kwargs)


def _run(srv, prompts, budgets):
    srv.start()
    d0 = _imperative.device_dispatch_count()
    hs = [srv.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
    seqs = [h.result(timeout=120) for h in hs]
    srv.drain()
    return seqs, srv.stats(), _imperative.device_dispatch_count() - d0


def _jax_run(jmodel, prompts, budgets, **kw):
    from mxnet_tpu import serve as jserve

    if "draft" in kw:
        kw["draft"] = jserve.TinyDraft(jmodel)
    srv = jserve.DecodeServer(jmodel, _spec(jserve), max_slots=4,
                              max_len=32, **kw)
    srv.start()
    hs = [srv.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
    seqs = [h.result(timeout=120) for h in hs]
    srv.drain()
    return seqs, srv.stats()


# -- against the JAX package --------------------------------------------------


@pytest.mark.parametrize("mode", [
    dict(page_tokens=4),
    dict(page_tokens=8, num_pages=10),
    dict(page_tokens=4, draft=True, spec_k=4),
    dict(page_tokens=4, draft=True, spec_k=2)])
def test_tokens_match_jax_token_for_token(mode):
    jmodel = _jax_model()
    model = _port_model(jmodel)
    rng = np.random.RandomState(5)
    prompts = _prompts(12, rng)
    budgets = [int(rng.randint(2, 12)) for _ in prompts]
    want, jst = _jax_run(jmodel, prompts, budgets, **mode)
    kw = dict(mode)
    if kw.pop("draft", False):
        kw["draft"] = serve.TinyDraft(model)
    got, st, _ = _run(_server(model, **kw), prompts, budgets)
    assert _no_near_ties(model, prompts, want) == []
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if "spec_k" in mode:
        assert st["spec"]["accept_rate"] == jst["spec"]["accept_rate"]


def test_paging_host_code_equals_jax():
    from mxnet_tpu.serve import paging as jpaging

    rng = np.random.RandomState(0)
    for _ in range(20):
        n = int(rng.randint(1, 30))
        p = rng.randint(0, 1000, size=n).astype(np.int32)
        t = int(rng.choice([1, 4, 16]))
        assert chunk_keys(p, n, t) == jpaging.chunk_keys(p, n, t)
        assert pages_spanned(n, t) == jpaging.pages_spanned(n, t)


# -- paging primitives --------------------------------------------------------


def test_allocator_refcount_lifecycle_and_ledger():
    a = PageAllocator(4, 8)
    assert a.trash == 4
    p0, p1 = a.alloc(), a.alloc()
    assert (p0, p1) == (0, 1) and a.live_count() == 2
    a.retain(p0)
    assert a.ref(p0) == 2 and not a.release(p0) and a.release(p0)
    assert a.ref(p0) == 0 and a.free_count() == 3
    a.check()
    with pytest.raises(MXNetError, match="non-live"):
        a.release(p0)
    for _ in range(3):
        a.alloc()
    with pytest.raises(MXNetError, match="exhausted"):
        a.alloc()


def test_chunk_keys_are_chained_prefix_hashes():
    a = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9], np.int32)
    b = np.array([9, 9, 9, 9, 5, 6, 7, 8, 9], np.int32)
    ka, kb = chunk_keys(a, 9, 4), chunk_keys(b, 9, 4)
    assert [k[0] for k in ka] == ["F", "F", "P"]
    assert ka[1] != kb[1]            # same chunk, other history
    assert chunk_keys(a, 8, 4)[1] == ka[1]
    assert ka[2][2] == 9 and pages_spanned(9, 4) == 3


def test_prefix_index_drop_page_invalidates_all_keys():
    idx = PrefixIndex()
    assert idx.register(("F", 0, "a"), 3) == 3
    assert idx.register(("F", 0, "a"), 5) == 3    # first writer wins
    idx.register(("P", 1, 6, "b"), 3)
    assert len(idx) == 2
    idx.drop_page(3)
    assert idx.lookup(("F", 0, "a")) is None and len(idx) == 0


# -- the port's contracts -----------------------------------------------------


def test_parity_paged_continuous_vs_whole_batch_and_contiguous():
    model = _port_model()
    rng = np.random.RandomState(1)
    prompts = _prompts(14, rng)
    budgets = [int(rng.randint(2, 12)) for _ in prompts]
    cont, s, _ = _run(_server(model), prompts, budgets)
    whole, _, _ = _run(_server(model, admission="batch"), prompts, budgets)
    contiguous, _, _ = _run(_server(model, page_tokens=0), prompts, budgets)
    for a, b, c in zip(cont, whole, contiguous):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert s["graph"]["post_warmup_compiles"] == 0


def test_speculative_greedy_bit_identical_and_dispatches():
    model = _port_model()
    rng = np.random.RandomState(5)
    prompts = _prompts(12, rng)
    budgets = [int(rng.randint(2, 12)) for _ in prompts]
    spec, s_spec, d_spec = _run(_server(model, draft=serve.TinyDraft(model),
                                        spec_k=4), prompts, budgets)
    plain, s_plain, d_plain = _run(_server(model), prompts, budgets)
    for a, b in zip(spec, plain):
        np.testing.assert_array_equal(a, b)
    assert s_spec["graph"]["post_warmup_compiles"] == 0
    assert d_spec == (s_spec["decode_steps"] + s_spec["spec_draft_steps"]
                      + s_spec["batches"])
    assert d_plain == s_plain["decode_steps"] + s_plain["batches"]
    assert s_spec["decode_steps"] < s_plain["decode_steps"]
    assert s_spec["spec"]["accept_rate"] > 0


def test_prefix_sharing_stores_shared_pages_once():
    model = _port_model()
    shared = np.arange(1, 9, dtype=np.int32)
    p1 = np.concatenate([shared, [9]]).astype(np.int32)
    p2 = p1.copy()
    srv = _server(model, spec=_spec(lengths=(4, 8, 16)), max_new_tokens=64)
    srv.start()
    h1 = srv.submit(p1, max_new_tokens=20)
    for _ in range(200):
        if srv.live_slots():
            break
        time.sleep(0.005)
    h2 = srv.submit(p2, max_new_tokens=20)
    seen_shared = False
    for _ in range(400):
        if srv.live_slots() == 2:
            tables = [list(srv._slot_pages[int(s)])
                      for s in np.flatnonzero(srv._active)]
            if len(tables) == 2:
                common = set(tables[0][:2]) & set(tables[1][:2])
                if common and all(srv._alloc.ref(pg) == 2 for pg in common):
                    seen_shared = True
                    break
        time.sleep(0.002)
    out = [h1.result(60), h2.result(60)]
    srv.drain()
    assert seen_shared, "prefix pages were never physically shared"
    s = srv.stats()
    assert s["page_prefix_hits"] >= 2 and s["page_cow"] >= 1
    srv._alloc.check()
    for p, o in zip((p1, p2), out):
        ref = _server(model, spec=_spec(lengths=(4, 8, 16)))
        ref.start()
        np.testing.assert_array_equal(
            o, ref.submit(p, max_new_tokens=20).result(60))
        ref.drain()


def test_prefix_eviction_only_at_refcount_zero():
    model = _port_model()
    shared = np.arange(1, 9, dtype=np.int32)
    p_short = np.concatenate([shared, [9]]).astype(np.int32)
    p_long = np.concatenate([shared, [11]]).astype(np.int32)
    srv = _server(model, spec=_spec(lengths=(4, 8, 16)), max_new_tokens=64)
    srv.start()
    h_long = srv.submit(p_long, max_new_tokens=20)
    for _ in range(200):
        if srv.live_slots():
            break
        time.sleep(0.005)
    keys = chunk_keys(p_long, len(p_long), 4)
    page0 = srv._prefix.lookup(keys[0])
    assert page0 is not None
    srv.submit(p_short, max_new_tokens=2).result(60)
    assert srv._alloc.ref(page0) >= 1
    assert srv._prefix.lookup(keys[0]) == page0
    h_long.result(60)
    srv.drain()
    assert srv._alloc.ref(page0) == 0
    assert srv._prefix.lookup(keys[0]) is None
    srv._alloc.check()


def test_fragmentation_churn_never_leaks_pages():
    model = _port_model()
    rng = np.random.RandomState(9)
    shared = np.arange(1, 5, dtype=np.int32)
    srv = _server(model, max_queue=256, num_pages=20)
    srv.start()
    handles = []
    for i in range(40):
        if rng.rand() < 0.4:
            p = np.concatenate([shared, rng.randint(
                0, VOCAB, size=int(rng.randint(1, 4)))])
        else:
            p = rng.randint(0, VOCAB, size=int(rng.randint(2, 9)))
        handles.append(srv.submit(p.astype(np.int32),
                                  max_new_tokens=int(rng.randint(1, 8))))
        if i % 3 == 0:
            time.sleep(0.002)
    for h in handles:
        h.result(timeout=120)
    srv.drain()
    alloc = srv._alloc
    alloc.check()
    assert alloc.free_count() == alloc.num_pages
    assert alloc.allocs == alloc.frees
    assert len(srv._prefix) == 0 and srv._committed == 0
    s = srv.stats()
    assert s["page_allocs"] == s["page_frees"]
    assert s["graph"]["post_warmup_compiles"] == 0


def test_submit_rejects_never_fitting_request_loudly():
    srv = _server(_port_model())
    srv.start()
    with pytest.raises(MXNetError) as e:
        srv.submit(np.arange(8, dtype=np.int32), max_new_tokens=100)
    assert "NEVER fit" in str(e.value) and "page pool" in str(e.value)
    srv.drain()


def test_small_pool_defers_admissions_instead_of_failing():
    srv = _server(_port_model(), num_pages=6, max_queue=64)
    srv.start()
    rng = np.random.RandomState(3)
    handles = [srv.submit(p, max_new_tokens=int(rng.randint(2, 6)))
               for p in _prompts(12, rng, max_len=6)]
    assert len([h.result(timeout=120) for h in handles]) == 12
    srv.drain()
    s = srv.stats()
    assert s["served"] == 12 and s["graph"]["post_warmup_compiles"] == 0
    srv._alloc.check()


def test_speculation_requires_paged_arena_and_draft():
    model = _port_model()
    draft = serve.TinyDraft(model)
    with pytest.raises(MXNetError, match="paged arena"):
        serve.DecodeServer(model, _spec(), max_slots=4, max_len=32,
                           draft=draft, spec_k=4, ctx=CPU)
    with pytest.raises(MXNetError, match="draft"):
        _server(model, spec_k=4)
    with pytest.raises(MXNetError, match="spec_k"):
        _server(model, draft=draft)
    other = _port_model(seed=11, vocab=32)
    with pytest.raises(MXNetError, match="vocab mismatch"):
        _server(model, draft=serve.TinyDraft(other), spec_k=4)


def test_stats_and_metrics_export_page_spec_families():
    from mxnet_tpu_torch.telemetry import metrics

    model = _port_model()
    srv = _server(model, draft=serve.TinyDraft(model), spec_k=2)
    srv.start()
    srv.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4).result(60)
    s = srv.stats()
    assert s["pages"]["page_tokens"] == 4
    # (num_pages + 1) pages of 4 positions of 16 float32
    assert s["pages"]["hbm_bytes"] == (32 + 1) * 4 * 16 * 4
    assert s["spec"]["k"] == 2 and s["spec"]["draft"] is True
    reg = metrics.Registry()
    metrics.register_decode_server(srv, registry=reg)
    text = reg.render()
    for name in ("mxtpu_decode_page_in_flight", "mxtpu_decode_page_hbm_bytes",
                 "mxtpu_decode_page_prefix_hits", "mxtpu_decode_spec_rounds",
                 "mxtpu_decode_spec_accepted"):
        assert name in text, name
    srv.drain()
