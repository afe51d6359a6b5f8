"""Continuous batching in the PyTorch port (``serve.DecodeServer``, the
contiguous arena), on the CPU, against the JAX package's DecodeServer.

The JAX package's ``TinyDecoder`` weights are carried across
(``load_numpy_params``) and the same prompts and budgets go through both
servers: the tokens are equal, one for one.  Greedy decode picks an
argmax, so a tie in the top two logits could split the packages on float
rounding alone: ``_no_near_ties`` recomputes every decision's logits and
names any pair of top logits closer than ``TIE_GAP`` (none at these
seeds).  Then the port's own contracts: continuous == whole-batch decode,
no new signature after warm-up, one dispatch a token step and an
admission group, deadlines, cancellation, drain, backpressure, reloads
between tokens, a failed step, the ``decodeServe`` section and the
``serve.decode.request`` spans.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _imperative, serve
from mxnet_tpu_torch.checkpoint import CheckpointManager

VOCAB = 64
CPU = tmx.cpu()
#: top-two logits closer than this are a tie float rounding could flip
TIE_GAP = 1e-5


def _jax_model(seed=3, vocab=VOCAB, embed=16):
    import mxnet_tpu as jmx
    from mxnet_tpu import serve as jserve

    jmx.random.seed(seed)
    model = jserve.TinyDecoder(vocab=vocab, embed=embed)
    model.initialize(jmx.init.Xavier())
    return model


def _port_model(jmodel=None, seed=3, vocab=VOCAB, embed=16):
    """The port's TinyDecoder; with ``jmodel``, its weights."""
    tmx.random.seed(seed)
    model = serve.TinyDecoder(vocab=vocab, embed=embed)
    model.initialize(tmx.init.Xavier(), ctx=CPU)
    if jmodel is not None:
        tmx.load_numpy_params(model, {
            k: p.data().asnumpy().copy()
            for k, p in jmodel._collect_params_with_prefix().items()})
    return model


def _spec(mod=serve, batches=(1, 2, 4), lengths=(4, 8)):
    return mod.BucketSpec(batch_sizes=batches, example_shape=(None,),
                          lengths=lengths, dtype="int32")


def _prompts(n, rng, max_len=8):
    return [rng.randint(0, VOCAB, size=int(rng.randint(2, max_len + 1)))
            .astype(np.int32) for _ in range(n)]


def _server(model, **kwargs):
    kwargs.setdefault("max_slots", 4)
    kwargs.setdefault("max_len", 32)
    kwargs.setdefault("ctx", CPU)
    return serve.DecodeServer(model, kwargs.pop("spec", _spec()), **kwargs)


def _run(srv, prompts, budgets, stagger=0.0):
    srv.start()
    handles = []
    for p, m in zip(prompts, budgets):
        handles.append(srv.submit(p, max_new_tokens=m))
        if stagger:
            time.sleep(stagger)
    out = [h.result(timeout=120) for h in handles]
    srv.drain()
    return out


def _no_near_ties(model, prompts, seqs):
    """Every greedy decision of ``seqs`` (prompt, then each emitted token
    fed back): the gap between the top two logits.  Returns the decisions
    closer than TIE_GAP as (request, position, gap)."""
    E = model.embedding.data().detach().numpy().astype(np.float64)
    P = model.proj.data().detach().numpy().astype(np.float64)
    ties = []
    for r, (p, seq) in enumerate(zip(prompts, seqs)):
        toks = list(p) + list(seq[:-1])
        for pos in range(len(seq)):
            h = E[toks[:len(p) + pos]].mean(axis=0)
            top = np.sort(h @ P)[-2:]
            if top[1] - top[0] < TIE_GAP:
                ties.append((r, pos, float(top[1] - top[0])))
    return ties


def test_tokens_match_jax_token_for_token():
    """Both packages' DecodeServer, the same weights, prompts and budgets
    under staggered continuous admission: the same tokens."""
    from mxnet_tpu import serve as jserve

    jmodel = _jax_model()
    model = _port_model(jmodel)
    rng = np.random.RandomState(1)
    prompts = _prompts(14, rng)
    budgets = [int(rng.randint(2, 12)) for _ in prompts]
    jsrv = jserve.DecodeServer(jmodel, _spec(jserve), max_slots=4,
                               max_len=32)
    want = _run(jsrv, prompts, budgets, stagger=0.002)
    got = _run(_server(model), prompts, budgets, stagger=0.002)
    assert _no_near_ties(model, prompts, want) == []
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert all(len(s) == m for s, m in zip(got, budgets))


@pytest.mark.parametrize("embed,vocab", [(16, 64), (64, 256)])
def test_tokens_match_jax_at_the_bench_widths(embed, vocab):
    """The bench's decoder widths (vocab 256, embed 64) and the small
    ones, whole-batch admission, 8 slots."""
    from mxnet_tpu import serve as jserve

    jmodel = _jax_model(seed=0, vocab=vocab, embed=embed)
    model = _port_model(jmodel, vocab=vocab, embed=embed)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab, size=int(rng.randint(2, 17)))
               .astype(np.int32) for _ in range(12)]
    budgets = [int(rng.randint(4, 13)) for _ in prompts]
    spec = dict(batches=(1, 2, 4, 8), lengths=(4, 8, 16))
    jsrv = jserve.DecodeServer(jmodel, _spec(jserve, **spec), max_slots=8,
                               max_len=48, admission="batch")
    want = _run(jsrv, prompts, budgets)
    got = _run(_server(model, spec=_spec(**spec), max_slots=8, max_len=48,
                       admission="batch"), prompts, budgets)
    assert _no_near_ties(model, prompts, want) == []
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_parity_continuous_vs_whole_batch_decode():
    model = _port_model()
    rng = np.random.RandomState(1)
    prompts = _prompts(14, rng)
    budgets = [int(rng.randint(2, 12)) for _ in prompts]
    cont = _run(_server(model), prompts, budgets, stagger=0.002)
    whole = _run(_server(model, admission="batch"), prompts, budgets)
    for a, b in zip(cont, whole):
        np.testing.assert_array_equal(a, b)


def test_staggered_admission_no_new_signature_exact_dispatches():
    model = _port_model()
    srv = _server(model)
    srv.start()
    rng = np.random.RandomState(2)
    d0 = _imperative.device_dispatch_count()
    handles = []
    for i, p in enumerate(_prompts(24, rng)):
        handles.append(srv.submit(p, max_new_tokens=int(rng.randint(1, 9))))
        if i % 4 == 0:
            time.sleep(0.002)
    for h in handles:
        h.result(timeout=120)
    srv.drain()
    d1 = _imperative.device_dispatch_count()
    s = srv.stats()
    assert s["served"] == s["admitted"] == 24
    assert s["graph"]["post_warmup_compiles"] == 0
    assert d1 - d0 == s["decode_steps"] + s["batches"]
    assert s["tokens"] > s["decode_steps"]


def test_single_sequence_one_dispatch_per_token():
    model = _port_model()
    srv = _server(model)
    srv.start()
    seq = srv.generate(_prompts(1, np.random.RandomState(3))[0],
                       max_new_tokens=9, timeout=120)
    srv.drain()
    s = srv.stats()
    assert len(seq) == 9
    assert s["decode_steps"] == 8 and s["batches"] == 1
    assert s["graph"]["post_warmup_compiles"] == 0


def test_eos_terminates_early_and_frees_slot():
    model = _port_model()
    prompt = _prompts(1, np.random.RandomState(12))[0]
    srv = _server(model)
    srv.start()
    ref = srv.generate(prompt, max_new_tokens=10, timeout=120)
    srv.drain()
    eos = int(ref[3])
    first_idx = int(np.argmax(ref == eos))
    srv2 = _server(model, eos_id=eos)
    srv2.start()
    seq = srv2.generate(prompt, max_new_tokens=10, timeout=120)
    srv2.drain()
    np.testing.assert_array_equal(seq, ref[:first_idx + 1])
    s = srv2.stats()
    assert s["served"] == 1 and s["slots"]["live"] == 0


def test_stream_iterator_and_sinks_match_future():
    srv = _server(_port_model())
    srv.start()
    h = srv.submit(_prompts(1, np.random.RandomState(4))[0],
                   max_new_tokens=7)
    streamed = list(h)
    assert streamed == list(h.result(timeout=120)) and len(streamed) == 7
    assert list(h) == []
    got = []
    h.add_sink(got.append)    # replays the history, then the terminal
    assert got[:-1] == streamed and got[-1] is serve.decode.STREAM_DONE
    srv.drain()


def test_mid_decode_deadline_frees_slot():
    srv = _server(_port_model())
    srv.start()
    rng = np.random.RandomState(5)
    doomed = srv.submit(_prompts(1, rng)[0], max_new_tokens=24,
                        deadline_ms=1)
    time.sleep(0.05)
    with pytest.raises(serve.DeadlineExceededError):
        doomed.result(timeout=120)
    assert len(srv.generate(_prompts(1, rng)[0], max_new_tokens=4,
                            timeout=120)) == 4
    srv.drain()
    s = srv.stats()
    assert s["expired_deadline"] == 1 and s["served"] == 1
    assert s["slots"]["live"] == 0
    assert s["submitted"] == s["served"] + s["expired_deadline"]
    with pytest.raises(serve.DeadlineExceededError):
        list(doomed)


def test_cancel_frees_slot_and_voids_queued():
    srv = _server(_port_model(), max_slots=1, max_len=2048)
    srv.start()
    rng = np.random.RandomState(6)
    live = srv.submit(_prompts(1, rng)[0], max_new_tokens=2000)
    queued = srv.submit(_prompts(1, rng)[0], max_new_tokens=2000)
    time.sleep(0.02)
    live.cancel()
    queued.cancel()
    srv.drain()
    s = srv.stats()
    assert s["cancelled"] == 2 and s["served"] == 0
    assert s["slots"]["live"] == 0 and s["queue_depth"] == 0


def test_drain_leaves_zero_live_slots_and_restarts_warm():
    srv = _server(_port_model())
    srv.start()
    rng = np.random.RandomState(7)
    handles = [srv.submit(p, max_new_tokens=5) for p in _prompts(10, rng)]
    srv.drain()
    assert all(h.future.done() for h in handles)
    s = srv.stats()
    assert s["served"] == s["submitted"] == 10
    assert s["queue_depth"] == 0 and s["slots"]["live"] == 0
    with pytest.raises(serve.ServerClosedError):
        srv.submit(_prompts(1, rng)[0])
    srv.start()
    assert len(srv.generate(_prompts(1, rng)[0], max_new_tokens=3,
                            timeout=120)) == 3
    srv.drain()
    assert srv.stats()["graph"]["post_warmup_compiles"] == 0


def test_overload_rejection_and_backpressure():
    srv = _server(_port_model(), max_slots=1, max_queue=2)
    srv.start()
    handles, rejected = [], 0
    for p in _prompts(12, np.random.RandomState(8)):
        try:
            handles.append(srv.submit(p, max_new_tokens=12))
        except serve.ServerOverloadedError:
            rejected += 1
    assert rejected > 0
    for h in handles:
        h.result(timeout=300)
    srv.drain()
    s = srv.stats()
    assert s["rejected_overload"] == rejected
    assert s["served"] == s["submitted"] == 12 - rejected


def test_submit_validation():
    srv = _server(_port_model())
    with pytest.raises(serve.ServerClosedError):
        srv.submit(np.zeros(3, np.int32))
    srv.start()
    with pytest.raises(tmx.MXNetError, match="max_len"):
        srv.submit(np.zeros(8, np.int32), max_new_tokens=30)
    with pytest.raises(tmx.MXNetError, match=">= 1"):
        srv.submit(np.zeros(3, np.int32), max_new_tokens=0)
    srv.drain()
    with pytest.raises(tmx.MXNetError, match="admission"):
        _server(_port_model(), admission="sometimes")
    with pytest.raises(tmx.MXNetError, match="exceeds"):
        _server(_port_model(), max_len=6)


def test_reload_between_tokens_of_a_live_stream(tmp_path):
    trained = _port_model(seed=11)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, params=trained, sync=True)
    serving = _port_model(seed=99)
    tensors = [p.data() for p in serving.collect_params().values()]
    srv = _server(serving, checkpoint=str(tmp_path))
    srv.start()
    prompt = _prompts(1, np.random.RandomState(9))[0]
    before = srv.generate(prompt, max_new_tokens=6, timeout=120)
    mid = srv.submit(prompt, max_new_tokens=20)
    meta = srv.reload_weights()
    assert len(mid.result(timeout=120)) == 20
    after = srv.generate(prompt, max_new_tokens=6, timeout=120)
    srv.drain()
    assert meta["step"] == 7
    s = srv.stats()
    assert s["reloads"] == 1 and s["graph"]["post_warmup_compiles"] == 0
    assert all(p.data() is t for p, t in
               zip(serving.collect_params().values(), tensors))
    ref_srv = _server(trained)
    ref_srv.start()
    ref = ref_srv.generate(prompt, max_new_tokens=6, timeout=120)
    ref_srv.drain()
    np.testing.assert_array_equal(after, ref)
    assert before.shape == after.shape


def test_injected_step_fault_fails_live_and_keeps_serving():
    from mxnet_tpu_torch.resilience import faults

    srv = _server(_port_model())
    srv.start()
    rng = np.random.RandomState(10)
    plan = faults.FaultPlan([{"site": "serve.decode", "action": "raise",
                              "on_hit": 2}])
    with faults.armed(plan):
        doomed = srv.submit(_prompts(1, rng)[0], max_new_tokens=24)
        with pytest.raises(faults.TransientFault):
            doomed.result(timeout=120)
    assert len(srv.generate(_prompts(1, rng)[0], max_new_tokens=5,
                            timeout=120)) == 5
    srv.drain()
    s = srv.stats()
    assert s["failed"] == 1 and s["served"] == 1 and s["slots"]["live"] == 0


def test_decode_serve_section_and_request_spans(tmp_path):
    from mxnet_tpu_torch import profiler, telemetry
    from mxnet_tpu_torch.serve import decode as decode_mod

    decode_mod.reset_decode_serve_stats()
    srv = _server(_port_model())
    srv.start()
    trace_path = str(tmp_path / "decode.trace.json")
    with telemetry.trace(trace_path):
        handles = [srv.submit(p, max_new_tokens=4)
                   for p in _prompts(6, np.random.RandomState(11))]
        for h in handles:
            h.result(timeout=120)
    srv.drain()
    section = json.loads(profiler.dumps(reset=True))["decodeServe"]
    assert section["admitted"] == section["finished"] == 6
    assert section["tokens"] == 24 and section["steps"] >= 3
    assert 0 < section["slot_occupancy"] <= 1
    fresh = json.loads(profiler.dumps())["decodeServe"]
    assert fresh["tokens"] == fresh["admitted"] == 0
    events = json.load(open(trace_path))["traceEvents"]
    begins = [e for e in events if e["ph"] == "b"
              and e["name"] == "serve.decode.request"]
    ends = [e for e in events if e["ph"] == "e"
            and e["name"] == "serve.decode.request"]
    assert len(begins) == len(ends) == 6
    assert {e["id"] for e in begins} == {e["id"] for e in ends}
    for e in ends:
        assert e["args"]["outcome"] == "served" and e["args"]["tokens"] == 4
    firsts = [e for e in events if e["ph"] == "n"
              and e["name"] == "serve.decode.first_token"]
    assert len(firsts) == 6
    assert {"serve.prefill", "serve.decode.admit",
            "serve.decode.step"} <= {e["name"] for e in events}


def test_metrics_export_of_a_live_server():
    from mxnet_tpu_torch.telemetry import metrics

    srv = _server(_port_model())
    srv.start()
    reg = metrics.Registry()
    metrics.register_decode_server(srv, registry=reg)
    srv.generate(_prompts(1, np.random.RandomState(13))[0],
                 max_new_tokens=3, timeout=120)
    srv.drain()
    text = reg.render()
    assert any(ln.startswith("mxtpu_decode_tokens{") and ln.endswith(" 3")
               for ln in text.splitlines())
    assert "mxtpu_decode_graph_post_warmup_compiles" in text


def test_concurrent_submitters():
    """Several submitting threads against the decode loop: every request
    resolves with its full budget and the accounting identity holds."""
    srv = _server(_port_model(), max_slots=8, max_queue=512)
    srv.start()
    results, errors = [], []
    lock = threading.Lock()

    def submitter(seed):
        rng = np.random.RandomState(seed)
        hs = [(srv.submit(p, max_new_tokens=m), m) for p, m in
              zip(_prompts(12, rng), rng.randint(1, 9, size=12))]
        for h, m in hs:
            try:
                r = h.result(timeout=300)
                with lock:
                    results.append(len(r) == m)
            except Exception as e:  # noqa: BLE001 -- collected for assert
                with lock:
                    errors.append(e)

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    srv.drain()
    s = srv.stats()
    assert not errors and len(results) == 60 and all(results)
    assert s["served"] == s["submitted"] == 60
    assert s["slots"]["live"] == 0 and s["queue_depth"] == 0
    assert s["graph"]["post_warmup_compiles"] == 0


def test_cached_step_op_counts_and_writes_in_place():
    """CachedStepOp on the CPU: every call runs the forward, books one
    dispatch and a compile (new signature) or a reuse; the in-place input
    is written where it lives."""
    from mxnet_tpu_torch.gluon.block import CachedStepOp, cached_graph_stats

    class Bump(tmx.gluon.Block):
        def forward(self, x, state, k=1):
            state.add_(x * k)
            return (state.sum().reshape(1),)

    state = torch.zeros(4)
    op = CachedStepOp(Bump(), inplace_inputs=(1,), static_kwargs={"k": 2})
    g0, d0 = cached_graph_stats(), _imperative.device_dispatch_count()
    for _ in range(3):
        (out,) = op(np.ones(4, np.float32), state)
    op(np.ones(2, np.float32), torch.zeros(2))
    assert float(out) == 24.0 and torch.equal(state, torch.full((4,), 6.0))
    assert op.stats == {"compiles": 2, "reuses": 2}
    g1 = cached_graph_stats()
    assert g1["compiles"] - g0["compiles"] == 2
    assert g1["reuses"] - g0["reuses"] == 2
    assert _imperative.device_dispatch_count() - d0 == 4
    with pytest.raises(TypeError):
        CachedStepOp(Bump(), static_kwargs={"k": [1]})


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode); "
                    "run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cached_step_op_replays_in_place_on_card(cuda_device):
    """First call eager, second captured, then replays: the carried state
    is written in place by every call, one capture, and a replaced state
    tensor captures again."""
    from mxnet_tpu_torch.gluon.block import CachedStepOp

    class Bump(tmx.gluon.Block):
        def forward(self, x, state):
            state.add_(x)
            return (state.sum().reshape(1),)

    state = torch.zeros(4, device=cuda_device)
    op = CachedStepOp(Bump(), inplace_inputs=(1,))
    c0 = _imperative.graph_capture_count()
    r0 = _imperative.graph_replay_count()
    outs = [float(op(np.full(4, i, np.float32), state)[0])
            for i in range(1, 6)]
    assert outs == [4.0, 12.0, 24.0, 40.0, 60.0]
    assert torch.equal(state.cpu(), torch.full((4,), 15.0))
    assert _imperative.graph_capture_count() - c0 == 1
    assert _imperative.graph_replay_count() - r0 == 4
    other = torch.zeros(4, device=cuda_device)
    op(np.ones(4, np.float32), other)
    assert _imperative.graph_capture_count() - c0 == 2
    assert float(other.sum()) == 4.0 and float(state.sum()) == 60.0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["contiguous", "paged", "speculative"])
def test_decode_on_card_equals_cpu(cuda_device, mode):
    """The same weights, prompts and budgets on the card and on the CPU:
    the same tokens; after warm-up no new capture, one replay a token
    step, a draft proposal and an admission group."""
    kw = {"paged": dict(page_tokens=4),
          "speculative": dict(page_tokens=4, spec_k=4)}.get(mode, {})
    rng = np.random.RandomState(14)
    prompts = _prompts(12, rng)
    budgets = [int(rng.randint(2, 12)) for _ in prompts]
    seqs = {}
    for ctx in (CPU, tmx.gpu(0)):
        model = _port_model(seed=3)
        model.collect_params().reset_ctx(ctx)
        extra = dict(kw)
        if mode == "speculative":
            extra["draft"] = serve.TinyDraft(model)
        srv = _server(model, ctx=ctx, **extra)
        srv.start()
        c0 = _imperative.graph_capture_count()
        r0 = _imperative.graph_replay_count()
        hs = [srv.submit(p, max_new_tokens=m)
              for p, m in zip(prompts, budgets)]
        seqs[ctx.device_type] = [h.result(timeout=120) for h in hs]
        srv.drain()
        s = srv.stats()
        assert s["graph"]["post_warmup_compiles"] == 0
        if ctx.device_type == "gpu":
            assert _imperative.graph_capture_count() == c0
            assert _imperative.graph_replay_count() - r0 == (
                s["decode_steps"] + s["spec_draft_steps"] + s["batches"])
    for a, b in zip(seqs["gpu"], seqs["cpu"]):
        np.testing.assert_array_equal(a, b)
