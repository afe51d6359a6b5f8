"""The autotuner of the PyTorch port (``mxnet_tpu_torch.tune``, a host
copy of ``mxnet_tpu/tune/``), on the CPU, against the JAX package.

The same seed over the same synthetic surface writes byte-identical trial
JSONL lines in both packages; the geometry (bucket ladders, decode arena
and page-pool sizes) and the cost model's predictions and rankings are
equal.  Then the port's own wiring: ``profiler_compiles`` reads the
port's captures (``cached_graph_stats`` and the whole-step signatures),
a trial over the paged knobs drives a decode server, and the ``tune``
profiler section is window-scoped and exported.
"""
import json
import math
import os

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import profiler, tune
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.tune import (CostModel, Knob, KnobRegistry,
                                  TrialRunner, Tuner, derive_batches,
                                  derive_bucket_spec, derive_decode_geometry,
                                  derive_lengths, format_grid,
                                  padding_overhead, parse_grid,
                                  reset_tune_stats, tune_stats)
from mxnet_tpu_torch.tune.cost_model import check_monotonic_agreement

_HEAVY_TAIL = {8: 500, 16: 300, 24: 100, 120: 20, 500: 5}


def _mem_knob(pkg, name, store, env, **kw):
    """A knob that applies into a dict (no MXTPU_* state leaks)."""
    default = kw.get("default")
    return pkg.Knob(name, env=env, apply=lambda v: store.__setitem__(name, v),
                    read=lambda: store.get(name, default), **kw)


def _two_knobs(pkg, store):
    reg = pkg.KnobRegistry()
    reg.register(_mem_knob(pkg, "alpha", store, "ALPHA_K", kind="int",
                           domain=(1, 2, 4, 8, 16, 32, 64), default=8))
    reg.register(_mem_knob(pkg, "beta", store, "BETA_K", kind="int",
                           domain=(1, 2, 4, 8, 16), default=4))
    return reg


def _quadratic(cfg):
    a, b = cfg["alpha"], cfg["beta"]
    return {"goodput": 100.0 - (math.log2(a) - 4.0) ** 2 * 3.0
            - (math.log2(b) - 3.0) ** 2 * 2.0}


def _jtune():
    from mxnet_tpu import tune as jtune

    return jtune


def _tuning_run(pkg, path, seed, start=None, **kw):
    store = {}
    reg = _two_knobs(pkg, store)
    if start:
        reg.apply(start)
    runner = pkg.TrialRunner(reg, _quadratic, history=str(path), seed=seed,
                             compile_counter=lambda: 0)
    rec = pkg.Tuner(reg, runner=runner, seed=seed, reference_configs={},
                    **kw).recommend()
    return rec, path.read_text()


@pytest.mark.parametrize("seed,start,kw", [
    (11, None, {}),
    (12, None, {}),
    (0, {"alpha": 1, "beta": 1}, {"top_k": 3, "passes": 2})])
def test_trial_lines_byte_identical_to_jax(tmp_path, seed, start, kw):
    jrec, jlines = _tuning_run(_jtune(), tmp_path / "jax.jsonl", seed,
                               start, **kw)
    trec, tlines = _tuning_run(tune, tmp_path / "port.jsonl", seed, start,
                               **kw)
    assert tlines == jlines and tlines.count("\n") == len(trec.trials)
    assert trec.config == jrec.config and trec.ratio == jrec.ratio
    for line in tlines.splitlines():
        rec = json.loads(line)
        assert rec["kind"] == "tune_trial"
        assert json.dumps(rec, sort_keys=True) == line


def test_default_registry_equals_jax():
    treg, jreg = tune.default_registry(), _jtune().default_registry()
    assert treg.names() == jreg.names()
    for t, j in zip(treg, jreg):
        assert (t.env, t.kind, t.domain, t.bounds, t.default, t.restart) \
            == (j.env, j.kind, j.domain, j.bounds, j.default, j.restart)
        assert t.candidates() == j.candidates()
    for name in ("decode_max_slots", "decode_max_len", "decode_page_tokens",
                 "decode_spec_k", "decode_draft", "serve_buckets"):
        assert name in treg


def test_knob_env_apply_roundtrip():
    knob = Knob("linger", env="TEST_TUNE_LINGER", kind="float",
                bounds=(0.0, 10.0), default=2.0)
    try:
        assert knob.read() == 2.0
        knob.apply(5.0)
        assert os.environ["MXTPU_TEST_TUNE_LINGER"] == "5.0"
        assert knob.read() == 5.0
        with pytest.raises(MXNetError, match="outside bounds"):
            knob.apply(99.0)
    finally:
        os.environ.pop("MXTPU_TEST_TUNE_LINGER", None)


def test_registry_validation_is_loud():
    with pytest.raises(MXNetError, match="bad bounds"):
        Knob("k", env="A_K", kind="int", bounds=(8, 1))
    with pytest.raises(MXNetError, match="domain= or bounds="):
        Knob("k", env="A_K", kind="int")
    with pytest.raises(MXNetError, match="restart class"):
        Knob("k", env="A_K", domain=(1, 2), restart="maybe")
    with pytest.raises(MXNetError, match="lower_snake_case"):
        Knob("Bad", env="A_K", domain=(1, 2))
    reg = KnobRegistry([Knob("a", env="SAME_K", domain=(1, 2)),
                        Knob("b", env="SAME_K", domain=(1, 2))])
    with pytest.raises(MXNetError, match="both claim"):
        reg.validate()


# -- geometry and the cost model against the JAX package ----------------------


@pytest.mark.parametrize("max_buckets,align", [(1, 8), (3, 8), (4, 16)])
def test_geometry_equals_jax(max_buckets, align):
    jt = _jtune()
    assert derive_lengths(_HEAVY_TAIL, max_buckets, align) == \
        jt.derive_lengths(_HEAVY_TAIL, max_buckets, align)
    lengths = derive_lengths(_HEAVY_TAIL, max_buckets, align)
    assert padding_overhead(lengths, _HEAVY_TAIL) == \
        jt.padding_overhead(lengths, _HEAVY_TAIL)
    snap = {"request_lengths": _HEAVY_TAIL,
            "group_sizes": {1: 40, 2: 25, 3: 10, 6: 5}}
    t = derive_bucket_spec(snap, (None,), max_buckets=max_buckets,
                           align=align)
    j = jt.derive_bucket_spec(snap, (None,), max_buckets=max_buckets,
                              align=align)
    assert (t.batch_sizes, t.lengths) == (j.batch_sizes, j.lengths)
    assert format_grid(t.batch_sizes, t.lengths) == \
        jt.format_grid(j.batch_sizes, j.lengths)


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=32, slot_occupancy=0.9, max_slots=8),
    dict(max_new_tokens=16, slot_occupancy=0.1, max_slots=8),
    dict(max_new_tokens=16, max_slots=8, paged=True, page_tokens=16),
    dict(max_new_tokens=72, max_slots=16, paged=True, page_tokens=8)])
def test_decode_geometry_equals_jax(kw):
    assert derive_decode_geometry(_HEAVY_TAIL, **kw) == \
        _jtune().derive_decode_geometry(_HEAVY_TAIL, **kw)


def test_cost_model_equals_jax():
    """Fitted on the same observations, both models predict the same
    scores and rank held-out candidates the same way."""
    models = []
    for pkg in (tune, _jtune()):
        m = pkg.CostModel(_two_knobs(pkg, {}))
        for a in (1, 8, 64):
            for b in (1, 4, 16):
                m.observe({"alpha": a, "beta": b},
                          _quadratic({"alpha": a, "beta": b})["goodput"])
        models.append(m)
    held_out = [{"alpha": a, "beta": b}
                for a, b in ((2, 2), (4, 8), (16, 4), (32, 16))]
    t, j = models
    np.testing.assert_allclose([t.predict(c) for c in held_out],
                               [j.predict(c) for c in held_out], rtol=1e-9)
    assert t.rank(held_out) == j.rank(held_out)
    measured = [_quadratic(c)["goodput"] for c in held_out]
    assert check_monotonic_agreement(t, held_out, measured) >= 0.75


def test_cost_model_phase_hint_prior():
    store = {}
    reg = KnobRegistry()
    reg.register(_mem_knob(tune, "pipeline_prefetch", store, "A_K",
                           kind="int", domain=(0, 1, 2, 4, 8), default=2))
    model = CostModel(reg, phase_hint={"input_wait_ms": 900.0,
                                       "compute_ms": 100.0})
    deep, shallow = {"pipeline_prefetch": 8}, {"pipeline_prefetch": 0}
    assert model.predict(deep) > model.predict(shallow)
    assert model.rank([shallow, deep])[0] == deep


def test_grid_strings():
    assert parse_grid("1,2,4x") == ((1, 2, 4), None)
    assert derive_batches({1: 3, 4: 1}, max_batch=2) == (1, 2)
    with pytest.raises(MXNetError, match="bad bucket grid"):
        parse_grid("1,2x4,oops")
    with pytest.raises(MXNetError, match="no batch sizes"):
        parse_grid("x32,64")


# -- the port's wiring --------------------------------------------------------


def test_recompile_debit_accounting():
    reset_tune_stats()
    store = {}
    reg = KnobRegistry()
    reg.register(_mem_knob(tune, "bucket", store, "BUCKET_K", kind="int",
                           domain=(1, 32), default=32, restart="recompile"))
    compiles = [0]

    def measure(cfg):
        if cfg["bucket"] != 32:
            compiles[0] += 3
        return {"goodput": 50.0}

    runner = TrialRunner(reg, measure, history="", seed=0,
                         recompile_penalty=2.0,
                         compile_counter=lambda: compiles[0])
    assert runner.run({"bucket": 32}, baseline=True)["score"] == 50.0
    moved = runner.run({"bucket": 1}, knob="bucket")
    assert moved["recompiles"] == 3 and moved["score"] == 44.0
    assert tune_stats()["recompiles_spent"] == 3


def test_profiler_compiles_reads_the_ports_captures():
    """A new CachedStepOp signature (what a decode server's warm-up makes)
    shows as one more compile to the trial runner's default counter."""
    from mxnet_tpu_torch.gluon.block import CachedStepOp
    from mxnet_tpu_torch.tune.trials import profiler_compiles

    class Twice(tmx.gluon.Block):
        def forward(self, x):
            return (x * 2,)

    op = CachedStepOp(Twice())
    before = profiler_compiles()
    op(np.ones(3, np.float32))
    op(np.ones(3, np.float32))
    op(np.ones(5, np.float32))
    assert profiler_compiles() - before == 2


def test_decode_server_traffic_feeds_the_geometry():
    """A trial over the paged knobs drives a decode server and is scored
    by its tokens; the traffic's prompt lengths size a decode arena."""
    from mxnet_tpu_torch import serve

    tmx.random.seed(0)
    model = serve.TinyDecoder(vocab=64, embed=16)
    model.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    spec = serve.BucketSpec(batch_sizes=(1, 2, 4), example_shape=(None,),
                            lengths=(4, 8), dtype="int32")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 64, size=int(rng.randint(2, 9)))
               .astype(np.int32) for _ in range(10)]
    reg = tune.default_registry()
    store = {}
    knobs = KnobRegistry()
    for name in ("decode_page_tokens", "decode_spec_k"):
        k = reg.get(name)
        knobs.register(Knob(name, env=k.env, kind=k.kind, domain=k.domain,
                            default=k.default, restart=k.restart,
                            apply=lambda v, n=name: store.__setitem__(n, v),
                            read=lambda n=name, d=k.default: store.get(n, d)))
    def measure(cfg):
        pt = cfg["decode_page_tokens"]
        kk = cfg["decode_spec_k"] if pt else 1
        srv = serve.DecodeServer(
            model, spec, max_slots=4, max_len=32, ctx=tmx.cpu(),
            page_tokens=pt, spec_k=kk,
            draft=serve.TinyDraft(model) if kk > 1 else None).start()
        for p in prompts:
            srv.submit(p, max_new_tokens=6)
        srv.drain()
        return {"tokens_per_s": float(srv.stats()["tokens"])}

    runner = TrialRunner(knobs, measure, history="", seed=0)
    base = runner.run({"decode_page_tokens": 0, "decode_spec_k": 1},
                      baseline=True)
    paged = runner.run({"decode_page_tokens": 8, "decode_spec_k": 4})
    assert base["score"] == paged["score"] == 60.0
    assert paged["recompiles"] > 0     # a new arena: new signatures
    hist = {}
    for p in prompts:
        hist[len(p)] = hist.get(len(p), 0) + 1
    geo = derive_decode_geometry(hist, max_new_tokens=6, max_slots=4,
                                 paged=True, page_tokens=8)
    assert geo["max_len"] >= 8 + 6 and geo["page_tokens"] == 8


def test_tune_section_window_scoping_and_export():
    reset_tune_stats()
    runner = TrialRunner(_two_knobs(tune, {}), _quadratic, history="",
                         seed=0, compile_counter=lambda: 0)
    runner.run({"alpha": 8, "beta": 4}, baseline=True)
    assert profiler.sections()["tune"]["trials"] == 1
    assert profiler.sections(reset=True)["tune"]["trials"] == 1
    assert profiler.sections()["tune"]["trials"] == 0
    from mxnet_tpu_torch.telemetry import metrics

    text = metrics.default_registry().render()
    assert "mxtpu_tune_trials" in text
    assert "mxtpu_tune_best_over_baseline" in text


def test_tuner_never_moves_restart_knobs_mid_burst():
    reset_tune_stats()
    store = {}
    reg = KnobRegistry()
    reg.register(_mem_knob(tune, "linger", store, "L_K", kind="float",
                           domain=(0.0, 2.0, 5.0), default=2.0))
    reg.register(_mem_knob(tune, "bucket_mb", store, "B_K", kind="int",
                           domain=(1, 32, 128), default=32,
                           restart="recompile"))
    reg.apply({"linger": 0.0, "bucket_mb": 1})
    runner = TrialRunner(reg, lambda c: {"goodput": c["linger"]
                                         + c["bucket_mb"]},
                         history="", seed=0, compile_counter=lambda: 0)
    rec = Tuner(reg, runner=runner, seed=0, top_k=3, busy_fn=lambda: True,
                reference_configs={}).recommend()
    assert all(t["config"]["bucket_mb"] == 1 for t in rec.trials)
    assert rec.config == {"linger": 5.0, "bucket_mb": 1}
    assert rec.blocked_moves == 1 == tune_stats()["blocked_moves"]
    with pytest.raises(MXNetError, match="may not move mid-burst"):
        reg.apply({"bucket_mb": 128}, allow_restart=False)
