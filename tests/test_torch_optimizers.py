"""The optimizers, ``multi_precision``, the update ops and the AMP ops of the
PyTorch port against the JAX package.

Inputs are made with numpy from a seed.  Each of the 16 optimizers takes 4
updates on the same weight and gradients in both packages (weight decay,
``clip_gradient``, ``rescale_grad`` and a FactorScheduler that halves the
lr after two updates, where the rule takes them), without and with
``multi_precision`` (a float16 weight with a float32 master); SGLD, whose
noise comes from each package's own generator, is held by structure: its
rule with the noise passed in, and determinism under a seed.  The port's
fused step is held to its sequential step bit for bit.  The 13 update ops
and the 4 AMP ops run through ``mx.nd`` in both packages.

Tolerances.  float32 weights and states, and the float32 masters: 1e-6
absolute plus 1e-5 relative (the same elementwise rule in other ops'
roundings; LAMB's norms sum in other orders).  The float16 weights: the
master rounded to float16, so within one float16 ulp (2**-10 relative)
where a master sits on a rounding edge.  The update ops: 1e-6 plus 1e-5.
The AMP ops: exact.  The tests marked ``gpu`` run the rules, ``multi_
precision`` and the ops on the card against the same calls on the CPU.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx

CPU = tmx.cpu()

#: (name, hyper-parameters): every registered optimizer but SGLD
OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
    ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "wd": 0.01, "centered": True}),
    ("adagrad", {"learning_rate": 0.1, "wd": 0.01}),
    ("adadelta", {"wd": 0.01}),
    ("ftrl", {"learning_rate": 0.1, "wd": 0.01}),
    ("signum", {"learning_rate": 0.01, "wd": 0.01}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01, "lower_bound": 0.5,
              "upper_bound": 2.0}),
    ("adamax", {"learning_rate": 0.01, "wd": 0.01}),
    ("nadam", {"learning_rate": 0.01, "wd": 0.01}),
    ("groupadagrad", {"learning_rate": 0.1}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("ftml", {"learning_rate": 0.01, "wd": 0.01}),
]
OPT_IDS = ["sgd", "nag", "adam", "adamw", "rmsprop", "rmsprop_centered",
           "adagrad", "adadelta", "ftrl", "signum", "lamb", "lamb_bounds",
           "adamax", "nadam", "groupadagrad", "dcasgd", "ftml"]


def _opt_args(pkg, base, mp=False):
    args = dict(base, clip_gradient=0.5, rescale_grad=0.25,
                multi_precision=mp)
    if "learning_rate" in base:
        args["lr_scheduler"] = pkg.lr_scheduler.FactorScheduler(
            step=2, factor=0.5, base_lr=base["learning_rate"])
    return args


def _leaves(st):
    """A state's arrays in order, as float32 numpy (nested tuples of a
    master and its states flattened)."""
    if st is None:
        return []
    if isinstance(st, (tuple, list)):
        return [a for s in st for a in _leaves(s)]
    if hasattr(st, "asnumpy"):
        return [st.asnumpy().astype(np.float32)]
    return [st.detach().float().numpy().copy()]


def _data(seed=7, shape=(6, 5)):
    rng = np.random.RandomState(seed)
    w0 = rng.randn(*shape).astype(np.float32)
    grads = [rng.randn(*shape).astype(np.float32) * 3 for _ in range(4)]
    return w0, grads


def _close(a, b, atol=1e-6, rtol=1e-5, msg=""):
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("mp", [False, True], ids=["fp32", "fp16_master"])
@pytest.mark.parametrize("name,base", OPTIMIZERS, ids=OPT_IDS)
def test_optimizer_updates_match_jax(name, base, mp):
    """Four updates of each rule; the weights, the masters and every state
    agree after each, and so do the update counts and the lr."""
    import mxnet_tpu as jmx

    w0, grads = _data()
    dt = np.float16 if mp else np.float32
    jopt = jmx.optimizer.create(name, **_opt_args(jmx, base, mp))
    topt = tmx.optimizer.create(name, **_opt_args(tmx, base, mp))
    jw = jmx.nd.array(w0.astype(dt), dtype=dt)
    tw = torch.from_numpy(w0.astype(dt))
    jst = jopt.create_state_multi_precision(0, jw)
    tst = topt.create_state_multi_precision(0, tw)
    if mp:   # the state is (float32 master, the rule's states)
        assert tst[0].dtype == torch.float32
    ulp = 2.0 ** -10 if mp else 1e-5
    for g in grads:
        jopt.update_multi_precision(0, jw, jmx.nd.array(g.astype(dt),
                                                        dtype=dt), jst)
        topt.update_multi_precision(0, tw, torch.from_numpy(g.astype(dt)),
                                    tst)
        assert tw.dtype == torch.from_numpy(w0.astype(dt)).dtype
        _close(tw.float().numpy(), jw.asnumpy().astype(np.float32),
               rtol=ulp, msg="weight")
        for j, (a, b) in enumerate(zip(_leaves(tst), _leaves(jst))):
            _close(a, b, msg=f"state {j}")
    assert topt.num_update == jopt.num_update == 4
    assert topt.learning_rate == jopt.learning_rate


def test_sgld_rule_with_the_noise_passed_in_matches_jax():
    """SGLD's update with the same noise in both packages."""
    from mxnet_tpu import optimizer as jopt
    import jax.numpy as jnp

    w0, grads = _data()
    noise = np.random.RandomState(3).randn(*w0.shape).astype(np.float32)
    want = np.asarray(jopt._k_sgld(jnp.asarray(w0), jnp.asarray(grads[0]),
                                   jnp.asarray(noise),
                                   jnp.asarray(0.01, jnp.float32),
                                   rescale=0.25, clip=0.5, wd=0.01))
    w = torch.from_numpy(w0.copy())
    sv = torch.tensor([0.01, 0.25, 0.01], dtype=torch.float32)
    tmx.optimizer._run_rule(tmx.optimizer._k_sgld,
                            (("clip", 0.5), ("decay", True)),
                            ("lr", "rescale", "wd"), sv, [w],
                            [torch.from_numpy(grads[0])],
                            [[torch.from_numpy(noise)]])
    _close(w.numpy(), want)


def test_sgld_noise_and_determinism():
    """As the JAX package's test: seeded runs repeat, the result is
    finite, and as lr goes to 0 so does the update."""
    w0, grads = _data()

    def run(lr):
        opt = tmx.optimizer.create("sgld", learning_rate=lr)
        w = torch.from_numpy(w0.copy())
        for g in grads:
            opt.update(0, w, torch.from_numpy(g), None)
        return w.numpy()

    tmx.random.seed(7)
    got1 = run(0.01)
    tmx.random.seed(7)
    got2 = run(0.01)
    np.testing.assert_array_equal(got1, got2)
    assert np.isfinite(got1).all() and not np.array_equal(got1, w0)
    tmx.random.seed(7)
    _close(run(1e-12), w0, atol=1e-4)


def test_group_adagrad_refuses_weight_decay():
    with pytest.raises(tmx.MXNetError, match="weight decay"):
        tmx.optimizer.create("groupadagrad", wd=0.1)


# -- the fused step against the sequential step ------------------------------

SPECS = [(3, 4), (17,), (2, 3, 2), (5, 5), (1,), (4, 1), (6,)]


def _params(specs, seed=0, dtypes=None):
    rng = np.random.RandomState(seed)
    ps = []
    for j, shape in enumerate(specs):
        dt = (dtypes or {}).get(j, "float32")
        p = tmx.gluon.Parameter(f"p{j}", shape=shape, dtype=dt,
                                wd_mult=0.5 if j == 1 else 1.0)
        p.initialize(ctx=CPU)
        p.set_data(rng.randn(*shape).astype(np.float32))
        ps.append(p)
    return ps


@pytest.mark.parametrize("name,base,mp", [
    ("rmsprop", {"learning_rate": 0.01, "wd": 0.01}, False),
    ("adagrad", {"learning_rate": 0.1, "wd": 0.01}, False),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}, False),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01}, True),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}, True),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, True),
], ids=["rmsprop", "adagrad", "rmsprop_centered", "lamb_mp", "adam_mp",
        "sgd_mom_mp"])
def test_fused_step_equals_sequential_step_bit_for_bit(name, base, mp):
    """``aggregate_num=1`` against the default over 4 Trainer steps: the
    same weights, masters and states to the bit.  Float16 parameters with
    masters (every second one under ``mp``) and the rules without a fused
    form take the sequential path inside the fused step, counted as the
    JAX package counts them."""
    dtypes = {j: "float16" for j in range(0, len(SPECS), 2)} if mp else None
    out = []
    for agg in (None, 1):
        ps = _params(SPECS, dtypes=dtypes)
        args = _opt_args(tmx, base, mp)
        if agg is not None:
            args["aggregate_num"] = agg
        tr = tmx.gluon.Trainer(ps, name, args)
        rng = np.random.RandomState(1)
        tmx.gluon.trainer.reset_trainer_step_stats()
        for _ in range(4):
            for p in ps:
                p.grad().copy_(torch.from_numpy(
                    rng.randn(*p.shape).astype(np.float32)))
            tr.step(2)
        out.append((ps, tr, tmx.gluon.trainer.trainer_step_stats()))
    (fp, ftr, fst), (sp, strn, _) = out
    for a, b in zip(fp, sp):
        assert torch.equal(a.data(), b.data())
    for a, b in zip(ftr._states, strn._states):
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(x, y)
    n_seq = len(SPECS) if not ftr.optimizer._has_rule() else (
        len(dtypes) if mp else 0)
    assert fst["params_fused"] == 4 * (len(SPECS) - n_seq)
    assert ftr.optimizer.num_update == strn.optimizer.num_update == 4


def test_fused_update_sends_master_weights_to_the_sequential_path():
    """Float16 weights with float32 masters: ``fused_update`` counts them
    as sequential updates and the rest as fused, as the JAX package's."""
    import mxnet_tpu as jmx

    rng = np.random.RandomState(2)
    shapes = [(4, 3), (5,), (2, 2)]
    dts = [np.float16, np.float32, np.float16]
    stats = {}
    for key, pkg in (("jax", jmx), ("port", tmx)):
        opt = pkg.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                   multi_precision=True)
        ws = [rng.randn(*s).astype(d) for s, d in zip(shapes, dts)]
        gs = [rng.randn(*s).astype(d) for s, d in zip(shapes, dts)]
        if key == "jax":
            ws = [jmx.nd.array(w, dtype=w.dtype) for w in ws]
            gs = [jmx.nd.array(g, dtype=g.dtype) for g in gs]
        else:
            ws = [torch.from_numpy(w) for w in ws]
            gs = [torch.from_numpy(g) for g in gs]
        sts = [opt.create_state_multi_precision(i, w)
               for i, w in enumerate(ws)]
        stats[key] = opt.fused_update([0, 1, 2], ws, gs, sts)
    assert stats["port"] == stats["jax"] == {
        "fused_calls": 1, "params_fused": 1, "seq_updates": 2}


def test_whole_step_plan_refuses_master_weights_with_the_jax_reason():
    import mxnet_tpu as jmx

    reasons = []
    for pkg, w in ((jmx, jmx.nd.array(np.ones(3, np.float16),
                                      dtype=np.float16)),
                   (tmx, torch.ones(3, dtype=torch.float16))):
        opt = pkg.optimizer.create("sgd", learning_rate=0.1,
                                   multi_precision=True)
        plan, _, reason = opt.whole_step_plan([0], [w], [None])
        assert plan is None
        reasons.append(reason)
    assert reasons[0] == reasons[1] == \
        "multi-precision fp16 master-weight params"
    # the rules the reference keeps sequential have no whole-step form
    w = torch.ones(3)
    for name in ("lamb", "adadelta", "nadam", "ftml"):
        opt = tmx.optimizer.create(name)
        assert opt.whole_step_plan([0], [w], [opt.create_state(0, w)])[2] \
            == f"optimizer {type(opt).__name__} has no fused kernel for " \
            f"param 0"


def test_master_states_round_trip_through_states_dict():
    """A Trainer's float32 masters and their states survive
    ``states_dict``/``load_states_dict`` into a fresh Trainer."""
    ps = _params(SPECS[:3], dtypes={0: "float16", 2: "float16"})
    tr = tmx.gluon.Trainer(ps, "lamb", {"learning_rate": 0.01,
                                        "multi_precision": True})
    for p in ps:
        p.grad().copy_(torch.ones(p.shape, dtype=p.data().dtype))
    tr.step(1)
    blob = tr.states_dict()
    tr2 = tmx.gluon.Trainer(ps, "lamb", {"learning_rate": 0.01,
                                         "multi_precision": True})
    tr2.load_states_dict(blob)
    for a, b in zip(tr._states, tr2._states):
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(x, y)
    assert tr2._states[0][0].dtype == torch.float32


# -- the update ops and the AMP ops ------------------------------------------

UPDATE_OPS = [
    ("sgd_update", 0, {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5,
                       "clip_gradient": 1.0}),
    ("sgd_mom_update", 1, {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("nag_mom_update", 1, {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("mp_sgd_update", "w32", {"lr": 0.1, "wd": 0.01}),
    ("mp_sgd_mom_update", "mom+w32", {"lr": 0.1, "momentum": 0.9}),
    ("adam_update", 2, {"lr": 0.01, "wd": 0.01, "clip_gradient": 1.0}),
    ("rmsprop_update", 1, {"lr": 0.01, "clip_weights": 0.8}),
    ("rmspropalex_update", 3, {"lr": 0.01, "wd": 0.01}),
    ("ftrl_update", 2, {"lr": 0.1, "wd": 0.01}),
    ("signsgd_update", 0, {"lr": 0.01, "wd": 0.01}),
    ("signum_update", 1, {"lr": 0.01, "momentum": 0.9, "wd_lh": 0.01}),
    ("ftml_update", 3, {"lr": 0.01, "t": 2, "clip_grad": 1.0}),
    ("adagrad_update", 1, {"lr": 0.1, "wd": 0.01}),
]


def _op_inputs(states, seed=11):
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 5).astype(np.float32)
    g = rng.randn(4, 5).astype(np.float32) * 2
    if states == "w32":
        return [w.astype(np.float16), g.astype(np.float16), w]
    if states == "mom+w32":
        return [w.astype(np.float16), g.astype(np.float16),
                np.abs(rng.randn(4, 5)).astype(np.float32) * 0.1, w]
    return [w, g] + [np.abs(rng.randn(4, 5)).astype(np.float32) * 0.1
                     for _ in range(states)]


@pytest.mark.parametrize("name,states,attrs", UPDATE_OPS,
                         ids=[u[0] for u in UPDATE_OPS])
def test_update_ops_match_jax(name, states, attrs):
    """``mx.nd.<op>(w, g, *states, out=w, **attrs)``: the weight written
    through ``out=``, every state updated in place, in both packages."""
    import mxnet_tpu as jmx

    arrays = _op_inputs(states)
    got = {}
    for key, pkg in (("jax", jmx), ("port", tmx)):
        nds = [pkg.nd.array(a, dtype=a.dtype, ctx=pkg.cpu())
               for a in arrays]
        out = getattr(pkg.nd, name)(*nds, out=nds[0], **attrs)
        assert out is nds[0]
        got[key] = [n.asnumpy().astype(np.float32) for n in nds]
    for j, (a, b) in enumerate(zip(got["port"], got["jax"])):
        _close(a, b, rtol=2.0 ** -10 if arrays[j].dtype == np.float16
               else 1e-5, msg=f"input {j}")
    # the weight and each state changed
    for j in [0] + list(range(2, len(arrays))):
        assert not np.array_equal(got["port"][j], arrays[j]), j


def test_update_ops_on_tensors_return_the_new_values():
    """On tensors (``F``) an update op returns the new weight and states
    and changes none of its inputs, as the JAX op."""
    w, g, mom = (torch.from_numpy(a) for a in _op_inputs(1))
    before = [t.clone() for t in (w, g, mom)]
    new_w, new_mom = tmx.nd.sgd_mom_update(w, g, mom, lr=0.1, momentum=0.9)
    for t, b in zip((w, g, mom), before):
        assert torch.equal(t, b)
    torch.testing.assert_close(new_mom, 0.9 * mom - 0.1 * g)
    torch.testing.assert_close(new_w, w + new_mom)


def test_amp_ops_match_jax():
    import mxnet_tpu as jmx

    rng = np.random.RandomState(4)
    x = rng.randn(3, 4).astype(np.float32)
    y = rng.randn(5).astype(np.float16)
    bad = x.copy()
    bad[1, 2] = np.inf
    for pkg in (jmx, tmx):
        arr = lambda v: pkg.nd.array(v, dtype=v.dtype,  # noqa: E731
                                     ctx=pkg.cpu())
        a = arr(x)
        h = pkg.nd.amp_cast(a, dtype="float16")
        assert np.dtype(h.dtype) == np.float16
        np.testing.assert_array_equal(h.asnumpy(), x.astype(np.float16))
        wide = pkg.nd.amp_multicast(a, arr(y), num_outputs=2)
        assert [np.dtype(o.dtype) for o in wide] == [np.float32] * 2
        narrow = pkg.nd.amp_multicast(a, arr(y), num_outputs=2,
                                      cast_narrow=True)
        assert [np.dtype(o.dtype) for o in narrow] == [np.float16] * 2
        np.testing.assert_array_equal(narrow[0].asnumpy(),
                                      x.astype(np.float16))
        for arrays, want in (([x], 1.0), ([bad], 0.0), ([x, y], 1.0),
                             ([y, bad], 0.0)):
            nds = [arr(v) for v in arrays]
            got = pkg.nd.all_finite(nds[0]) if len(nds) == 1 else \
                pkg.nd.multi_all_finite(*nds, num_arrays=len(nds))
            assert got.shape == (1,) and np.dtype(got.dtype) == np.float32
            assert float(got.asnumpy()[0]) == want, (pkg.__name__, arrays)


def test_registry_lacks_at_most_100_of_the_jax_names():
    """With the update ops and the AMP ops, the port's registry lacks at
    most 100 of the JAX registry's names: those the JAX package's own
    modules register (a plugin a test loads through ``mx.library`` adds
    more in its process)."""
    import mxnet_tpu.subgraph  # noqa: F401  (registers the fused op)
    import mxnet_tpu.symbol  # noqa: F401  (registers the scalar ops)
    import mxnet_tpu_torch.subgraph  # noqa: F401
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry

    for name, *_ in UPDATE_OPS:
        assert registry.entry(name).mutate_aux == jreg.get(name).mutate_aux
    own = {n for n in jreg.list_ops()
           if getattr(jreg.get(n).fn, "__module__", "").startswith(
               "mxnet_tpu.")}
    missing = sorted(own - set(registry.list_ops()))
    assert len(missing) <= 100, missing


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine with -m gpu")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("mp", [False, True], ids=["fp32", "fp16_master"])
@pytest.mark.parametrize("name,base", OPTIMIZERS, ids=OPT_IDS)
def test_optimizers_on_card_match_cpu(name, base, mp, cuda_device):
    """The same four updates on the card and on the CPU: the card's
    elementwise ops round as the CPU's but for sqrt, div and norm ulps, so
    the float32 tolerances above hold."""
    w0, grads = _data()
    dt = torch.float16 if mp else torch.float32
    out = {}
    for dev in ("cpu", cuda_device):
        opt = tmx.optimizer.create(name, **_opt_args(tmx, base, mp))
        w = torch.tensor(w0, device=dev, dtype=dt)   # a copy on the CPU too
        st = opt.create_state_multi_precision(0, w)
        for g in grads:
            opt.update_multi_precision(0, w, torch.from_numpy(g).to(dev, dt),
                                       st)
        out[str(dev)] = [w.float().cpu().numpy()] + _leaves(
            tmx.optimizer._states_to(st, "cpu"))
    for j, (a, b) in enumerate(zip(out["cpu"], out[str(cuda_device)])):
        _close(b, a, rtol=2.0 ** -10 if (mp and j == 0) else 1e-5,
               msg=f"array {j}")


@pytest.mark.gpu
@pytest.mark.parametrize("name,states,attrs", UPDATE_OPS,
                         ids=[u[0] for u in UPDATE_OPS])
def test_update_ops_on_card_match_cpu(name, states, attrs, cuda_device):
    arrays = _op_inputs(states)
    got = {}
    for ctx in (tmx.cpu(), tmx.gpu(0)):
        nds = [tmx.nd.array(a, dtype=a.dtype, ctx=ctx) for a in arrays]
        getattr(tmx.nd, name)(*nds, out=nds[0], **attrs)
        got[str(ctx)] = [n.asnumpy().astype(np.float32) for n in nds]
    for a, b in zip(got["cpu(0)"], got["gpu(0)"]):
        _close(b, a, rtol=2.0 ** -10)


@pytest.mark.gpu
def test_amp_ops_and_overflow_flag_on_card(cuda_device):
    x = torch.randn(3, 4, device=cuda_device)
    assert tmx.nd.amp_cast(x, dtype="float16").dtype == torch.float16
    assert float(tmx.nd.all_finite(x)) == 1.0
    x[0, 0] = float("nan")
    assert float(tmx.nd.multi_all_finite(torch.ones(2, device=cuda_device),
                                         x)) == 0.0
    scaler = tmx.amp.LossScaler()
    assert scaler.has_overflow([torch.ones(3, device=cuda_device), x])
    assert not scaler.has_overflow([torch.ones(3, device=cuda_device)])
