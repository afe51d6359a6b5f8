"""The port's imperative NDArray against the JAX package's.

The same numpy inputs (fixed seeds) as NDArrays of both packages, on the
CPU; results must be NDArrays of the JAX result's shape and dtype, with
values within 1e-6 (float32 math in other orders) unless a test says
otherwise.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()
# queue 3, item 12's inputs
A = np.arange(24, dtype=np.float32).reshape(2, 3, 4) - 7
B = np.random.RandomState(1).randint(-5, 6, (2, 3, 4)).astype(np.float32)
POS = np.random.RandomState(2).uniform(0.5, 3.0, (2, 3, 4)).astype(
    np.float32)


def _pair(a, dtype=None):
    import mxnet_tpu as jmx

    return (jmx.nd.array(a, dtype=dtype or a.dtype),
            tmx.nd.array(a, ctx=CPU, dtype=dtype or a.dtype))


def _same(t, j, atol=1e-6):
    if isinstance(j, (tuple, list)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _same(a, b, atol)
        return
    assert isinstance(t, tmx.nd.NDArray), type(t)
    assert t.shape == j.shape and t.dtype == j.dtype, \
        (t.shape, j.shape, t.dtype, j.dtype)
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), atol=atol,
                               rtol=1e-6)


def test_every_jax_ndarray_member_exists():
    """A ``dir()`` diff of the two classes' public members and operator
    methods; the JAX class's private slots (``_data``, ``_grad``, ...)
    are its own storage."""
    import mxnet_tpu as jmx

    want = {n for n in dir(jmx.nd.NDArray)
            if not n.startswith("_") or (n.startswith("__")
                                         and n.endswith("__"))}
    missing = sorted(want - set(dir(tmx.nd.NDArray)))
    assert not missing, missing


OPS = {"==": lambda x, y: x == y, "!=": lambda x, y: x != y,
       ">": lambda x, y: x > y, ">=": lambda x, y: x >= y,
       "<": lambda x, y: x < y, "<=": lambda x, y: x <= y}


@pytest.mark.parametrize("other", ["scalar", "array"])
@pytest.mark.parametrize("op", list(OPS))
def test_comparisons_are_elementwise_as_jax(op, other):
    """Queue 3, item 12: 0/1 in the array's dtype, not a Python bool."""
    jx, tx = _pair(A)
    if other == "scalar":
        jy, ty = 2, 2
    else:
        jy, ty = _pair(B)
    _same(OPS[op](tx, ty), OPS[op](jx, jy))
    assert hash(tx) == id(tx)


ARITH = {"+": lambda x, y: x + y, "-": lambda x, y: x - y,
         "*": lambda x, y: x * y, "/": lambda x, y: x / y,
         "%": lambda x, y: x % y, "**": lambda x, y: x ** y}


@pytest.mark.parametrize("other", ["scalar", "array", "reflected", "list"])
@pytest.mark.parametrize("op", list(ARITH))
def test_arithmetic_and_reflected_forms_as_jax(op, other):
    jx, tx = _pair(POS)
    f = ARITH[op]
    if other == "scalar":
        _same(f(tx, 1.5), f(jx, 1.5))
    elif other == "array":
        jy, ty = _pair(POS[::-1].copy())
        _same(f(tx, ty), f(jx, jy))
    elif other == "reflected" and op == "%":
        # the JAX class has no __rmod__: numpy is the reference
        out = f(2.5, tx)
        assert isinstance(out, tmx.nd.NDArray) and out.dtype == np.float32
        np.testing.assert_allclose(out.asnumpy(), 2.5 % POS, rtol=1e-6)
    elif other == "reflected":
        _same(f(2.5, tx), f(2.5, jx))
    else:
        row = [[0.5, 1.0, 1.5, 2.0]] * 3
        _same(f(tx, row), f(jx, row))


def test_integer_arithmetic_keeps_jax_dtypes():
    ji, ti = _pair(np.arange(6, dtype=np.int32).reshape(2, 3))
    for f in (lambda x: x + 1, lambda x: x * 2, lambda x: x / 2,
              lambda x: x + 1.5, lambda x: x % 4, lambda x: -x,
              lambda x: abs(x - 3), lambda x: x == 2):
        _same(f(ti), f(ji))


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/="])
def test_in_place_forms_write_into_the_same_tensor(op):
    jx, tx = _pair(POS)
    jy, ty = _pair(B + 10)
    t_before = tx.data
    exec(f"jx {op} jy\ntx {op} ty")
    assert tx.data is t_before
    _same(tx, jx)
    exec(f"jx {op} 2\ntx {op} 2")
    _same(tx, jx)


INDICES = {
    "int": lambda m: 1,
    "negative-int": lambda m: -1,
    "slice": lambda m: slice(0, 1),
    "tuple": lambda m: (1, slice(None), 2),
    "ellipsis-newaxis": lambda m: (Ellipsis, None, 1),
    "negative-step": lambda m: (slice(None), slice(None, None, -1)),
    "list": lambda m: [1, 0, 1],
    "ndarray": lambda m: m.array(np.array([1, 0], np.int32)),
    "mixed": lambda m: (slice(None), m.array(np.array([2, 0], np.int32)),
                        slice(1, 3)),
}


@pytest.mark.parametrize("kind", list(INDICES))
def test_getitem_and_setitem_as_jax(kind):
    import mxnet_tpu as jmx

    jx, tx = _pair(A)
    jidx = INDICES[kind](jmx.nd)
    tidx = INDICES[kind](type("M", (), {"array": staticmethod(
        lambda a: tmx.nd.array(a, ctx=CPU))}))
    _same(tx[tidx], jx[jidx])
    shape = jx[jidx].shape
    v = np.random.RandomState(3).randn(*shape).astype(np.float32)
    jx[jidx] = jmx.nd.array(v)
    tx[tidx] = tmx.nd.array(v, ctx=CPU)
    _same(tx, jx)
    jx[jidx] = 5.0
    tx[tidx] = 5.0
    _same(tx, jx)


def test_iteration_len_bool_and_scalars():
    jx, tx = _pair(A)
    assert len(tx) == len(jx) == 2
    for t, j in zip(tx, jx):
        _same(t, j)
    one_t, one_j = _pair(np.array([3.5], np.float32))
    assert float(one_t) == float(one_j) and int(one_t) == int(one_j)
    assert bool(one_t) and one_t.item() == one_j.item() == 3.5
    assert not bool(tmx.nd.zeros((0,), ctx=CPU))
    with pytest.raises(MXNetError):
        bool(tx)
    assert tx.size == 24 and tx.ndim == 3 and tx.stype == "default"
    _same(tx.T, jx.T)


RESHAPES = [((0, -1), False), ((-1,), False), ((-2,), False),
            ((-3, 4), False), ((2, -4, 1, 3, 4), False),
            ((0, -4, -1, 3, 0), False), ((-4, 1, 2, -2), False),
            ((-3, -2), False), ((0, 0, 2, 2), False), ((0, -1), True),
            ((-1, 0), True), ((6, 0), True)]


@pytest.mark.parametrize("shape,reverse", RESHAPES,
                         ids=[f"{s}{'-reverse' if r else ''}"
                              for s, r in RESHAPES])
def test_reshape_codes_as_jax(shape, reverse):
    jx, tx = _pair(A)
    _same(tx.reshape(shape, reverse=reverse),
          jx.reshape(shape, reverse=reverse))
    _same(tmx.nd.reshape(tx, shape=shape, reverse=reverse),
          jx.reshape(shape, reverse=reverse))


METHODS = [
    ("sum", (), {}), ("sum", (), {"axis": 1, "keepdims": True}),
    ("mean", (), {"axis": (0, 2)}), ("max", (), {"axis": 2}),
    ("min", (), {}), ("prod", (), {"axis": 0}),
    ("norm", (), {}), ("norm", (), {"ord": 1, "axis": 1}),
    ("argmax", (), {"axis": 1}), ("argmin", (), {}),
    ("clip", (-2.0, 3.0), {}), ("abs", (), {}), ("sqrt", (), {}),
    ("exp", (), {}), ("log", (), {}), ("sigmoid", (), {}),
    ("relu", (), {}), ("softmax", (), {"axis": 1}),
    ("log_softmax", (), {}), ("square", (), {}),
    ("astype", ("int32",), {}), ("astype", ("float16",), {}),
    ("flatten", (), {}), ("expand_dims", (1,), {}),
    ("swapaxes", (0, 2), {}), ("transpose", ((2, 0, 1),), {}),
    ("transpose", (), {}), ("broadcast_to", ((3, 2, 3, 4),), {}),
    ("tile", ((1, 2),), {}), ("repeat", (2,), {"axis": 0}),
    ("flip", (1,), {}), ("moveaxis", (0, -1), {}),
    ("slice", ((0, 1, 0), (2, 3, 4), (1, 1, 2)), {}),
    ("slice_axis", (2, 1, 3), {}), ("split", (2,), {"axis": 0}),
    ("copy", (), {}),
]


@pytest.mark.parametrize("name,args,kwargs", METHODS,
                         ids=[f"{m}-{i}" for i, (m, _, _) in
                              enumerate(METHODS)])
def test_methods_and_reductions_as_jax(name, args, kwargs):
    src = np.abs(A) + 0.5 if name in ("sqrt", "log") else A
    jx, tx = _pair(src)
    _same(getattr(tx, name)(*args, **kwargs),
          getattr(jx, name)(*args, **kwargs), atol=1e-5)


def test_methods_with_array_arguments_as_jax():
    jx, tx = _pair(A)
    ji, ti = _pair(np.array([[2, 0, 1], [1, 3, 0]], np.float32))
    _same(tx.pick(ti, axis=2), jx.pick(ji, axis=2))
    _same(tx.take(ti, axis=2), jx.take(ji, axis=2))
    # the JAX method passes depth where its op wants an array: nd.one_hot
    import mxnet_tpu as jmx
    _same(ti.one_hot(4), jmx.nd.one_hot(ji, 4))
    jy, ty = _pair(np.ones((4, 5), np.float32))
    _same(tx.dot(ty), jx.dot(jy), atol=1e-5)
    _same(tx @ ty, jx @ jy, atol=1e-5)
    jz, tz = _pair(np.ones((1, 2, 2), np.float32))
    _same(tx.slice_like(tz, axes=(1, 2)), jx.slice_like(jz, axes=(1, 2)))
    _same(tx.reshape_like(tx.reshape((4, 6))), jx.reshape_like(
        jx.reshape((4, 6))))
    jb, tb = _pair(np.ones((2, 3, 1), np.float32))
    _same(tb.broadcast_like(tx), jb.broadcast_like(jx))
    _same(tx.squeeze(), jx.squeeze())
    _same(tx.detach(), jx.detach())
    assert tx.as_in_ctx(CPU) is tx and tx.as_nd_ndarray() is tx
    assert tx.tostype("default") is tx


def test_creation_helpers_as_jax():
    import mxnet_tpu as jmx

    pairs = [(tmx.nd.ones((2, 3), ctx=CPU), jmx.nd.ones((2, 3))),
             (tmx.nd.full((2, 2), 7, ctx=CPU), jmx.nd.full((2, 2), 7)),
             (tmx.nd.empty((3,), ctx=CPU, dtype="int32"),
              jmx.nd.empty((3,), dtype="int32")),
             (tmx.nd.eye(3, 4, 1, ctx=CPU), jmx.nd.eye(3, 4, 1)),
             (tmx.nd.linspace(0, 1, 5, ctx=CPU), jmx.nd.linspace(0, 1, 5)),
             (tmx.nd.linspace(0, 1, 5, endpoint=False, ctx=CPU),
              jmx.nd.linspace(0, 1, 5, endpoint=False)),
             (tmx.nd.arange(2, 8, 2, repeat=2, ctx=CPU),
              jmx.nd.arange(2, 8, 2, repeat=2)),
             (tmx.nd.arange(5, ctx=CPU), jmx.nd.arange(5))]
    for t, j in pairs:
        _same(t, j)
    jx, tx = _pair(A)
    _same(tmx.nd.zeros_like(tx), jmx.nd.zeros_like(jx))
    _same(tmx.nd.ones_like(tx), jmx.nd.ones_like(jx))
    _same(tmx.nd.concatenate([tx, tx], axis=1),
          jmx.nd.concatenate([jx, jx], axis=1))
    _same(tmx.nd.moveaxis(tx, 2, 0), jmx.nd.moveaxis(jx, 2, 0))
    _same(tmx.nd.histogram(tx, bins=5), jmx.nd.histogram(jx, bins=5))
    _same(tmx.nd.histogram(tx, bins=4, range=(-5, 5)),
          jmx.nd.histogram(jx, bins=4, range=(-5, 5)))
    edges = np.array([-7.0, -1.0, 0.0, 3.5, 16.0], np.float32)
    _same(tmx.nd.histogram(tx, bins=tmx.nd.array(edges, ctx=CPU)),
          jmx.nd.histogram(jx, bins=jmx.nd.array(edges)))
    tmx.nd.waitall()
    tmx.waitall()


def test_module_level_helpers_as_jax():
    import mxnet_tpu as jmx

    jx, tx = _pair(A)
    jy, ty = _pair(POS)
    for name in ("maximum", "minimum", "power", "hypot"):
        _same(getattr(tmx.nd, name)(tx, ty), getattr(jmx.nd, name)(jx, jy),
              atol=1e-4)
    _same(tmx.nd.maximum(tx, 0.0), jmx.nd.maximum(jx, 0.0))
    ji, ti = _pair(np.array([0, 2, 1], np.float32))
    _same(tmx.nd.one_hot(ti, 3), jmx.nd.one_hot(ji, 3))
    _same(tmx.nd.relu(tx), jmx.nd.relu(jx))
    _same(tmx.nd.sum(tx, axis=1), jmx.nd.sum(jx, axis=1))
    _same(tmx.nd.concat(tx, tx, dim=0), jmx.nd.concat(jx, jx, dim=0))
    _same(tmx.nd.broadcast_add(tx, 2), jmx.nd.broadcast_add(jx, 2))
    _same(tmx.nd.take(tx, [1, 0], axis=1), jmx.nd.take(jx, [1, 0], axis=1))
    _same(tmx.nd.split(tx, num_outputs=3, axis=1),
          jmx.nd.split(jx, num_outputs=3, axis=1))
    out = tmx.nd.zeros((2, 3, 4), ctx=CPU)
    ptr = out.data.data_ptr()
    assert tmx.nd.exp(tx, out=out) is out and out.data.data_ptr() == ptr
    _same(out, jmx.nd.exp(jx), atol=1e-4)


def test_image_namespace_as_jax():
    import mxnet_tpu as jmx

    img = np.random.RandomState(4).randint(0, 256, (6, 8, 3)).astype(
        np.uint8)
    ji, ti = _pair(img)
    _same(tmx.nd.image.to_tensor(ti), jmx.nd.image.to_tensor(ji))
    jc, tc = jmx.nd.image.to_tensor(ji), tmx.nd.image.to_tensor(ti)
    _same(tmx.nd.image.normalize(tc, (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)),
          jmx.nd.image.normalize(jc, (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)),
          atol=1e-5)
    _same(tmx.nd.image.crop(ti, 1, 2, 4, 3), jmx.nd.image.crop(ji, 1, 2, 4, 3))
    assert tmx.nd.image.resize(ti, (4, 3)).shape == \
        jmx.nd.image.resize(ji, (4, 3)).shape == (3, 4, 3)
    flipped = tmx.nd.image.random_flip_left_right(ti).asnumpy()
    assert np.array_equal(flipped, img) or np.array_equal(flipped,
                                                          img[:, ::-1])


def test_later_slices_raise_naming_them():
    with pytest.raises(AttributeError, match="slice 9"):
        tmx.nd.linalg.gemm2
    with pytest.raises(MXNetError, match="slice 9"):
        tmx.nd.contrib.foreach


def test_batch_norm_commits_its_moving_statistics_as_jax():
    """``mutate_aux``: BatchNorm on NDArrays in training writes the moving
    statistics into the aux arrays and returns the output alone."""
    import mxnet_tpu as jmx

    x = np.random.RandomState(5).randn(4, 3, 2, 2).astype(np.float32)
    g, b = np.full(3, 1.5, np.float32), np.full(3, 0.25, np.float32)
    outs = []
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, CPU)):
        arrs = [mx.nd.array(a, ctx=ctx) for a in
                (x, g, b, np.zeros(3, np.float32), np.ones(3, np.float32))]
        with mx.autograd.train_mode():
            y = mx.nd.BatchNorm(*arrs, fix_gamma=False, momentum=0.8)
        outs.append((y, arrs[3], arrs[4]))
    for t, j in zip(outs[1], outs[0]):
        _same(t, j, atol=1e-5)


def test_variable_keeps_its_tensor_and_gradient_through_updates():
    """``w[:] = w - lr * w.grad`` and ``w -= ...`` write into the tensor
    autograd knows, which stays a variable with its gradient buffer."""
    w = tmx.nd.array(np.random.RandomState(6).randn(4, 3).astype(
        np.float32), ctx=CPU)
    x = tmx.nd.array(np.random.RandomState(7).randn(5, 4).astype(
        np.float32), ctx=CPU)
    w.attach_grad()
    t, ptr = w.data, w.data.data_ptr()
    for update in ("w[:] = w - 0.1 * w.grad", "w -= 0.1 * w.grad"):
        with tmx.autograd.record():
            loss = tmx.nd.dot(x, w).square().mean()
        loss.backward()
        g = w.grad.asnumpy().copy()
        before = w.asnumpy().copy()
        exec(update)
        assert w.data is t and w.data.data_ptr() == ptr
        assert t.requires_grad and t.is_leaf and t.grad is not None
        np.testing.assert_allclose(w.asnumpy(), before - 0.1 * g, atol=1e-7)


def test_in_place_write_into_a_variable_under_record_raises():
    """Deliberate difference: torch cannot record an in-place change of a
    leaf it differentiates; the write outside ``record()`` is fine."""
    w = tmx.nd.ones((2, 2), ctx=CPU)
    w.attach_grad()
    with tmx.autograd.record():
        with pytest.raises(MXNetError, match=r"NDArray \(2, 2\) float32"):
            w[:] = 3.0
        with pytest.raises(MXNetError, match="attach_grad"):
            w += 1
        y = w * 2
        y += 1          # not a variable: recorded
        y.sum().backward()
    np.testing.assert_array_equal(w.grad.asnumpy(), np.full((2, 2), 2.0))


def test_views_share_memory_and_copy_does_not():
    """Deliberate difference: ``reshape`` and basic indexing give torch
    views, as MXNet's own; the JAX package's arrays never share."""
    x = tmx.nd.array(A, ctx=CPU)
    row = x[0]
    row[:] = 0
    assert x.asnumpy()[0].sum() == 0
    c = x.copy()
    c[:] = 1
    assert x.asnumpy().sum() != c.asnumpy().sum()


def test_parameter_data_stays_a_tensor_and_wraps_on_request():
    """Deliberate difference: ``Parameter.data()``/``.grad()`` return
    tensors (what the trainers and captured steps read); ``nd.array`` and
    NDArray arithmetic take them."""
    p = tmx.gluon.Parameter("w", shape=(2, 3))
    p.initialize(init=tmx.init.One(), ctx=CPU)
    assert isinstance(p.data(), torch.Tensor)
    w = tmx.nd.array(p.data(), ctx=CPU)
    np.testing.assert_array_equal(w.asnumpy(), np.ones((2, 3)))
    s = w + p.data()
    assert isinstance(s, tmx.nd.NDArray)
    np.testing.assert_array_equal((s * 2).asnumpy(), np.full((2, 3), 4.0))
    assert isinstance(p.data() + s, tmx.nd.NDArray)


def _mlp_steps(mx, ctx, x, y, w1, w2, steps, lr=0.5):
    W1, W2 = mx.nd.array(w1, ctx=ctx), mx.nd.array(w2, ctx=ctx)
    X, Y = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
    W1.attach_grad()
    W2.attach_grad()
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            out = mx.nd.dot(mx.nd.relu(mx.nd.dot(X, W1)), W2)
            loss = -mx.nd.pick(mx.nd.log_softmax(out), Y).mean()
        loss.backward()
        losses.append(loss.asscalar())
        W1[:] = W1 - lr * W1.grad
        W2[:] = W2 - lr * W2.grad
    acc = (mx.nd.argmax(out, axis=1) == Y).mean().asscalar()
    return losses, W1.asnumpy(), acc


def test_imperative_mlp_first_steps_match_jax():
    """The imperative MLP (``nd.dot``, ``relu``, ``log_softmax``, ``pick``,
    ``w[:] = w - lr * w.grad``): 3 steps within 1e-5 relative."""
    import mxnet_tpu as jmx

    rs = np.random.RandomState(8)
    x = rs.randn(32, 12).astype(np.float32)
    y = np.argmax(x @ rs.randn(12, 4), axis=1).astype(np.float32)
    w1 = (0.2 * rs.randn(12, 16)).astype(np.float32)
    w2 = (0.2 * rs.randn(16, 4)).astype(np.float32)
    jl, jw, jacc = _mlp_steps(jmx, jmx.cpu(), x, y, w1, w2, 3)
    tl, tw, tacc = _mlp_steps(tmx, CPU, x, y, w1, w2, 3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)
    assert type(tacc) is float and tacc == jacc
    assert tl[-1] < tl[0]


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU "
                    "mode); run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_imperative_attention_launches_the_flash_kernels_on_card(
        cuda_device):
    """``nd.multihead_attention`` on CUDA NDArrays under ``record()``: one
    launch each of the flash forward, dQ and dK/dV kernels, no plain call,
    and the output and gradients of the CPU oracle within 1e-4."""
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    rs = np.random.RandomState(0)
    arrays = [rs.randn(2, 64, 128).astype(np.float32),
              (0.05 * rs.randn(384, 128)).astype(np.float32),
              np.zeros(384, np.float32),
              (0.05 * rs.randn(128, 128)).astype(np.float32),
              np.zeros(128, np.float32)]
    results = []
    for ctx in (tmx.gpu(0), CPU):
        x, wi, bi, wo, bo = (tmx.nd.array(a, ctx=ctx) for a in arrays)
        wi.attach_grad()
        kernels.reset_counts()
        plain0 = fa.counts.plain_calls_on_cuda
        with tmx.autograd.record():
            out = tmx.nd.multihead_attention(x, x, x, wi, bi, wo, bo,
                                             num_heads=2)
            out.square().sum().backward()
        launches = {k: c.launches for k, c in kernels.KERNEL_COUNTS.items()
                    if k.startswith("flash_attention")}
        assert isinstance(out, tmx.nd.NDArray) and out.context == ctx
        results.append((out.asnumpy(), wi.grad.asnumpy(), launches,
                        fa.counts.plain_calls_on_cuda - plain0))
    (go, gg, gl, gp), (co, cg, _, _) = results
    assert gl == {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
                  "flash_attention_bwd_dkv": 1} and gp == 0
    np.testing.assert_allclose(go, co, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gg, cg, atol=1e-4 * np.abs(cg).max(),
                               rtol=1e-4)


@pytest.mark.gpu
def test_ndarray_arithmetic_and_updates_on_card(cuda_device):
    """The operators, indexing and the in-place update on CUDA NDArrays
    give the CPU's values and keep the variable's tensor."""
    for ctx in (tmx.gpu(0), CPU):
        x = tmx.nd.array(A, ctx=ctx)
        y = ((x * 2 - 1) / 3) ** 2 + (x == 2) - x[1].reshape((0, -1))
        assert y.context == ctx
        if ctx == CPU:
            np.testing.assert_allclose(y.asnumpy(), want, rtol=1e-6)
        else:
            want = y.asnumpy()
        w = tmx.nd.ones((3, 4), ctx=ctx)
        w.attach_grad()
        t = w.data
        with tmx.autograd.record():
            (w * x[0]).sum().backward()
        w[:] = w - 0.5 * w.grad
        assert w.data is t and t.is_cuda == (ctx != CPU)
        np.testing.assert_allclose(w.asnumpy(), 1 - 0.5 * A[0])
