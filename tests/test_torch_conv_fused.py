"""The BatchNorm-statistics and fused 1x1-convolution kernels of the
PyTorch port against the JAX package, and the ops built on them.

On the CPU each wrapper takes its kernel's plain version.  The plain
versions are held against the JAX Pallas kernels (``_stats_kernel``,
``_mm_stats_kernel``, ``_bn_act_mm_kernel``, ``_bn_act_mm_stats_kernel``)
run in interpret mode (the ``interpret_pallas`` fixture and
``MXTPU_CONV_FUSED_INTERPRET=1``, as ``tests/test_conv_fused.py`` does), at
shapes that pass the JAX package's gates (K and N multiples of 64, M of 8),
so a Pallas kernel, not its jnp reference, is what is compared; the
gradients go through the port's autograd Functions and the JAX custom
VJPs.  Then the ops ``_k_conv1x1_bn_act``, ``_k_bn_fold`` and
``_k_batch_norm`` against the JAX ones.  Inputs are numpy from a seed.
The tests marked ``gpu`` hold each CUDA kernel against its plain version
on the card.

Tolerances.  fp32: 1e-5 absolute plus 1e-5 relative on outputs and sums
(the same products summed in other orders; sums of squares over up to 256
rows reach ~1e3); gradients, sums over up to 256 rows with cancellation,
within 2e-5 of their largest magnitude plus 1e-4 relative.  bf16:
outputs within 2e-2 relative plus 2e-2 absolute (both round the same fp32
sums to bf16, whose ulp is 2^-8 relative, and a sum in another order may
round to the neighbouring value), sums within 1e-2 relative, gradients
within 3e-2 relative plus 3e-2 absolute (rounded to bf16 twice: dy, then
the product).  fp16 (ulp 2^-11 relative, eight times finer than bf16's):
outputs within 4e-3 relative plus 4e-3 absolute (two fp16 ulps: the same
rounding of a sum taken in another order, and a prologue value rounded to
the neighbouring fp16 where the JAX package's fp32 multiply-add is
contracted), sums within 2e-3 relative (of the stored values, so only a
neighbouring y moves them), gradients within 8e-3 relative plus 8e-3
absolute (rounded to fp16 twice, as bf16's).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import conv_fused_ops as tops
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops.kernels import batch_norm as tbn
from mxnet_tpu_torch.ops.kernels import conv_fused as tcf

DTYPES = ("float32", "bfloat16", "float16")
TOL = {"float32": dict(out=(1e-5, 1e-5), stats=(1e-5, 1e-5),
                       grad=(1e-4, 1e-4)),
       "bfloat16": dict(out=(2e-2, 2e-2), stats=(1e-2, 1e-2),
                        grad=(3e-2, 3e-2)),
       "float16": dict(out=(4e-3, 4e-3), stats=(2e-3, 2e-3),
                       grad=(8e-3, 8e-3))}
#: channels a 16-byte load of the BN-statistics kernel reads, by dtype
VEC = {"float32": 4, "bfloat16": 8, "float16": 8}


@pytest.fixture
def jax_kernels(interpret_pallas, monkeypatch):
    """The JAX package's fused kernels, forced onto their Pallas route in
    interpret mode."""
    monkeypatch.setenv("MXTPU_CONV_FUSED_INTERPRET", "1")
    from mxnet_tpu.ops.pallas import batch_norm as jbn
    from mxnet_tpu.ops.pallas import conv_fused as jcf

    return jcf, jbn


def _close(a, b, tol, msg=""):
    atol, rtol = tol
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


def _close_grad(a, b, msg=""):
    """Gradients: sums over up to 256 rows with cancellation, so the
    absolute part scales with the largest magnitude: 2e-5 of it plus 1e-4
    relative."""
    scale = max(1.0, float(np.abs(b).max()))
    _close(a, b, (2e-5 * scale, 1e-4), msg)


def _np(t):
    return t.detach().float().numpy()


def _jnp_to_np(a):
    import jax.numpy as jnp

    return np.asarray(a.astype(jnp.float32))


def _inputs(M, K, N, seed):
    rng = np.random.RandomState(seed)
    x = (rng.rand(M, K) - 0.5).astype(np.float32)
    w = ((rng.rand(K, N) - 0.5) * 0.2).astype(np.float32)
    sc = (rng.rand(1, K) + 0.5).astype(np.float32)
    sh = (rng.rand(1, K) - 0.5).astype(np.float32)
    cot = [rng.randn(M, N).astype(np.float32),
           rng.randn(1, N).astype(np.float32),
           (rng.randn(1, N) * 0.1).astype(np.float32)]
    return x, w, sc, sh, cot


def _jax_run(fn, args, cot, n_diff):
    """JAX outputs and the gradients of sum(out_i * cot_i) w.r.t. the
    first ``n_diff`` args."""
    import jax
    import jax.numpy as jnp

    def loss(*a):
        outs = fn(*a)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o.astype(jnp.float32) * jnp.asarray(c))
                   for o, c in zip(outs, cot))

    outs = fn(*args)
    grads = jax.grad(loss, tuple(range(n_diff)))(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return [_jnp_to_np(o) for o in outs], [_jnp_to_np(g) for g in grads]


def _torch_run(fn, args, cot, n_diff):
    ts = [a.clone().requires_grad_(i < n_diff) if isinstance(a, torch.Tensor)
          else a for i, a in enumerate(args)]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * torch.from_numpy(c)).sum()
               for o, c in zip(outs, cot))
    grads = torch.autograd.grad(loss, ts[:n_diff])
    return [_np(o) for o in outs], [_np(g) for g in grads]


# -- the plain versions against the JAX Pallas kernels ------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["matmul_bn_stats", "bn_act_matmul",
                                  "bn_act_matmul_stats"])
def test_plain_matches_jax_kernel(kind, dtype, jax_kernels):
    """Forward and gradients of each fused matmul, ReLU on."""
    import jax.numpy as jnp

    jcf, _ = jax_kernels
    M, K, N = 128, 64, 128
    x, w, sc, sh, cot = _inputs(M, K, N, seed=len(kind))
    assert jcf._tile_plan(M, K, N, 4 if dtype == "float32" else 2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    tsc, tsh = torch.from_numpy(sc), torch.from_numpy(sh)
    jsc, jsh = jnp.asarray(sc), jnp.asarray(sh)
    if kind == "matmul_bn_stats":
        jout, jg = _jax_run(jcf.matmul_bn_stats, (jx, jw), cot, 2)
        tout, tg = _torch_run(tcf.matmul_bn_stats, (tx, tw), cot, 2)
        gnames = ("dx", "dw")
    else:
        jfn = getattr(jcf, kind)
        tfn = getattr(tcf, kind)
        ncot = cot[:1] if kind == "bn_act_matmul" else cot
        jout, jg = _jax_run(lambda a, b, c, d: jfn(a, b, c, d, True),
                            (jx, jsc, jsh, jw), ncot, 4)
        tout, tg = _torch_run(lambda a, b, c, d: tfn(a, b, c, d, True),
                              (tx, tsc, tsh, tw), ncot, 4)
        gnames = ("dx", "dscale", "dshift", "dw")
    tol = TOL[dtype]
    for name, t, j in zip(("y", "sum", "sumsq"), tout, jout):
        _close(t, j, tol["out" if name == "y" else "stats"], name)
    for name, t, j in zip(gnames, tg, jg):
        scale = max(1.0, float(np.abs(j).max()))
        atol, rtol = tol["grad"]
        _close(t, j, (atol * scale, rtol), name)


@pytest.mark.parametrize("relu", [True, False])
def test_plain_bn_act_matmul_matches_jax_with_and_without_relu(
        relu, jax_kernels):
    import jax.numpy as jnp

    jcf, _ = jax_kernels
    x, w, sc, sh, cot = _inputs(64, 128, 64, seed=9)
    jy = jcf.bn_act_matmul(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(sh),
                           jnp.asarray(w), relu)
    ty = tcf.bn_act_matmul(*(torch.from_numpy(a) for a in (x, sc, sh, w)),
                           relu)
    _close(_np(ty), np.asarray(jy), TOL["float32"]["out"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_bn_stats_plain_matches_jax_kernel(dtype, jax_kernels):
    import jax
    import jax.numpy as jnp

    _, jbn = jax_kernels
    rng = np.random.RandomState(4)
    x = (rng.randn(256, 64) + 0.3).astype(np.float32)
    ds, dq = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    assert jbn.stats_supported(*x.shape)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    js, jq = jbn.bn_stats(jx)
    jdx = jax.grad(lambda a: jnp.sum(jbn.bn_stats(a)[0] * ds)
                   + jnp.sum(jbn.bn_stats(a)[1] * dq))(jx)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    ts, tq = tbn.bn_stats(tx)
    (tdx,) = torch.autograd.grad((ts * torch.from_numpy(ds)).sum()
                                 + (tq * torch.from_numpy(dq)).sum(), tx)
    assert ts.dtype == torch.float32 and tdx.dtype == tx.dtype
    # the same (rounded) values summed in fp32 in other orders; bf16's
    # limit is looser than it needs (kept as it was set)
    rtol = 1e-2 if dtype == "bfloat16" else 1e-5
    _close(_np(ts), np.asarray(js), (1e-4, rtol), "sum")
    _close(_np(tq), np.asarray(jq), (1e-4, rtol), "sumsq")
    _close(_np(tdx), _jnp_to_np(jdx), TOL[dtype]["grad"], "dx")


def _bn_stats_order(x, P, groups, runs=16):
    """A float32 model of the order in which the CUDA kernel
    (``csrc/batch_norm.cu``) sums ``x`` (M, C), for ``P`` row blocks of
    ``groups`` row groups: block p takes rows [p*R, (p+1)*R), R =
    ceil(M/P); row group g of it adds rows g, g + groups, ... of its run in
    order (squares rounded before the add, as ``__fmul_rn`` does); a warp's
    ``32 * groups / 512`` row groups are added by a butterfly (((g0 + g1) +
    (g2 + g3)) for 4), then the warps in order; the last block adds the P
    partials in ``runs`` contiguous runs of ceil(P/runs), each in order,
    then the runs in order.  Every add and product is rounded to float32,
    as on the card, so on the card the model gives the kernel's sums bit
    for bit."""
    x = np.asarray(x, np.float32)
    M, C = x.shape
    R = -(-M // P)
    K = -(-R // groups)
    xb = np.zeros((P, K * groups, C), np.float32)
    for p in range(P):  # rows past M, or past a block's run, add +0.0
        run = x[p * R:min(M, (p + 1) * R)]
        xb[p, :len(run)] = run
    xb = xb.reshape(P, K, groups, C)
    acc = np.zeros((2, P, groups, C), np.float32)
    for k in range(K):
        v = xb[:, k]
        acc[0] += v
        acc[1] += v * v
    per_warp = max(1, 32 * groups // 512)
    acc = acc.reshape(2, P, groups // per_warp, per_warp, C)
    off = 1
    while off < per_warp:  # the butterfly of shuffles
        acc = acc + acc[:, :, :, np.arange(per_warp) ^ off]
        off *= 2
    part = np.zeros((2, P, C), np.float32)
    for e in range(groups // per_warp):
        part += acc[:, :, e, 0]
    per = -(-P // runs)
    out = np.zeros((2, C), np.float32)
    for g in range(runs):
        run = np.zeros((2, C), np.float32)
        for p in range(g * per, min(P, (g + 1) * per)):
            run += part[:, p]
        out += run
    return out[0], out[1]


def _stats_within(got, x, what=""):
    """``got`` (sum, sumsq) of ``x`` against fp64 sums: within 1e-5 of each
    column's sum of magnitudes plus 1e-5 (``_check_stats``' rule: fp32
    sums in any fixed order stay well inside it at these sizes)."""
    xd = np.asarray(x, np.float64)
    for g, r, mag in zip(got, (xd.sum(0), (xd * xd).sum(0)),
                         (np.abs(xd).sum(0), (xd * xd).sum(0))):
        err = np.abs(np.asarray(g, np.float64) - r)
        assert (err <= 1e-5 * mag + 1e-5).all(), (what, err.max())


# (M, C, P, row groups): the kernel's bf16 and fp32 16-byte routes (64, 32
# row groups) and its scalar route (8) at small sizes, ragged M and C
# among them
ORDER_CASES = [(256, 64, 3, 64), (4096, 128, 7, 32), (1000, 70, 5, 8),
               (37, 3, 4, 8), (8, 512, 1, 64), (777, 24, 13, 32),
               (1, 5, 1, 8), (8192, 64, 40, 64), (3000, 40, 33, 8)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,C,P,groups", ORDER_CASES)
def test_bn_stats_order_model_matches_jax_kernel(M, C, P, groups, dtype,
                                                 jax_kernels):
    """The model of the kernel's summation order against the JAX Pallas
    kernel in interpret mode.  Where the JAX gate refuses the shape (ragged
    M or C), the JAX kernel runs on x padded with zero rows and columns up
    to its gate's multiples, which leaves the real columns' sums as they
    are.  Both sum the same values: bf16 inputs are rounded to bf16 first."""
    import jax.numpy as jnp

    _, jbn = jax_kernels
    rng = np.random.RandomState(M + C)
    x = (rng.randn(M, C) + 0.3).astype(np.float32)
    x = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
    Mp, Cp = -(-M // 8) * 8, -(-C // 8) * 8
    xp = np.zeros((Mp, Cp), np.float32)
    xp[:M, :C] = x
    assert jbn.stats_supported(Mp, Cp)
    js, jq = jbn.bn_stats(jnp.asarray(xp, getattr(jnp, dtype)))
    model = _bn_stats_order(x, P, groups)
    _stats_within(model, x, "model against fp64")
    xd = x.astype(np.float64)
    for m, j, mag in zip(model, (js, jq), (np.abs(xd).sum(0),
                                          (xd * xd).sum(0))):
        err = np.abs(m - np.asarray(j, np.float64)[:C])
        assert (err <= 1e-5 * mag + 1e-5).all(), err.max()


@pytest.mark.parametrize("M,C", [(401408, 64), (100352, 128), (25088, 256),
                                 (6272, 512), (1, 3), (1000, 70)])
@pytest.mark.parametrize("code,vec", [(0, 1), (1, 1), (2, 1), (0, 0), (1, 0),
                                      (2, 0)])
def test_row_blocks_fill_the_card_once(M, C, code, vec):
    """The grid at ResNet-50's four stage shapes (b=128) and ragged ones on
    132 SMs: no more blocks than are resident at once, at least one, and
    each thread a full unrolled load of rows where M gives that many."""
    groups = tbn.row_groups(code, vec)
    assert groups == {(0, 1): 32, (1, 1): 64, (2, 1): 64}.get((code, vec),
                                                             8)
    strips = -(-C // tbn.STRIP)
    P = tbn.row_blocks(M, C, groups, 132)
    assert P >= 1 and (P == 1 or P * strips <= 132)
    if M >= groups * tbn.UNROLL * P:
        assert -(-M // P) >= groups * tbn.UNROLL


@pytest.mark.parametrize("M,K,N", [(M, K, N) for M in (8, 100, 512, 6272)
                                   for K in (48, 64, 256, 1024)
                                   for N in (24, 64, 2048)])
def test_gates_match_jax(M, K, N):
    """The port's copies of ``_tile_plan`` and ``stats_supported`` decide
    as the JAX package's do."""
    from mxnet_tpu.ops.pallas import batch_norm as jbn
    from mxnet_tpu.ops.pallas import conv_fused as jcf

    for item in (2, 4):
        assert tcf._tile_plan(M, K, N, item) == jcf._tile_plan(M, K, N, item)
    assert tbn.stats_supported(M, N) == jbn.stats_supported(M, N)
    assert tbn.stats_supported(M, K) == jbn.stats_supported(M, K)


def test_functions_match_autograd_of_the_plain_forward():
    """The Functions' backward rules against torch.autograd through the
    plain forward (fp32, CPU): 1e-4 absolute plus 1e-4 relative."""
    x, w, sc, sh, cot = _inputs(96, 64, 64, seed=12)
    args = [torch.from_numpy(a) for a in (x, sc, sh, w)]
    cases = [(tcf.matmul_bn_stats, tcf.matmul_bn_stats_plain,
              [args[0], args[3]]),
             (lambda *a: tcf.bn_act_matmul(*a, True),
              lambda *a: tcf.bn_act_matmul_plain(*a, True), args),
             (lambda *a: tcf.bn_act_matmul_stats(*a, False),
              lambda *a: tcf.bn_act_matmul_stats_plain(*a, False), args)]
    for fn, plain, a in cases:
        _, got = _torch_run(fn, a, cot, len(a))
        _, ref = _torch_run(plain, a, cot, len(a))
        for g, r in zip(got, ref):
            _close(g, r, (1e-4, 1e-4))


def _resnet_training_shapes(b):
    """The (M, K, N) of ResNet-50 v1's fused 1x1 convolutions in training at
    batch b, 224^2 (stride on conv1): conv1, conv1 of the later blocks and
    the downsample through ``matmul_bn_stats``, conv3 through
    ``bn_act_matmul_stats``."""
    shapes = set()
    for i, (width, s) in enumerate(zip((64, 128, 256, 512), (56, 28, 14, 7))):
        m = b * s * s
        cin = 64 if i == 0 else 2 * width
        shapes |= {(m, cin, width), (m, 4 * width, width),
                   (m, cin, 4 * width), (m, width, 4 * width)}
    return sorted(shapes)


def _operands(M, K, N, dtype=torch.bfloat16):
    """x (M, K), wt (N, K), y (M, N) that share one aligned element: the
    route reads only dtype, shape and pointers."""
    one = torch.empty(1, dtype=dtype)
    return one.expand(M, K), one.expand(N, K), one.expand(M, N)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M,K,N", sorted(set(_resnet_training_shapes(128)
                                             + _resnet_training_shapes(2))))
def test_route_takes_tma_for_every_resnet_training_shape(M, K, N, dtype):
    """bf16 and fp16 take the TMA route at every training shape, in all
    three kinds (``bn_act_matmul`` too: the fp16 predict forward)."""
    for kind in tcf._KINDS:
        assert tcf.route(kind, *_operands(M, K, N, dtype)) == "tma", kind


def _resnet_predict_shapes(b):
    """The (M, K, N) of ResNet-50 v1's conv3 in predict mode at batch b,
    224^2, which go through ``bn_act_matmul``."""
    return [(b * s * s, width, 4 * width)
            for width, s in zip((64, 128, 256, 512), (56, 28, 14, 7))]


@pytest.mark.parametrize("M,K,N", _resnet_predict_shapes(64)
                         + _resnet_predict_shapes(2))
def test_route_takes_tf32_for_every_resnet_predict_shape(M, K, N):
    """fp32 ``bn_act_matmul`` at the predict forward's shapes takes the
    TF32 route; fp32 statistics kinds at the same shapes keep the simple
    route."""
    ops = _operands(M, K, N, torch.float32)
    assert tcf.route("bn_act_matmul", *ops) == "tf32"
    for kind in ("matmul_bn_stats", "bn_act_matmul_stats"):
        assert tcf.route(kind, *ops) == "simple", kind


@pytest.mark.parametrize("case", ["float32", "k_ragged", "n_ragged",
                                  "misaligned_x", "misaligned_wt"])
def test_route_takes_simple_where_tma_cannot_address(case):
    """fp32 (but for ``bn_act_matmul``, which takes the TF32 route), K or
    N not a multiple of 8, and a view one element past an aligned start
    take the simple route."""
    M, K, N = 6272, 64, 256
    kinds = tuple(tcf._KINDS)
    if case == "float32":
        ops = _operands(M, K, N, torch.float32)
        kinds = ("matmul_bn_stats", "bn_act_matmul_stats")
    elif case == "k_ragged":
        ops = _operands(M, K + 4, N)
    elif case == "n_ragged":
        ops = _operands(M, K, N - 2)
    else:
        x, wt, y = _operands(M, K, N)
        shifted = torch.empty(M * K + 1, dtype=torch.bfloat16)[1:]
        if case == "misaligned_x":
            x = shifted.view(M, K)
        else:
            wt = shifted[:N * K].view(N, K)
        assert x.storage_offset() + wt.storage_offset() == 1
        ops = (x, wt, y)
    for kind in kinds:
        assert tcf.route(kind, *ops) == "simple", kind


@pytest.mark.parametrize("case", ["k_ragged", "n_ragged", "misaligned_x",
                                  "misaligned_wt"])
def test_route_keeps_fp32_bn_act_matmul_simple_where_tma_cannot_address(
        case):
    """fp32 ``bn_act_matmul`` whose operands a tensor map cannot address
    (K or N not a multiple of 8, a view one element past an aligned start)
    takes the simple route."""
    M, K, N = 3136, 512, 2048
    if case == "k_ragged":
        ops = _operands(M, K - 4, N, torch.float32)
    elif case == "n_ragged":
        ops = _operands(M, K, N + 2, torch.float32)
    else:
        x, wt, y = _operands(M, K, N, torch.float32)
        shifted = torch.empty(M * K + 1)[1:]
        if case == "misaligned_x":
            x = shifted.view(M, K)
        else:
            wt = shifted[:N * K].view(N, K)
        ops = (x, wt, y)
    assert tcf.route("bn_act_matmul", *ops) == "simple"


# -- the ops against the JAX package's --------------------------------------


def _bn_arrays(C, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(C) + 0.5).astype(np.float32),
            (rng.rand(C) - 0.5).astype(np.float32),
            (rng.rand(C) - 0.5).astype(np.float32),
            (rng.rand(C) + 0.5).astype(np.float32)]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("in_scale", [False, True])
def test_conv1x1_bn_act_matches_jax(train, stride, in_scale, jax_kernels):
    """``_k_conv1x1_bn_act``: raw output, folded (scale, shift) and moving
    statistics, and the gradients of data and weight through them."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import conv_fused_ops as jops

    rng = np.random.RandomState(stride + 2 * in_scale)
    data = rng.rand(2, 8, 8, 64).astype(np.float32)
    weight = ((rng.rand(128, 1, 1, 64) - 0.5) * 0.2).astype(np.float32)
    bn = _bn_arrays(128, 3)
    pre = [(rng.rand(64) + 0.5).astype(np.float32),
           (rng.rand(64) - 0.5).astype(np.float32)] if in_scale else []
    gy = rng.randn(2, 8 // stride, 8 // stride, 128).astype(np.float32)
    kw = dict(stride=stride, eps=1e-5, momentum=0.9, fix_gamma=False,
              _train=train)

    def jfn(d, wt, *extra):
        return jops._k_conv1x1_bn_act(d, wt, *map(jnp.asarray, bn), *extra,
                                      **kw)

    def jloss(d, wt, *extra):
        y, s, h, _, _ = jfn(d, wt, *extra)
        return jnp.sum(y * gy) + jnp.sum(s * 2.0) + jnp.sum(h)

    jargs = [jnp.asarray(data), jnp.asarray(weight)] + \
        [jnp.asarray(a) for a in pre]
    jout = jfn(*jargs)
    jg = jax.grad(jloss, tuple(range(len(jargs))))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in [data, weight] + pre]
    tout = tops._k_conv1x1_bn_act(targs[0], targs[1],
                                  *map(torch.from_numpy, bn), *targs[2:],
                                  **kw)
    y, s, h, _, _ = tout
    loss = (y * torch.from_numpy(gy)).sum() + (s * 2.0).sum() + h.sum()
    tg = torch.autograd.grad(loss, targs)
    for name, t, j in zip(("y", "scale", "shift", "new_mm", "new_mv"),
                          tout, jout):
        _close(_np(t), np.asarray(j), (1e-5, 1e-4), name)
    for t, j in zip(tg, jg):
        _close_grad(_np(t), np.asarray(j))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("C", [64, 12])
def test_bn_fold_matches_jax(train, C, jax_kernels):
    """``_k_bn_fold`` on a shape the statistics kernel's gate takes (C=64)
    and one it refuses (C=12)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import conv_fused_ops as jops

    rng = np.random.RandomState(C)
    data = rng.randn(2, 8, 8, C).astype(np.float32)
    bn = _bn_arrays(C, 5)
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=False, _train=train)
    jout = jops._k_bn_fold(jnp.asarray(data), *map(jnp.asarray, bn), **kw)
    jg = jax.grad(lambda d: jnp.sum(jops._k_bn_fold(
        d, *map(jnp.asarray, bn), **kw)[0] * 3.0) + jnp.sum(
        jops._k_bn_fold(d, *map(jnp.asarray, bn), **kw)[1]))(
        jnp.asarray(data))
    td = torch.from_numpy(data).requires_grad_(True)
    tout = tops._k_bn_fold(td, *map(torch.from_numpy, bn), **kw)
    for name, t, j in zip(("scale", "shift", "new_mm", "new_mv"), tout,
                          jout):
        _close(_np(t), np.asarray(j), (1e-5, 1e-4), name)
    if train:
        (tg,) = torch.autograd.grad((tout[0] * 3.0).sum() + tout[1].sum(),
                                    td)
        _close_grad(_np(tg), np.asarray(jg))


@pytest.mark.parametrize("mode", ["default", "autodiff", "stats_kernel"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_batch_norm_op_matches_jax(mode, train, layout, monkeypatch,
                                   interpret_pallas):
    """``_k_batch_norm``: the default closed-form train path
    (``_bn_train_fused``) and the ``MXTPU_BN_STATS=pallas`` branch, which
    takes the statistics through autograd: from the statistics kernel
    where channel-last input passes ``stats_supported`` (``stats_kernel``),
    from plain sums where the gate refuses the shape (``autodiff``: 12
    channels, not a multiple of 8) and for channel-first input.  Output,
    gradients of data, gamma and beta, and the moving statistics."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import nn as jnn

    if mode != "default":
        monkeypatch.setenv("MXTPU_BN_STATS", "pallas")
    C = 12 if mode == "autodiff" else 16
    axis = -1 if layout == "NHWC" else 1
    rng = np.random.RandomState(7)
    data = (rng.randn(4, 6, 6, C) if layout == "NHWC"
            else rng.randn(4, C, 6, 6)).astype(np.float32) + 0.5
    if layout == "NHWC" and mode != "default":
        assert tbn.stats_supported(4 * 6 * 6, C) == (mode == "stats_kernel")
    g, b, mm, mv = _bn_arrays(C, 8)
    gy = rng.randn(*data.shape).astype(np.float32)
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=False, axis=axis,
              _train=train)

    def jloss(d, gg, bb):
        out = jnn._k_batch_norm(d, gg, bb, jnp.asarray(mm), jnp.asarray(mv),
                                **kw)[0]
        return jnp.sum(out * gy)

    jargs = tuple(jnp.asarray(a) for a in (data, g, b))
    jout = jnn._k_batch_norm(*jargs, jnp.asarray(mm), jnp.asarray(mv), **kw)
    jg = jax.grad(jloss, (0, 1, 2))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in (data, g, b)]
    tout = tnn._k_batch_norm(*targs, torch.from_numpy(mm),
                             torch.from_numpy(mv), **kw)
    tg = torch.autograd.grad((tout[0] * torch.from_numpy(gy)).sum(), targs)
    for name, t, j in zip(("out", "new_mm", "new_mv"), tout, jout):
        _close(_np(t), np.asarray(j), (1e-5, 1e-4), name)
    for name, t, j in zip(("data", "gamma", "beta"), tg, jg):
        _close_grad(_np(t), np.asarray(j), name)


@pytest.mark.parametrize("flag", ["use_global_stats", "fix_gamma"])
def test_batch_norm_op_flags_match_jax(flag):
    """``use_global_stats`` normalizes a training batch with the moving
    statistics and leaves them; ``fix_gamma`` scales by one."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import nn as jnn

    rng = np.random.RandomState(9)
    data = rng.randn(3, 4, 4, 8).astype(np.float32)
    g, b, mm, mv = _bn_arrays(8, 1)
    kw = dict(eps=1e-5, momentum=0.9, axis=-1, _train=True,
              fix_gamma=flag == "fix_gamma",
              use_global_stats=flag == "use_global_stats")
    jout = jnn._k_batch_norm(*map(jnp.asarray, (data, g, b, mm, mv)), **kw)
    jg = jax.grad(lambda gg: jnp.sum(jnn._k_batch_norm(
        jnp.asarray(data), gg, *map(jnp.asarray, (b, mm, mv)), **kw)[0]
        * data))(jnp.asarray(g))
    tg_in = torch.from_numpy(g).requires_grad_(True)
    tout = tnn._k_batch_norm(torch.from_numpy(data), tg_in,
                             *map(torch.from_numpy, (b, mm, mv)), **kw)
    for t, j in zip(tout, jout):
        _close(_np(t), np.asarray(j), (1e-5, 1e-5))
    if flag == "fix_gamma":  # the output does not depend on gamma
        assert not tout[0].requires_grad and not np.asarray(jg).any()
    else:
        (tg,) = torch.autograd.grad(
            (tout[0] * torch.from_numpy(data)).sum(), tg_in)
        _close_grad(_np(tg), np.asarray(jg))


def test_batch_norm_op_bf16_matches_jax():
    """bf16 activations: the statistics in fp32, the normalize in bf16."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import nn as jnn

    rng = np.random.RandomState(3)
    data = rng.randn(4, 5, 5, 32).astype(np.float32)
    bn = _bn_arrays(32, 2)
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=False, axis=-1, _train=True)
    jout = jnn._k_batch_norm(jnp.asarray(data, jnp.bfloat16),
                             *map(jnp.asarray, bn), **kw)
    tout = tnn._k_batch_norm(torch.from_numpy(data).to(torch.bfloat16),
                             *map(torch.from_numpy, bn), **kw)
    assert tout[0].dtype == torch.bfloat16 and tout[1].dtype == torch.float32
    _close(_np(tout[0]), _jnp_to_np(jout[0]), (3e-2, 2e-2), "out")
    for t, j in zip(tout[1:], jout[1:]):
        _close(_np(t), np.asarray(j), (1e-5, 1e-4))


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU "
                    "mode); run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# ResNet-50's 1x1 convolutions at b=2, 56^2/28^2/14^2/7^2 (M = 6272, 1568,
# 392, 98), and ragged shapes no 64-wide tile divides
RESNET_SHAPES = [(6272, 64, 64), (6272, 256, 64), (6272, 64, 256),
                 (1568, 512, 128), (1568, 128, 512), (392, 1024, 256),
                 (98, 2048, 512), (98, 512, 2048)]
RAGGED_SHAPES = [(1, 1, 1), (77, 50, 33), (130, 96, 65), (1000, 3, 200)]
# fp16: two ulps of y's O(1) values (4e-3), the products summed in another
# order than the plain version's fp32 product
CARD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2),
            "float16": (4e-3, 4e-3)}


def _card_inputs(M, K, N, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (torch.rand(M, K, generator=g) - 0.5).to(dev, dt)
    w = ((torch.rand(K, N, generator=g) - 0.5) * (2.0 / K ** 0.5)).to(dev, dt)
    sc = (torch.rand(1, K, generator=g) + 0.5).to(dev)
    sh = (torch.rand(1, K, generator=g) - 0.5).to(dev)
    return x, w, sc, sh


def _check_stats(got, y):
    """``got``, the kernel's column sums of ``y`` and of its squares, where
    ``y`` is what the kernel stored (or read): against fp64 sums of the
    same values, within 1e-5 of the sum of magnitudes (fp32 sums in the
    kernel's order) plus 1e-5.  No rounding allowance: the sums are of the
    stored values, in bf16 as in fp32."""
    yd = y.double()
    for g, r, mag in zip(got, (yd.sum(dim=0), (yd * yd).sum(dim=0)),
                         (yd.abs().sum(dim=0), (yd * yd).sum(dim=0))):
        err = (g.reshape(-1).double() - r).abs()
        bound = 1e-5 * mag + 1e-5
        assert bool((err <= bound).all()), (err - bound).max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("M,K,N", RESNET_SHAPES + RAGGED_SHAPES)
def test_fused_kernels_match_plain_on_card(M, K, N, relu, dtype,
                                           cuda_device):
    x, w, sc, sh = _card_inputs(M, K, N, dtype, cuda_device)
    atol, rtol = CARD_TOL[dtype]
    cases = [("bn_act_matmul", (x, sc, sh, w, relu)),
             ("bn_act_matmul_stats", (x, sc, sh, w, relu))]
    if not relu:
        cases.append(("matmul_bn_stats", (x, w)))
    for name, args in cases:
        # fp32 bn_act_matmul takes the TF32 route, the other fp32 kinds the
        # simple one; every ragged shape (K or N not a multiple of 8) too;
        # bf16 and fp16 take the TMA route
        simple = (M, K, N) in RAGGED_SHAPES or (
            dtype == "float32" and name != "bn_act_matmul")
        tf32 = dtype == "float32" and not simple
        f16 = dtype == "float16"
        counts = getattr(tcf, f"{name}_counts")
        before = (counts.launches, counts.simple_launches,
                  getattr(counts, "tf32_launches", 0),
                  counts.float16_launches)
        got = getattr(tcf, f"{name}_fwd")(*args)
        ref = getattr(tcf, f"{name}_plain")(*args)
        torch.cuda.synchronize()
        assert (counts.launches, counts.simple_launches,
                getattr(counts, "tf32_launches", 0),
                counts.float16_launches) == (
            before[0] + 1, before[1] + simple, before[2] + tf32,
            before[3] + f16)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        assert got[0].dtype == x.dtype and got[0].shape == (M, N)
        torch.testing.assert_close(got[0].float(), ref[0].float(), atol=atol,
                                   rtol=rtol, msg=name)
        if len(got) == 3:
            _check_stats(got[1:], got[0])


# bf16 shapes the TMA route takes beyond RESNET_SHAPES: ResNet-50's first
# stage at b=128, then M, K and N that no tile divides (K, N multiples of 8)
TMA_SHAPES = RESNET_SHAPES + [(401408, 64, 64), (401408, 256, 64),
                              (401408, 64, 256), (6349, 64, 192),
                              (130, 136, 72), (300, 72, 136), (200, 40, 24)]


def _on_route(name, args, route):
    """``<name>_fwd(*args)`` on CUDA tensors pinned to ``route`` through the
    wrapper's private ``forced``; returns ``(y,)`` or ``(y, sum, sumsq)``."""
    if name == "matmul_bn_stats":
        (x, w), extra = args, ()
    else:
        x, sc, sh, w, relu = args
        extra = (sc, sh, relu)
    out = tcf._launch(name, getattr(tcf, f"{name}_counts"), x, w, *extra,
                      forced=route)
    return out[:1] if name == "bn_act_matmul" else out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("M,K,N", TMA_SHAPES)
def test_tma_route_matches_plain_and_simple_on_card(M, K, N, relu, dtype,
                                                    cuda_device):
    """The TMA route against the plain version (y within CARD_TOL, sums
    within _check_stats) and against the simple route on the same inputs
    (y within the dtype's CARD_TOL: the products sum in another order); two
    runs give bit-identical sums; each launch counts on its route."""
    x, w, sc, sh = _card_inputs(M, K, N, dtype, cuda_device, seed=M + N)
    atol, rtol = CARD_TOL[dtype]
    cases = [("bn_act_matmul", (x, sc, sh, w, relu)),
             ("bn_act_matmul_stats", (x, sc, sh, w, relu))]
    if not relu:
        cases.append(("matmul_bn_stats", (x, w)))
    for name, args in cases:
        counts = getattr(tcf, f"{name}_counts")
        fwd = getattr(tcf, f"{name}_fwd")
        before = (counts.launches, counts.simple_launches)
        got = fwd(*args)
        again = fwd(*args)
        simple = _on_route(name, args, "simple")
        ref = getattr(tcf, f"{name}_plain")(*args)
        torch.cuda.synchronize()
        assert (counts.launches, counts.simple_launches) == (
            before[0] + 3, before[1] + 1), name
        got, again, simple, ref = (t if isinstance(t, tuple) else (t,)
                                   for t in (got, again, simple, ref))
        assert got[0].dtype == x.dtype and got[0].shape == (M, N)
        for other in (ref, simple):
            torch.testing.assert_close(got[0].float(), other[0].float(),
                                       atol=atol, rtol=rtol, msg=name)
        assert torch.equal(got[0], again[0])
        if len(got) == 3:
            _check_stats(got[1:], got[0])
            assert all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))


# fp32 bn_act_matmul shapes the TF32 route takes: ResNet-50's predict
# forward at b=64 and b=2, then M, K and N that no tile divides (K, N
# multiples of 8)
TF32_SHAPES = (_resnet_predict_shapes(64) + _resnet_predict_shapes(2)
               + [(6349, 64, 192), (130, 136, 72), (300, 72, 136),
                  (200, 40, 24), (1, 8, 8)])


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("M,K,N", TF32_SHAPES)
def test_tf32_route_matches_plain_and_simple_on_card(M, K, N, relu,
                                                     cuda_device):
    """fp32 bn_act_matmul on the TF32 route against the plain version and
    against the simple route on the same inputs, both within the fp32
    CARD_TOL; two runs give bit-identical y; each launch counts on its
    route."""
    x, w, sc, sh = _card_inputs(M, K, N, "float32", cuda_device, seed=M + K)
    args = (x, sc, sh, w, relu)
    c = tcf.bn_act_matmul_counts
    before = (c.launches, c.simple_launches, c.tf32_launches)
    got = tcf.bn_act_matmul_fwd(*args)
    again = tcf.bn_act_matmul_fwd(*args)
    (simple,) = _on_route("bn_act_matmul", args, "simple")
    ref = tcf.bn_act_matmul_plain(*args)
    torch.cuda.synchronize()
    assert (c.launches, c.simple_launches, c.tf32_launches) == (
        before[0] + 3, before[1] + 1, before[2] + 2)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.equal(got, again)
    atol, rtol = CARD_TOL["float32"]
    for other in (ref, simple):
        torch.testing.assert_close(got, other, atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["misaligned_x", "k_ragged", "n_ragged"])
def test_fp32_bn_act_matmul_takes_simple_route_where_tf32_cannot(
        case, cuda_device):
    """fp32 bn_act_matmul whose x is not 16-byte aligned, or whose K or N
    is not a multiple of 8, takes the simple route, matches the plain
    version, and refuses a pinned TF32 route."""
    M, K, N = 1000, 64, 256
    if case == "k_ragged":
        K = 60
    elif case == "n_ragged":
        N = 250
    x, w, sc, sh = _card_inputs(M, K, N, "float32", cuda_device, seed=7)
    if case == "misaligned_x":
        x = torch.zeros(M * K + 1, device=cuda_device)[1:].view(M, K) \
            .copy_(x)
        assert x.data_ptr() % 16
    c = tcf.bn_act_matmul_counts
    before = (c.simple_launches, c.tf32_launches)
    got = tcf.bn_act_matmul_fwd(x, sc, sh, w, True)
    assert (c.simple_launches, c.tf32_launches) == (before[0] + 1,
                                                    before[1])
    atol, rtol = CARD_TOL["float32"]
    torch.testing.assert_close(
        got, tcf.bn_act_matmul_plain(x, sc, sh, w, True), atol=atol,
        rtol=rtol)
    with pytest.raises(MXNetError, match="tf32 route"):
        _on_route("bn_act_matmul", (x, sc, sh, w, True), "tf32")


@pytest.mark.gpu
def test_tma_route_refuses_what_it_cannot_address(cuda_device):
    x, w, _, _ = _card_inputs(128, 64, 64, "float32", cuda_device)
    with pytest.raises(MXNetError, match="tma route"):
        _on_route("matmul_bn_stats", (x, w), "tma")
    xb = torch.zeros(128 * 64 + 1, dtype=torch.bfloat16,
                     device=cuda_device)[1:].view(128, 64)
    with pytest.raises(MXNetError, match="tma route"):
        _on_route("matmul_bn_stats", (xb, w.to(torch.bfloat16)), "tma")
    # at K = 20480 the prologue's coefficients and two ring slots exceed a
    # block's shared memory: no TMA plan, so the rule takes the simple route
    x, w, sc, sh = _card_inputs(128, 20480, 64, "bfloat16", cuda_device)
    c = tcf.bn_act_matmul_counts
    before = c.simple_launches
    got = tcf.bn_act_matmul_fwd(x, sc, sh, w, True)
    assert c.simple_launches == before + 1
    atol, rtol = CARD_TOL["bfloat16"]
    torch.testing.assert_close(
        got.float(), tcf.bn_act_matmul_plain(x, sc, sh, w, True).float(),
        atol=atol, rtol=rtol)
    with pytest.raises(MXNetError, match="tma route"):
        _on_route("bn_act_matmul", (x, sc, sh, w, True), "tma")


def _bn_stats_input(M, C, dtype, dev, offset=0):
    """x (M, C) from a seed on ``dev``: a contiguous tensor, or with
    ``offset`` a contiguous view that many elements into its storage (so
    its data pointer is not 16-byte aligned)."""
    g = torch.Generator().manual_seed(M + C)
    flat = (torch.randn(offset + M * C, generator=g) + 0.5).to(
        dev, getattr(torch, dtype))
    x = flat[offset:].view(M, C)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,C,offset", [
    (6272, 64, 0), (1568, 128, 0), (392, 256, 0), (98, 512, 0), (1, 3, 0),
    (1000, 70, 0), (5, 1, 0),
    # ResNet-50's four stage shapes at b=128, as its training step hands
    # them over
    (401408, 64, 0), (100352, 128, 0), (25088, 256, 0), (6272, 512, 0),
    # misaligned views: the scalar route
    (6272, 64, 1), (98, 512, 3)])
def test_bn_stats_kernel_matches_plain_on_card(M, C, offset, dtype,
                                               cuda_device):
    x = _bn_stats_input(M, C, dtype, cuda_device, offset)
    vec = C % VEC[dtype] == 0 and offset == 0
    c = tbn.counts
    before = (c.launches, c.scalar_launches, c.float16_launches)
    got = tbn.bn_stats_fwd(x)
    ref = tbn.bn_stats_plain(x)
    torch.cuda.synchronize()
    assert (c.launches, c.scalar_launches, c.float16_launches) == (
        before[0] + 1, before[1] + (not vec),
        before[2] + (dtype == "float16"))
    _check_stats(got, x)
    _check_stats(ref, x)
    again = tbn.bn_stats_fwd(x)  # no atomics: bit-identical
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,C,offset", [(6272, 64, 0), (1568, 128, 0),
                                        (98, 512, 0), (1000, 70, 0),
                                        (37, 3, 0), (777, 24, 0),
                                        (1568, 128, 1)])
def test_bn_stats_kernel_matches_its_order_model_on_card(M, C, offset, dtype,
                                                         cuda_device):
    """The kernel's sums equal, bit for bit, the float32 model of its
    summation order (``_bn_stats_order``) on the plan it launched."""
    x = _bn_stats_input(M, C, dtype, cuda_device, offset)
    P, vec, groups = tbn.launch_plan(x)
    assert vec == (offset == 0 and C % VEC[dtype] == 0)
    got = tbn.bn_stats_fwd(x)
    want = _bn_stats_order(x.float().cpu().numpy(), P, groups)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), torch.from_numpy(w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,C", [(401408, 64), (6272, 512), (1000, 70)])
def test_bn_stats_kernel_replays_in_a_cuda_graph_on_card(M, C, dtype,
                                                         cuda_device):
    """Captured in a CUDA graph, the launch replays three times with sums
    bit-identical to the eager calls': the last block of each strip resets
    its ticket counter, so every replay starts from zeroed counters."""
    x = _bn_stats_input(M, C, dtype, cuda_device)
    eager = tbn.bn_stats_fwd(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tbn.bn_stats_fwd(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tbn.bn_stats_fwd(x)
    for _ in range(3):
        for t in captured:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))
    again = tbn.bn_stats_fwd(x)  # eager after the replays
    assert all(torch.equal(a, b) for a, b in zip(again, eager))


@pytest.mark.gpu
def test_functions_on_card_match_autograd_of_plain(cuda_device):
    """The Functions on the card (kernel forward, plain backward) against
    autograd through the plain forward, fp32: 1e-4 plus 1e-4 relative."""
    x, w, sc, sh = _card_inputs(512, 128, 64, "float32", cuda_device, seed=3)
    g = torch.Generator().manual_seed(5)
    cot = [torch.randn(512, 64, generator=g).to(cuda_device),
           torch.randn(1, 64, generator=g).to(cuda_device),
           torch.randn(1, 64, generator=g).to(cuda_device) * 0.1]

    def grads(fn, args):
        ts = [a.clone().requires_grad_(True) for a in args]
        outs = fn(*ts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o.float() * c).sum() for o, c in zip(outs, cot))
        return torch.autograd.grad(loss, ts)

    cases = [(tcf.matmul_bn_stats, tcf.matmul_bn_stats_plain, (x, w)),
             (lambda *a: tcf.bn_act_matmul(*a, True),
              lambda *a: tcf.bn_act_matmul_plain(*a, True), (x, sc, sh, w)),
             (lambda *a: tcf.bn_act_matmul_stats(*a, True),
              lambda *a: tcf.bn_act_matmul_stats_plain(*a, True),
              (x, sc, sh, w)),
             ]
    for fn, plain, args in cases:
        for got, ref in zip(grads(fn, args), grads(plain, args)):
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    cot = [torch.randn(128, generator=g).to(cuda_device) for _ in range(2)]
    for got, ref in zip(grads(tbn.bn_stats, (x,)),
                        grads(tbn.bn_stats_plain, (x,))):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take(cuda_device):
    x64 = torch.zeros(64, 64, device=cuda_device, dtype=torch.float64)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        tcf.matmul_bn_stats_fwd(x64, x64)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        tbn.bn_stats_fwd(x64)
    x = torch.zeros(64, 64, device=cuda_device)
    with pytest.raises(MXNetError, match="one dtype"):
        tcf.matmul_bn_stats_fwd(x, x.to(torch.bfloat16))
    with pytest.raises(MXNetError, match=r"\(M, K\)"):
        tcf.matmul_bn_stats_fwd(x, torch.zeros(32, 64, device=cuda_device))
    with pytest.raises(MXNetError, match="w is on"):
        tcf.matmul_bn_stats_fwd(x, torch.zeros(64, 64))
    with pytest.raises(MXNetError, match="scale"):
        tcf.bn_act_matmul_fwd(x, torch.zeros(1, 32, device=cuda_device),
                              torch.zeros(1, 64, device=cuda_device), x)
    with pytest.raises(MXNetError, match="contiguous"):
        tbn.bn_stats_fwd(x.t()[:, :32])
    with pytest.raises(MXNetError, match="C >= 1"):
        tbn.bn_stats_fwd(torch.zeros(4, 0, device=cuda_device))


@pytest.mark.gpu
def test_gate_counts_plain_calls_on_card(cuda_device):
    """A shape the JAX gate refuses takes the plain version on the card and
    counts in plain_calls_on_cuda; a shape it takes launches."""
    x, w, _, _ = _card_inputs(100, 48, 24, "float32", cuda_device)
    c = tcf.matmul_bn_stats_counts
    before = (c.launches, c.plain_calls_on_cuda)
    tcf.matmul_bn_stats(x, w)
    assert (c.launches, c.plain_calls_on_cuda) == (before[0],
                                                   before[1] + 1)
    x, w, _, _ = _card_inputs(128, 64, 64, "float32", cuda_device)
    tcf.matmul_bn_stats(x, w)
    assert c.launches == before[0] + 1
    d = torch.zeros(2, 4, 4, 12, device=cuda_device)
    ones = torch.ones(12, device=cuda_device)
    before = tbn.counts.plain_calls_on_cuda
    tops._k_bn_fold(d, ones, ones, ones, ones, _train=True)
    assert tbn.counts.plain_calls_on_cuda == before + 1
