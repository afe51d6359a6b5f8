"""``mx.random``'s samplers and the random ops, against the JAX package.

The draws come from torch generators, so their values differ from the JAX
package's threefry streams (a deliberate difference): each sampler is held
to the JAX sampler's shape, dtype and context, reseeding gives the same
bits, and the moments of 2^20 draws lie within 6 standard errors of the
distribution's.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
N = 1 << 20

# (sampler, args, kwargs, mean, variance) of each sampler's distribution
SAMPLERS = [
    ("uniform", (-1.0, 3.0), {}, 1.0, 16 / 12),
    ("normal", (0.5, 2.0), {}, 0.5, 4.0),
    ("randn", (), {"loc": -1.0, "scale": 0.5}, -1.0, 0.25),
    ("randint", (-3, 7), {}, 1.5, (10 ** 2 - 1) / 12),
    ("poisson", (3.5,), {}, 3.5, 3.5),
    ("exponential", (2.0,), {}, 2.0, 4.0),
    ("gamma", (2.5, 1.5), {}, 3.75, 2.5 * 1.5 ** 2),
    ("bernoulli", (0.3,), {}, 0.3, 0.21),
]


def _draw(mx, name, args, kwargs, shape, ctx):
    fn = getattr(mx.random, name)
    if name == "randn":
        return fn(*shape, ctx=ctx, **kwargs)
    return fn(*args, shape=shape, ctx=ctx, **kwargs)


@pytest.mark.parametrize("name,args,kwargs,mean,var", SAMPLERS,
                         ids=[s[0] for s in SAMPLERS])
def test_sampler_shape_dtype_context_seed_and_moments(name, args, kwargs,
                                                      mean, var):
    import mxnet_tpu as jmx

    j = _draw(jmx, name, args, kwargs, (2, 3), jmx.cpu())
    t = _draw(tmx, name, args, kwargs, (2, 3), CPU)
    assert isinstance(t, tmx.nd.NDArray)
    assert t.shape == j.shape and t.dtype == j.dtype and t.context == CPU
    assert _draw(tmx, name, args, kwargs, (4,), CPU).context == CPU
    with tmx.cpu():
        assert getattr(tmx.random, name)(*args, **kwargs).shape == \
            getattr(jmx.random, name)(*args, **kwargs).shape
    tmx.random.seed(11)
    a = _draw(tmx, name, args, kwargs, (N,), CPU).asnumpy()
    tmx.random.seed(11)
    b = _draw(tmx, name, args, kwargs, (N,), CPU).asnumpy()
    assert np.array_equal(a, b)
    a = a.astype(np.float64)
    assert abs(a.mean() - mean) < 6 * math.sqrt(var / N)
    # the variance's standard error from the fourth central moment
    m4 = ((a - a.mean()) ** 4).mean()
    assert abs(a.var() - var) < 6 * math.sqrt((m4 - var ** 2) / N)


def test_the_nd_random_namespace_and_its_flat_names():
    """``nd.random.X`` is the sampler (NDArrays), or the ``_random_X`` op;
    with a ``torch.device`` as ``ctx`` (``F.random`` in a block) a
    sampler gives the tensor."""
    assert tmx.nd.random.normal is tmx.random.normal
    assert isinstance(tmx.nd.random_uniform(shape=(2,), ctx=CPU),
                      tmx.nd.NDArray)
    assert isinstance(tmx.nd.random.uniform(shape=(3,),
                                            ctx=torch.device("cpu")),
                      torch.Tensor)
    assert isinstance(tmx.nd.random.poisson(lam=2.0, shape=(3,), ctx=CPU),
                      tmx.nd.NDArray)
    g = tmx.nd._random_gamma(alpha=2.0, shape=(5,), ctx=CPU)
    assert isinstance(g, tmx.nd.NDArray) and g.shape == (5,)
    assert type(tmx.nd._random_normal(shape=(2,),
                                      ctx=torch.device("cpu"))) is torch.Tensor


def test_multinomial_draws_and_log_probabilities():
    """Shapes and dtypes as the JAX sampler's; ``get_prob`` gives each
    draw's log-probability, exactly ``log_softmax`` of the log weights at
    the draw; the frequencies match the weights."""
    import mxnet_tpu as jmx

    p = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    for shape in ((), (4,), (2, 3)):
        j = jmx.random.multinomial(jmx.nd.array(p), shape=shape)
        t = tmx.random.multinomial(tmx.nd.array(p, ctx=CPU), shape=shape)
        assert t.shape == j.shape and t.dtype == j.dtype
    tp = tmx.nd.array(p * 3, ctx=CPU)
    s, lp = tmx.random.multinomial(tp, shape=(N // 4,), get_prob=True)
    jl = jmx.random.multinomial(jmx.nd.array(p), get_prob=True)
    assert lp.shape == s.shape and lp.dtype == jl[1].dtype
    want = torch.log_softmax(torch.log(tp.data), -1).gather(
        -1, s.data.long())
    assert torch.equal(lp.data, want)
    freq = np.stack([np.bincount(r, minlength=3) for r in s.asnumpy()]) \
        / s.shape[1]
    se = np.sqrt(p * (1 - p) / s.shape[1])
    assert (np.abs(freq - p) < 6 * se).all()
    tmx.random.seed(3)
    a = tmx.random.multinomial(tp, shape=(64,)).asnumpy()
    tmx.random.seed(3)
    assert np.array_equal(a, tmx.random.multinomial(tp, shape=(64,))
                          .asnumpy())


def test_shuffle_is_a_seeded_permutation_of_the_rows():
    import mxnet_tpu as jmx

    x = np.arange(N, dtype=np.float32).reshape(-1, 4)
    tmx.random.seed(5)
    s = tmx.random.shuffle(tmx.nd.array(x, ctx=CPU))
    j = jmx.random.shuffle(jmx.nd.array(x))
    assert s.shape == j.shape and s.dtype == j.dtype and s.context == CPU
    rows = s.asnumpy()
    assert np.array_equal(np.sort(rows[:, 0]), x[:, 0])
    assert np.array_equal(rows[:, 1] - rows[:, 0], np.ones(len(x)))
    assert not np.array_equal(rows, x)
    tmx.random.seed(5)
    assert np.array_equal(tmx.random.shuffle(tmx.nd.array(x, ctx=CPU))
                          .asnumpy(), rows)


# per-row parameters -> (mean, variance) of each row's distribution
SAMPLE_OPS = [
    ("sample_uniform", [[0.0, -2.0], [1.0, 4.0]],
     lambda lo, hi: ((lo + hi) / 2, (hi - lo) ** 2 / 12)),
    ("sample_normal", [[0.0, 3.0], [1.0, 0.5]],
     lambda m, s: (m, s ** 2)),
    ("sample_gamma", [[2.0, 0.5], [1.0, 3.0]],
     lambda a, b: (a * b, a * b * b)),
    ("sample_exponential", [[2.0, 0.5]], lambda lam: (1 / lam, 1 / lam ** 2)),
    ("sample_poisson", [[1.5, 6.0]], lambda lam: (lam, lam)),
    ("sample_negative_binomial", [[3.0, 5.0], [0.4, 0.7]],
     lambda k, p: (k * (1 - p) / p, k * (1 - p) / p ** 2)),
    ("sample_generalized_negative_binomial", [[2.0, 4.0], [0.5, 0.25]],
     lambda mu, a: (mu, mu + a * mu * mu)),
]


@pytest.mark.parametrize("name,params,moments", SAMPLE_OPS,
                         ids=[s[0] for s in SAMPLE_OPS])
def test_sample_ops_take_per_row_parameters(name, params, moments):
    import mxnet_tpu as jmx

    jp = [jmx.nd.array(np.array(p, np.float32)) for p in params]
    tp = [tmx.nd.array(np.array(p, np.float32), ctx=CPU) for p in params]
    j = getattr(jmx.nd, name)(*jp, shape=(3,))
    t = getattr(tmx.nd, name)(*tp, shape=(3,))
    assert t.shape == j.shape == (2, 3) and t.dtype == j.dtype
    tmx.random.seed(13)
    draws = getattr(tmx.nd, name)(*tp, shape=(N // 2,)).asnumpy()
    draws = draws.astype(np.float64)
    mean, var = moments(*(np.array(p, np.float64) for p in params))
    n = draws.shape[1]
    assert (np.abs(draws.mean(1) - mean) < 6 * np.sqrt(var / n)).all(), \
        (draws.mean(1), mean)
    m4 = ((draws - draws.mean(1, keepdims=True)) ** 4).mean(1)
    assert (np.abs(draws.var(1) - var)
            < 6 * np.sqrt((m4 - var ** 2) / n)).all(), (draws.var(1), var)


@pytest.mark.gpu
def test_samplers_on_card():
    """Every sampler on gpu(0): the CPU's shape and dtype, the context,
    and the same bits after reseeding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine with -m gpu")
    gpu = tmx.gpu(0)
    for name, args, kwargs, _, _ in SAMPLERS:
        cpu = _draw(tmx, name, args, kwargs, (2, 3), CPU)
        tmx.random.seed(7)
        a = _draw(tmx, name, args, kwargs, (1000,), gpu)
        tmx.random.seed(7)
        b = _draw(tmx, name, args, kwargs, (1000,), gpu)
        assert a.context == gpu and a.data.is_cuda
        assert _draw(tmx, name, args, kwargs, (2, 3), gpu).dtype == cpu.dtype
        assert torch.equal(a.data, b.data)
    p = tmx.nd.array(np.array([[0.2, 0.8]], np.float32), ctx=gpu)
    s, lp = tmx.random.multinomial(p, shape=(5,), get_prob=True)
    assert s.context == gpu and s.shape == (1, 5) and lp.shape == (1, 5)
    x = tmx.nd.array(np.arange(10, dtype=np.float32), ctx=gpu)
    assert sorted(tmx.random.shuffle(x).asnumpy()) == list(range(10))
