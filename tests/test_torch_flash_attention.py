"""Flash-attention forward of the PyTorch port against the JAX package.

On the CPU the port's wrapper takes the kernel's plain version; it is held
against the JAX Pallas kernels ``_flash_forward`` (K/V resident) and
``_flash_forward_stream`` (K/V streamed), run in interpret mode, and the
port's entry against the JAX entry on the cases it sends to the oracle.
Inputs are made with numpy from a seed.  The tests marked ``gpu`` hold the
CUDA kernel against the plain version on the card and skip without one.

Tolerances: float32 o within 2e-5 absolute (both sides accumulate in fp32;
they differ by the online-softmax rescaling order), lse within 1e-4
absolute plus 1e-6 relative (dead rows sit at -1e9).  bfloat16 o within
2e-2: the JAX kernel rounds q*scale with scale rounded to bf16 first, the
port with scale in fp32, and each rounds the probabilities to bf16.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.attention import sdpa_reference as t_sdpa_reference
from mxnet_tpu_torch.ops.kernels import flash_attention as tfa

MASKS = ("none", "additive", "bool", "dead_row", "causal")


def _qkv(b, h, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32) * 0.5
    k = rng.randn(b, h, sk, d).astype(np.float32) * 0.5
    v = rng.randn(b, h, sk, d).astype(np.float32)
    return q, k, v


# valid lengths of sk=512 that make whole key tiles dead or leave one live
# key at a tile edge (the tensor-core kernel's tiles hold 32 keys at
# d=64 and 128, 16 at d=64 where sk <= 128)
TILE_EDGES = (0, 1, 63, 64, 65, 127, 128, 129)


def _key_mask(kind, b, sk, seed=1):
    """(additive (b, sk) row or None, 4-d mask as the model passes it or
    None, causal).  ``valid_<n>``: batch row 0 has n valid keys, the rest
    all; ``causal_key_padding``: random valid lengths and causal."""
    if kind in ("none", "causal"):
        return None, None, kind == "causal"
    rng = np.random.RandomState(seed)
    valid = rng.randint(1, sk + 1, size=b)
    if kind == "dead_row":
        valid[-1] = 0
    elif kind.startswith("valid_"):
        valid[:] = sk
        valid[0] = int(kind[len("valid_"):])
    keep = np.arange(sk)[None, :] < valid[:, None]
    row = np.where(keep, 0.0, -1e9).astype(np.float32)
    mask4 = keep.reshape(b, 1, 1, sk) if kind == "bool" \
        else row.reshape(b, 1, 1, sk)
    return row, mask4, kind == "causal_key_padding"


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [128, 256])
def test_plain_matches_jax_forward_kernels(s, d, mask, stream,
                                           interpret_pallas):
    import jax.numpy as jnp

    from mxnet_tpu.ops.pallas import flash_attention as jfa

    b, h = 2, 2
    q, k, v = _qkv(b, h, s, s, d)
    _, mask4, causal = _key_mask(mask, b, s)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    # each package turns the model's (b,1,1,s) mask into its kernel's row
    jrow = None if mask4 is None else \
        jfa._as_key_padding_mask(jnp.asarray(mask4), jq, jk)
    trow = None if mask4 is None else \
        tfa.as_key_padding_mask(torch.from_numpy(mask4), tq, tk)
    scale = 1.0 / np.sqrt(d)
    jfwd = jfa._flash_forward_stream if stream else jfa._flash_forward
    jo, jlse = jfwd(jq, jk, jv, causal=causal, scale=scale, kmask=jrow)
    to, tlse = tfa.flash_attention_fwd(tq, tk, tv, trow, causal=causal,
                                       scale=scale)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(tlse.numpy(),
                               np.asarray(jlse).reshape(b * h, s),
                               atol=1e-4, rtol=1e-6)


def test_plain_matches_jax_forward_kernel_bf16(interpret_pallas):
    import jax.numpy as jnp

    from mxnet_tpu.ops.pallas import flash_attention as jfa

    b, h, s, d = 2, 2, 128, 128
    q, k, v = _qkv(b, h, s, s, d, seed=3)
    row, _, _ = _key_mask("dead_row", b, s)
    jo, _ = jfa._flash_forward(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        causal=False, scale=1.0 / np.sqrt(d), kmask=jnp.asarray(row))
    to, _ = tfa.flash_attention_fwd(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        torch.from_numpy(row), causal=False, scale=1.0 / np.sqrt(d))
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=2e-2, rtol=0)


def test_dead_row_is_mean_of_v_not_nan():
    """A batch row whose keys are all padding (a dead row of a padded
    serving batch) gives the mean of V over its keys, as the JAX kernel
    does with its -1e9 masking."""
    b, h, s, d = 2, 2, 128, 64
    q, k, v = _qkv(b, h, s, s, d)
    row, _, _ = _key_mask("dead_row", b, s)
    o, lse = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(row), causal=False, scale=0.125)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(
        o[-1].numpy(), np.broadcast_to(v[-1].mean(axis=1, keepdims=True),
                                       (h, s, d)), atol=1e-5)


@pytest.mark.parametrize("case", ["score_mask", "causal_cross_length",
                                  "head_dim_96", "key_padding",
                                  "length_100"])
def test_entry_matches_jax_entry(case, interpret_pallas):
    """The port's entry follows the JAX entry's routing: a full score
    mask, causal attention with sq != sk (the oracle's end-aligned mask),
    a head dim that is not a multiple of 64 and a length that is not a
    multiple of 128 go to the oracle; a (b,1,1,sk) key-padding mask rides
    the kernel."""
    import jax.numpy as jnp

    from mxnet_tpu.ops.pallas.flash_attention import \
        flash_attention as jflash

    b, h = 2, 2
    sq, sk, d = (128, 256, 64) if case == "causal_cross_length" else \
        (100, 100, 64) if case == "length_100" else \
        (128, 128, 96 if case == "head_dim_96" else 64)
    q, k, v = _qkv(b, h, sq, sk, d, seed=5)
    causal = case == "causal_cross_length"
    mask = None
    if case == "score_mask":
        rng = np.random.RandomState(6)
        mask = np.where(rng.rand(b, 1, sq, sk) > 0.3, 0.0,
                        -1e9).astype(np.float32)
    elif case in ("key_padding", "length_100"):
        _, mask, _ = _key_mask("additive", b, sk)
    jo = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                mask=None if mask is None else jnp.asarray(mask),
                causal=causal)
    to = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=0)


def test_oracle_matches_jax_oracle():
    import jax.numpy as jnp

    from mxnet_tpu.ops.attention import sdpa_reference as j_sdpa_reference

    b, h, sq, sk, d = 2, 3, 64, 96, 32
    q, k, v = _qkv(b, h, sq, sk, d, seed=7)
    bmask = np.random.RandomState(8).rand(b, 1, 1, sk) > 0.2
    for kw in ({"causal": True}, {"mask": bmask}, {"scale": 0.3}):
        jkw = {key: (jnp.asarray(val) if key == "mask" else val)
               for key, val in kw.items()}
        tkw = {key: (torch.from_numpy(val) if key == "mask" else val)
               for key, val in kw.items()}
        jo = j_sdpa_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **jkw)
        to = t_sdpa_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **tkw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)


def test_key_padding_mask_normalisation():
    b, sk = 2, 16
    q = torch.zeros(b, 1, 4, 8)
    k = torch.zeros(b, 1, sk, 8)
    keep = torch.arange(sk)[None, :] < torch.tensor([[16], [5]])
    row = tfa.as_key_padding_mask(keep.reshape(b, 1, 1, sk), q, k)
    assert row.dtype == torch.float32 and row.shape == (b, sk)
    assert torch.equal(row < -1e8, ~keep)
    add = torch.where(keep, 0.0, -1e9).reshape(b, 1, 1, sk)
    assert torch.equal(tfa.as_key_padding_mask(add, q, k), row)
    assert tfa.as_key_padding_mask(torch.zeros(b, 1, 4, sk), q, k) is None
    assert tfa.as_key_padding_mask(None, q, k) is None


def test_rows_aligned_rule():
    """The kernels read rows in place where each starts on a 16-byte
    boundary: contiguous tensors and head views of a packed QKV tensor;
    other views are copied to contiguous ones first.  Strides of
    single-entry dims do not count."""
    q = torch.zeros(2, 3, 100, 64)
    packed = torch.zeros(2, 100, 3 * 3 * 64)
    heads = [t.reshape(2, 100, 3, 64).transpose(1, 2)
             for t in packed.chunk(3, dim=-1)]
    for t in (q, *heads, q.bfloat16(), *(t.bfloat16() for t in heads)):
        assert tfa.rows_aligned(t) and tfa._aligned_rows(t) is t
    for odd in (torch.zeros(2, 3, 100, 65)[..., :64],
                torch.zeros(2, 3, 100, 66)[..., 1:65]):
        assert not tfa.rows_aligned(odd)
        copy = tfa._aligned_rows(odd)
        assert copy.is_contiguous() and tfa.rows_aligned(copy)
        assert torch.equal(copy, odd)
    single = torch.zeros(2, 3, 64).as_strided((2, 3, 1, 64), (192, 64, 3, 1))
    assert tfa.rows_aligned(single)


def visited_key_tiles(row, b, h, sq, sk, bk, causal):
    """The key tiles the tensor-core kernels visit, by their rule, and the
    tiles they would visit without skipping: a tile whose keys all have
    mask values <= -1e9 is skipped when every query row of the block of
    64 sees a live key."""
    visited = total = 0
    for bi in range(b):
        live = np.nonzero(row[bi] > -1e9)[0] if row is not None else \
            np.arange(sk)
        for q0 in range(0, sq, 64):
            n_kt = -(-sk // bk)
            if causal:
                n_kt = min(n_kt, (min(q0 + 64, sq) - 1) // bk + 1)
            first = live[0] if len(live) else None
            skip = row is not None and first is not None and \
                first <= (q0 if causal else sk)
            for kt in range(n_kt):
                total += h
                tile_live = ((live >= kt * bk) & (live < (kt + 1) * bk)).any()
                visited += h if (not skip or tile_live) else 0
    return visited, total


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 70, 45, 64))
    before = (tfa.counts.launches, tfa.counts.plain_calls_on_cuda)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=False, scale=0.2)
    po, plse = tfa.flash_attention_plain(q, k, v, causal=False, scale=0.2)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert lse.shape == (2, 70)
    tfa.flash_attention(q, k, v, mask=torch.zeros(1, 1, 70, 45))
    assert (tfa.counts.launches, tfa.counts.plain_calls_on_cuda) == before


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU "
                    "mode); run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# every mask at three shapes; at sk=512, valid lengths at tile edges and
# causal with key padding
CARD_CASES = ([(sq, sk, m) for sq, sk in ((128, 128), (100, 77), (1, 300))
               for m in MASKS]
              + [(512, 512, f"valid_{n}") for n in TILE_EDGES]
              + [(512, 512, "causal_key_padding"),
                 (128, 128, "causal_key_padding")])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("sq,sk,mask", CARD_CASES)
def test_kernel_matches_plain_on_card(sq, sk, mask, d, dtype, cuda_device):
    """fp32 o within 1e-4, bf16 within 2e-2 (one bf16 ulp of values near
    1, from probabilities rounded at different sum orders); lse within
    1e-3 absolute plus 1e-6 relative."""
    b, h = 2, 3
    q, k, v = (torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
               for x in _qkv(b, h, sq, sk, d))
    row, _, causal = _key_mask(mask, b, sk)
    km = None if row is None else torch.from_numpy(row).to(cuda_device)
    before = tfa.counts.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, km, causal=causal)
    torch.cuda.synchronize()
    assert tfa.counts.launches == before + 1
    po, plse = tfa.flash_attention_plain(q, k, v, km, causal=causal)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(o.float(), po.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=1e-6)


def _unaligned(t):
    """``t`` as a view whose rows do not start on 16-byte boundaries."""
    b, h, s, d = t.shape
    wide = torch.zeros(b, h, s, d + 1, dtype=t.dtype, device=t.device)
    wide[..., 1:] = t
    return wide[..., 1:]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("mask", ["dead_row", "causal", "valid_65"])
def test_unaligned_views_match_plain_on_card(mask, d, dtype, cuda_device):
    """Views whose rows are not 16-byte aligned are copied and launch the
    kernel once; tolerances as above."""
    b, h, s = 2, 3, 200
    q, k, v = (_unaligned(torch.from_numpy(x).to(cuda_device,
                                                 getattr(torch, dtype)))
               for x in _qkv(b, h, s, s, d, seed=4))
    assert not any(tfa.rows_aligned(t) for t in (q, k, v))
    row, _, causal = _key_mask(mask, b, s)
    km = None if row is None else torch.from_numpy(row).to(cuda_device)
    before = tfa.counts.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, km, causal=causal)
    torch.cuda.synchronize()
    assert tfa.counts.launches == before + 1
    po, plse = tfa.flash_attention_plain(q, k, v, km, causal=causal)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(o.float(), po.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mask", [f"valid_{n}" for n in TILE_EDGES]
                         + ["causal_key_padding", "none"])
def test_kernel_skips_dead_key_tiles_on_card(mask, d, cuda_device):
    """The tensor-core kernel visits exactly the key tiles its rule
    keeps (32 keys a tile at d=64 and 128), and two launches on the same
    inputs are bit-identical."""
    b, h, s = 2, 3, 512
    q, k, v = (torch.from_numpy(x).to(cuda_device)
               for x in _qkv(b, h, s, s, d, seed=6))
    row, _, causal = _key_mask(mask, b, s)
    km = None if row is None else torch.from_numpy(row).to(cuda_device)
    tiles = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    o1, lse1 = tfa._launch_fwd(q, k, v, km, causal, None, tiles=tiles)
    o2, lse2 = tfa._launch_fwd(q, k, v, km, causal, None)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    expect = visited_key_tiles(row, b, h, s, s, 32, causal)
    assert tuple(tiles.tolist()) == expect


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_reads_packed_head_views_on_card(dtype, cuda_device):
    """Heads as strided views of one packed (b, s, 3*h*d) QKV tensor, the
    layout the attention op passes, read in place; tolerances as above."""
    b, s, h, d = 2, 100, 3, 64
    rng = np.random.RandomState(9)
    packed = torch.from_numpy(rng.randn(b, s, 3 * h * d).astype(np.float32)
                              * 0.5).to(cuda_device, getattr(torch, dtype))
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in packed.chunk(3, dim=-1))
    assert not q.is_contiguous()
    assert all(tfa._aligned_rows(t) is t for t in (q, k, v))
    row, _, _ = _key_mask("dead_row", b, s)
    km = torch.from_numpy(row).to(cuda_device)
    o, lse = tfa.flash_attention_fwd(q, k, v, km)
    po, plse = tfa.flash_attention_plain(q, k, v, km)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(o.float(), po.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=1e-6)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 64, 64, device=cuda_device)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        tfa.flash_attention_fwd(q.half(), q.half(), q.half())
    q96 = torch.zeros(1, 2, 64, 96, device=cuda_device)
    with pytest.raises(MXNetError, match="head dims"):
        tfa.flash_attention_fwd(q96, q96, q96)
    qt = torch.zeros(1, 2, 64, 64, device=cuda_device).transpose(2, 3)
    with pytest.raises(MXNetError, match="contiguous"):
        tfa.flash_attention_fwd(qt, qt, qt)
    with pytest.raises(MXNetError, match="key-padding row"):
        tfa.flash_attention_fwd(q, q, q, torch.zeros(1, 64))
