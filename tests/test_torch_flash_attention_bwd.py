"""Flash-attention backward of the PyTorch port against the JAX package.

On the CPU the port's backward wrapper takes the kernels' plain version,
``flash_attention_bwd_plain``.  It is held against the JAX Pallas backward
kernels ``_flash_backward`` (K/V and Q/dO resident) and
``_flash_backward_stream`` (streamed), run in interpret mode on the same
q, k, v, dO and the same o and lse (the JAX forward's), made with numpy
from a seed; against ``torch.autograd`` through the oracle; and the port's
``FlashAttentionFunction`` against autograd through the plain forward.
The tests marked ``gpu`` hold each CUDA kernel against the plain backward
on the card, and check that attention gradients reach the parameters of
the layer (on the card the forward's output used to come back detached).

Tolerances.  fp32 against the JAX kernels: 2e-4 absolute plus 1e-5
relative (both sum in fp32 over up to 256 keys, in other orders; a dead
row's gradients sum dO over every query and reach ~30).  bf16: 5e-2
absolute plus 2e-2 relative (the outputs are rounded to bf16, one ulp of
values near 4).  Against autograd: 1e-4 absolute plus 1e-4 relative.  The
dead row is left out of the comparisons with autograd: there the fp32 lse
rounds to -1e9, so the flash formula's p is 1 where softmax's is 1/sk,
and the port, like the JAX kernels, gives the flash formula's gradient.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.attention import sdpa_reference
from mxnet_tpu_torch.ops.kernels import flash_attention as tfa

MASKS = ("none", "additive", "bool", "dead_row", "causal")


def _inputs(b, h, s, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, s, d).astype(np.float32) * 0.5
    k = rng.randn(b, h, s, d).astype(np.float32) * 0.5
    v = rng.randn(b, h, s, d).astype(np.float32)
    do = rng.randn(b, h, s, d).astype(np.float32)
    return q, k, v, do


# valid lengths of sk=512 that make whole key tiles dead or leave one live
# key at a tile edge (the dQ kernel's tiles: 32 keys at d=64, 128 and
# 192, 16 at d=256)
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


def _jax_backward(q, k, v, do, mask4, causal, stream, dtype="float32"):
    """The JAX forward's (o, lse) and its backward kernels' (dq, dk, dv),
    as numpy float32."""
    import jax.numpy as jnp

    from mxnet_tpu.ops.pallas import flash_attention as jfa

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    jrow = None if mask4 is None else \
        jfa._as_key_padding_mask(jnp.asarray(mask4), jq, jk)
    scale = 1.0 / np.sqrt(q.shape[-1])
    jo, jlse = jfa._flash_forward(jq, jk, jv, causal=causal, scale=scale,
                                  kmask=jrow)
    jbwd = jfa._flash_backward_stream if stream else jfa._flash_backward
    grads = jbwd(jq, jk, jv, jo, jlse, jdo, causal=causal, scale=scale,
                 kmask=jrow)
    as_np = lambda x: np.array(x, np.float32)  # noqa: E731
    return as_np(jo), as_np(jlse), [as_np(g) for g in grads]


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [128, 256])
def test_plain_backward_matches_jax_backward_kernels(s, d, mask, stream,
                                                     interpret_pallas):
    b, h = 2, 2
    q, k, v, do = _inputs(b, h, s, d)
    _, mask4, causal = _key_mask(mask, b, s)
    jo, jlse, jgrads = _jax_backward(q, k, v, do, mask4, causal, stream)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    trow = None if mask4 is None else \
        tfa.as_key_padding_mask(torch.from_numpy(mask4), tq, tk)
    tgrads = tfa.flash_attention_bwd(
        tq, tk, tv, torch.from_numpy(jo),
        torch.from_numpy(jlse.reshape(b * h, s)), tdo, trow, causal=causal,
        scale=1.0 / np.sqrt(d))
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), j, atol=2e-4, rtol=1e-5,
                                   err_msg=name)


def test_plain_backward_matches_jax_backward_kernel_bf16(interpret_pallas):
    b, h, s, d = 2, 2, 128, 128
    q, k, v, do = _inputs(b, h, s, d, seed=3)
    _, mask4, _ = _key_mask("dead_row", b, s)
    jo, jlse, jgrads = _jax_backward(q, k, v, do, mask4, False, False,
                                     "bfloat16")
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    tq, tk, tv, tdo = (bf(x) for x in (q, k, v, do))
    trow = tfa.as_key_padding_mask(torch.from_numpy(mask4), tq, tk)
    tgrads = tfa.flash_attention_bwd(
        tq, tk, tv, bf(jo), torch.from_numpy(jlse.reshape(b * h, s)), tdo,
        trow, causal=False, scale=1.0 / np.sqrt(d))
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(t.float().numpy(), j, atol=5e-2,
                                   rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
@pytest.mark.parametrize("causal", [False, True])
def test_jax_backward_gives_dead_key_blocks_exact_zeros(causal, stream,
                                                        interpret_pallas):
    """The premise of the dK/dV kernel's skipping, in the JAX package's own
    backward kernels: batch row 0's keys 64..127 are padding (-1e9) and
    its first live key is 0 (<= 64, so under causal too every row that
    sees them has a live key): their dk and dv are exactly 0.0.  Batch row
    1 has no live key (a dead row): p = 1 for each of its keys, so its
    dk and dv are not zero and its blocks must not be skipped."""
    b, h, s, d = 2, 2, 128, 64
    q, k, v, do = _inputs(b, h, s, d, seed=4)
    keep = np.ones((b, s), bool)
    keep[0, 64:] = False
    keep[1] = False
    mask4 = np.where(keep, 0.0, -1e9).astype(np.float32).reshape(b, 1, 1, s)
    _, _, (_, dk, dv) = _jax_backward(q, k, v, do, mask4, causal, stream)
    for name, g in (("dk", dk), ("dv", dv)):
        assert not g[0, :, 64:].any(), name
        assert np.abs(g[0, :, :64]).min(axis=-1).max() > 0, name
        assert np.abs(g[1]).max(axis=-1).min() > 0, name


def skipped_key_blocks(row, sk, causal, block=64):
    """The (batch row, block) pairs of ``block`` keys that the dK/dV kernel
    skips, by its rule (``dead_key_block`` in ``csrc/attention_tiles.cuh``):
    every key of the block is padding (<= -1e9) and every query row that
    sees the block has a live key, that is the batch row's first live key
    is at most the block's first key under causal, or exists at all."""
    skipped = set()
    if row is None:
        return skipped
    for bi in range(row.shape[0]):
        live = np.nonzero(row[bi] > -1e9)[0]
        if not len(live):
            continue
        for k0 in range(0, sk, block):
            block_live = ((live >= k0) & (live < k0 + block)).any()
            if not block_live and live[0] <= (k0 if causal else sk):
                skipped.add((bi, k0 // block))
    return skipped


def visited_key_blocks(row, b, h, sk, causal):
    """(blocks the dK/dV kernel visits, blocks there are) over b*h heads."""
    total = b * h * -(-sk // 64)
    return total - h * len(skipped_key_blocks(row, sk, causal)), total


@pytest.mark.parametrize("mask", ["valid_1", "valid_65", "valid_128",
                                  "dead_row", "additive",
                                  "causal_key_padding"])
def test_skipped_key_blocks_have_zero_dk_dv_in_plain_backward(mask):
    """Every block of 64 keys that the model of the dK/dV kernel's rule
    skips has exactly zero dk and dv in the plain backward, on the CPU
    (sk = 300 leaves a ragged last block); the valid_* cases skip some."""
    b, h, s, d = 3, 2, 300, 64
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(b, h, s, d, seed=8))
    row, _, causal = _key_mask(mask, b, s, seed=3)
    km = torch.from_numpy(row)
    o, lse = tfa.flash_attention_plain(q, k, v, km, causal=causal)
    _, dk, dv = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, km,
                                              causal=causal)
    skipped = skipped_key_blocks(row, s, causal)
    if mask.startswith("valid_"):
        assert skipped
    for bi, kb in skipped:
        for g in (dk, dv):
            assert not g[bi, :, 64 * kb:64 * (kb + 1)].any(), (bi, kb)


def _autograd_grads(fn, q, k, v, do):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*ts)
    return torch.autograd.grad(out, ts, torch.from_numpy(do))


@pytest.mark.parametrize("mask", ["none", "additive", "causal"])
def test_plain_backward_matches_autograd_of_the_oracle(mask):
    b, h, s, d = 2, 3, 96, 64
    q, k, v, do = _inputs(b, h, s, d, seed=5)
    row, mask4, causal = _key_mask(mask, b, s)
    scale = 1.0 / np.sqrt(d)
    ref = _autograd_grads(lambda a, c, e: sdpa_reference(
        a, c, e, None if mask4 is None else torch.from_numpy(mask4),
        scale=scale, causal=causal), q, k, v, do)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    km = None if row is None else torch.from_numpy(row)
    o, lse = tfa.flash_attention_plain(tq, tk, tv, km, causal=causal,
                                       scale=scale)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, km,
                                        causal=causal, scale=scale)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("mask", ["none", "additive", "causal"])
def test_function_on_cpu_matches_autograd_of_the_plain_forward(mask):
    """The autograd.Function's CPU path (plain forward, plain backward)
    against torch.autograd through the plain forward."""
    b, h, s, d = 2, 2, 70, 64
    q, k, v, do = _inputs(b, h, s, d, seed=7)
    row, _, causal = _key_mask(mask, b, s)
    km = None if row is None else torch.from_numpy(row)
    scale = 0.125
    ref = _autograd_grads(lambda a, c, e: tfa.flash_attention_plain(
        a, c, e, km, causal=causal, scale=scale)[0], q, k, v, do)
    before = (tfa.dq_counts.launches, tfa.dkv_counts.launches)
    got = _autograd_grads(lambda a, c, e: tfa.FlashAttentionFunction.apply(
        a, c, e, km, causal, scale), q, k, v, do)
    assert (tfa.dq_counts.launches, tfa.dkv_counts.launches) == before
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_entry_records_only_when_a_gradient_is_needed():
    """The entry goes through the Function only when autograd records and
    an input needs a gradient; its output then carries a graph, and the
    key-padding mask gets no gradient.  s=128: shorter lengths go to the
    oracle, as in the JAX entry."""
    b, h, s, d = 2, 2, 128, 64
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(b, h, s, d))
    assert tfa.flash_attention(q, k, v, mask=torch.zeros(b, 1, 1, s)) \
        .grad_fn is None
    qg = q.clone().requires_grad_(True)
    mask = torch.zeros(b, 1, 1, s, requires_grad=True)
    with torch.no_grad():
        assert tfa.flash_attention(qg, k, v, mask=mask).grad_fn is None
    out = tfa.flash_attention(qg, k, v, mask=mask)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    out.backward(do)
    assert qg.grad is not None and mask.grad is None


def _entry_mask(b, s):
    """An additive (b,1,1,s) mask: batch row 1 all padding (a dead row),
    row 0's last 10 keys padding."""
    keep = np.ones((b, s), bool)
    keep[1] = False
    keep[0, -10:] = False
    return np.where(keep, 0.0, -1e9).astype(np.float32).reshape(b, 1, 1, s)


@pytest.mark.parametrize("s,headdim64,flash", [
    (100, None, False), (128, None, True), (128, "0", False)],
    ids=["s100_oracle", "s128_flash", "s128_headdim64_off_oracle"])
def test_entry_gradients_match_jax_entry(s, headdim64, flash, monkeypatch,
                                         interpret_pallas):
    """On CPU tensors the port's entry routes as the JAX entry does: sq
    or sk below 128 or not a multiple of 128, and d=64 with
    ``MXTPU_FLASH_HEADDIM64=0``, go to the oracle; s=128 takes the flash
    formula.  Forward and the
    gradients of q, k and v agree within 1e-6 absolute plus 1e-6 relative
    (at s=128 the dead row's gradients reach ~18, where one fp32 ulp is
    2e-6); on the dead row the oracle's softmax gradient and the flash
    formula's differ by ~sk times, so a wrong route fails by far more."""
    import jax
    import jax.numpy as jnp

    from mxnet_tpu.ops.pallas.flash_attention import \
        flash_attention as jflash

    if headdim64 is None:
        monkeypatch.delenv("MXTPU_FLASH_HEADDIM64", raising=False)
        monkeypatch.delenv("MXNET_FLASH_HEADDIM64", raising=False)
    else:
        monkeypatch.setenv("MXTPU_FLASH_HEADDIM64", headdim64)
    b, h, d = 2, 2, 64
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(b, h, s, d).astype(np.float32) * 0.5
                   for _ in range(4))
    mask = _entry_mask(b, s)
    jo, vjp = jax.vjp(lambda a, c, e: jflash(a, c, e,
                                             mask=jnp.asarray(mask)),
                      *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*ts, mask=torch.from_numpy(mask))
    assert (type(out.grad_fn).__name__
            == "FlashAttentionFunctionBackward") == flash
    tgrads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               atol=1e-6, rtol=1e-6, err_msg="o")
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                                   rtol=1e-6, err_msg=name)


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU "
                    "mode); run on the GPU machine with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# causal runs at sq == sk only: the entry sends causal sq != sk to the
# oracle; at sk=512, valid lengths at tile edges and causal with key padding
CARD_CASES = ([(sq, sk, m) for sq, sk in ((128, 128), (100, 77), (1, 300))
               for m in MASKS if m != "causal" or sq == sk]
              + [(512, 512, f"valid_{n}") for n in TILE_EDGES]
              + [(512, 512, "causal_key_padding"),
                 (128, 128, "causal_key_padding")])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("sq,sk,mask", CARD_CASES)
def test_backward_kernels_match_plain_on_card(sq, sk, mask, d, dtype,
                                              cuda_device):
    """Each kernel against the plain backward: fp32 within 1e-4 absolute
    plus 1e-4 relative (sums over up to 300 keys in other orders), bf16
    within 3e-2 plus 2e-2 (outputs rounded to bf16)."""
    b, h = 2, 3
    rng = np.random.RandomState(11)
    dt = getattr(torch, dtype)
    q, do = (torch.from_numpy(rng.randn(b, h, sq, d).astype(np.float32)
                              * 0.5).to(cuda_device, dt) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, h, sk, d).astype(np.float32)
                             * 0.5).to(cuda_device, dt) for _ in range(2))
    row, _, causal = _key_mask(mask, b, sk)
    km = None if row is None else torch.from_numpy(row).to(cuda_device)
    o, lse = tfa.flash_attention_fwd(q, k, v, km, causal=causal)
    before = (tfa.dq_counts.launches, tfa.dkv_counts.launches)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, km, causal=causal)
    torch.cuda.synchronize()
    assert (tfa.dq_counts.launches, tfa.dkv_counts.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, km,
                                        causal=causal)
    atol, rtol = (1e-4, 1e-4) if dtype == "float32" else (3e-2, 2e-2)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dt and torch.isfinite(g).all(), name
        torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=name)


def _card_backward_inputs(b, h, s, d, dtype, mask, dev, seed=12):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32)
                                    * 0.5).to(dev, getattr(torch, dtype))
                   for _ in range(4))
    row, _, causal = _key_mask(mask, b, s)
    km = None if row is None else torch.from_numpy(row).to(dev)
    o, lse = tfa.flash_attention_fwd(q, k, v, km, causal=causal)
    delta = (do.float() * o.float()).sum(-1).reshape(b * h, s)
    return (q, k, v, do, lse, delta, km), o, causal


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
def test_dq_on_unaligned_views_matches_plain_on_card(mask, d, dtype,
                                                     cuda_device):
    """q, k, v and dO as views whose rows are not 16-byte aligned: the dQ
    and the dK/dV wrappers copy them and launch once each; tolerances as
    above."""
    args, o, causal = _card_backward_inputs(2, 3, 200, d, dtype, mask,
                                            cuda_device)
    q, k, v, do = (_unaligned(t) for t in args[:4])
    assert not any(tfa.rows_aligned(t) for t in (q, k, v, do))
    args = (q, k, v, do, *args[4:])
    before = (tfa.dq_counts.launches, tfa.dkv_counts.launches)
    dq = tfa.flash_attention_bwd_dq(*args, causal=causal)
    dk, dv = tfa.flash_attention_bwd_dkv(*args, causal=causal)
    torch.cuda.synchronize()
    assert (tfa.dq_counts.launches, tfa.dkv_counts.launches) == \
        (before[0] + 1, before[1] + 1)
    q, k, v, do, lse, _, km = args
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, km,
                                        causal=causal)
    atol, rtol = (1e-4, 1e-4) if dtype == "float32" else (3e-2, 2e-2)
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("mask", ["valid_1", "valid_65", "dead_row",
                                  "causal_key_padding"])
def test_dq_kernel_skips_tiles_and_repeats_bit_for_bit_on_card(
        mask, d, cuda_device):
    """The tensor-core dQ kernel skips dead key tiles (it visits fewer
    than all where a live row has a dead tile) and two launches on the
    same inputs are bit-identical."""
    args, _, causal = _card_backward_inputs(2, 3, 512, d, "float32", mask,
                                            cuda_device)
    tiles = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    dq1 = tfa._launch_dq(*args, causal, None, tiles=tiles)
    dq2 = tfa.flash_attention_bwd_dq(*args, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(dq1, dq2)
    visited, total = tiles.tolist()
    assert 0 < visited <= total
    if mask in ("valid_1", "valid_65"):
        assert visited < total


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("mask", ["valid_1", "valid_65", "valid_128",
                                  "dead_row", "causal_key_padding", "none"])
def test_dkv_kernel_skips_blocks_and_repeats_bit_for_bit_on_card(
        mask, d, dtype, cuda_device):
    """The dK/dV kernel visits exactly the blocks of 64 keys that the
    model of its rule keeps (skipped_key_blocks), the skipped blocks' dk
    and dv are zeros, the rest match the plain backward (tolerances as
    above), and two launches on the same inputs are bit-identical."""
    b, h, s = 2, 3, 512
    args, o, causal = _card_backward_inputs(b, h, s, d, dtype, mask,
                                            cuda_device)
    blocks = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    dk1, dv1 = tfa._launch_dkv(*args, causal, None, blocks=blocks)
    dk2, dv2 = tfa.flash_attention_bwd_dkv(*args, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    row, _, _ = _key_mask(mask, b, s)
    assert tuple(blocks.tolist()) == visited_key_blocks(row, b, h, s, causal)
    if mask.startswith("valid_"):
        assert blocks[0] < blocks[1]
    for bi, kb in skipped_key_blocks(row, s, causal):
        for g in (dk1, dv1):
            assert not g[bi, :, 64 * kb:64 * (kb + 1)].any()
    q, k, v, do, lse, _, km = args
    _, dk, dv = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, km,
                                              causal=causal)
    atol, rtol = (1e-4, 1e-4) if dtype == "float32" else (3e-2, 2e-2)
    for g, r in ((dk1, dk), (dv1, dv)):
        torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.gpu
def test_backward_reads_packed_head_views_on_card(cuda_device):
    """q, k, v as strided views of one packed QKV tensor and dO as the
    transposed view autograd hands over, read in place."""
    b, s, h, d = 2, 100, 3, 64
    rng = np.random.RandomState(9)
    packed = torch.from_numpy(rng.randn(b, s, 3 * h * d).astype(np.float32)
                              * 0.5).to(cuda_device)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in packed.chunk(3, dim=-1))
    do = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32)) \
        .to(cuda_device).transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    row, _, _ = _key_mask("dead_row", b, s)
    km = torch.from_numpy(row).to(cuda_device)
    o, lse = tfa.flash_attention_fwd(q, k, v, km)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, km)
    ref = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, km)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_attention_gradients_reach_attn_in_weight_on_card(cuda_device):
    """The repaired fault: on the card, the attention output must carry a
    graph, so the QKV projection's parameters get the attention part of
    their gradient.  The card's gradients equal the CPU's (at s=64 the
    oracle, as in the JAX entry; no row is dead) within 1e-4 plus 1e-4
    relative."""
    import mxnet_tpu_torch as tmx

    b, s = 2, 64
    rng = np.random.RandomState(2)
    x = rng.randn(b, s, 128).astype(np.float32)
    row = np.where(np.arange(s)[None] < np.array([[64], [40]]), 0.0,
                   -1e9).astype(np.float32).reshape(b, 1, 1, s)
    w_in = (rng.randn(384, 128) * 0.05).astype(np.float32)
    w_out = (rng.randn(128, 128) * 0.05).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda_device):
        params = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in (w_in, np.zeros(384, np.float32), w_out,
                            np.zeros(128, np.float32))]
        xt = torch.from_numpy(x).to(dev)
        before = tfa.dkv_counts.launches
        out = tmx.nd.multihead_attention(
            xt, xt, xt, *params, torch.from_numpy(row).to(dev), num_heads=2)
        out.square().sum().backward()
        grads[str(dev)] = [p.grad.cpu() for p in params]
        if dev != "cpu":
            assert tfa.dkv_counts.launches == before + 1
    cpu, card = grads["cpu"], grads[str(cuda_device)]
    assert float(card[0].abs().sum()) > 0 and float(card[1].abs().sum()) > 0
    for c, g in zip(cpu, card):
        torch.testing.assert_close(g, c, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [100, 128])
def test_entry_launches_at_every_length_on_card(s, cuda_device):
    """On the card the entry launches the forward and both backward
    kernels at every length: the JAX entry's length rule routes CPU
    tensors only.  The output and batch row 0's gradients equal the CPU
    entry's within 1e-4 plus 1e-4 relative.  The dead batch row's
    gradients are the flash formula's (the plain backward: p = 1 per key)
    at every length; at s=100 the CPU, as the JAX entry, gives the
    oracle's softmax gradients there instead, which differ by more than 1
    (ROADMAP.md, deliberate differences)."""
    b, h, d = 2, 2, 64
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(b, h, s, d).astype(np.float32) * 0.5
                   for _ in range(4))
    mask = _entry_mask(b, s)
    outs, grads = {}, {}
    for dev in ("cpu", cuda_device):
        ts = [torch.from_numpy(x).to(dev).requires_grad_(True)
              for x in (q, k, v)]
        before = (tfa.counts.launches, tfa.dq_counts.launches,
                  tfa.dkv_counts.launches, tfa.counts.plain_calls_on_cuda)
        out = tfa.flash_attention(*ts, mask=torch.from_numpy(mask).to(dev))
        g = torch.autograd.grad(out, ts, torch.from_numpy(do).to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            after = (tfa.counts.launches, tfa.dq_counts.launches,
                     tfa.dkv_counts.launches, tfa.counts.plain_calls_on_cuda)
            assert after == (before[0] + 1, before[1] + 1, before[2] + 1,
                             before[3])
        outs[str(dev)] = out.detach().cpu()
        grads[str(dev)] = [t.cpu() for t in g]
    cpu, card = grads["cpu"], grads[str(cuda_device)]
    torch.testing.assert_close(outs[str(cuda_device)], outs["cpu"],
                               atol=1e-4, rtol=1e-4)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    km = torch.from_numpy(mask.reshape(b, s))
    o, lse = tfa.flash_attention_plain(qt, kt, vt, km)
    flash = tfa.flash_attention_bwd_plain(qt, kt, vt, o, lse, dot, km)
    for name, c, g, f in zip(("dq", "dk", "dv"), cpu, card, flash):
        torch.testing.assert_close(g[0], c[0], atol=1e-4, rtol=1e-4,
                                   msg=name)
        torch.testing.assert_close(g[1], f[1], atol=1e-4, rtol=1e-4,
                                   msg=name)
    gap = max(float((g[1] - c[1]).abs().max()) for g, c in zip(card, cpu))
    assert (gap > 1.0) == (s == 100), gap


@pytest.mark.gpu
def test_backward_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 64, 64, device=cuda_device)
    lse = torch.zeros(2, 64, device=cuda_device)
    with pytest.raises(MXNetError, match="lse"):
        tfa.flash_attention_bwd(q, q, q, q, lse.reshape(1, 2, 64), q)
    q96 = torch.zeros(1, 2, 64, 96, device=cuda_device)
    with pytest.raises(MXNetError, match="head dims"):
        tfa.flash_attention_bwd(q96, q96, q96, q96, lse, q96)
