#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result):

1. device: the card's name, count and power limit;
2. build: every kernel of the port built from ``mxnet_tpu_torch/csrc``
   (one nvcc per source, in parallel), with nvcc's ``-Xptxas -v`` report;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it, timed beside the plain version, the
   PyTorch library call that computes the same function, and the least
   time the card could take;
   The backward kernels (dQ, dK/dV) are held against the plain backward
   at the training shape (b=32, h=12, s=128, d=64), the serving shape
   (b=8, h=12, s=512, d=64) and d=128, in fp32 and bf16, with no mask, a
   key-padding mask with a dead row, and causal; and the autograd
   Function's gradients against autograd through the plain forward;
4. serve: BERT-base (12 layers, 768 units, 12 heads of 64, vocab 30522,
   random weights from a seed) behind ``serve.ModelServer``, 32 requests
   from 4 client threads; the kernels' launch counts are read around this
   run, and 3 responses are compared with the same weights on the CPU;
5. train: BERT-base with MLM+NSP heads (dropout 0.1) takes 20 AdamW steps
   through ``autograd.record``, ``backward`` and ``gluon.Trainer`` at
   batch 32, sequence 128, fp32; the launch counts are read around the
   20 steps; every trainable parameter must have a finite gradient after
   the first backward and the loss must fall; then 2 steps at batch 4
   with dropout 0 on the card and on the CPU from the same weights must
   agree.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Needs one CUDA device, the
CUDA toolkit, and the repository beside this file.

    python3 chip_smoke.py --profile-train

also writes a ``torch.profiler`` table of two training steps to
``chiprun_out/train_profile.txt`` and prints its top rows.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): CUDA-core fp32 and tensor-core
# bf16 FLOP/s, and HBM3 bytes/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

SERVE_REQUESTS = 32
SERVE_THREADS = 4
# fp32 card vs CPU after 12 encoder layers: matmuls sum in other orders
# on the two devices (TF32 off); outputs are LayerNorm-scaled, O(1)
CPU_ATOL = 1e-3

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 32, 128, 20
# training, card vs CPU from the same weights (fp32, TF32 off, dropout 0):
# the two losses within 1e-4 relative, and layer 0's attn_in_weight
# gradient within 1e-3 of its largest magnitude (12 layers of backward
# summed in other orders on the two devices)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
# backward kernels vs their plain version: fp32 sums over up to 512 keys
# in other orders; bf16 outputs are rounded to bf16
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 2e-2)}


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean time of ``fn`` on the card, from CUDA events around ``iters``
    calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3: flash attention forward ---------------------------------------


def valid_pairs(b, h, sq, sk, valid, causal):
    """The (query, key) pairs a call's rows attend to: their valid keys,
    or under causal the keys up to each row."""
    if causal:
        return b * h * sum(min(i + 1, sk) for i in range(sq))
    if valid is not None:
        return h * sq * int(sum(valid))
    return b * h * sq * sk


def least_ms(nbytes, flops, dtype):
    """The least time (ms) for ``nbytes`` moved at the memory rate and
    ``flops`` at the peak rate of ``dtype``, and which of the two bounds
    it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(b, h, sq, sk, d, dtype, valid, causal):
    """Least time (ms) of the forward: q, k, v and the mask read once, o
    and lse written once, and the QK and PV products over the valid
    pairs."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (b * h * (sq + 2 * sk) * d * item + b * h * sq * d * item
              + b * h * sq * 4 + (b * sk * 4 if valid is not None else 0))
    pairs = valid_pairs(b, h, sq, sk, valid, causal)
    return least_ms(nbytes, 4.0 * pairs * d, dtype)


def check_flash_attention(mx):
    """Kernel vs plain at BERT-base attention shapes; returns the record
    of the main-path case (fp32, key padding, b=8, h=12, s=512, d=64).

    q, k and v are strided views of one packed ``(b, s, 3*h*d)`` tensor,
    the layout the attention op hands the kernel (the packed QKV
    projection split into heads without a copy)."""
    import numpy as np
    import torch
    import torch.nn.functional as tF

    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda", 0)
    tol = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 1e-3)}
    rng = np.random.RandomState(0)
    main = None
    log("flash_attention_fwd: kernel vs plain (o atol / lse atol: fp32 "
        "1e-4 / 1e-3, bf16 2e-2 / 1e-3); q, k, v are head views of a "
        "packed QKV tensor")
    for d, h in ((64, 12), (128, 6)):
        b, s = 8, 512
        packed = torch.from_numpy(rng.randn(b, s, 3 * h * d)
                                  .astype(np.float32) * 0.5).to(dev)
        valid = np.array([512, 500, 384, 300, 256, 130, 17, 0])
        keep = torch.from_numpy(np.arange(s)[None, :] < valid[:, None])
        row = torch.where(keep, 0.0, -1e9).to(dev, torch.float32)
        for dtype in ("float32", "bfloat16"):
            q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in
                       packed.to(getattr(torch, dtype)).chunk(3, dim=-1))
            for mask in ("none", "key_padding", "causal"):
                km = row if mask == "key_padding" else None
                causal = mask == "causal"
                o, lse = fa.flash_attention_fwd(q, k, v, km, causal=causal)
                po, plse = fa.flash_attention_plain(q, k, v, km,
                                                    causal=causal)
                torch.cuda.synchronize()
                o_err = (o.float() - po.float()).abs().max().item()
                lse_err = ((lse - plse).abs()
                           / (1.0 + 1e-6 * plse.abs())).max().item()
                finite = bool(torch.isfinite(o).all())
                ok = finite and o_err <= tol[dtype][0] and \
                    lse_err <= tol[dtype][1]
                kern_ms = cuda_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, km, causal=causal), iters=20)
                plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
                    q, k, v, km, causal=causal), iters=5)
                attn_mask = None if km is None else \
                    km.to(q.dtype).view(b, 1, 1, s)
                lib_ms = cuda_ms(lambda: tF.scaled_dot_product_attention(
                    q, k, v, attn_mask=attn_mask, is_causal=causal),
                    iters=20)
                bound_ms, bound_by = attention_bound(
                    b, h, s, s, d, dtype,
                    valid if mask == "key_padding" else None, causal)
                log(f"  b={b} h={h} s={s} d={d} {dtype:8s} {mask:11s} "
                    f"o_err={o_err:.3g} lse_err={lse_err:.3g} "
                    f"kernel={kern_ms:.4f}ms plain={plain_ms:.4f}ms "
                    f"sdpa={lib_ms:.4f}ms bound={bound_ms:.4f}ms "
                    f"({bound_by}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"flash attention kernel disagrees "
                                     f"with its plain version: d={d} "
                                     f"{dtype} {mask}")
                if (d, dtype, mask) == (64, "float32", "key_padding"):
                    main = {"max_abs_err": o_err, "ms": kern_ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": lib_ms}
    return main


def bwd_bound(b, h, sq, sk, d, dtype, valid, causal, n_ops, n_out):
    """Least time (ms) of one backward kernel: q, k, v, dO read once, lse
    and delta (fp32) and the mask read once, ``n_out`` (b,h,s,d) outputs
    written once; ``n_ops * d`` operations per valid pair."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (b * h * (2 * sq + 2 * sk) * d * item + 2 * b * h * sq * 4
              + (b * sk * 4 if valid is not None else 0)
              + n_out * b * h * sq * d * item)
    pairs = valid_pairs(b, h, sq, sk, valid, causal)
    return least_ms(nbytes, float(n_ops) * pairs * d, dtype)


def check_flash_attention_bwd(mx):
    """dQ and dK/dV kernels vs the plain backward; returns the records of
    the main-path case (fp32, key padding, the training shape) and the
    forward kernel's time at that shape.

    q, k and v are head views of one packed ``(b, s, 3*h*d)`` tensor and
    dO a head view of a ``(b, s, h*d)`` one, the layouts autograd hands
    the kernels in training."""
    import numpy as np
    import torch
    import torch.nn.functional as tF

    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(2)
    main = {}
    log(f"flash_attention_bwd: dQ and dK/dV kernels vs plain (fp32 atol/"
        f"rtol {BWD_TOL['float32']}, bf16 {BWD_TOL['bfloat16']}); the "
        f"key-padding case has a dead row except at the training shape's "
        f"main case")
    shapes = (("train", TRAIN_BATCH, 12, TRAIN_SEQ, 64),
              ("serve", 8, 12, 512, 64), ("d128", 8, 6, 512, 128))
    for label, b, h, s, d in shapes:
        packed = torch.from_numpy(rng.randn(b, s, 3 * h * d)
                                  .astype(np.float32) * 0.5).to(dev)
        dout = torch.from_numpy(rng.randn(b, s, h * d)
                                .astype(np.float32)).to(dev)
        if label == "train":
            valid = rng.randint(32, s + 1, size=b)
        else:
            valid = np.array([512, 500, 384, 300, 256, 130, 17, 0])
        cases = ["none", "key_padding", "causal"]
        if label == "train":
            cases.insert(1, "key_padding_dead_row")
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in
                       packed.to(dt).chunk(3, dim=-1))
            do = dout.to(dt).reshape(b, s, h, d).transpose(1, 2)
            for mask in cases:
                vl = valid.copy()
                if mask == "key_padding_dead_row":
                    vl[-1] = 0
                keep = torch.from_numpy(np.arange(s)[None, :] < vl[:, None])
                km = torch.where(keep, 0.0, -1e9).to(dev, torch.float32) \
                    if mask.startswith("key_padding") else None
                causal = mask == "causal"
                o, lse = fa.flash_attention_fwd(q, k, v, km, causal=causal)
                dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, km,
                                                    causal=causal)
                ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, km,
                                                   causal=causal)
                torch.cuda.synchronize()
                atol, rtol = BWD_TOL[dtype]
                errs, ok = [], True
                for g, r in zip((dq, dk, dv), ref):
                    errs.append((g.float() - r.float()).abs().max().item())
                    ok = ok and bool(torch.isfinite(g).all()) and \
                        torch.allclose(g.float(), r.float(), atol=atol,
                                       rtol=rtol)
                delta = (do.float() * o.float()).sum(-1).reshape(b * h, s)
                args = (q, k, v, do, lse, delta, km)
                dq_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq(
                    *args, causal=causal), iters=20)
                dkv_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv(
                    *args, causal=causal), iters=20)
                plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
                    q, k, v, o, lse, do, km, causal=causal), iters=5)
                lib_ms = sdpa_backward_ms(tF, q, k, v, do, km, causal)
                dvalid = vl if km is not None else None
                dq_bound = bwd_bound(b, h, s, s, d, dtype, dvalid, causal,
                                     6, 1)
                dkv_bound = bwd_bound(b, h, s, s, d, dtype, dvalid, causal,
                                      8, 2)
                log(f"  {label:5s} b={b} h={h} s={s} d={d} {dtype:8s} "
                    f"{mask:20s} err dq/dk/dv {errs[0]:.3g}/{errs[1]:.3g}/"
                    f"{errs[2]:.3g} dQ={dq_ms:.4f}ms (bound "
                    f"{dq_bound[0]:.4f} {dq_bound[1]}) dKdV={dkv_ms:.4f}ms "
                    f"(bound {dkv_bound[0]:.4f} {dkv_bound[1]}) "
                    f"plain={plain_ms:.4f}ms sdpa_bwd={lib_ms:.4f}ms "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"flash attention backward kernels "
                                     f"disagree with their plain version: "
                                     f"{label} {dtype} {mask}")
                if (label, dtype, mask) == ("train", "float32",
                                            "key_padding"):
                    fwd_ms = cuda_ms(lambda: fa.flash_attention_fwd(
                        q, k, v, km), iters=20)
                    for name, ms, err, (bms, bby) in (
                            ("dq", dq_ms, errs[0], dq_bound),
                            ("dkv", dkv_ms, max(errs[1:]), dkv_bound)):
                        main[name] = {"max_abs_err": err, "ms": ms,
                                      "plain_ms": plain_ms, "bound_ms": bms,
                                      "bound_by": bby, "library_ms": lib_ms}
                    main["fwd_ms"] = fwd_ms
                    log(f"  train shape fp32 key padding: forward kernel "
                        f"{fwd_ms:.4f} ms")
    check_function_gradients(fa, dev, rng)
    return main


def sdpa_backward_ms(tF, q, k, v, do, km, causal):
    """The backward of ``scaled_dot_product_attention`` at the same shape
    and mask, timed on its own (the graph is kept across calls)."""
    import torch

    b, s = q.shape[0], q.shape[2]
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    attn_mask = None if km is None else km.to(q.dtype).view(b, 1, 1, s)
    out = tF.scaled_dot_product_attention(qs, ks, vs, attn_mask=attn_mask,
                                          is_causal=causal)
    return cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                               retain_graph=True), iters=10)


def check_function_gradients(fa, dev, rng):
    """The autograd Function on the card (kernel forward and backward)
    against torch.autograd through the plain forward, fp32, key padding
    without dead rows: within 1e-4 absolute plus 1e-4 relative."""
    import numpy as np
    import torch

    b, h, s, d = 4, 12, 128, 64
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32)
                                    * 0.5).to(dev) for _ in range(4))
    keep = torch.from_numpy(np.arange(s)[None, :]
                            < np.array([[128], [100], [64], [33]]))
    km = torch.where(keep, 0.0, -1e9).to(dev, torch.float32)
    grads = []
    for fn in (lambda a, c, e: fa.FlashAttentionFunction.apply(
                   a, c, e, km, False, 0.125),
               lambda a, c, e: fa.flash_attention_plain(
                   a, c, e, km, scale=0.125)[0]):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*ts), ts, do))
    err = max((g - r).abs().max().item() for g, r in zip(*grads))
    ok = all(torch.allclose(g, r, atol=1e-4, rtol=1e-4)
             for g, r in zip(*grads))
    log(f"FlashAttentionFunction on the card vs autograd of the plain "
        f"forward: max abs err {err:.3g} (atol 1e-4 rtol 1e-4) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the autograd Function's gradients disagree with "
                         "autograd through the plain forward")


# -- phase 4: serving --------------------------------------------------------


def serving_block(mx):
    import torch

    class BertServing(mx.gluon.HybridBlock):
        """Token ids (B, S) -> (sequence, pooled); id 0 is padding."""

        def __init__(self, bert, **kwargs):
            super().__init__(**kwargs)
            self.bert = bert

        def hybrid_forward(self, F, ids):
            valid = (ids != 0).sum(dim=1).to(torch.float32)
            return self.bert(ids, torch.zeros_like(ids), valid)

    return BertServing


def serve_bert(mx, card, attn_ms):
    import numpy as np

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    BertServing = serving_block(mx)
    mx.random.seed(0)
    bert = mx.models.bert_base(use_decoder=False, use_classifier=False)
    bert.initialize(init=mx.init.Normal(0.02), ctx=mx.gpu(0))
    net = BertServing(bert)
    spec = mx.serve.BucketSpec(batch_sizes=(1, 4, 8), example_shape=(None,),
                               lengths=(128, 256, 512), dtype="int32")
    rng = np.random.RandomState(1)
    lengths = rng.randint(16, 513, size=SERVE_REQUESTS)
    reqs = [rng.randint(1, 30522, size=int(n)).astype(np.int32)
            for n in lengths]
    results = [None] * SERVE_REQUESTS
    server = mx.serve.ModelServer(net, spec, ctx=mx.gpu(0))

    kernels.reset_counts()
    t0 = time.perf_counter()
    server.start()
    t_warm = time.perf_counter() - t0

    def client(idx):
        futs = [(i, server.submit(reqs[i])) for i in idx]
        for i, f in futs:
            results[i] = f.result(timeout=300)

    threads = [threading.Thread(
        target=client, args=(range(c, SERVE_REQUESTS, SERVE_THREADS),))
        for c in range(SERVE_THREADS)]
    t1 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t1
    server.shutdown(drain=True, timeout=120)
    launches = fa.counts.launches
    plain_on_cuda = fa.counts.plain_calls_on_cuda

    if any(t.is_alive() for t in threads):
        raise SystemExit("serve: client threads did not finish")
    st = server.stats()
    n_batches = st["batches"] + st["warmup_batches"]
    log(f"serve: warmup {st['warmup_batches']} buckets in {t_warm:.2f}s; "
        f"{st['served']}/{SERVE_REQUESTS} served in {st['batches']} "
        f"batches, {wall:.3f}s wall, {SERVE_REQUESTS / wall:.2f} req/s; "
        f"latency p50 {st['latency']['p50_ms']} ms p99 "
        f"{st['latency']['p99_ms']} ms; bucket hits {st['bucket_hits']} "
        f"on {card}")
    log(f"serve: graph {st['graph']}; flash launches {launches} "
        f"(12 x {n_batches} batches = {12 * n_batches}); plain calls on "
        f"cuda {plain_on_cuda}")
    checks = {
        "served": st["served"] == SERVE_REQUESTS and st["failed"] == 0,
        "post_warmup_compiles": st["graph"]["post_warmup_compiles"] == 0,
        "launches": launches == 12 * n_batches,
        "plain_calls_on_cuda": plain_on_cuda == 0,
        "shapes": all(seq.shape == (len(r), 768) and pooled.shape == (768,)
                      and np.isfinite(seq).all() and np.isfinite(pooled).all()
                      for r, (seq, pooled) in zip(reqs, results)),
    }

    # the largest bucket's forward timed alone, beside its 12 attention
    # launches timed in the kernel phase at the same shape
    big = mx.nd.array(spec.pad_batch(reqs[:8], 8, 512), ctx=mx.gpu(0))
    fwd_ms = cuda_ms(lambda: net(big), iters=5)
    log(f"serve: b8xl512 forward {fwd_ms:.3f} ms; 12 flash launches x "
        f"{attn_ms:.4f} ms = {12 * attn_ms / fwd_ms:.1%} of it")

    # the same weights on the CPU (plain attention), three requests
    cpu_bert = mx.models.bert_base(use_decoder=False, use_classifier=False)
    cpu_bert.initialize(ctx=mx.cpu())
    mx.load_numpy_params(cpu_bert, {
        k: p.data().detach().cpu().numpy()
        for k, p in bert._collect_params_with_prefix().items()})
    cpu_net = BertServing(cpu_bert)
    cpu_err = 0.0
    for i in range(3):
        seq, pooled = cpu_net(mx.nd.array(reqs[i][None], ctx=mx.cpu()))
        cpu_err = max(cpu_err,
                      float(np.abs(seq.asnumpy()[0] - results[i][0]).max()),
                      float(np.abs(pooled.asnumpy()[0] - results[i][1]).max()))
    checks["cpu_parity"] = cpu_err <= CPU_ATOL
    log(f"serve: card vs cpu max abs err over 3 responses {cpu_err:.3g} "
        f"(atol {CPU_ATOL})")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"serve checks failed: {failed}")
    return {"launches": launches}


# -- phase 5: training -------------------------------------------------------


def pretrain_block(mx):
    class BERTForPretrain(mx.gluon.HybridBlock):
        """MLM + NSP loss head over the backbone, one scalar loss out
        (after examples/bert/pretrain_bert.py)."""

        def __init__(self, model, **kwargs):
            super().__init__(**kwargs)
            self.model = model

        def hybrid_forward(self, F, inputs, token_types, mlm_targets,
                           nsp_labels, mask_weight, valid_length,
                           masked_positions):
            mlm_scores, nsp_scores = self.model(inputs, token_types,
                                                valid_length,
                                                masked_positions)
            mlm_log = F.log_softmax(mlm_scores)
            mlm_ll = F.pick(mlm_log, mlm_targets, axis=-1)
            mlm_loss = -F.sum(mlm_ll * mask_weight) / (F.sum(mask_weight) + 1)
            nsp_log = F.log_softmax(nsp_scores)
            nsp_loss = -F.mean(F.pick(nsp_log, nsp_labels, axis=-1))
            return mlm_loss + nsp_loss

    return BERTForPretrain


def synthetic_batch(rng, bs, seq_len, vocab, mask_frac=0.15):
    """examples/bert/pretrain_bert.py's recipe, with valid lengths drawn
    in [32, seq_len] and padding ids 0, so the key-padding mask reaches
    the attention kernels."""
    import numpy as np

    K = max(1, int(round(seq_len * mask_frac)))
    valid = rng.randint(32, seq_len + 1, bs)
    tokens = rng.randint(4, vocab, (bs, seq_len))
    tokens[np.arange(seq_len)[None, :] >= valid[:, None]] = 0
    types = np.zeros((bs, seq_len), np.int32)
    types[:, seq_len // 2:] = 1
    positions = np.stack([rng.choice(v, K, replace=False)
                          for v in valid]).astype(np.int32)
    targets = np.take_along_axis(tokens, positions, 1)
    inputs = tokens.copy()
    np.put_along_axis(inputs, positions, 3, 1)  # 3 = [MASK]
    weights = np.ones((bs, K), np.float32)
    nsp = rng.randint(0, 2, (bs,))
    return (inputs.astype(np.int32), types, targets.astype(np.int32),
            nsp.astype(np.int32), weights, valid.astype(np.float32),
            positions)


def pretrain_net(mx, ctx, dropout):
    mx.random.seed(0)
    net = pretrain_block(mx)(mx.models.bert_base(
        use_decoder=True, use_classifier=True, dropout=dropout))
    net.initialize(init=mx.init.Normal(0.02), ctx=ctx)
    return net


def train_step(mx, net, trainer, batch):
    with mx.autograd.record():
        loss = net(*batch)
    loss.backward()
    trainer.step(1)
    return loss


def train_bert(mx, card, attn_ms, profile=False):
    """20 AdamW steps of BERT-base MLM+NSP at b=32, s=128 on the card;
    then card vs CPU at b=4 with dropout 0.  Returns the launch counts."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    gpu = mx.gpu(0)
    net = pretrain_net(mx, gpu, dropout=0.1)
    data = synthetic_batch(np.random.RandomState(3), TRAIN_BATCH, TRAIN_SEQ,
                           30522)
    batch = [mx.nd.array(a, ctx=gpu) for a in data]
    trainer = mx.gluon.Trainer(net.collect_params(), "adamw",
                               {"learning_rate": 1e-4, "wd": 0.01})
    params = net.collect_params()
    losses, step_ms, missing = [], [], []

    kernels.reset_counts()
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = net(*batch)
        loss.backward()
        if step == 0:  # the gradient the card used to lose
            for name, p in params.items():
                g = p.data().grad
                if p.grad_req != "null" and (
                        g is None or not bool(torch.isfinite(g).all())):
                    missing.append(name)
        trainer.step(1)
        losses.append(loss.asscalar())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {name: c.launches for name, c in kernels.KERNEL_COUNTS.items()}
    plain_on_cuda = fa.counts.plain_calls_on_cuda

    median_ms = statistics.median(step_ms[2:])
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (median_ms / 1e3)
    n = TRAIN_STEPS
    log(f"train: BERT-base MLM+NSP b={TRAIN_BATCH} s={TRAIN_SEQ} fp32 "
        f"AdamW, {n} steps; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"step median {median_ms:.3f} ms over steps 3-{n} (first "
        f"{step_ms[0]:.1f} ms), {tokens_s:.0f} tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    log(f"train: losses {[round(x, 4) for x in losses]}")
    log(f"train: launches {counts} (12 x {n} = {12 * n} each); plain calls "
        f"on cuda {plain_on_cuda}; attention kernels at this shape (fwd "
        f"{attn_ms['fwd_ms']:.4f} + dQ {attn_ms['dq']['ms']:.4f} + dK/dV "
        f"{attn_ms['dkv']['ms']:.4f} ms) x 12 = "
        f"{12 * (attn_ms['fwd_ms'] + attn_ms['dq']['ms'] + attn_ms['dkv']['ms']) / median_ms:.1%}"
        f" of the median step")
    checks = {
        "finite_losses": all(np.isfinite(losses)),
        "loss_falls": losses[-1] < losses[0],
        "first_backward_gradients": not missing,
        "launches": all(c == 12 * n for c in counts.values()),
        "plain_calls_on_cuda": plain_on_cuda == 0,
    }
    if missing:
        log(f"train: parameters without a finite gradient after the first "
            f"backward: {missing}")
    if profile:
        profile_steps(mx, net, trainer, batch)
    del net, trainer, batch
    torch.cuda.empty_cache()
    checks.update(train_card_vs_cpu(mx, data))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"train checks failed: {failed}")
    return counts


def train_card_vs_cpu(mx, data):
    """Two AdamW steps at b=4 with dropout 0 on the card and on the CPU from
    the same initial weights: the losses and layer 0's attn_in_weight
    gradient after the first backward must agree."""
    import numpy as np

    out = []
    weights = None
    small = [a[:4] for a in data]
    for ctx in (mx.gpu(0), mx.cpu()):
        net = pretrain_net(mx, ctx, dropout=0.0)
        batch = [mx.nd.array(a, ctx=ctx) for a in small]
        if weights is None:
            with mx.autograd.pause():
                net(*batch)  # completes the deferred shapes
            weights = {k: p.data().detach().cpu().numpy().copy()
                       for k, p in net._collect_params_with_prefix().items()}
        else:
            mx.load_numpy_params(net, weights)
        trainer = mx.gluon.Trainer(net.collect_params(), "adamw",
                                   {"learning_rate": 1e-4, "wd": 0.01})
        losses = []
        for step in range(2):
            losses.append(train_step(mx, net, trainer, batch).asscalar())
            if step == 0:
                p = net._collect_params_with_prefix()[
                    "model.encoder.layers.0.attn_in_weight"]
                grad = p.grad().detach().cpu().numpy().copy()
        out.append((losses, grad))
    (gl, gg), (cl, cg) = out
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    grad_err = float(np.abs(gg - cg).max() / np.abs(cg).max())
    log(f"train: card vs cpu, b=4 s={TRAIN_SEQ} dropout 0, 2 AdamW steps: "
        f"losses card {gl} cpu {cl}, max rel err {loss_err:.3g} (rtol "
        f"{TRAIN_LOSS_RTOL}); layer 0 attn_in_weight gradient max abs err "
        f"/ max |grad| {grad_err:.3g} (rtol {TRAIN_GRAD_RTOL})")
    return {"card_vs_cpu_loss": loss_err <= TRAIN_LOSS_RTOL,
            "card_vs_cpu_grad": grad_err <= TRAIN_GRAD_RTOL}


def profile_steps(mx, net, trainer, batch):
    """A torch.profiler table of two training steps, by CUDA time, into
    chiprun_out/train_profile.txt; its top rows are printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tprofile(activities=acts) as prof:
        for _ in range(2):
            train_step(mx, net, trainer, batch)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=60)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_profile.txt").write_text(table)
    log("train profile (2 steps, by CUDA time):")
    log("\n".join(table.splitlines()[:28]))


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-train", action="store_true",
                    help="also profile two training steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "mxnet_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the mxnet_tpu_torch package is not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import kernels

    # fp32 comparisons are in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"device: {name} x{count}; nvidia-smi: {card}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t = time.perf_counter()
    kernels.build_all_kernels()
    log(f"build: {time.perf_counter() - t:.1f}s")
    for lib in kernels.KERNEL_LIBRARIES:
        log(f"build log of {lib.source.name}:\n{lib.build_log}")

    flash = check_flash_attention(mx)
    bwd = check_flash_attention_bwd(mx)
    serve = serve_bert(mx, card, flash["ms"])
    train = train_bert(mx, card, bwd, profile=args.profile_train)

    src = "mxnet_tpu/ops/pallas/flash_attention.py"
    fwd_launches = serve["launches"] + train["flash_attention_fwd"]
    record = {"kernels": [
        dict(name="flash_attention_fwd", route="cuda",
             source="mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces=f"{src}:30,104", launches=fwd_launches,
             launches_by_path={"serve": serve["launches"],
                               "train": train["flash_attention_fwd"]},
             **flash),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source="mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces=f"{src}:427,252",
             launches=train["flash_attention_bwd_dq"], **bwd["dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source="mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces=f"{src}:471,299",
             launches=train["flash_attention_bwd_dkv"], **bwd["dkv"]),
    ]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
