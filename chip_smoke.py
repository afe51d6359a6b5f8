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
   Function's gradients against autograd through the plain forward.
   The fp32 attention bounds are at the 3xTF32 rate (the CUDA-core bound
   printed beside); the share of key tiles the forward and dQ kernels
   visit and of 64-key blocks the dK/dV kernel visits (held to a model
   of its rule), their wrappers' host time per call, the SASS opcode mix
   of their kernels and SDPA's kernels (its backend, read by
   torch.profiler in a process of its own) are printed, and at the
   training shape dK/dV against 8/14 of SDPA's backward and dQ + dK/dV
   against all of it, in the same call (printed, not gated);
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
   agree;
6. ResNet kernels: the BatchNorm-statistics kernel and the three fused
   1x1-convolution kernels against their plain versions at every shape
   ResNet-50 gives them (batch 128 at 224^2 in training, 64 in predict
   mode), in fp32 and bf16, with and without ReLU, timed beside the plain
   version, a library yardstick (``torch.var_mean``; ``torch.matmul`` at
   the same shape, the product alone) and the least time; the
   BN-statistics kernel also by its device time from torch.profiler and
   its wrapper's host time a call, at all four stage shapes; at each bf16
   training shape the fused kernels' TMA route and simple route are held
   against each other and timed side by side (also by their device time
   from torch.profiler), and the fused forward of one step is summed from
   them; fp32 ``bn_act_matmul`` (the predict forward's) runs on its TF32
   route, bound at the 3xTF32 rate (the CUDA-core bound beside), held
   against the simple route and timed beside it and ``torch.matmul`` at
   all four predict shapes, summed over one forward's 16 launches; and
   their autograd Functions against autograd through the plain forwards;
7. ResNet training: ResNet-50 v1, NHWC, 1000 classes, with
   ``MXTPU_CONV_EPILOGUE=pallas``, takes 20 steps through
   ``parallel.DataParallelTrainer`` (SGD, lr 0.1, momentum 0.9, wd 1e-4,
   bf16 compute, fp32 masters) at batch 128, 224^2, on one synthetic
   batch; the launch counts are read around the 20 steps, every fused
   launch must have taken the TMA route and every BN-statistics launch
   the 16-byte loads (none its scalar route); the losses after the first two
   updates must be below the first, every trainable parameter change and
   stay finite, the moving statistics move; then the first 4 steps again
   from the same weights with the fused kernels pinned to the simple
   route (PR 3's template), whose losses the TMA run's must track;
8. ResNet predict: the trained net in predict mode at batch 64, fp32; the
   launches of ``bn_act_matmul`` are read around the timed forwards, and
   every one must have taken the TF32 route;
9. ResNet references, fp32 with TF32 off, batch 8 at 112^2: 2 steps of the
   fused net on the card, the same on the CPU, and the standard (unfused)
   net on the card, from the same weights, must agree; the fused net on
   the card with its input moved by one ulp gives the floor of those gaps;
10. RNN kernels: the LSTM and GRU forward and backward kernels against
    their plain versions (every forward output and every gradient) at
    DeepAR training (T=96, N=32, H=40), DeepAR predict (T=73 and 96,
    N=1600; T=96, N=3200), the GRU phase (T=35, N=32, H=200) and a
    large-H LSTM (T=35, N=32, H=512), in fp32 and bf16, each kernel run
    twice for bit-identity; timed beside the plain versions, the bound,
    and cuDNN's layer (``torch.nn.LSTM``/``GRU``, fp32) against the port's
    layer (input GEMM plus kernel), forward and backward; the LSTM forward
    and the GRU backward on every route that takes the shape (register,
    tensor-core, cluster, split), each held against the plain version;
    at the main paths' shapes (DeepAR training and predict, the GRU
    phase; fp32) the planned route timed beside the split route and by
    torch.profiler's device time; the redesigned routes' kernels must
    show 0 spill bytes in nvcc's report; the wrappers' host time a call
    at the main shapes; and the autograd Functions against autograd
    through the plain forwards;
11. DeepAR train: ``deepar(40, 2)`` (GluonTS defaults: 2x40 LSTM,
    Student-t head, dropout 0.1), Xavier, 20 Adam steps (lr 1e-3) at
    batch 32, context 72 + prediction 24, on fresh covariate batches from
    ``data.timeseries.InstanceSplitter`` over ``synthetic_dataset``; the
    launch counts are read around the 20 steps, every ``lstm_fwd`` on
    the register route; every parameter must have a finite gradient after
    the first backward and the mean NLL of the last 5 steps must be below
    the first;
12. DeepAR predict: 16 context series of 72 points, 100 samples each
    (N=1600), 24 sampling steps; then 32 series (GluonTS's default predict
    batch: N=3200, past the JAX package's size rule for its kernel); the
    launches are read around each, every one on the tensor-core route;
13. DeepAR card vs CPU: the same weights, dropout 0, fp32, batch 4: the
    first NLL, ``lstm.l0_h2h_weight``'s gradient, 2 Adam steps' losses,
    the first predict step's (mu, sigma, nu) (``DeepARNetwork.next_params``,
    which ``predict`` calls) and ``predict``'s paths must agree;
14. GRU: ``gluon.rnn.GRU(200, num_layers=2)``, TNC, T=35, N=32, input 200
    (MXNet 1.x's word-language-model example with ``--model gru``), 20
    Adam steps on an L2 loss against a fixed target; the launch counts
    are read around the 20 steps, every ``gru_bwd`` on the cluster route,
    and the loss must fall.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Needs one CUDA device, the
CUDA toolkit, and the repository beside this file.

    python3 chip_smoke.py --profile-train

also writes a ``torch.profiler`` table of two training steps to
``chiprun_out/train_profile.txt`` and prints its top rows;
``--profile-resnet`` does the same for two ResNet-50 steps, into
``chiprun_out/resnet_profile.txt``, and prints the fused kernels' share of
the device time.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
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
# fp32 products on the tensor cores as 3xTF32 (three TF32 products, 495
# TFLOP/s dense, per fp32 product): the fp32 attention bounds' rate, which
# a tensor-core kernel can beat the CUDA cores' 67 TFLOP/s by
TF32X3_FLOPS = 495e12 / 3

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

RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS = 128, 224, 20
PREDICT_BATCH = 64
# fused 1x1 kernels vs their plain version: y within these (atol, rtol):
# fp32 sums over up to 2048 products in other orders; bf16 outputs are
# rounded to bf16 (2^-8 relative), and another order may round a sum to
# the neighbouring value
FUSED_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
# the bf16 training step against the same steps from the same weights with
# the fused 1x1 kernels pinned to the simple route (PR 3's template): the
# products and the statistics sum in other orders, and at lr 0.1 each
# update widens the gap (the two runs part after ~8 steps).  On one H100
# (PERF.md, PR 5) the losses of steps 1-4 were 4.0e-5, 2.6e-4, 1.6e-3 and
# 7.5e-3 apart, relative; the limits are about ten times those, five at
# step 4.  A fused kernel that is wrong moves the first loss by far more.
RESNET_ROUTE_RTOL = (4e-4, 3e-3, 1.5e-2, 4e-2)
# ResNet-50 references (fp32, TF32 off, b=8, 112^2, 2 SGD steps from the
# same weights).  The first loss is a forward alone: within 1e-4 relative
# (sums in other orders through 53 layers).  The first step's updates,
# -lr*(grad + wd*w), relative in L2.  A ReLU input within rounding of zero
# can open on one side and not on the other, which moves the gradient of
# every layer below it; a one-ulp change of the input moves ReLU inputs by
# up to ~4e-5.  So the limits are set from the gaps that a one-ulp change
# of the input (up, then down) makes on the card alone, the floor the
# script prints beside them; on one H100 (PERF.md, PR 3) the floor and the
# card-vs-CPU and fused-vs-standard gaps were: classifier weight (no ReLU
# above it) 3.4-4.9e-5, limit 5e-4; the last bottleneck's conv3 weight
# (the final ReLU above it) 0.67-1.06%, limit 3%; the first bottleneck's
# conv1 weight (every ReLU above it) 2.48-2.84%, limit 6%; the second loss
# (after every layer's update at lr 0.1) 1.66-4.12%, limit 8%.
RESNET_FC_KEY = "output.weight"
RESNET_TOP_KEY = "features.7.2.body.6.weight"
RESNET_DEEP_KEY = "features.4.0.body.0.weight"
RESNET_LOSS1_RTOL = 1e-4
RESNET_FC_UPDATE_RTOL = 5e-4
RESNET_TOP_UPDATE_RTOL = 0.03
RESNET_UPDATE_RTOL = 0.06
RESNET_LOSS2_RTOL = 0.08

# the recurrence kernels vs their plain versions, max |err| over max(1,
# max |ref|): fp32, the same products and activations summed in other
# orders through up to 96 dependent steps and, for dWh, over up to 307,200
# rows; bf16 forward outputs (ys, hn, cn) are rounded to bf16 (2^-8
# relative), so a value within rounding of a midpoint may round the other
# way: two ulps
RNN_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
DEEPAR_BATCH, DEEPAR_CONTEXT, DEEPAR_PREDICT = 32, 72, 24
DEEPAR_STEPS, DEEPAR_SAMPLES = 20, 100
# DeepAR card vs CPU (fp32, TF32 off, dropout 0, batch 4, same weights).
# The first NLL is a mean over 4 x 96 positions of a 2-layer, 96-step
# recurrence whose sums run in other orders on the two devices: 1e-5
# relative.  l0_h2h_weight's gradient sums over all 96 steps of both
# layers' backward: 1e-4 of its largest magnitude.  The losses of 2 Adam
# steps (the second after an update of every weight): 1e-4 relative.  The
# first predict step's (mu, sigma, nu), O(1) values out of the same
# network: 1e-4 absolute.  predict's paths (4 series x 4 samples, 3 steps):
# the same RandomState draws scaled by those parameters, each step's value
# fed back as the next step's lag: 1e-4 of the largest |value|.
DEEPAR_NLL_RTOL = 1e-5
DEEPAR_GRAD_RTOL = 1e-4
DEEPAR_LOSS_RTOL = 1e-4
DEEPAR_PARAM_ATOL = 1e-4
DEEPAR_PATH_RTOL = 1e-4
# MXNet 1.x's example/gluon/word_language_model defaults with --model gru
GRU_HIDDEN, GRU_T, GRU_BATCH, GRU_STEPS = 200, 35, 32, 20


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


def least_ms(nbytes, flops, dtype, rate=None):
    """The least time (ms) for ``nbytes`` moved at the memory rate and
    ``flops`` at ``rate`` (default: the peak rate of ``dtype``), and which
    of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / (rate or PEAK_FLOPS[dtype])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_rates(dtype):
    """The attention kernels' bound rates: fp32 at 3xTF32 on the tensor
    cores, and on the CUDA cores (the bound rows 1-6 had until the
    tensor-core kernels); bf16 at the bf16 tensor-core rate."""
    if dtype == "float32":
        return TF32X3_FLOPS, PEAK_FLOPS["float32"]
    return PEAK_FLOPS[dtype], PEAK_FLOPS[dtype]


def attention_bound(b, h, sq, sk, d, dtype, valid, causal, cores=False):
    """Least time (ms) of the forward: q, k, v and the mask read once, o
    and lse written once, and the QK and PV products over the valid
    pairs, at the 3xTF32 rate (``cores``: the CUDA cores') in fp32."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (b * h * (sq + 2 * sk) * d * item + b * h * sq * d * item
              + b * h * sq * 4 + (b * sk * 4 if valid is not None else 0))
    pairs = valid_pairs(b, h, sq, sk, valid, causal)
    return least_ms(nbytes, 4.0 * pairs * d, dtype,
                    attention_rates(dtype)[int(cores)])


def host_us(fn, iters=200):
    """Host time (us) of one call of ``fn``: the wrapper's Python, checks,
    allocations and launch, without waiting for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def sass_mix(library, name, ops=("HMMA", "MUFU", "LDS", "F2F", "FFMA",
                                  "BAR", "SYNCS")):
    """Counts of a few opcodes in the SASS of each kernel of ``library``
    whose name holds ``name`` (cuobjdump from the CUDA toolkit), or None
    where cuobjdump is missing: shows which unit does the products."""
    import shutil

    from mxnet_tpu_torch.ops.kernels.build import nvcc_path

    tool = shutil.which("cuobjdump") or str(Path(nvcc_path()).with_name(
        "cuobjdump"))
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(library._target())],
                         capture_output=True, text=True, timeout=120).stdout
    mixes, current = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            current = fn if name in fn else None
            if current:
                mixes[current] = dict.fromkeys(ops, 0)
        elif current and "/*" in line:
            text = line.split("*/", 1)[-1].strip()
            op = text.split()[0] if text else ""
            if op.startswith("@"):
                op = text.split()[1]
            for o in ops:
                if op.startswith(o):
                    mixes[current][o] += 1
    return mixes


def spill_bytes(build_log, names):
    """(spill store bytes, spill load bytes) of each kernel of a library
    whose mangled name holds one of ``names``, from nvcc's ``-Xptxas -v``
    report."""
    import re

    out, current = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1) if any(n in m.group(1) for n in names) \
                else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current:
            out[current] = (int(m.group(1)), int(m.group(2)))
            current = None
    return out


def short_name(mangled):
    """A kernel's name and template arguments out of its mangled name."""
    import re

    found = re.search(r"[a-z_]+kernelI\w{0,40}?E(?=v|E)", mangled)
    return found.group(0) if found else mangled[:80]


def tile_share(launch):
    """The share of key tiles a tensor-core attention kernel visited in
    ``launch(tiles)``, from the counter it adds to: (visited, of)."""
    import torch

    tiles = torch.zeros(2, dtype=torch.int32, device="cuda")
    launch(tiles)
    visited, total = tiles.tolist()
    return visited, total


SDPA_PROBE = r"""
import json, sys
import torch
import torch.nn.functional as tF
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
torch.backends.cuda.matmul.allow_tf32 = False
b, h, s, d, n_valid = (int(x) for x in sys.argv[1:])
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=g)
           .requires_grad_(True) for _ in range(3))
mask = torch.zeros(b, 1, 1, s, device="cuda")
mask[..., n_valid:] = -1e9
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    out = tF.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    torch.cuda.synchronize()
times = {}
for e in prof.key_averages():
    if e.device_type == DeviceType.CUDA:
        t = getattr(e, "self_device_time_total", None)
        times[e.key] = e.self_cuda_time_total if t is None else t
print(json.dumps(sorted(times, key=lambda n: -times[n])[:4]))
"""


def sdpa_kernel_names(b, h, s, d):
    """The device kernels, longest first, of one fp32 SDPA forward and
    backward on (b, h, s, d) inputs with an additive key-padding mask: the
    backend PyTorch picks.  Read by torch.profiler in a process of its
    own, so that no profiler session of this process comes before the
    ResNet phase's device readings."""
    out = subprocess.run([sys.executable, "-c", SDPA_PROBE, str(b), str(h),
                          str(s), str(d), str(s // 2)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0 or not out.stdout.strip():
        return f"not read: {out.stderr.strip()[-300:]}"
    return json.loads(out.stdout.strip().splitlines()[-1])


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
        "packed QKV tensor, read in place; bound at 3xTF32 "
        "(fp32), the CUDA-core bound in brackets; tiles: key tiles "
        "visited of those without skipping")
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
                assert all(fa.rows_aligned(t) for t in (q, k, v))
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
                vl = valid if mask == "key_padding" else None
                bound_ms, bound_by = attention_bound(b, h, s, s, d, dtype,
                                                     vl, causal)
                cores_ms, _ = attention_bound(b, h, s, s, d, dtype, vl,
                                              causal, cores=True)
                visited, total = tile_share(lambda t: fa._launch_fwd(
                    q, k, v, km, causal, None, tiles=t))
                log(f"  b={b} h={h} s={s} d={d} {dtype:8s} {mask:11s} "
                    f"o_err={o_err:.3g} lse_err={lse_err:.3g} "
                    f"kernel={kern_ms:.4f}ms "
                    f"plain={plain_ms:.4f}ms sdpa={lib_ms:.4f}ms "
                    f"bound={bound_ms:.4f}ms ({bound_by}; "
                    f"{cores_ms:.4f}) tiles {visited}/{total} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"flash attention kernel disagrees "
                                     f"with its plain version: d={d} "
                                     f"{dtype} {mask}")
                if (d, dtype, mask) == (64, "float32", "key_padding"):
                    main = {"max_abs_err": o_err, "ms": kern_ms,
                            "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": lib_ms,
                            "cuda_core_bound_ms": cores_ms,
                            "tiles_visited": [visited, total]}
                    main["host_us"] = host_us(lambda: fa.flash_attention_fwd(
                        q, k, v, km))
                    log(f"  main case: the wrapper's host time "
                        f"{main['host_us']:.1f} us a call")
    return main


def bwd_bound(b, h, sq, sk, d, dtype, valid, causal, n_ops, n_out,
              cores=False):
    """Least time (ms) of one backward kernel: q, k, v, dO read once, lse
    and delta (fp32) and the mask read once, ``n_out`` (b,h,s,d) outputs
    written once; ``n_ops * d`` operations per valid pair, at the rates of
    :func:`attention_bound`."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (b * h * (2 * sq + 2 * sk) * d * item + 2 * b * h * sq * 4
              + (b * sk * 4 if valid is not None else 0)
              + n_out * b * h * sq * d * item)
    pairs = valid_pairs(b, h, sq, sk, valid, causal)
    return least_ms(nbytes, float(n_ops) * pairs * d, dtype,
                    attention_rates(dtype)[int(cores)])


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
        f"main case; bounds at 3xTF32 (fp32), the CUDA-core bound after the "
        f"slash; tiles: the dQ kernel's key tiles visited of those without "
        f"skipping")
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
                assert all(fa.rows_aligned(t) for t in (q, k, v, do))
                dq_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq(
                    *args, causal=causal), iters=20)
                visited, total = tile_share(lambda t: fa._launch_dq(
                    *args, causal, None, tiles=t))
                dkv_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv(
                    *args, causal=causal), iters=20)
                blocks = tile_share(lambda t: fa._launch_dkv(
                    *args, causal, None, blocks=t))
                rule = dkv_block_model(vl if km is not None else None, b, h,
                                       s, causal)
                if blocks != rule:
                    raise SystemExit(
                        f"the dK/dV kernel visited {blocks} blocks of keys, "
                        f"its rule {rule}: {label} {dtype} {mask}")
                plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
                    q, k, v, o, lse, do, km, causal=causal), iters=5)
                lib_ms = sdpa_backward_ms(tF, q, k, v, do, km, causal)
                dvalid = vl if km is not None else None
                dq_bound = bwd_bound(b, h, s, s, d, dtype, dvalid, causal,
                                     6, 1)
                dkv_bound = bwd_bound(b, h, s, s, d, dtype, dvalid, causal,
                                      8, 2)
                dq_cores = bwd_bound(b, h, s, s, d, dtype, dvalid, causal,
                                     6, 1, cores=True)[0]
                dkv_cores = bwd_bound(b, h, s, s, d, dtype, dvalid, causal,
                                      8, 2, cores=True)[0]
                log(f"  {label:5s} b={b} h={h} s={s} d={d} {dtype:8s} "
                    f"{mask:20s} err dq/dk/dv {errs[0]:.3g}/{errs[1]:.3g}/"
                    f"{errs[2]:.3g} dQ={dq_ms:.4f}ms "
                    f"(bound {dq_bound[0]:.4f} {dq_bound[1]}/{dq_cores:.4f})"
                    f" tiles {visited}/{total} dKdV={dkv_ms:.4f}ms (bound "
                    f"{dkv_bound[0]:.4f} {dkv_bound[1]}/{dkv_cores:.4f}) "
                    f"blocks {blocks[0]}/{blocks[1]} "
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
                    sdpa_fwd_ms = cuda_ms(
                        lambda: tF.scaled_dot_product_attention(
                            q, k, v, attn_mask=km.view(b, 1, 1, s)),
                        iters=20)
                    for name, ms, err, (bms, bby), cores in (
                            ("dq", dq_ms, errs[0], dq_bound, dq_cores),
                            ("dkv", dkv_ms, max(errs[1:]), dkv_bound,
                             dkv_cores)):
                        main[name] = {"max_abs_err": err, "ms": ms,
                                      "plain_ms": plain_ms, "bound_ms": bms,
                                      "bound_by": bby, "library_ms": lib_ms,
                                      "cuda_core_bound_ms": cores}
                    main["dq"].update(
                        tiles_visited=[visited, total],
                        host_us=host_us(lambda: fa.flash_attention_bwd_dq(
                            *args, causal=causal)))
                    main["dkv"].update(
                        blocks_visited=list(blocks),
                        host_us=host_us(lambda: fa.flash_attention_bwd_dkv(
                            *args, causal=causal)))
                    main["fwd_ms"] = fwd_ms
                    names = sdpa_kernel_names(b, h, s, d)
                    log(f"  train shape fp32 key padding: forward kernel "
                        f"{fwd_ms:.4f} ms, SDPA's forward {sdpa_fwd_ms:.4f};"
                        f" dQ {dq_ms:.4f} ms against 6/14 of SDPA's "
                        f"backward {6 / 14 * lib_ms:.4f}; the dQ and dK/dV "
                        f"wrappers' host time {main['dq']['host_us']:.1f} "
                        f"and {main['dkv']['host_us']:.1f} us a call; "
                        f"SDPA's kernels at this shape (forward and "
                        f"backward, by device time): {names}")
                    held = {"dkv_at_or_below_8/14_of_sdpa_bwd":
                            dkv_ms <= 8 / 14 * lib_ms,
                            "dq_plus_dkv_below_sdpa_bwd":
                            dq_ms + dkv_ms < lib_ms}
                    log(f"  train shape fp32 key padding, same call: dK/dV "
                        f"{dkv_ms:.4f} ms against 8/14 of SDPA's backward "
                        f"{8 / 14 * lib_ms:.4f}; dQ + dK/dV "
                        f"{dq_ms + dkv_ms:.4f} ms against SDPA's backward "
                        f"{lib_ms:.4f}; dK/dV blocks of 64 keys visited "
                        f"{blocks[0]} of {blocks[1]}; "
                        + ", ".join(f"{k}: {'held' if v else 'MISSED'}"
                                    for k, v in held.items())
                        + " (printed, not gated)")
    check_function_gradients(fa, dev, rng)
    return main


def dkv_block_model(valid, b, h, s, causal, block=64):
    """The blocks of ``block`` keys the dK/dV kernel visits by its rule,
    and all its blocks, for sq = sk = s and batch row i's first
    ``valid[i]`` keys live (``valid`` None: no mask): a block is skipped
    when all its keys are padding and the row's first live key is at most
    the block's first key under causal, or exists at all."""
    n = -(-s // block)
    skipped = 0
    if valid is not None:
        for nv in valid:
            if nv > 0:
                skipped += sum(1 for kb in range(n) if block * kb >= nv)
    # under causal the first live key (0) is at most every block's first
    return (b * n - skipped) * h, b * n * h


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
    counts = {name: c.launches for name, c in kernels.KERNEL_COUNTS.items()
              if name.startswith("flash_attention")}
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
        profile_steps(lambda: [train_step(mx, net, trainer, batch)
                               for _ in range(2)],
                      "train_profile.txt", "train")
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


def profile_steps(run_two_steps, filename, title):
    """A torch.profiler table of ``run_two_steps()`` by CUDA time, into
    chiprun_out/<filename>; its top rows are printed.  Returns the device
    time (us) by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tprofile(activities=acts) as prof:
        run_two_steps()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    table = averages.table(sort_by="cuda_time_total", row_limit=60)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / filename).write_text(table)
    log(f"{title} profile (2 steps, by CUDA time):")
    log("\n".join(table.splitlines()[:28]))
    return kernel_times(averages)


def kernel_times(averages):
    """Device time (us) by kernel name from a profiler's key averages: the
    entries that ran on the card (kernels, copies, fills)."""
    from torch.autograd import DeviceType

    out = {}
    for e in averages:
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            out[e.key] = e.self_cuda_time_total if t is None else t
    return out


@contextlib.contextmanager
def simple_route(kcf):
    """Within the block the fused 1x1 kernels' route rule (``kcf.route``)
    picks the simple route, PR 3's template, for every launch."""
    rule = kcf.route
    kcf.route = lambda *args: "simple"
    try:
        yield
    finally:
        kcf.route = rule


def device_ms(fn, iters, tags, attempts=3):
    """Mean device time (ms) a call of ``fn`` spends in the kernels whose
    names hold one of ``tags``, from torch.profiler over ``iters`` calls
    after one warm call: the kernels alone, without the host's time
    between launches.  On the H100 torch.profiler has now and then left a
    launch, or every launch of a session, unrecorded (PERF.md §6): a
    session in which no tagged kernel was recorded, or one's launches are
    not a whole number a call, is logged and taken again, up to
    ``attempts`` sessions.  Each kernel's time counts as its mean over the
    launches recorded times its launches a call (the recorded count over
    ``iters``, rounded), so a launch left out of the last session does not
    count as 0."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        launches = {e.key: e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and any(tag in e.key for tag in tags)}
        if launches and all(c % iters == 0 for c in launches.values()):
            break
        log(f"  device_ms: torch.profiler session {attempt} of {attempts} "
            f"recorded {launches or 'no launches'} of {tags} over {iters} "
            f"calls; " + ("taken again" if attempt < attempts
                          else "counted over the launches recorded"))
    times = kernel_times(prof.key_averages())
    return sum(times[k] / n * max(1, round(n / iters))
               for k, n in launches.items()) / 1e3


# -- phase 6: the ResNet kernels ----------------------------------------------


def resnet_kernel_shapes():
    """The (M, K, N) each fused kernel gets from ResNet-50 v1 (stride on
    conv1): in training at batch 128, 224^2 (stage sizes 56, 28, 14, 7;
    3, 4, 6, 3 bottlenecks), conv1 and downsample through
    ``matmul_bn_stats``, conv3 through ``bn_act_matmul_stats``, bn2's C
    through ``bn_stats``; in predict mode at batch 64, conv3 through
    ``bn_act_matmul``.  ``per_step`` maps (kernel, (M, K, N)) to its
    launches in one training step (20 and 16 in all)."""
    per_step, act, stats = {}, [], []
    for i, (width, s, blocks) in enumerate(zip((64, 128, 256, 512),
                                               (56, 28, 14, 7),
                                               (3, 4, 6, 3))):
        m = RESNET_BATCH * s * s
        cin = 64 if i == 0 else 2 * width
        for key, n in ((("matmul_bn_stats", (m, cin, width)), 1),
                       (("matmul_bn_stats", (m, cin, 4 * width)), 1),
                       (("matmul_bn_stats", (m, 4 * width, width)),
                        blocks - 1),
                       (("bn_act_matmul_stats", (m, width, 4 * width)),
                        blocks)):
            per_step[key] = per_step.get(key, 0) + n
        act.append((PREDICT_BATCH * s * s, width, 4 * width))
        stats.append((m, width))
    mm = sorted(shape for kind, shape in per_step if kind == "matmul_bn_stats")
    act_stats = [shape for kind, shape in per_step
                 if kind == "bn_act_matmul_stats"]
    return mm, act_stats, act, stats, per_step


def gemm_bound(m, k, n, dtype, prologue, stats, rate=None):
    """Least time (ms): x, w read once, y written once (plus scale and
    shift read, the fp32 sums written); 2*M*K*N operations at ``rate``
    (default the dtype's peak: for fp32 the CUDA cores'; TF32X3_FLOPS for
    the fp32 products of the TF32 route)."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = ((m * k + k * n + m * n) * item + (2 * k * 4 if prologue else 0)
              + (2 * n * 4 if stats else 0))
    return least_ms(nbytes, 2.0 * m * k * n, dtype, rate)


def check_stats(got, y):
    """``got``, a kernel's column sums of ``y`` and of its squares, where
    ``y`` is what the kernel stored (or read): against fp64 sums of the
    same values, within 1e-5 of the sum of magnitudes (fp32 sums in the
    kernel's order) plus 1e-5, in bf16 as in fp32.  Returns the largest
    error relative to the column's sum of magnitudes, and whether every
    column holds."""
    yd = y.double()
    worst, ok = 0.0, True
    for g, r, mag in zip(got, (yd.sum(dim=0), (yd * yd).sum(dim=0)),
                         (yd.abs().sum(dim=0), (yd * yd).sum(dim=0))):
        err = (g.reshape(-1).double() - r).abs()
        worst = max(worst, (err / mag.clamp_min(1e-30)).max().item())
        ok = ok and bool((err <= 1e-5 * mag + 1e-5).all())
    return worst, ok


def check_resnet_kernels(dev):
    """Rows 7-10 of the kernel table against their plain versions at the
    ResNet-50 shapes on ``dev``; returns each kernel's record at its main
    shape (stage 1: bf16 in training, fp32 in predict mode).  At each bf16
    training shape the fused kernels' two routes are timed side by side
    (CUDA events around back-to-back calls, and the kernels' own device
    time from torch.profiler) and held against each other; the fused
    forward of one training step is summed from them, old route against
    new."""
    import torch

    from mxnet_tpu_torch.ops.kernels import batch_norm as kbn
    from mxnet_tpu_torch.ops.kernels import conv_fused as kcf

    gen = torch.Generator(device=dev).manual_seed(0)
    mm, act_stats, act, stats, per_step = resnet_kernel_shapes()
    routes = {}  # (kernel, shape) -> times of both routes, bf16 training
    predict = {}  # shape -> times of fp32 bn_act_matmul with ReLU
    # each kernel's record: stage 1, in the dtype of its main path
    main_case = {"bn_stats": (stats[0], "bfloat16", False),
                 "matmul_bn_stats": ((RESNET_BATCH * 56 * 56, 256, 64),
                                     "bfloat16", False),
                 "bn_act_matmul_stats": (act_stats[0], "bfloat16", True),
                 "bn_act_matmul": (act[0], "float32", True)}
    main = {}
    log(f"resnet kernels: kernel vs plain (y atol/rtol fp32 "
        f"{FUSED_TOL['float32']}, bf16 {FUSED_TOL['bfloat16']}; sums within "
        f"1e-5 of their magnitudes of fp64 sums of the stored y, or of x for "
        f"bn_stats; err is y's, or the sums' for bn_stats); library = "
        f"torch.matmul at the same shape (the product alone) or "
        f"torch.var_mean")

    def rand(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.rand(*shape, generator=gen, device=dev) * scale
                + shift).to(dtype)

    def record(name, key, err, ok, kern, plain, lib, bound, label,
               stats_err=None, extra=None):
        sums = "" if stats_err is None else f" sums_rel={stats_err:.3g}"
        more = "".join(f" {k}={v:.1f}us" if k.endswith("_us")
                       else f" {k}={v:.4f}ms" for k, v in (extra or {}).items())
        log(f"  {name:20s} {label} err={err:.3g}{sums} kernel={kern:.4f}ms"
            f"{more} plain={plain:.4f}ms library={lib:.4f}ms "
            f"bound={bound[0]:.4f}ms ({', '.join(bound[1:])})"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} kernel disagrees with its plain "
                             f"version: {label}")
        if key:
            main[name] = {"max_abs_err": err, "ms": kern, "plain_ms": plain,
                          "bound_ms": bound[0], "bound_by": bound[1],
                          "library_ms": lib, "shape": label, **(extra or {})}

    bn_stages = []  # row 7 at each stage and dtype
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for (m, c), n_step in zip(stats, (3, 4, 6, 3)):
            x = rand(m, c, dtype=dt, shift=-0.3)
            got, ref = kbn.bn_stats_fwd(x), kbn.bn_stats_plain(x)
            err = max((g - r).abs().max().item() for g, r in zip(got, ref))
            serr, ok = check_stats(got, x)
            ok = ok and check_stats(ref, x)[1]
            again = kbn.bn_stats_fwd(x)
            ok = ok and all(torch.equal(a, b) for a, b in zip(got, again))
            bound = least_ms(m * c * x.element_size() + 2 * c * 4,
                             3.0 * m * c, "float32")
            extra = {"device_ms": device_ms(lambda: kbn.bn_stats_fwd(x), 10,
                                            ("bn_stats_kernel",)),
                     "host_us": host_us(lambda: kbn.bn_stats_fwd(x))}
            kern = cuda_ms(lambda: kbn.bn_stats_fwd(x), 10)
            plain = cuda_ms(lambda: kbn.bn_stats_plain(x), 3)
            lib = cuda_ms(lambda: torch.var_mean(x, dim=0, correction=0), 10)
            label = f"M={m} C={c} {dtype}"
            record("bn_stats",
                   main_case["bn_stats"] == ((m, c), dtype, False), err, ok,
                   kern, plain, lib, bound, label, serr, extra)
            bn_stages.append(dict(shape=label, max_abs_err=err, ms=kern,
                                  plain_ms=plain, bound_ms=bound[0],
                                  library_ms=lib, launches_per_step=n_step,
                                  **extra))
            del x, got, ref, again
        cases = [("matmul_bn_stats", shape, False) for shape in mm]
        cases += [("bn_act_matmul_stats", shape, relu)
                  for shape in act_stats for relu in (True, False)]
        cases += [("bn_act_matmul", shape, relu)
                  for shape in act for relu in (True, False)]
        for name, (m, k, n), relu in cases:
            x = rand(m, k, dtype=dt, shift=-0.5)
            # w as the main path hands it over: a (Cout, Cin) weight's
            # transpose, so the kernels take it without a copy
            w = rand(n, k, dtype=dt, scale=2.0 / k ** 0.5,
                     shift=-1.0 / k ** 0.5).t()
            prologue = name != "matmul_bn_stats"
            args = ((x, rand(1, k, shift=0.5), rand(1, k, shift=-0.5), w, relu)
                    if prologue else (x, w))
            fwd = getattr(kcf, f"{name}_fwd")
            plain = getattr(kcf, f"{name}_plain")
            got, ref = fwd(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            torch.cuda.synchronize()
            atol, rtol = FUSED_TOL[dtype]
            err = (got[0].float() - ref[0].float()).abs().max().item()
            ok = bool(torch.isfinite(got[0]).all()) and torch.allclose(
                got[0].float(), ref[0].float(), atol=atol, rtol=rtol)
            serr = None
            if len(got) == 3:
                serr, sok = check_stats(got[1:], got[0])
                ok = ok and sok
            extra = None
            tf32 = dtype == "float32" and name == "bn_act_matmul"
            if tf32:  # the TF32 route, held against the simple route
                c = kcf.bn_act_matmul_counts
                before = c.tf32_launches
                fwd(*args)
                ok = ok and c.tf32_launches == before + 1
                with simple_route(kcf):
                    simple = fwd(*args)
                    extra = {"simple_ms": cuda_ms(lambda: fwd(*args), 5)}
                ok = ok and torch.allclose(got[0], simple, atol=atol,
                                           rtol=rtol)
                extra["cuda_core_bound_ms"] = gemm_bound(m, k, n, dtype,
                                                         True, False)[0]
                del simple
            if (dtype == "bfloat16" and (name, (m, k, n)) in per_step
                    and relu == prologue):  # the training step's call
                extra = {"device_ms": device_ms(lambda: fwd(*args), 10,
                                                ("tma_mm_kernel",
                                                 "stats_reduce_kernel"))}
                with simple_route(kcf):
                    simple = fwd(*args)
                    extra["simple_ms"] = cuda_ms(lambda: fwd(*args), 5)
                    extra["simple_device_ms"] = device_ms(
                        lambda: fwd(*args), 3,
                        ("fused_mm_kernel", "stats_reduce_kernel"))
                ok = ok and torch.allclose(got[0].float(), simple[0].float(),
                                           atol=atol, rtol=rtol)
                ok = ok and check_stats(simple[1:], simple[0])[1]
                del simple
            del got, ref
            kern = cuda_ms(lambda: fwd(*args), 10)
            lib = cuda_ms(lambda: torch.matmul(x, w), 10)
            bound = gemm_bound(m, k, n, dtype, prologue,
                               name.endswith("stats"),
                               TF32X3_FLOPS if tf32 else None)
            record(name, main_case[name] == ((m, k, n), dtype, relu), err, ok,
                   kern, cuda_ms(lambda: plain(*args), 3), lib,
                   bound + ("3xTF32",) * tf32,
                   f"M={m} K={k} N={n} {dtype} relu={relu}", serr, extra)
            if tf32:
                if relu:  # the predict forward's call
                    predict[(m, k, n)] = dict(extra, ms=kern, library_ms=lib,
                                              bound_ms=bound[0])
            elif extra:
                routes[(name, (m, k, n))] = dict(extra, ms=kern)
            del x, w, args
        torch.cuda.empty_cache()
    main["bn_stats"]["stages"] = bn_stages
    step_routes(routes, per_step)
    predict_routes(predict)
    check_fused_function_gradients(kbn, kcf, dev)
    return main


def predict_routes(predict):
    """fp32 ``bn_act_matmul`` at the four shapes of ResNet-50's predict
    forward (b=64): the TF32 route against ``torch.matmul`` (the product
    alone) and the simple route, each shape and the forward's 16 launches
    (3, 4, 6, 3 a stage); printed, not gated."""
    log("resnet kernels: fp32 bn_act_matmul (ReLU) at the predict forward's "
        "shapes, TF32 route against torch.matmul and the simple route "
        "(events around back-to-back calls):")
    total = dict.fromkeys(("ms", "library_ms", "simple_ms", "bound_ms"), 0.0)
    for (m, k, n), t in sorted(predict.items(), key=lambda kv: -kv[0][0]):
        count = {64: 3, 128: 4, 256: 6, 512: 3}[k]
        for key in total:
            total[key] += t[key] * count
        log(f"  M={m} K={k} N={n} x{count}: tf32 {t['ms']:.4f} ms, "
            f"torch.matmul {t['library_ms']:.4f} "
            f"({'at or below' if t['ms'] <= t['library_ms'] else 'ABOVE'}), "
            f"simple {t['simple_ms']:.4f}, bound {t['bound_ms']:.4f} "
            f"(3xTF32) / {t['cuda_core_bound_ms']:.4f} (CUDA cores)")
    log(f"  one predict forward, 16 launches: tf32 {total['ms']:.4f} ms, "
        f"torch.matmul {total['library_ms']:.4f}, simple "
        f"{total['simple_ms']:.4f}, bound {total['bound_ms']:.4f}")


def step_routes(routes, per_step):
    """The fused forward of one bf16 training step, each shape's time x its
    launches per step, on the TMA route against the simple route; fails
    where the TMA route's kernels take longer than the simple route's."""
    log("resnet kernels: the fused 1x1 forward of one bf16 training step "
        "(time x launches a step; events around back-to-back calls, device = "
        "the kernels' own time), TMA route against the simple route:")
    total = dict.fromkeys(("ms", "device_ms", "simple_ms",
                           "simple_device_ms"), 0.0)
    slower = []
    for (name, (m, k, n)), t in sorted(routes.items(),
                                       key=lambda kv: -kv[0][1][0]):
        count = per_step[(name, (m, k, n))]
        for key in total:
            total[key] += t[key] * count
        log(f"  {name:20s} M={m} K={k} N={n} x{count}: tma {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f}), simple {t['simple_ms']:.4f} ms "
            f"(device {t['simple_device_ms']:.4f})")
        if t["device_ms"] > t["simple_device_ms"]:
            slower.append((name, (m, k, n)))
    log(f"  one step, {sum(per_step.values())} launches: tma "
        f"{total['ms']:.4f} ms (device {total['device_ms']:.4f}), simple "
        f"{total['simple_ms']:.4f} ms (device "
        f"{total['simple_device_ms']:.4f})")
    if len(routes) != len(per_step) or slower:
        raise SystemExit(f"the TMA route is slower than the simple route at "
                         f"{slower}, or a training shape went untimed")


def check_fused_function_gradients(kbn, kcf, dev):
    """The four autograd Functions on the card (kernel forwards, plain
    backwards) against torch.autograd through the plain forwards, fp32 at
    a stage-4 shape: within 1e-4 absolute plus 1e-4 relative of each
    gradient's largest magnitude."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    m, k, n = 6272, 512, 256
    x = torch.rand(m, k, generator=gen, device=dev) - 0.5
    w = (torch.rand(k, n, generator=gen, device=dev) - 0.5) * 0.1
    sc = torch.rand(1, k, generator=gen, device=dev) + 0.5
    sh = torch.rand(1, k, generator=gen, device=dev) - 0.5
    cot = [torch.randn(m, n, generator=gen, device=dev),
           torch.randn(1, n, generator=gen, device=dev),
           torch.randn(1, n, generator=gen, device=dev) * 0.01]
    ccot = [torch.randn(k, generator=gen, device=dev) for _ in range(2)]

    def grads(fn, args, cots):
        ts = [a.clone().requires_grad_(True) for a in args]
        outs = fn(*ts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(
            sum((o.float() * c).sum() for o, c in zip(outs, cots)), ts)

    cases = [
        ("matmul_bn_stats", kcf.matmul_bn_stats, kcf.matmul_bn_stats_plain,
         (x, w), cot),
        ("bn_act_matmul", lambda *a: kcf.bn_act_matmul(*a, True),
         lambda *a: kcf.bn_act_matmul_plain(*a, True), (x, sc, sh, w), cot),
        ("bn_act_matmul_stats", lambda *a: kcf.bn_act_matmul_stats(*a, True),
         lambda *a: kcf.bn_act_matmul_stats_plain(*a, True),
         (x, sc, sh, w), cot),
        ("bn_stats", kbn.bn_stats, kbn.bn_stats_plain, (x,), ccot)]
    worst, ok = 0.0, True
    for name, fn, plain, args, cots in cases:
        for g, r in zip(grads(fn, args, cots), grads(plain, args, cots)):
            scale = r.abs().max().item()
            worst = max(worst, (g - r).abs().max().item() / max(scale, 1e-30))
            ok = ok and bool(((g - r).abs() <= 1e-4 * scale
                              + 1e-4 * r.abs()).all())
    log(f"resnet kernels: autograd Functions on the card vs autograd of the "
        f"plain forwards, M={m} K={k} N={n} fp32: max err / max |grad| "
        f"{worst:.3g} (atol 1e-4 of the largest, rtol 1e-4) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the fused kernels' autograd Functions disagree "
                         "with autograd through the plain forwards")


# -- phases 7-9: ResNet-50 ----------------------------------------------------


def resnet50(mx, ctx, fuse):
    """ResNet-50 v1, NHWC, 1000 classes, Xavier from seed 0 (deferred
    shapes); ``fuse`` sets MXTPU_CONV_EPILOGUE, which the bottlenecks read
    when they are built."""
    os.environ["MXTPU_CONV_EPILOGUE"] = "pallas" if fuse else ""
    mx.random.seed(0)
    net = mx.gluon.model_zoo.vision.resnet50_v1(layout="NHWC", classes=1000)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def resnet_trainer(mx, net, compute_dtype=None):
    """train_imagenet.py's optimizer settings."""
    return mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        compute_dtype=compute_dtype)


def synthetic_images(rng, batch, image):
    x = rng.rand(batch, image, image, 3).astype("float32")
    y = rng.randint(0, 1000, batch).astype("float32")
    return x, y


def train_resnet(mx, card, profile=False):
    """20 bf16 steps of fused ResNet-50 through DataParallelTrainer at
    b=128, 224^2; then predict mode at b=64.  Returns the launch counts of
    both runs."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels

    gpu = mx.gpu(0)
    net = resnet50(mx, gpu, fuse=True)
    x, y = synthetic_images(np.random.RandomState(0), RESNET_BATCH,
                            RESNET_IMAGE)
    xg, yg = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    trainer = resnet_trainer(mx, net, compute_dtype="bfloat16")
    trainer.build(xg)  # deferred shapes: one predict-mode probe
    start = [p.detach().clone() for p in trainer._params]
    names = [n for n, _ in trainer._named]
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []

    kernels.reset_counts()
    for _ in range(RESNET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.step(xg, yg)
        losses.append(loss.asscalar())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {k: (c.launches, c.plain_calls_on_cuda)
              for k, c in kernels.KERNEL_COUNTS.items()}
    fused = ("matmul_bn_stats", "bn_act_matmul_stats")
    simple = {k: kernels.KERNEL_COUNTS[k].simple_launches for k in fused}
    scalar = kernels.KERNEL_COUNTS["bn_stats"].scalar_launches

    n = RESNET_STEPS
    median_ms = statistics.median(step_ms[2:])
    log(f"resnet train: ResNet-50 v1 NHWC fused, b={RESNET_BATCH} "
        f"{RESNET_IMAGE}^2, bf16 compute, SGD momentum, {n} steps; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; step median {median_ms:.3f} "
        f"ms over steps 3-{n} (first {step_ms[0]:.1f} ms), "
        f"{RESNET_BATCH / (median_ms / 1e3):.1f} images/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    log(f"resnet train: losses {[round(v, 4) for v in losses]}; mean of "
        f"the last 5 {statistics.mean(losses[-5:]):.4f}")
    log(f"resnet train: (launches, plain calls on cuda) {counts}; "
        f"launches on the simple route {simple}; bn_stats launches on its "
        f"scalar route {scalar}")
    unchanged, bad, still = [], [], []
    for name, p0, p1, tr in zip(names, start, trainer._params,
                                trainer._trainable):
        if not bool(torch.isfinite(p1).all()):
            bad.append(name)
        if tr and torch.equal(p0, p1):
            unchanged.append(name)
        if "running" in name and torch.equal(p0, p1):
            still.append(name)
    expect = {"matmul_bn_stats": 20 * n, "bn_stats": 16 * n,
              "bn_act_matmul_stats": 16 * n}
    checks = {
        "launches": all(counts[k][0] == v for k, v in expect.items()),
        # every fused launch of the bf16 step on the TMA route
        "tma_route": all(v == 0 for v in simple.values()),
        # every bn_stats launch with 16-byte loads
        "bn_stats_vector_loads": scalar == 0,
        "plain_calls_on_cuda": all(c[1] == 0 for c in counts.values()),
        "finite_losses": all(np.isfinite(losses)),
        # at lr 0.1 the loss on one batch swings from step to step and,
        # after about 8 steps, its path depends on the rounding of every
        # sum (runs that differ only in the fused kernels' summation order
        # part there): the first two updates must each leave it below the
        # first loss, and the first steps must track the simple route's
        # (route_gap below)
        "loss_falls": max(losses[1:3]) < losses[0],
        "parameters_change": not unchanged,
        "parameters_finite": not bad,
        "running_stats_move": not still,
    }
    if unchanged or bad or still:
        log(f"resnet train: unchanged {unchanged[:5]}, non-finite "
            f"{bad[:5]}, running stats that did not move {still[:5]}")
    if profile:
        times = profile_steps(lambda: [trainer.step(xg, yg)
                                       for _ in range(2)],
                              "resnet_profile.txt", "resnet train")
        busy = sum(times.values())
        shares = {tag: sum(t for k, t in times.items() if tag in k) / busy
                  for tag in ("tma_mm_kernel", "fused_mm_kernel",
                              "stats_reduce_kernel", "bn_stats_kernel")}
        log(f"resnet train: device time of 2 profiled steps {busy / 1e3:.3f} "
            f"ms; shares: fused 1x1 kernels, TMA route "
            f"{shares['tma_mm_kernel']:.1%}, simple route "
            f"{shares['fused_mm_kernel']:.1%}; their stats_reduce_kernel "
            f"{shares['stats_reduce_kernel']:.1%}; bn_stats_kernel "
            f"{shares['bn_stats_kernel']:.1%}")

    checks.update(resnet_route_gap(mx, start, xg, yg, losses))

    # predict mode on the trained weights, b=64, fp32
    trainer.sync_to_block()
    del trainer
    torch.cuda.empty_cache()
    xp = xg[:PREDICT_BATCH].contiguous()
    net(xp)  # warm
    torch.cuda.synchronize()
    kernels.reset_counts()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out = net(xp)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3 / reps
    pcounts = {k: (c.launches, c.plain_calls_on_cuda)
               for k, c in kernels.KERNEL_COUNTS.items()}
    log(f"resnet predict: b={PREDICT_BATCH} fp32 forward {fwd_ms:.3f} ms, "
        f"{PREDICT_BATCH / (fwd_ms / 1e3):.1f} images/s; (launches, plain "
        f"calls on cuda) {pcounts}")
    checks["predict_launches"] = pcounts["bn_act_matmul"][0] == 16 * reps
    # every fp32 bn_act_matmul of the forward on the TF32 route
    bam = kernels.KERNEL_COUNTS["bn_act_matmul"]
    log(f"resnet predict: bn_act_matmul launches on the TF32 route "
        f"{bam.tf32_launches}, on the simple route {bam.simple_launches}")
    checks["predict_tf32_route"] = (bam.simple_launches == 0
                                    and bam.tf32_launches == 16 * reps)
    checks["predict_plain_calls_on_cuda"] = all(
        c[1] == 0 for c in pcounts.values())
    checks["predict_output"] = tuple(out.shape) == (PREDICT_BATCH, 1000) \
        and bool(torch.isfinite(out.data).all())
    del net, xg, yg, xp, out
    torch.cuda.empty_cache()
    checks.update(resnet_references(mx))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"resnet checks failed: {failed}")
    return ({k: counts[k][0] for k in expect},
            pcounts["bn_act_matmul"][0])


def resnet_route_gap(mx, start, xg, yg, losses):
    """The first steps of the bf16 training run again from its starting
    weights ``start``, with the fused 1x1 kernels pinned to the simple
    route; the training run's ``losses`` (TMA route) must stay within
    RESNET_ROUTE_RTOL of these, step by step."""
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import conv_fused as kcf

    trainer = resnet_trainer(mx, resnet50(mx, mx.gpu(0), fuse=True),
                             compute_dtype="bfloat16")
    trainer.build(xg)
    with torch.no_grad():
        for p, p0 in zip(trainer._params, start):
            p.copy_(p0)
    n = len(RESNET_ROUTE_RTOL)
    kernels.reset_counts()
    with simple_route(kcf):
        simple = [trainer.step(xg, yg).asscalar() for _ in range(n)]
    fused = ("matmul_bn_stats", "bn_act_matmul_stats")
    pinned = all(kernels.KERNEL_COUNTS[k].simple_launches
                 == kernels.KERNEL_COUNTS[k].launches > 0 for k in fused)
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, simple)]
    log(f"resnet train: the first {n} losses on the TMA route "
        f"{losses[:n]} against the simple route's {simple} from the same "
        f"weights: relative gaps {[f'{g:.3g}' for g in gaps]}, limits "
        f"{list(RESNET_ROUTE_RTOL)}; every fused launch of the simple run "
        f"on the simple route: {pinned}")
    del trainer
    torch.cuda.empty_cache()
    return {"route_gap": all(g <= t for g, t in zip(gaps, RESNET_ROUTE_RTOL)),
            "route_gap_pinned": pinned}


def resnet_references(mx):
    """Two fp32 steps at b=8, 112^2 (TF32 off) from the same weights: the
    fused net on the card, on the CPU, and the standard net on the card.
    Their losses and the first step's updates of the classifier, the last
    bottleneck's conv3 weight and the first bottleneck's conv1 weight must
    agree.  The fused net on the card with its input moved by one ulp up
    and down gives the gaps that rounding alone makes (the floor), as a
    reading."""
    import numpy as np

    x, y = synthetic_images(np.random.RandomState(1), 8, 112)
    keys = {"fc": RESNET_FC_KEY, "top": RESNET_TOP_KEY,
            "deep": RESNET_DEEP_KEY}
    runs, weights = {}, None
    for label, ctx, fuse, xin in (
            ("fused card", mx.gpu(0), True, x),
            ("fused card, input +1 ulp", mx.gpu(0), True,
             np.nextafter(x, np.float32(2))),
            ("fused card, input -1 ulp", mx.gpu(0), True,
             np.nextafter(x, np.float32(-1))),
            ("fused cpu", mx.cpu(), True, x),
            ("standard card", mx.gpu(0), False, x)):
        net = resnet50(mx, ctx, fuse)
        trainer = resnet_trainer(mx, net)
        if weights is None:
            trainer.build(mx.nd.array(xin, ctx=ctx))
            weights = {k: p.data().detach().cpu().numpy().copy() for k, p in
                       net._collect_params_with_prefix().items()}
        else:
            mx.load_numpy_params(net, weights)
        xa, ya = mx.nd.array(xin, ctx=ctx), mx.nd.array(y, ctx=ctx)
        losses = [trainer.step(xa, ya).asscalar()]
        trainer.sync_to_block()
        params = net._collect_params_with_prefix()
        updates = {w: params[k].data().detach().cpu().numpy() - weights[k]
                   for w, k in keys.items()}
        losses.append(trainer.step(xa, ya).asscalar())
        runs[label] = (losses, updates)
        del net, trainer
    (ref1, ref2), ref_upd = runs["fused card"]
    limits = {"loss1": RESNET_LOSS1_RTOL, "fc": RESNET_FC_UPDATE_RTOL,
              "top": RESNET_TOP_UPDATE_RTOL, "deep": RESNET_UPDATE_RTOL,
              "loss2": RESNET_LOSS2_RTOL}
    log(f"resnet reference: b=8 112^2 fp32, 2 steps; gaps to the fused card "
        f"run, relative: loss1, loss2, and the step-1 update (L2) of "
        f"{RESNET_FC_KEY} (fc), {RESNET_TOP_KEY} (top) and "
        f"{RESNET_DEEP_KEY} (deep); limits "
        f"{limits} (the ulp runs are the floor, not checked)")
    checks = {}
    for label, ((l1, l2), upd) in runs.items():
        if label == "fused card":
            continue
        gaps = {"loss1": abs(ref1 - l1) / abs(l1),
                "fc": 0.0, "top": 0.0, "deep": 0.0,
                "loss2": abs(ref2 - l2) / abs(l2)}
        for w in keys:
            gaps[w] = float(np.linalg.norm(ref_upd[w] - upd[w])
                            / np.linalg.norm(upd[w]))
        log(f"resnet reference: fused card vs {label}: losses "
            f"{[ref1, ref2]} vs {[l1, l2]}; gaps "
            + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
        if "ulp" in label:
            continue
        slug = label.replace(" ", "_")
        for k, v in gaps.items():
            checks[f"{slug}_{k}"] = v <= limits[k]
    return checks


# -- phase 10: the RNN kernels -------------------------------------------------


def rnn_kernel_shapes():
    """(label, T, N, H, I) the recurrence kernels get: DeepAR training
    (T=96, N=32, H=40; I=40 is its second layer), DeepAR predict (N=1600,
    the path grows from T=73 to 96; N=3200 at GluonTS's default batch of
    32 series, which the JAX package's size rule sends to its loop), the
    GRU phase (T=35, N=32, H=200) and a large-H LSTM near that rule's
    limit (T=35, N=32, H=512)."""
    return (("deepar_train", 96, 32, 40, 40), ("deepar_predict", 73, 1600, 40, 40),
            ("deepar_predict", 96, 1600, 40, 40),
            ("deepar_predict", 96, 3200, 40, 40),
            ("gru_phase", 35, 32, 200, 200), ("large_h", 35, 32, 512, 512))


def rnn_bound(cell, direction, T, N, H, dtype, rate=None):
    """Least time (ms) of one recurrence kernel call: each input read once
    and each output written once, in their dtypes (x_proj, wh, h0 and c0,
    ys, hn and cn in ``dtype``; saved gates, cell states or hn_lin, and
    every gradient in fp32); ``2*T*N*G*H*H`` operations for the forward's
    recurrent product at ``rate`` (default: the dtype's peak; the
    tensor-core route's is TF32X3_FLOPS), twice that for the backward
    (dh_prev and dWh) at the fp32 rate."""
    G = 4 if cell == "lstm" else 3
    item = 2 if dtype == "bfloat16" else 4
    tn = T * N
    if direction == "fwd":
        nbytes = (tn * G * H * item + G * H * H * item + (G - 2) * N * H * item
                  + tn * H * item + (G - 2) * N * H * item + tn * G * H * 4
                  + tn * H * 4 + (G * H * item if cell == "gru" else 0))
        return least_ms(nbytes, 2.0 * tn * G * H * H, dtype, rate)
    nbytes = (tn * H * 4 + tn * G * H * 4 + tn * H * 4 + tn * H * item
              + G * H * H * 4 + 2 * (G - 2) * N * H * 4
              + tn * G * H * 4 + G * H * H * 4 + (G - 2) * N * H * 4
              + (G * H * 4 if cell == "gru" else 0))
    return least_ms(nbytes, 4.0 * tn * G * H * H, "float32")


def rnn_inputs(cell, T, N, H, I, dtype, dev, gen):
    """Inputs of one case on ``dev``: x (T, N, I), Xavier-scaled Wi, Wh and
    biases, small states, and unit cotangents."""
    G = 4 if cell == "lstm" else 3
    import torch

    dt = getattr(torch, dtype)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale)

    t = {"x": rnd(T, N, I, scale=0.5), "wi": rnd(G * H, I, scale=I ** -0.5),
         "wh": rnd(G * H, H, scale=H ** -0.5), "b": rnd(G * H, scale=0.1),
         "bh": rnd(G * H, scale=0.1), "h0": rnd(N, H, scale=0.1),
         "c0": rnd(N, H, scale=0.1), "dys": rnd(T, N, H),
         "dhn": rnd(N, H), "dcn": rnd(N, H)}
    t["xp"] = (torch.matmul(t["x"], t["wi"].T) + t["b"]).to(dt)
    for k in ("wh", "h0", "c0", "bh"):
        t[k] = t[k].to(dt)
    return t


def rel_err(got, ref):
    """Largest |got - ref| over the largest |ref| (at least 1)."""
    scale = max(1.0, ref.float().abs().max().item())
    return (got.float() - ref.float()).abs().max().item() / scale


def cudnn_layer(cell, t, H, I, N):
    """torch.nn.LSTM/GRU (cuDNN) with the same weights: gate orders i,f,g,o
    and r,z,n and the linear-before-reset GRU equal the JAX package's."""
    import torch

    mod = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(I, H).to(
        t["x"].device)
    with torch.no_grad():
        mod.weight_ih_l0.copy_(t["wi"])
        mod.weight_hh_l0.copy_(t["wh"].float())
        mod.bias_ih_l0.copy_(t["b"])
        mod.bias_hh_l0.copy_(t["bh"].float() if cell == "gru"
                             else torch.zeros_like(t["b"]))
    h0 = t["h0"].float()[None]
    state = (h0, t["c0"].float()[None]) if cell == "lstm" else h0
    return mod, state


def check_rnn_kernels(mx, dev):
    """Rows 11-14 against their plain versions at every shape of
    :func:`rnn_kernel_shapes`, fp32 and bf16, LSTM and GRU, forward
    outputs and every backward output; timed beside the plain versions,
    cuDNN's layer (fp32, against the port's layer: input GEMM plus kernel)
    and the bound.  Returns each kernel's record at its main shape (fp32;
    DeepAR training for the LSTM, the GRU phase for the GRU)."""
    import torch

    from mxnet_tpu_torch.ops.kernels import rnn as kr

    gen = torch.Generator(device=dev).manual_seed(4)
    main, predict = {}, []
    log(f"rnn kernels: kernel vs plain, max |err| / max(1, max |ref|) within "
        f"{RNN_TOL} (forward outputs in x_proj's dtype; gates, states and "
        f"every gradient fp32); backward inputs are the plain forward's "
        f"saved tensors; cudnn = torch.nn.LSTM/GRU, fp32, vs the port's "
        f"layer (x @ Wi.T + b, then the kernel); per-step = kernel / T")
    for label, T, N, H, I in rnn_kernel_shapes():
        for cell in ("lstm", "gru"):
            for dtype in ("float32", "bfloat16"):
                t = rnn_inputs(cell, T, N, H, I, dtype, dev, gen)
                if cell == "lstm":
                    f_args = (t["xp"], t["wh"], t["h0"], t["c0"])
                    fwd, fplain = kr.lstm_fwd, kr.lstm_fwd_plain
                    bwd, bplain = kr.lstm_bwd, kr.lstm_bwd_plain
                    ref = fplain(*f_args)
                    b_args = (t["wh"], t["h0"], t["c0"], ref[0], ref[3],
                              ref[4], t["dys"], t["dhn"], t["dcn"])
                else:
                    f_args = (t["xp"], t["wh"], t["bh"], t["h0"])
                    fwd, fplain = kr.gru_fwd, kr.gru_fwd_plain
                    bwd, bplain = kr.gru_bwd, kr.gru_bwd_plain
                    ref = fplain(*f_args)
                    b_args = (t["wh"], t["h0"], ref[0], ref[2], ref[3],
                              t["dys"], t["dhn"])
                got = fwd(*f_args)
                bgot, bref = bwd(*b_args), bplain(*b_args)
                torch.cuda.synchronize()
                ferr = max(rel_err(g, r) for g, r in zip(got, ref))
                berr = max(rel_err(g, r) for g, r in zip(bgot, bref))
                ok = (ferr <= RNN_TOL[dtype] and berr <= RNN_TOL["float32"]
                      and all(bool(torch.isfinite(g).all()) for g in got)
                      and all(g.dtype == r.dtype and g.shape == r.shape
                              for g, r in zip(got, ref)))
                again = bwd(*b_args)
                ok = ok and all(torch.equal(a, b) for a, b in zip(bgot, again))
                fagain = fwd(*f_args)
                ok = ok and all(torch.equal(a, b) for a, b in zip(got, fagain))
                del again, fagain
                f_ms = cuda_ms(lambda: fwd(*f_args), 10)
                b_ms = cuda_ms(lambda: bwd(*b_args), 10)
                fp_ms = cuda_ms(lambda: fplain(*f_args), 2, warmup=1)
                bp_ms = cuda_ms(lambda: bplain(*b_args), 2, warmup=1)
                fbound = rnn_bound(cell, "fwd", T, N, H, dtype)
                bbound = rnn_bound(cell, "bwd", T, N, H, dtype)
                main_shape = (label, cell) in (("deepar_train", "lstm"),
                                               ("gru_phase", "gru"))
                predict_shape = (label, cell) == ("deepar_predict", "lstm")
                # every route that takes this shape, each direction, held
                # against the plain version; on the main paths' shapes
                # (fp32) the planned route and the split route (the
                # shared-memory kernel every launch took before the
                # redesigned routes) are timed, both directions (the
                # forward alone at predict's, whose path runs no backward)
                G = 4 if cell == "lstm" else 3
                pinned = {"fwd": kr._lstm_fwd if cell == "lstm"
                          else kr._gru_fwd,
                          "bwd": kr._lstm_bwd if cell == "lstm"
                          else kr._gru_bwd}
                routes = {}
                for d, args, want in (("fwd", f_args, ref),
                                      ("bwd", b_args, bref)):
                    back = d == "bwd"
                    route = kr.plan(G, back, N, H, dev)[0]
                    timed = (route, "split") if dtype == "float32" and (
                        main_shape or (predict_shape and not back)) else ()
                    routes_ms, rerr, checked = route_times(
                        lambda r: pinned[d](*args, route=r),  # noqa: B023
                        want,
                        lambda r: kr.plan(G, back, N, H, dev, r),  # noqa: B023
                        timed)
                    if rerr > 0:
                        raise SystemExit(f"{cell}_{d}: a route disagrees "
                                         f"with the plain version by "
                                         f"{rerr:.3g} past RNN_TOL at "
                                         f"{label} T={T} {dtype}")
                    routes[d] = (route, routes_ms, checked)
                cores = ""
                if routes["fwd"][0] == "mma":  # 3xTF32 products: their bound
                    cores = (f" (3xTF32; {fbound[0]:.4f} {fbound[1]} at the "
                             f"CUDA cores)")
                    fbound = rnn_bound(cell, "fwd", T, N, H, dtype,
                                       TF32X3_FLOPS)
                lib = ""
                rec = {}
                if dtype == "float32":
                    rec = rnn_layer_times(cell, t, T, N, H, I)
                    lib = (f" | layer fwd port {rec['port_fwd']:.4f} cudnn "
                           f"{rec['cudnn_fwd']:.4f} ms, bwd port "
                           f"{rec['port_bwd']:.4f} cudnn "
                           f"{rec['cudnn_bwd']:.4f} ms")
                log(f"  {label:14s} {cell} T={T} N={N} H={H} {dtype:8s} "
                    f"err fwd {ferr:.3g} bwd {berr:.3g} | fwd {f_ms:.4f} ms "
                    f"({1e3 * f_ms / T:.2f} us/step, bound {fbound[0]:.4f} "
                    f"{fbound[1]}{cores}, plain {fp_ms:.3f}) bwd "
                    f"{b_ms:.4f} ms "
                    f"({1e3 * b_ms / T:.2f} us/step, bound {bbound[0]:.4f} "
                    f"{bbound[1]}, plain {bp_ms:.3f}) | "
                    + "; ".join(
                        f"{cell}_{d} on the {r} route, routes held to plain "
                        f"{'/'.join(chk)}, timed (ms) "
                        + (", ".join(f"{k} {v:.4f}" for k, v in rms.items())
                           or "none")
                        for d, (r, rms, chk) in routes.items())
                    + f"{lib} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"{cell} kernels disagree with their "
                                     f"plain versions: {label} T={T} "
                                     f"{dtype}")
                dev_ms = {}
                if dtype == "float32" and (main_shape or predict_shape):
                    # each kernel's device time: where its wrapper's host
                    # time exceeds it, events over calls read the host; the
                    # backward's with and without its dW product
                    for d, fn, tags in (
                            ("fwd", lambda: fwd(*f_args), (f"{cell}_fwd",)),
                            ("bwd", lambda: bwd(*b_args),
                             (f"{cell}_bwd", "dw_")),
                            ("recurrence", lambda: bwd(*b_args),
                             (f"{cell}_bwd",))):
                        if main_shape or d == "fwd":
                            dev_ms[d] = device_ms(fn, 5, tags)
                    log(f"  {cell} at {label} T={T} N={N}, device ms "
                        f"(torch.profiler): "
                        + ", ".join(f"{cell}_{d} {v:.4f}" if d != "recurrence"
                                    else f"{cell}_bwd without the dW product "
                                    f"{v:.4f}" for d, v in dev_ms.items()))
                if dtype == "float32" and main_shape:
                    hosts = {"fwd": host_us(lambda: fwd(*f_args), 100),
                             "bwd": host_us(lambda: bwd(*b_args), 100)}
                    log(f"  {cell} wrappers' host time a call at {label}: "
                        f"fwd {hosts['fwd']:.1f} us, bwd "
                        f"{hosts['bwd']:.1f} us")
                    for d, ms, pms, bound, err in (
                            ("fwd", f_ms, fp_ms, fbound, ferr),
                            ("bwd", b_ms, bp_ms, bbound, berr)):
                        route, routes_ms, _ = routes[d]
                        main[f"{cell}_{d}"] = {
                            "max_abs_err": err, "ms": ms, "plain_ms": pms,
                            "bound_ms": bound[0], "bound_by": bound[1],
                            "library_ms": rec[f"cudnn_{d}"],
                            "us_per_step": 1e3 * ms / T,
                            "port_layer_ms": rec[f"port_{d}"],
                            "host_us": hosts[d], "kernel_route": route,
                            "split_route_ms": routes_ms.get("split"),
                            "route_ms": routes_ms, "device_ms": dev_ms[d],
                            "shape": f"T={T} N={N} H={H} I={I} fp32"}
                    main[f"{cell}_bwd"]["recurrence_device_ms"] = \
                        dev_ms["recurrence"]
                if dtype == "float32" and predict_shape:
                    route, routes_ms, _ = routes["fwd"]
                    predict.append({
                        "shape": f"T={T} N={N} H={H} I={I} fp32", "ms": f_ms,
                        "device_ms": dev_ms["fwd"],
                        "kernel_route": route,
                        "split_route_ms": routes_ms.get("split"),
                        "route_ms": routes_ms,
                        "bound_ms": fbound[0], "bound_by": fbound[1],
                        "library_ms": rec["cudnn_fwd"],
                        "port_layer_ms": rec["port_fwd"]})
                del t, f_args, b_args, ref, got, bgot, bref
        torch.cuda.empty_cache()
    main["lstm_fwd"]["predict"] = predict
    check_rnn_functions(kr, dev, gen)
    return main


def route_times(call, want, has_plan, timed=()):
    """Each route of the kernel wrappers' ``ROUTES`` that has a plan for
    the call (``has_plan(route)`` does not raise): ``call(route)``'s
    outputs against ``want`` (the plain version's), as the main check
    holds them, and the time of those in ``timed``.  Returns ({route: ms}
    of the timed routes, the largest error past RNN_TOL (0 if none), the
    routes checked)."""
    import torch

    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.kernels import rnn as kr

    times, worst, checked = {}, 0.0, []
    tol = RNN_TOL["bfloat16" if want[0].dtype == torch.bfloat16
                  else "float32"]
    for r in kr.ROUTES:
        try:
            has_plan(r)
        except MXNetError:
            continue
        got = call(r)
        err = max(rel_err(g, w) for g, w in zip(got, want))
        worst = max(worst, err - tol if err > tol else 0.0)
        del got
        checked.append(r)
        if r in timed:
            times[r] = cuda_ms(lambda: call(r), 10)  # noqa: B023
    return times, worst, checked


def rnn_layer_times(cell, t, T, N, H, I):
    """The port's layer (``input_projection``, then the kernel's autograd
    Function, as ``ops/rnn.py`` runs a layer) and cuDNN's, forward and
    backward (autograd through each, the graph kept across calls), fp32:
    each the least of three runs of 10 calls, the two layers in turns
    (port, cuDNN, cuDNN, port, port, cuDNN): at small shapes both are
    host-bound, and the host is shared."""
    import torch

    from mxnet_tpu_torch.ops.kernels import rnn as kr

    mod, state = cudnn_layer(cell, t, H, I, N)
    x = t["x"].detach().requires_grad_(True)
    wi = t["wi"].detach().requires_grad_(True)
    wh = t["wh"].detach().requires_grad_(True)

    def port():
        xp = kr.input_projection(x, wi, t["b"])
        if cell == "lstm":
            return kr.lstm_layer(xp, wh, t["h0"], t["c0"])[0]
        return kr.gru_layer(xp, wh, t["bh"], t["h0"])[0]

    y = port()
    yc = mod(x, state)[0]
    params = (x, mod.weight_ih_l0, mod.weight_hh_l0)
    calls = {
        "port_fwd": port, "cudnn_fwd": lambda: mod(x, state),
        "port_bwd": lambda: torch.autograd.grad(
            y, (x, wi, wh), t["dys"], retain_graph=True),
        "cudnn_bwd": lambda: torch.autograd.grad(
            yc, params, t["dys"], retain_graph=True)}
    out = {}
    for d in ("fwd", "bwd"):
        for order in (("port", "cudnn"), ("cudnn", "port"),
                      ("port", "cudnn")):
            for side in order:
                key = f"{side}_{d}"
                out[key] = min(out.get(key, float("inf")),
                               cuda_ms(calls[key], 10))
    return out


def check_rnn_functions(kr, dev, gen):
    """lstm_layer and gru_layer on the card (kernel forward and backward)
    against torch.autograd through the plain forward, fp32 at the DeepAR
    and GRU-phase shapes: every gradient within RNN_TOL of its largest
    magnitude."""
    import torch

    worst = 0.0
    for cell, T, N, H in (("lstm", 96, 32, 40), ("gru", 35, 32, 200)):
        t = rnn_inputs(cell, T, N, H, H, "float32", dev, gen)
        keys = ("xp", "wh", "h0", "c0") if cell == "lstm" else \
            ("xp", "wh", "bh", "h0")
        grads = []
        for fn in ((kr.lstm_layer, kr.lstm_layer_plain) if cell == "lstm"
                   else (kr.gru_layer, kr.gru_layer_plain)):
            ins = [t[k].clone().requires_grad_(True) for k in keys]
            outs = fn(*ins)
            loss = (outs[0] * t["dys"]).sum() + (outs[1] * t["dhn"]).sum()
            grads.append(torch.autograd.grad(loss, ins))
        worst = max(worst, max(rel_err(g, r) for g, r in zip(*grads)))
    ok = worst <= RNN_TOL["float32"]
    log(f"rnn kernels: lstm_layer/gru_layer on the card vs autograd of the "
        f"plain forward, fp32: max err / max |grad| {worst:.3g} (limit "
        f"{RNN_TOL['float32']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the RNN autograd Functions disagree with autograd "
                         "through the plain forward")


# -- phases 11-13: DeepAR -----------------------------------------------------


def deepar_net(mx, ctx, dropout=0.1):
    """GluonTS's DeepAR defaults: 2x40 LSTM, Student-t head, Xavier from
    seed 0 (deferred input width)."""
    mx.random.seed(0)
    net = mx.models.deepar(40, 2, dropout=dropout)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def deepar_data():
    """The port's GluonTS-style pipeline: 16 synthetic hourly series of 200
    points and a splitter of context 72, prediction 24."""
    import numpy as np

    from mxnet_tpu_torch.data import timeseries as dts

    ds = dts.synthetic_dataset(np.random.RandomState(0))
    return ds, dts.InstanceSplitter(DEEPAR_CONTEXT, DEEPAR_PREDICT, seed=0)


def train_deepar(mx, card):
    """20 Adam steps of DeepAR at batch 32 on fresh covariate batches, then
    predict; then card vs CPU.  Returns the launch counts of both runs, the
    median step, lstm_fwd's launches by route on each path and lstm_bwd's
    in training."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import rnn as kr

    gpu = mx.gpu(0)
    net = deepar_net(mx, gpu)
    ds, splitter = deepar_data()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
    losses, step_ms, missing = [], [], []
    kernels.reset_counts()
    for step in range(DEEPAR_STEPS):
        inst = splitter.training_instances(ds, DEEPAR_BATCH)
        series = mx.nd.array(inst["target"], ctx=gpu)
        covs = mx.nd.array(inst["covariates"], ctx=gpu)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            nll = net(series, covs)
        nll.backward()
        if step == 0:
            for name, p in net.collect_params().items():
                g = p.data().grad
                if g is None or not bool(torch.isfinite(g).all()):
                    missing.append(name)
        trainer.step(DEEPAR_BATCH)
        losses.append(nll.asscalar())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {k: (kernels.KERNEL_COUNTS[k].launches,
                  kernels.KERNEL_COUNTS[k].plain_calls_on_cuda)
              for k in ("lstm_fwd", "lstm_bwd")}
    routes = launches_by_route(kr.lstm_fwd_counts)
    bwd_routes = launches_by_route(kr.lstm_bwd_counts)
    n = DEEPAR_STEPS
    median_ms = statistics.median(step_ms[2:])
    log(f"deepar train: 2x40 LSTM, Student-t, dropout 0.1, b={DEEPAR_BATCH}"
        f" context {DEEPAR_CONTEXT} + prediction {DEEPAR_PREDICT}, 3 "
        f"covariates, Adam 1e-3, {n} steps; nll {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; step median {median_ms:.3f} ms over steps "
        f"3-{n} (first {step_ms[0]:.1f} ms), "
        f"{DEEPAR_BATCH / (median_ms / 1e3):.1f} series/s on {card}")
    log(f"deepar train: losses {[round(v, 4) for v in losses]}")
    log(f"deepar train: (launches, plain calls on cuda) {counts} (2 x {n} "
        f"= {2 * n} each); launches by route: lstm_fwd {routes}, lstm_bwd "
        f"{bwd_routes}")
    checks = {
        "finite_losses": all(np.isfinite(losses)),
        "first_backward_gradients": not missing,
        "nll_falls": statistics.mean(losses[-5:]) < losses[0],
        "launches": all(c[0] == 2 * n for c in counts.values()),
        "plain_calls_on_cuda": all(c[1] == 0 for c in counts.values()),
        "lstm_fwd_register_route": routes == {"split": 0, "reg": 2 * n,
                                              "mma": 0},
        "lstm_bwd_register_route": bwd_routes == {"split": 0, "reg": 2 * n},
    }
    if missing:
        log(f"deepar train: parameters without a finite gradient after the "
            f"first backward: {missing}")

    pred = splitter.prediction_instances(ds)
    plaunch, by_route = {}, {"deepar_train": routes}
    for label, reps in (("deepar_predict", 1), ("deepar_predict_b32", 2)):
        # reps 2: the 16 series twice, GluonTS's default predict batch
        context = mx.nd.array(np.tile(pred["target"], (reps, 1)), ctx=gpu)
        covs = np.tile(pred["covariates"], (reps, 1, 1))
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        samples = net.predict(context, prediction_length=DEEPAR_PREDICT,
                              num_samples=DEEPAR_SAMPLES, covariates=covs,
                              seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (kr.lstm_fwd_counts.launches,
               kr.lstm_fwd_counts.plain_calls_on_cuda)
        proutes = by_route[label] = launches_by_route(kr.lstm_fwd_counts)
        plaunch[label] = got[0]
        p50 = np.median(samples[0], axis=0)
        p90 = np.percentile(samples[0], 90, axis=0)
        nser = samples.shape[0]
        log(f"deepar predict: {nser} series x {DEEPAR_SAMPLES} samples "
            f"(N={nser * DEEPAR_SAMPLES}), {DEEPAR_PREDICT} steps in "
            f"{wall:.3f} s on {card}; lstm_fwd (launches, plain calls on "
            f"cuda) {got} (2 x {DEEPAR_PREDICT} = {2 * DEEPAR_PREDICT}), by "
            f"route {proutes}")
        log(f"deepar predict: series 0 p50[:6] "
            f"{np.round(p50[:6], 3).tolist()} p90[:6] "
            f"{np.round(p90[:6], 3).tolist()}")
        checks[f"{label}_launches"] = got == (2 * DEEPAR_PREDICT, 0)
        checks[f"{label}_tensor_core_route"] = proutes == {
            "split": 0, "reg": 0, "mma": 2 * DEEPAR_PREDICT}
        checks[f"{label}_samples"] = samples.shape == (
            nser, DEEPAR_SAMPLES, DEEPAR_PREDICT) and bool(
                np.isfinite(samples).all())
    del net, trainer
    torch.cuda.empty_cache()
    checks.update(deepar_card_vs_cpu(mx, splitter, ds))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"deepar checks failed: {failed}")
    return ({k: c[0] for k, c in counts.items()}, plaunch, median_ms,
            by_route, bwd_routes)


def launches_by_route(counts):
    """A kernel's launches by route since the counts were last reset."""
    from mxnet_tpu_torch.ops.kernels import rnn as kr

    return {r: getattr(counts, f"{r}_launches") for r in kr.ROUTES
            if hasattr(counts, f"{r}_launches")}


def deepar_card_vs_cpu(mx, splitter, ds):
    """Batch 4, dropout 0, fp32 with TF32 off, the same weights on the card
    and on the CPU: the first NLL, l0_h2h_weight's gradient, 2 Adam steps'
    losses, the first predict step's (mu, sigma, nu) and predict's paths
    (4 samples, 3 steps) must agree."""
    import numpy as np
    import torch

    inst = splitter.training_instances(ds, 4)
    pred = splitter.prediction_instances(ds)
    ctx_np, cov_np = pred["target"][:4], pred["covariates"][:4]
    runs, weights = [], None
    for ctx in (mx.gpu(0), mx.cpu()):
        net = deepar_net(mx, ctx, dropout=0.0)
        batch = [mx.nd.array(inst[k], ctx=ctx)
                 for k in ("target", "covariates")]
        if weights is None:
            with mx.autograd.pause():
                net(*batch)
            weights = {k: p.data().detach().cpu().numpy().copy() for k, p in
                       net._collect_params_with_prefix().items()}
        else:
            mx.load_numpy_params(net, weights)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 1e-3})
        losses = []
        for step in range(2):
            with mx.autograd.record():
                nll = net(*batch)
            nll.backward()
            if step == 0:
                grad = net._collect_params_with_prefix()[
                    "lstm.l0_h2h_weight"].grad().detach().cpu().numpy().copy()
            trainer.step(4)
            losses.append(nll.asscalar())
        mx.load_numpy_params(net, weights)
        dev = next(iter(net.collect_params().values())).data().device
        params = net.next_params(ctx_np, torch.from_numpy(cov_np).to(dev))
        paths = net.predict(ctx_np, prediction_length=3, num_samples=4,
                            covariates=cov_np[:, :DEEPAR_CONTEXT + 3], seed=1)
        runs.append((losses, grad, params, paths))
        del net, trainer
    (gl, gg, gp, gpath), (cl, cg, cp, cpath) = runs
    nll_err = abs(gl[0] - cl[0]) / abs(cl[0])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    grad_err = float(np.abs(gg - cg).max() / np.abs(cg).max())
    param_err = max(float(np.abs(a - b).max()) for a, b in zip(gp, cp))
    path_err = float(np.abs(gpath - cpath).max() / np.abs(cpath).max())
    log(f"deepar card vs cpu, b=4 dropout 0 fp32: first nll {gl[0]:.7f} vs "
        f"{cl[0]:.7f} rel err {nll_err:.3g} (limit {DEEPAR_NLL_RTOL}); "
        f"l0_h2h_weight gradient max abs err / max |grad| {grad_err:.3g} "
        f"(limit {DEEPAR_GRAD_RTOL}); 2 Adam steps' losses {gl} vs {cl} max "
        f"rel err {loss_err:.3g} (limit {DEEPAR_LOSS_RTOL}); first predict "
        f"step's (mu, sigma, nu) max abs err {param_err:.3g} (limit "
        f"{DEEPAR_PARAM_ATOL}); predict paths max err / max |path| "
        f"{path_err:.3g} (limit {DEEPAR_PATH_RTOL})")
    return {"card_vs_cpu_nll": nll_err <= DEEPAR_NLL_RTOL,
            "card_vs_cpu_grad": grad_err <= DEEPAR_GRAD_RTOL,
            "card_vs_cpu_losses": loss_err <= DEEPAR_LOSS_RTOL,
            "card_vs_cpu_predict_params": param_err <= DEEPAR_PARAM_ATOL,
            "card_vs_cpu_predict_paths": path_err <= DEEPAR_PATH_RTOL}


# -- phase 14: the GRU ----------------------------------------------------------


def train_gru(mx, card):
    """gluon.rnn.GRU(200, num_layers=2), TNC, T=35, N=32, input 200, 20
    Adam steps on an L2 loss against a fixed target.  Returns the launch
    counts, the median step and gru_fwd's and gru_bwd's launches by
    route."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels

    class GruRegression(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.gru = mx.gluon.rnn.GRU(GRU_HIDDEN, num_layers=2)

        def hybrid_forward(self, F, x, target):
            return F.mean(F.square(self.gru(x) - target)) * 0.5

    gpu = mx.gpu(0)
    mx.random.seed(0)
    net = GruRegression()
    net.initialize(mx.init.Xavier(), ctx=gpu)
    rng = np.random.RandomState(5)
    x = mx.nd.array(rng.randn(GRU_T, GRU_BATCH, GRU_HIDDEN) * 0.5, ctx=gpu)
    target = mx.nd.array(np.tanh(rng.randn(GRU_T, GRU_BATCH, GRU_HIDDEN)),
                         ctx=gpu)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
    losses, step_ms = [], []
    kernels.reset_counts()
    for _ in range(GRU_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = net(x, target)
        loss.backward()
        trainer.step(1)
        losses.append(loss.asscalar())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {k: (kernels.KERNEL_COUNTS[k].launches,
                  kernels.KERNEL_COUNTS[k].plain_calls_on_cuda)
              for k in ("gru_fwd", "gru_bwd")}
    routes = {k: launches_by_route(kernels.KERNEL_COUNTS[k])
              for k in ("gru_fwd", "gru_bwd")}
    n = GRU_STEPS
    median_ms = statistics.median(step_ms[2:])
    log(f"gru: gluon.rnn.GRU({GRU_HIDDEN}, num_layers=2) TNC T={GRU_T} "
        f"N={GRU_BATCH}, L2 loss, Adam 1e-3, {n} steps; loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; step median {median_ms:.3f} "
        f"ms over steps 3-{n} on {card}; (launches, plain calls on cuda) "
        f"{counts} (2 x {n} = {2 * n} each); launches by route {routes}")
    checks = {"finite_losses": all(np.isfinite(losses)),
              "loss_falls": losses[-1] < losses[0],
              "launches": all(c[0] == 2 * n for c in counts.values()),
              "plain_calls_on_cuda": all(c[1] == 0 for c in counts.values()),
              "gru_fwd_cluster_route": routes["gru_fwd"] == {
                  "split": 0, "cluster": 2 * n},
              "gru_bwd_cluster_route": routes["gru_bwd"] == {
                  "split": 0, "cluster": 2 * n}}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"gru checks failed: {failed}")
    return {k: c[0] for k, c in counts.items()}, median_ms, routes


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-train", action="store_true",
                    help="also profile two BERT training steps")
    ap.add_argument("--profile-resnet", action="store_true",
                    help="also profile two ResNet-50 training steps")
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
    from mxnet_tpu_torch.ops.kernels import rnn as krnn
    spills = spill_bytes(krnn.library.build_log,
                         ("lstm_fwd_reg_kernel", "lstm_fwd_mma_kernel",
                          "gru_bwd_cluster_kernel", "lstm_bwd_reg_kernel",
                          "gru_fwd_cluster_kernel"))
    log(f"spill bytes (stores, loads) of the register, tensor-core and "
        f"cluster routes' kernels: {sorted(set(spills.values()))} over "
        f"{len(spills)} instantiations (24 + 16 + 2 + 12 + 6)")
    if len(spills) != 60 or any(v != (0, 0) for v in spills.values()):
        raise SystemExit(f"a redesigned route's kernel spills: {spills}")
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.ops.kernels import conv_fused as kcf
    for lib, kname in ((fa.library, "mma_kernel"),
                       (fa.bwd_library, "mma_kernel"),
                       (kcf.library, "tf32_mm_kernel")):
        mixes = sass_mix(lib, kname)
        log(f"SASS of the tensor-core kernels in {lib.source.name} "
            f"(opcode counts): "
            + ("cuobjdump not found" if mixes is None else "; ".join(
                f"{short_name(fn)}: {mix}" for fn, mix in mixes.items())))

    flash = check_flash_attention(mx)
    bwd = check_flash_attention_bwd(mx)
    serve = serve_bert(mx, card, flash["ms"])
    train = train_bert(mx, card, bwd, profile=args.profile_train)
    rkern = check_resnet_kernels(torch.device("cuda", 0))
    rtrain, rpredict = train_resnet(mx, card, profile=args.profile_resnet)
    rnn = check_rnn_kernels(mx, torch.device("cuda", 0))
    dtrain, dpredict, _, droutes, dbroutes = train_deepar(mx, card)
    gtrain, _, groutes = train_gru(mx, card)

    src = "mxnet_tpu/ops/pallas/flash_attention.py"
    cf_src = "mxnet_tpu/ops/pallas/conv_fused.py"
    rnn_src = "mxnet_tpu/ops/pallas/rnn.py"
    rnn_cu = "mxnet_tpu_torch/csrc/rnn.cu"
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
        dict(name="bn_stats", route="cuda",
             source="mxnet_tpu_torch/csrc/batch_norm.cu",
             replaces="mxnet_tpu/ops/pallas/batch_norm.py:33",
             launches=rtrain["bn_stats"], **rkern["bn_stats"]),
        dict(name="matmul_bn_stats", route="cuda",
             source="mxnet_tpu_torch/csrc/conv_fused.cu",
             replaces=f"{cf_src}:123",
             launches=rtrain["matmul_bn_stats"], **rkern["matmul_bn_stats"]),
        dict(name="bn_act_matmul", route="cuda",
             source="mxnet_tpu_torch/csrc/conv_fused.cu",
             replaces=f"{cf_src}:227", launches=rpredict,
             **rkern["bn_act_matmul"]),
        dict(name="bn_act_matmul_stats", route="cuda",
             source="mxnet_tpu_torch/csrc/conv_fused.cu",
             replaces=f"{cf_src}:323",
             launches=rtrain["bn_act_matmul_stats"],
             **rkern["bn_act_matmul_stats"]),
        dict(name="lstm_fwd", route="cuda", source=rnn_cu,
             replaces=f"{rnn_src}:41",
             launches=dtrain["lstm_fwd"] + sum(dpredict.values()),
             launches_by_path={"deepar_train": dtrain["lstm_fwd"],
                               **dpredict},
             launches_by_route=droutes, **rnn["lstm_fwd"]),
        dict(name="lstm_bwd", route="cuda", source=rnn_cu,
             replaces=f"{rnn_src}:132", launches=dtrain["lstm_bwd"],
             launches_by_route=dbroutes, **rnn["lstm_bwd"]),
        dict(name="gru_fwd", route="cuda", source=rnn_cu,
             replaces=f"{rnn_src}:300", launches=gtrain["gru_fwd"],
             launches_by_route=groutes["gru_fwd"], **rnn["gru_fwd"]),
        dict(name="gru_bwd", route="cuda", source=rnn_cu,
             replaces=f"{rnn_src}:366", launches=gtrain["gru_bwd"],
             launches_by_route=groutes["gru_bwd"], **rnn["gru_bwd"]),
    ]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
