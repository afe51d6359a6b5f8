"""Time the routes of the port's LSTM backward and GRU forward recurrence
kernels against each other on one CUDA card.

For each shape below, every route of ``lstm_bwd`` or ``gru_fwd`` that has
a plan (``mxnet_tpu_torch/ops/kernels/rnn.py:plan``), and for the GRU
forward at H=200 the cluster route at clusters of 4, 8 and 16 blocks: the
wrapper by CUDA events (10 calls, the least of ``--rounds`` rounds taken in
turns A B B A ...), and the recurrence kernel alone by torch.profiler's
device time (the LSTM backward's dW product left out).  fp32, inputs from a
seed.  Prints one line per (kernel, shape, route), then the card's name and
power limit as nvidia-smi gives them.

    python3 tools/rnn_route_times.py [--rounds 3]
"""
import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (kernel, T, N, H): DeepAR training, at 1 and 192 steps too (the launch's
# fixed cost against a step's), H=96 and a predict-sized batch; the GRU
# phase, at 1 and 70 steps too, and the widths about the GRU forward's
# crossover between the split route's independent blocks and the cluster
# route
SHAPES = (("lstm_bwd", 96, 32, 40), ("lstm_bwd", 1, 32, 40),
          ("lstm_bwd", 192, 32, 40), ("lstm_bwd", 96, 32, 96),
          ("lstm_bwd", 96, 1600, 40), ("gru_fwd", 35, 32, 200),
          ("gru_fwd", 1, 32, 200), ("gru_fwd", 70, 32, 200),
          *(("gru_fwd", 35, 32, H) for H in (40, 48, 56, 64, 72, 80, 96)))


def events_ms(fn, iters=10):
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


def device_ms(fn, tag, iters=5):
    """Device time (ms) of the kernels whose names hold ``tag``, a call:
    each kernel's mean over the launches torch.profiler recorded (it has
    left one out now and then) times its launches a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total / e.count * max(1, round(e.count / iters))
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and tag in e.key) / 1e3


def calls(kernel, T, N, H, dev, gen):
    """{route label: a call of the wrapper pinned to it}."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.kernels import rnn as kr

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    G = 4 if kernel == "lstm_bwd" else 3
    xp, wh = rnd(T, N, G * H, scale=0.5), rnd(G * H, H, scale=H ** -0.5)
    h0, c0 = rnd(N, H, scale=0.1), rnd(N, H, scale=0.1)
    if kernel == "lstm_bwd":
        ys, _, _, gates, cs = kr.lstm_fwd_plain(xp, wh, h0, c0)
        args = (wh, h0, c0, ys, gates, cs, rnd(T, N, H), rnd(N, H),
                rnd(N, H))
        pinned = kr._lstm_bwd
    else:
        args = (xp, wh, rnd(G * H, scale=0.1), h0)
        pinned = kr._gru_fwd
    plans = {}
    for route in kr.ROUTES:
        try:
            kr.plan(G, kernel == "lstm_bwd", N, H, dev, route)
        except MXNetError:
            continue
        plans[route] = route
    if kernel == "gru_fwd" and H == 200:
        for nb, jb in ((1, 50), (2, 25), (4, 13)):
            plans[f"cluster C={-(-H // jb)} NB={nb}"] = ("cluster", nb, jb)
    return {label: (lambda p=p: pinned(*args, route=p))
            for label, p in plans.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rnn_route_times: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxnet_tpu_torch.ops.kernels import rnn as kr

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(9)
    for kernel, T, N, H in SHAPES:
        fns = calls(kernel, T, N, H, dev, gen)
        planned = kr.plan(4 if kernel == "lstm_bwd" else 3,
                          kernel == "lstm_bwd", N, H, dev)
        best = dict.fromkeys(fns, float("inf"))
        for r in range(args.rounds):
            for label in fns if r % 2 == 0 else reversed(list(fns)):
                best[label] = min(best[label], events_ms(fns[label]))
        for label, fn in fns.items():
            dev_ms = device_ms(fn, kernel)
            print(f"{kernel} T={T} N={N} H={H} {label:22s} events "
                  f"{best[label]:.4f} ms, recurrence device {dev_ms:.4f} ms "
                  f"({1e3 * dev_ms / T:.2f} us/step)"
                  + (f"  <- planned {planned}" if label == planned[0] else ""))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
