"""Time the port's BN-statistics kernel (``bn_stats_fwd``) at the four
shapes ResNet-50's training step hands it, on one CUDA card.

For each stage (M, C) of the step at batch 128, 224^2, in bf16 and fp32:
the wrapper by CUDA events (10 back-to-back calls after 2 warm ones), the
kernels it launches by torch.profiler's device time, the wrapper's host
time a call, ``torch.var_mean`` by events, and the least time (the input
read once at 3.35 TB/s); the sums are held to fp64 sums as
``chip_smoke.py`` holds them (``check_stats``).  The timing helpers are
this checkout's ``chip_smoke.py``'s; the package timed is the one under
``--root`` (default: this checkout), so a second checkout (the parent
commit, unpacked with ``git archive``) is timed by the same code.
``--scan`` adds C=64 at M from 512 (one block: the launch's fixed cost)
to twice stage 1's, and reads the streaming rate from the two largest
(both past the 50 MB L2 in fp32; smaller inputs stay in L2 between
back-to-back calls) and the fixed cost at stage 1 beside it.  Prints a
line per (shape, dtype), a JSON line of them all, then the card's name
and power limit as nvidia-smi gives them.

    python3 tools/bn_stats_times.py [--root DIR] [--label NAME] [--scan]
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
STAGES = ((401408, 64, 3), (100352, 128, 4), (25088, 256, 6), (6272, 512, 3))
# (M, C, launches a step) of the scan: not on the step, so 0
SCAN = tuple((m, 64, 0) for m in (512, 6272, 25088, 100352, 200704, 802816))


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose mxnet_tpu_torch is timed")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--scan", action="store_true",
                    help="also time C=64 at M from 512 to 802816")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bn_stats_times: no CUDA device is visible", file=sys.stderr)
        return 2
    smoke = load_smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from mxnet_tpu_torch.ops.kernels import batch_norm as kbn

    kbn.library.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dtype in ("bfloat16", "float32"):
        for m, c, per_step in STAGES + SCAN * args.scan:
            x = (torch.rand(m, c, generator=gen, device=dev) - 0.3).to(
                getattr(torch, dtype))
            fn = kbn.bn_stats_fwd
            err, ok = smoke.check_stats(fn(x), x)
            row = dict(label=args.label, dtype=dtype, M=m, C=c,
                       launches_per_step=per_step,
                       ms=smoke.cuda_ms(lambda: fn(x), 10),
                       device_ms=smoke.device_ms(lambda: fn(x), 10,
                                                 ("stats",)),
                       host_us=smoke.host_us(lambda: fn(x)),
                       library_ms=smoke.cuda_ms(
                           lambda: torch.var_mean(x, dim=0, correction=0),
                           10),
                       bound_ms=smoke.least_ms(
                           m * c * x.element_size() + 2 * c * 4,
                           3.0 * m * c, "float32")[0],
                       sums_rel=err, ok=ok)
            rows.append(row)
            print(f"{args.label}: M={m} C={c} {dtype}: events "
                  f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms, "
                  f"host {row['host_us']:.1f} us, var_mean "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
                  f"ms, sums_rel {err:.3g} {'ok' if ok else 'FAIL'}",
                  flush=True)
            del x
    if args.scan:
        for dtype in ("bfloat16", "float32"):
            (b1, t1), (b2, t2) = sorted(
                (r["M"] * r["C"] * (2 if dtype == "bfloat16" else 4),
                 r["device_ms"]) for r in rows
                if r["dtype"] == dtype and r["C"] == 64
                and r["M"] in (401408, 802816))
            rate = (b2 - b1) / (t2 - t1)  # bytes a ms
            print(f"{args.label}: {dtype} C=64, M 401408 -> 802816: "
                  f"{rate * 1e-9:.3f} TB/s streaming; fixed cost at stage 1 "
                  f"{t1 - b1 / rate:.4f} ms", flush=True)
    print(json.dumps(rows))
    print(smoke.card_line())
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
