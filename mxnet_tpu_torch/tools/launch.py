"""Start the workers of a multi-process job on this machine (ref:
``tools/launch.py``'s local launcher, ``launch_local``; dmlc-tracker).

    python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local -p 29510 \\
        python train.py

Each worker gets the env protocol that ``parallel.dist.init`` reads, in
both spellings:

- ``MXTPU_COORDINATOR`` = ``127.0.0.1:PORT``, ``DMLC_PS_ROOT_URI`` =
  ``127.0.0.1``, ``DMLC_PS_ROOT_PORT`` = ``PORT``;
- ``MXTPU_NUM_WORKER`` / ``DMLC_NUM_WORKER`` = ``N``;
- ``MXTPU_WORKER_ID`` / ``DMLC_WORKER_ID`` = the worker's rank;
- ``DMLC_NUM_SERVER`` = 0 and ``DMLC_ROLE`` = ``worker``.

Rank 0 listens on ``PORT``.  When a worker fails, the others are
terminated and the launcher exits with a non-zero code; it exits with 0
when every worker did.  The ssh, mpi and k8s launchers and parameter
servers (``-s``) come with slice 7, part 3 and raise here.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def worker_env(n, rank, port, base=None):
    """The environment of worker ``rank`` of ``n``."""
    env = dict(os.environ if base is None else base)
    env.update({
        "MXTPU_COORDINATOR": f"127.0.0.1:{port}",
        "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(port),
        "MXTPU_NUM_WORKER": str(n), "DMLC_NUM_WORKER": str(n),
        "DMLC_NUM_SERVER": "0",
        "MXTPU_WORKER_ID": str(rank), "DMLC_WORKER_ID": str(rank),
        "DMLC_ROLE": "worker",
    })
    return env


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + 10
    for p in procs:
        try:
            p.wait(max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch_local(n, cmd, port):
    """Run ``cmd`` as ``n`` workers here; their exit codes OR-ed (1 for a
    worker a signal ended)."""
    procs = [subprocess.Popen(cmd, env=worker_env(n, i, port))
             for i in range(n)]
    code = 0
    try:
        live = list(procs)
        while live:
            for p in list(live):
                rc = p.poll()
                if rc is None:
                    continue
                live.remove(p)
                if rc:
                    code |= rc if rc > 0 else 1
            if code:
                break
            time.sleep(0.05)
    except KeyboardInterrupt:
        code = 1
    finally:
        _stop(procs)
    return code


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="parameter servers (dist_async): slice 7, part 3")
    ap.add_argument("--launcher", choices=["local", "ssh", "mpi", "k8s"],
                    default="local")
    ap.add_argument("-H", "--hostfile", default=None)
    ap.add_argument("-p", "--port", type=int, default=9099)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given")
    if args.launcher != "local" or args.num_servers:
        what = (f"--launcher {args.launcher}" if args.launcher != "local"
                else "parameter servers (-s)")
        ap.error(f"{what} is not ported yet; it comes with part 3 of the "
                 "distributed slice (slice 7, part 3; ROADMAP.md queue 1)")
    return launch_local(args.num_workers, cmd, args.port)


if __name__ == "__main__":
    sys.exit(main())
