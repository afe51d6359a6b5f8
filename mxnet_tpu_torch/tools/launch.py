"""Start the processes of a multi-process job (ref: ``tools/launch.py``;
dmlc-tracker's local, ssh and mpi transports).

    python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local -p 29510 \\
        python train.py
    python -m mxnet_tpu_torch.tools.launch -n 2 -s 1 python train.py
    python -m mxnet_tpu_torch.tools.launch -n 8 --launcher ssh -H hosts \\
        python train.py
    python -m mxnet_tpu_torch.tools.launch -n 4 --launcher mpi python train.py
    python -m mxnet_tpu_torch.tools.launch -n 4 --launcher k8s \\
        --image IMAGE python train.py > job.yaml

Each worker gets the env protocol that ``parallel.dist.init`` reads, in
both spellings:

- ``MXTPU_COORDINATOR`` = ``HOST:PORT``, ``DMLC_PS_ROOT_URI`` = ``HOST``,
  ``DMLC_PS_ROOT_PORT`` = ``PORT`` (rank 0 listens there);
- ``MXTPU_NUM_WORKER`` / ``DMLC_NUM_WORKER`` = ``N``;
- ``MXTPU_WORKER_ID`` / ``DMLC_WORKER_ID`` = the worker's rank;
- ``DMLC_NUM_SERVER`` and ``DMLC_ROLE`` = ``worker``.

``-s N`` (the local launcher) also starts N parameter servers for
``dist_async``, ``python -m mxnet_tpu_torch.kvstore_server`` with
``DMLC_ROLE=server``, ``DMLC_SERVER_ID`` and ``DMLC_PS_SERVER_PORT`` =
``PORT + 1`` (server ``i`` binds ``PORT + 1 + i``; the workers get the
same base and shard keys over the servers).  When a worker fails, the
others are terminated; a server that dies with a code other than 0 or
-15 (SIGTERM) fails the job too, and the launcher logs each server's exit
code.  It exits with 0 when every worker did.

The ssh launcher runs ``N`` workers over the hosts of ``-H`` (the first
host is the coordinator); the mpi launcher has ``mpirun`` start the ranks,
each of which re-enters this module with ``--mpi-shim`` to turn its MPI
rank variable into the worker id; the k8s launcher prints an indexed Job
and a headless Service for ``kubectl apply -f -`` and starts nothing.
Only the local launcher starts servers.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time


def worker_env(n, rank, port, base=None, num_servers=0):
    """The environment of worker ``rank`` of ``n``."""
    env = dict(os.environ if base is None else base)
    env.update(_protocol(n, port, num_servers))
    env.update({"MXTPU_WORKER_ID": str(rank), "DMLC_WORKER_ID": str(rank),
                "DMLC_ROLE": "worker"})
    return env


def _protocol(n, port, num_servers=0):
    out = {
        "MXTPU_COORDINATOR": f"127.0.0.1:{port}",
        "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(port),
        "MXTPU_NUM_WORKER": str(n), "DMLC_NUM_WORKER": str(n),
        "DMLC_NUM_SERVER": str(num_servers),
    }
    if num_servers:
        out["DMLC_PS_SERVER_PORT"] = str(port + 1)
    return out


def server_env(n, sid, port, num_servers):
    """The environment of parameter server ``sid`` of ``num_servers``."""
    env = dict(os.environ)
    env.update(_protocol(n, port, num_servers))
    env.update({"DMLC_ROLE": "server", "DMLC_SERVER_ID": str(sid)})
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


def launch_local(n, cmd, port, num_servers=0):
    """Run ``cmd`` as ``n`` workers here, beside ``num_servers``
    parameter servers; returns the workers' exit codes OR-ed (1 for a
    worker a signal ended, or for a server that died)."""
    servers = [subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.kvstore_server"],
        env=server_env(n, sid, port, num_servers))
        for sid in range(num_servers)]
    procs = [subprocess.Popen(cmd, env=worker_env(n, i, port,
                                                  num_servers=num_servers))
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
            for s in servers:
                # a server that died mid-job (a port clash, a crash) fails
                # the job even if the workers limp on
                if s.poll() not in (None, 0, -signal.SIGTERM):
                    code |= 1
            if code:
                break
            time.sleep(0.05)
    except KeyboardInterrupt:
        code = 1
    finally:
        _stop(procs)
        _stop(servers)
    for sid, s in enumerate(servers):
        print(f"launch: server {sid} exited with {s.returncode}",
              file=sys.stderr, flush=True)
        if s.returncode not in (0, -signal.SIGTERM):
            code |= 1
    return code


def launch_mpi(n, cmd, port, hostfile=None, mpirun="mpirun"):
    """The mpirun transport (ref: dmlc_tracker/mpi.py): ``mpirun`` starts
    the ranks and each takes its worker id from its MPI rank (the
    ``--mpi-shim`` re-entry).  The protocol goes on the command line
    through ``env``, since remote ranks do not inherit the launcher's
    environment; ``--oversubscribe`` and ``--allow-run-as-root`` are passed
    where this ``mpirun`` takes them (tried richest first)."""
    proto = _protocol(n, port)
    proto["DMLC_ROLE"] = "worker"
    if hostfile:
        # several hosts: every rank must reach the coordinator
        with open(hostfile) as f:
            first = [h.strip().split()[0] for h in f if h.strip()][0]
        proto["MXTPU_COORDINATOR"] = f"{first}:{port}"
        proto["DMLC_PS_ROOT_URI"] = first
    env = dict(os.environ)
    env.update(proto)
    extra = []
    for flags in (["--oversubscribe", "--allow-run-as-root"],
                  ["--allow-run-as-root"], ["--oversubscribe"], []):
        p = subprocess.run([mpirun] + flags + ["-n", "1", "true"],
                           capture_output=True)
        if p.returncode == 0:
            extra = flags
            break
    argv = [mpirun] + extra + ["-n", str(n)]
    if hostfile:
        argv += ["--hostfile", hostfile]
    argv += ["env"] + [f"{k}={v}" for k, v in proto.items()]
    argv += [sys.executable, os.path.abspath(__file__), "--mpi-shim",
             "--"] + list(cmd)
    return subprocess.call(argv, env=env)


_RANK_VARS = ("OMPI_COMM_WORLD_RANK", "PMIX_RANK", "PMI_RANK",
              "MV2_COMM_WORLD_RANK", "SLURM_PROCID")


def mpi_shim(cmd):
    """One rank's re-entry under mpirun: its MPI rank variable (OpenMPI,
    PMIx, PMI/MPICH, MVAPICH2 or Slurm spellings) becomes the worker id,
    then the command replaces this process.  Exits with 2 when no rank
    variable is set."""
    rank = next((os.environ[v] for v in _RANK_VARS
                 if os.environ.get(v) is not None), None)
    if rank is None:
        sys.stderr.write("launch --mpi-shim: no MPI rank variable found in "
                         "the environment\n")
        sys.exit(2)
    os.environ["MXTPU_WORKER_ID"] = rank
    os.environ["DMLC_WORKER_ID"] = rank
    os.execvp(cmd[0], cmd)


K8S_HEADER = """\
# Generated by python -m mxnet_tpu_torch.tools.launch --launcher k8s (ref:
# dmlc_tracker's yarn/k8s transports). A headless Service gives worker-0 a
# stable DNS name for the torch.distributed rendezvous; an indexed Job runs
# one worker per pod with the DMLC env protocol from the completion index.
"""

K8S_MANIFEST = """\
apiVersion: v1
kind: Service
metadata:
  name: {name}
spec:
  clusterIP: None
  selector:
    job-name: {name}
  ports:
  - port: {port}
---
apiVersion: batch/v1
kind: Job
metadata:
  name: {name}
spec:
  completions: {n}
  parallelism: {n}
  completionMode: Indexed
  template:
    metadata:
      labels:
        job-name: {name}
    spec:
      subdomain: {name}
      restartPolicy: Never
      containers:
      - name: worker
        image: {image}
        command: {cmd_json}
        env:
        - name: MXTPU_WORKER_ID
          valueFrom:
            fieldRef:
              fieldPath: metadata.annotations['batch.kubernetes.io/job-completion-index']
        - name: DMLC_WORKER_ID
          valueFrom:
            fieldRef:
              fieldPath: metadata.annotations['batch.kubernetes.io/job-completion-index']
        - name: MXTPU_COORDINATOR
          value: "{name}-0.{name}:{port}"
        - name: DMLC_PS_ROOT_URI
          value: "{name}-0.{name}"
        - name: DMLC_PS_ROOT_PORT
          value: "{port}"
        - name: MXTPU_NUM_WORKER
          value: "{n}"
        - name: DMLC_NUM_WORKER
          value: "{n}"
        - name: DMLC_ROLE
          value: worker
"""


def k8s_manifest(n, cmd, port, image, name="mxtpu-job"):
    """The indexed Job and headless Service for ``kubectl apply -f -``
    (the JAX tool's manifest under this launcher's header comment).  It
    renders text only: nothing here reaches a cluster."""
    return K8S_HEADER + K8S_MANIFEST.format(
        n=n, port=port, image=image, name=name, cmd_json=json.dumps(cmd))


def launch_ssh(hosts, n, cmd, port):
    """The ssh transport: ``n`` workers, ``n // len(hosts)`` (at least 1)
    a host in host order, one ``ssh`` each, the first host the
    coordinator; ``DMLC_PS_BIND_HOST`` is passed on where it is set.
    Returns the exit codes OR-ed."""
    coordinator = hosts[0]
    per_host = max(1, n // len(hosts))
    procs, wid = [], 0
    for host in hosts:
        for _ in range(per_host):
            if wid >= n:
                break
            envs = " ".join([
                f"MXTPU_COORDINATOR={coordinator}:{port}",
                f"DMLC_PS_ROOT_URI={coordinator}",
                f"DMLC_PS_ROOT_PORT={port}",
                f"MXTPU_NUM_WORKER={n}", f"DMLC_NUM_WORKER={n}",
                f"MXTPU_WORKER_ID={wid}", f"DMLC_WORKER_ID={wid}",
                "DMLC_ROLE=worker",
            ] + ([f"DMLC_PS_BIND_HOST={os.environ['DMLC_PS_BIND_HOST']}"]
                 if os.environ.get("DMLC_PS_BIND_HOST") else []))
            remote = f"cd {os.getcwd()} && env {envs} {' '.join(cmd)}"
            procs.append(subprocess.Popen(["ssh", "-o",
                                           "StrictHostKeyChecking=no",
                                           host, remote]))
            wid += 1
    code = 0
    for p in procs:
        code |= p.wait()
    return code


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "--mpi-shim":
        cmd = argv[1:]
        if cmd and cmd[0] == "--":
            cmd = cmd[1:]
        mpi_shim(cmd)
        return 0  # not reached: the command replaced this process
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="parameter-server processes for dist_async "
                    "(the local launcher)")
    ap.add_argument("--launcher", choices=["local", "ssh", "mpi", "k8s"],
                    default="local")
    ap.add_argument("-H", "--hostfile", default=None)
    ap.add_argument("-p", "--port", type=int, default=9099)
    ap.add_argument("--image", default="mxnet-tpu:latest",
                    help="container image for --launcher k8s")
    ap.add_argument("--job-name", default="mxtpu-job",
                    help="Job and Service name for --launcher k8s")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given")
    if args.launcher == "local":
        return launch_local(args.num_workers, cmd, args.port,
                            args.num_servers)
    if args.num_servers:
        # the dist_async transport needs its servers: refuse rather than
        # start the workers without them
        ap.error(f"--num-servers is not supported by the {args.launcher} "
                 "launcher (use --launcher local)")
    if args.launcher == "mpi":
        return launch_mpi(args.num_workers, cmd, args.port,
                          hostfile=args.hostfile)
    if args.launcher == "k8s":
        sys.stdout.write(k8s_manifest(args.num_workers, cmd, args.port,
                                      args.image, args.job_name))
        return 0
    if not args.hostfile:
        ap.error("--launcher ssh needs -H HOSTFILE")
    with open(args.hostfile) as f:
        hosts = [h.strip() for h in f if h.strip()]
    return launch_ssh(hosts, args.num_workers, cmd, args.port)


if __name__ == "__main__":
    sys.exit(main())
