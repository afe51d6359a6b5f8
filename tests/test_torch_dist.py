"""The port's multi-process path on the CPU: ``parallel.dist`` on
``torch.distributed`` (gloo), ``kvstore('dist_sync')`` under
``gluon.Trainer``, and the launchers.

One launch of 2 ranks through ``python -m mxnet_tpu_torch.tools.launch``
runs ``tests/torch_dist_worker.py train``: the collectives, then the
nightly's loop (``tests/nightly/dist_gluon_trainer.py``) with
``update_on_kvstore`` True and False.  Both ranks' parameters must be
bit-identical after every step, and bit-identical to the same loop run
here with ``kvstore='device'`` over ``cpu(0)`` and ``cpu(1)`` on the same
halves (a sum of two values is one IEEE addition on either path); the
losses within 1e-6 relative (summed in other orders).  A second launch
goes through the repository's ``tools/launch.py`` unchanged, to prove
that its env protocol is the one ``dist.init`` reads.  Each launch runs
on a free port (the suite runs under xdist) with its own timeout.  The
``gpu``-marked test needs a CUDA device and skips here.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_dist_worker.py"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(launcher, mode, out, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for k in list(env):  # a clean env protocol: only the launcher's
        if k.startswith(("DMLC_", "MXTPU_COORDINATOR", "MXTPU_NUM_WORKER",
                         "MXTPU_WORKER_ID")):
            del env[k]
    for _ in range(3):  # another process may take the free port first
        cmd = [sys.executable, *launcher, "-n", "2", "--launcher", "local",
               "-p", str(_free_port()), sys.executable, str(WORKER),
               str(out), mode]
        proc = subprocess.run(cmd, cwd=str(REPO), env=env, timeout=timeout,
                              capture_output=True, text=True)
        if "address already in use" not in proc.stderr.lower():
            break
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(2)]


def test_dist_sync_trainer_is_bit_identical_to_two_contexts(tmp_path):
    sys.path.insert(0, str(REPO / "tests"))
    import torch_dist_worker as w

    ranks = _launch(["-m", "mxnet_tpu_torch.tools.launch"], "train",
                    tmp_path)
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["size"] == 2 and r["backend"] == "gloo" for r in ranks)
    npz = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for uok in (True, False):
        losses, after = w.train("device", [tmx.cpu(0), tmx.cpu(1)],
                                [slice(0, 8), slice(8, 16)], uok)
        for r in ranks:
            np.testing.assert_allclose(r[f"losses_uok{int(uok)}"], losses,
                                       rtol=1e-6)
        assert losses[-1] < losses[0]
        for s, params in enumerate(after):
            for k, v in params.items():
                key = f"uok{int(uok)}/{s}/{k}"
                np.testing.assert_array_equal(npz[0][key], npz[1][key])
                np.testing.assert_array_equal(npz[0][key], v)


def test_repository_launcher_starts_the_port_workers(tmp_path):
    """``tools/launch.py`` (the JAX package's launcher, with no server)
    exports the env protocol the port's ``dist.init`` reads."""
    ranks = _launch([str(REPO / "tools" / "launch.py")], "collectives",
                    tmp_path)
    assert sorted(r["rank"] for r in ranks) == [0, 1]
    assert all(r["backend"] == "gloo" for r in ranks)


def test_port_launcher_refuses_what_later_parts_bring():
    """The ssh, mpi and k8s launchers and -s came with slice 7, part 3
    (tests/test_torch_launch.py); what the launcher still refuses is what
    the JAX tool refuses: servers beside another launcher, and ssh
    without a host file."""
    from mxnet_tpu_torch.tools import launch

    for argv in (["-n", "2", "--launcher", "ssh", "true"],
                 ["-n", "2", "-s", "1", "--launcher", "mpi", "true"],
                 ["-n", "2", "-s", "1", "--launcher", "ssh", "-H", "h",
                  "true"]):
        with pytest.raises(SystemExit):
            launch.main(argv)
    env = launch.worker_env(4, 3, 1234, base={})
    assert env["MXTPU_COORDINATOR"] == "127.0.0.1:1234"
    assert env["DMLC_PS_ROOT_PORT"] == "1234"
    assert env["MXTPU_WORKER_ID"] == env["DMLC_WORKER_ID"] == "3"
    assert env["MXTPU_NUM_WORKER"] == env["DMLC_NUM_WORKER"] == "4"


def test_backend_rule():
    from mxnet_tpu_torch.parallel import dist

    n = tmx.num_gpus()
    nccl = n >= 1 and torch.distributed.is_nccl_available()
    assert dist.choose_backend(1) == ("nccl" if nccl else "gloo")
    assert dist.choose_backend(n + 1) == "gloo"


@pytest.mark.gpu
def test_two_ranks_on_the_card(tmp_path):
    """2 ranks training on the card (``gpu(r)`` and NCCL with 2 or more
    cards, both on ``gpu(0)`` and gloo with one): the backend the rule
    names, and both ranks' parameters bit-identical after every step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine with -m gpu")
    ranks = _launch(["-m", "mxnet_tpu_torch.tools.launch"], "card",
                    tmp_path)
    want = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    assert all(r["backend"] == want for r in ranks)
    a, b = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    assert a.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
