"""The port's launcher (``python -m mxnet_tpu_torch.tools.launch``)
against the JAX package's (``tools/launch.py``): the k8s manifest, the
mpi shim's rank translation, the ssh and mpi command lines (with
``subprocess`` replaced, so nothing is started), and ``-s`` starting the
server role beside the workers with the env protocol the JAX tool gives.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from mxnet_tpu_torch.tools import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_launch():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_launch", os.path.join(REPO, "tools", "launch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _body(text):
    """The manifest without its leading comment lines, which name the
    tool that wrote it."""
    lines = text.splitlines(keepends=True)
    while lines and lines[0].startswith("#"):
        lines.pop(0)
    return "".join(lines)


@pytest.mark.parametrize("n,name,image", [
    (4, "trainjob", "example/img:1"), (1, "mxtpu-job", "mxnet-tpu:latest")])
def test_k8s_manifest_is_the_jax_tools(n, name, image):
    cmd = ["python", "train.py", "--lr", "0.1"]
    got = launch.k8s_manifest(n, cmd, 9099, image, name)
    want = _jax_launch().k8s_manifest(n, cmd, 9099, image, name)
    assert _body(got) == _body(want)
    assert got.startswith("# Generated by python -m "
                          "mxnet_tpu_torch.tools.launch --launcher k8s")
    assert f'value: "{name}-0.{name}:9099"' in got
    assert f"command: {json.dumps(cmd)}" in got


def test_k8s_launcher_prints_the_manifest(capsys):
    assert launch.main(["-n", "2", "--launcher", "k8s", "--image", "img",
                        "--job-name", "j", "python", "t.py"]) == 0
    assert capsys.readouterr().out == launch.k8s_manifest(
        2, ["python", "t.py"], 9099, "img", "j")


def test_mpi_shim_translates_the_rank():
    """The re-entry as ``mpirun`` makes it: the launcher's file, which
    imports nothing of the package."""
    shim = [sys.executable, launch.__file__, "--mpi-shim", "--"]
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in list(env):
        if "RANK" in k or "PROCID" in k:
            del env[k]
    for var in ("OMPI_COMM_WORLD_RANK", "PMI_RANK", "SLURM_PROCID"):
        res = subprocess.run(
            shim + [sys.executable, "-c",
                    "import os; print('wid', os.environ['MXTPU_WORKER_ID'], "
                    "os.environ['DMLC_WORKER_ID'])"],
            capture_output=True, text=True, timeout=60,
            env=dict(env, **{var: "3"}), cwd=REPO)
        assert res.returncode == 0, res.stderr[-1000:]
        assert "wid 3 3" in res.stdout
    # no rank variable: a diagnosable failure, never a wrong id
    res = subprocess.run(shim + ["true"], capture_output=True, text=True,
                         timeout=60, env=env, cwd=REPO)
    assert res.returncode == 2
    assert "no MPI rank variable" in res.stderr


class _Recorder:
    """``subprocess`` stand-in: records each command and environment and
    hands back processes that exit with ``codes[i]`` (0 by default)."""

    def __init__(self, codes=None):
        self.calls, self.codes = [], dict(codes or {})

    def popen(self, argv, env=None, **kw):
        rec = self

        class P:
            def __init__(self):
                self.index = len(rec.calls)
                rec.calls.append((list(argv), dict(env or {})))
                self.returncode = rec.codes.get(self.index, 0)

            def poll(self):
                return self.returncode

            def wait(self, timeout=None):
                return self.returncode

            def send_signal(self, sig):
                pass

            def kill(self):
                pass

        return P()

    def run(self, argv, **kw):
        return subprocess.CompletedProcess(argv, 0, b"", b"")

    def call(self, argv, env=None, **kw):
        self.calls.append((list(argv), dict(env or {})))
        return 0


def _patch(monkeypatch, module, rec):
    monkeypatch.setattr(module.subprocess, "Popen", rec.popen)
    monkeypatch.setattr(module.subprocess, "run", rec.run)
    monkeypatch.setattr(module.subprocess, "call", rec.call)


def test_ssh_commands_are_the_jax_tools(monkeypatch, tmp_path):
    jl = _jax_launch()
    hosts = ["h0", "h1", "h2"]
    cmd = ["python", "train.py"]
    monkeypatch.setenv("DMLC_PS_BIND_HOST", "0.0.0.0")
    got, want = _Recorder(), _Recorder()
    _patch(monkeypatch, launch, got)
    assert launch.launch_ssh(hosts, 5, cmd, 9100) == 0
    _patch(monkeypatch, jl, want)
    assert jl.launch_ssh(hosts, 5, cmd, 9100) == 0
    assert [a for a, _ in got.calls] == [a for a, _ in want.calls]
    assert len(got.calls) == 3   # 5 // 3 = 1 worker a host
    assert "MXTPU_WORKER_ID=2" in got.calls[2][0][-1]
    # the command line the launcher's main builds from a host file
    (tmp_path / "hosts").write_text("h0\nh1\n")
    got.calls.clear()
    _patch(monkeypatch, launch, got)
    assert launch.main(["-n", "2", "--launcher", "ssh", "-H",
                        str(tmp_path / "hosts"), "python", "t.py"]) == 0
    assert [a[3] for a, _ in got.calls] == ["h0", "h1"]


@pytest.mark.parametrize("hostfile", [False, True])
def test_mpi_command_is_the_jax_tools(monkeypatch, tmp_path, hostfile):
    jl = _jax_launch()
    hf = None
    if hostfile:
        hf = str(tmp_path / "hosts")
        (tmp_path / "hosts").write_text("node7 slots=4\nnode8\n")
    cmd = ["python", "train.py"]
    got, want = _Recorder(), _Recorder()
    _patch(monkeypatch, launch, got)
    assert launch.launch_mpi(4, cmd, 9200, hostfile=hf) == 0
    _patch(monkeypatch, jl, want)
    assert jl.launch_mpi(4, cmd, 9200, hostfile=hf) == 0
    (g_argv, g_env), = got.calls
    (j_argv, j_env), = want.calls
    # the same mpirun line but for the shim's own path
    shim = g_argv.index("--mpi-shim")
    assert g_argv[shim - 1] == launch.__file__.replace(".pyc", ".py") \
        or g_argv[shim - 1].endswith("mxnet_tpu_torch/tools/launch.py")
    assert g_argv[:shim - 1] == j_argv[:shim - 1]
    assert g_argv[shim:] == j_argv[j_argv.index("--mpi-shim"):]
    assert g_argv[:4] == ["mpirun", "--oversubscribe", "--allow-run-as-root",
                          "-n"]
    keys = ("MXTPU_COORDINATOR", "DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT",
            "MXTPU_NUM_WORKER", "DMLC_NUM_WORKER", "DMLC_NUM_SERVER",
            "DMLC_ROLE")
    assert {k: g_env[k] for k in keys} == {k: j_env[k] for k in keys}
    assert g_env["MXTPU_COORDINATOR"] == (
        "node7:9200" if hostfile else "127.0.0.1:9200")


def test_servers_start_beside_the_workers_as_in_the_jax_tool(monkeypatch):
    """``-s 2``: two ``DMLC_ROLE=server`` processes of the port's
    ``kvstore_server`` on ``PORT + 1``, then the workers, with the JAX
    tool's env protocol."""
    jl = _jax_launch()
    got, want = _Recorder(), _Recorder()
    _patch(monkeypatch, launch, got)
    assert launch.main(["-n", "3", "-s", "2", "-p", "9300", "python",
                        "w.py"]) == 0
    _patch(monkeypatch, jl, want)
    assert jl.launch_local(3, ["python", "w.py"], 9300, 2) == 0
    assert [a for a, _ in got.calls[:2]] == [
        [sys.executable, "-m", "mxnet_tpu_torch.kvstore_server"]] * 2
    assert [a for a, _ in want.calls[:2]] == [
        [sys.executable, "-m", "mxnet_tpu.kvstore_server"]] * 2
    assert [a for a, _ in got.calls[2:]] == [a for a, _ in want.calls[2:]]
    keys = ("MXTPU_COORDINATOR", "DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT",
            "MXTPU_NUM_WORKER", "DMLC_NUM_WORKER", "DMLC_NUM_SERVER",
            "DMLC_PS_SERVER_PORT", "DMLC_ROLE", "DMLC_SERVER_ID",
            "MXTPU_WORKER_ID", "DMLC_WORKER_ID")
    for (_, g), (_, j) in zip(got.calls, want.calls):
        assert {k: g.get(k) for k in keys} == {k: j.get(k) for k in keys}
    assert got.calls[0][1]["DMLC_ROLE"] == "server"
    assert got.calls[1][1]["DMLC_SERVER_ID"] == "1"
    assert got.calls[0][1]["DMLC_PS_SERVER_PORT"] == "9301"


def test_a_server_that_dies_fails_the_job(monkeypatch, capsys):
    rec = _Recorder(codes={0: 1})     # the server exits with 1
    _patch(monkeypatch, launch, rec)
    assert launch.launch_local(2, ["python", "w.py"], 9400, 1) == 1
    assert "launch: server 0 exited with 1" in capsys.readouterr().err
    rec = _Recorder(codes={0: -15})   # SIGTERM is a clean stop
    _patch(monkeypatch, launch, rec)
    assert launch.launch_local(2, ["python", "w.py"], 9400, 1) == 0
