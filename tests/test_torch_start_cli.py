"""``python -m ray_tpu_torch start`` / ``status`` / ``stop`` against
ray_tpu's CLI, on the CPU.

Each side, in a temp dir of its own: ``start --head --port 0 --block``
(the head and a node in a foreground process, its address written to
``head.addr``), ``start --address=<head>`` (a second node, detached),
``--address <head> status``, then ``stop`` (SIGTERM to every process the
temp dir records). Both CLIs print the same fields: the cluster's
resources as ``<name>: <available> / <total> available`` and the node
table (``node_id``, ``alive``, ``resources``) with both nodes, and
``stop`` reports the processes it signalled. Port-only:
``init(address="auto")`` (and ``"host:port"``) from another process runs
a task in a worker process of that cluster, and after ``stop`` no
process of the cluster is alive: the head's, the node's, and every
worker's (their pids read from the daemons before the stop).
"""

import os
import re
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_TIMEOUT_S = 60


def _env(temp):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               RTPU_TEMP_DIR=temp, RAY_TPU_TEMP_DIR=temp)
    return env


def _cli(pkg, temp, *args):
    return subprocess.run([sys.executable, "-m", pkg, *args],
                          env=_env(temp), capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S, cwd=temp)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _fields(status: str) -> dict:
    res = dict(re.findall(r"^  (\w+): (\S+ / \S+) available$", status, re.M))
    nodes = re.search(r"^Nodes \((\d+)\):\n(.*)$", status, re.M)
    rows = [l for l in status.splitlines()
            if re.match(r"^[0-9a-f]{32}\s", l)]
    return {"resources": res, "nodes": int(nodes.group(1)),
            "columns": nodes.group(2).split(),
            "alive": sorted(l.split()[1] for l in rows)}


def _session(pkg, temp) -> dict:
    os.makedirs(temp, exist_ok=True)
    head = subprocess.Popen(
        [sys.executable, "-m", pkg, "start", "--head", "--port", "0",
         "--block", "--num-cpus", "2", "--temp-dir", temp],
        env=_env(temp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=temp)
    out = {"head_pid": head.pid}
    try:
        addr_file = os.path.join(temp, "head.addr")
        deadline = time.monotonic() + CLI_TIMEOUT_S
        while not os.path.exists(addr_file):
            assert head.poll() is None, head.stdout.read()
            assert time.monotonic() < deadline, "the head never came up"
            time.sleep(0.05)
        with open(addr_file) as f:
            addr = f.read().strip()
        out["addr"] = addr
        node = _cli(pkg, temp, "start", f"--address={addr}", "--num-cpus",
                    "1", "--temp-dir", temp)
        assert node.returncode == 0, node.stderr
        out["node_line"] = "joined" in node.stdout
        status = _cli(pkg, temp, "--address", addr, "status")
        assert status.returncode == 0, status.stderr
        out["status"] = _fields(status.stdout)
        if pkg == "ray_tpu_torch":
            out["port"] = _port_only(temp, addr)
        stop = _cli(pkg, temp, "stop", "--temp-dir", temp)
        assert stop.returncode == 0, stop.stderr
        # "stopped 2 process(es)", and ray_tpu adds " (k force-killed)"
        # for what outlived its grace period.
        out["stop"] = re.match(r"stopped (\d+) process\(es\)",
                               stop.stdout.strip()).group(1)
        out["head_rc"] = head.wait(CLI_TIMEOUT_S)
    finally:
        if head.poll() is None:
            head.kill()
            head.wait()
    return out


_DRIVER = r'''
import os, sys
import ray_tpu_torch as rt
from ray_tpu_torch.core.cluster.protocol import RpcClient
rt.init(address=sys.argv[1])
@rt.remote
def pid():
    return os.getpid()
task = rt.get(pid.remote(), timeout=60)
rt_ = rt.core.worker.global_worker.runtime
pids = []
for n in rt_.list_nodes().values():
    c = RpcClient(*n["addr"])
    info = c.call("node_info")
    pids += [w["pid"] for w in info["workers"].values()]
    c.close()
rt.shutdown()
print(task, os.getpid(), *pids)
'''


def _port_only(temp, addr) -> dict:
    out = {}
    for address in ("auto", addr):
        got = subprocess.run([sys.executable, "-c", _DRIVER, address],
                             env=_env(temp), capture_output=True, text=True,
                             timeout=CLI_TIMEOUT_S, cwd=temp)
        assert got.returncode == 0, got.stderr
        task, driver, *workers = map(int, got.stdout.split())
        out[address == "auto"] = (task != driver and task in workers,
                                  workers)
    return out


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    return {pkg: _session(pkg, str(tmp_path_factory.mktemp(pkg)))
            for pkg in ("ray_tpu", "ray_tpu_torch")}


def test_status_prints_ray_tpus_fields(sessions):
    jax_s, port = sessions["ray_tpu"], sessions["ray_tpu_torch"]
    assert port["status"] == jax_s["status"]
    assert port["status"]["resources"] == {"CPU": "3 / 3"}
    assert port["status"]["nodes"] == 2
    assert port["status"]["columns"] == ["node_id", "alive", "resources"]
    assert port["node_line"] and jax_s["node_line"]


def test_stop_signals_the_head_and_node(sessions):
    assert sessions["ray_tpu_torch"]["stop"] == sessions["ray_tpu"]["stop"]
    assert sessions["ray_tpu_torch"]["stop"] == "2"
    assert sessions["ray_tpu_torch"]["head_rc"] == 0


def test_init_auto_and_address_run_tasks_in_worker_processes(sessions):
    port = sessions["ray_tpu_torch"]["port"]
    assert port[True][0] and port[False][0]


def test_no_process_of_the_cluster_outlives_stop(sessions):
    port = sessions["ray_tpu_torch"]
    pids = [port["head_pid"], *port["port"][True][1], *port["port"][False][1]]
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert [p for p in pids if _alive(p)] == []
