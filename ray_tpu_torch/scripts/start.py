"""``python -m ray_tpu_torch start`` / ``stop``: a cluster's processes.

Port of ray_tpu/scripts/start.py. ``start --head`` runs a head and a node
daemon in a process of their own (``--block``: in this one, until
SIGTERM or SIGINT), writes its pid and the head's address under the temp
dir (the config's ``temp_dir``, or ``--temp-dir``), and prints how to
connect: ``init(address="host:port")`` or ``init(address="auto")``, which
reads that address. ``start --address=host:port`` joins a node to a head.
A node's resources are ``--num-cpus`` (default: this host's cores), the
cards ``accelerators/gpu.py`` counts, and ``--resources`` (JSON).
``stop`` SIGTERMs every process recorded under the temp dir (SIGKILL
after ``--grace-period``): each stops its node's workers on the way out.
Out: the head-only mode and persistence (``--head-only``, ``--persist``:
head fault tolerance, ROADMAP Queue A item 7(b)).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid


def default_temp_dir() -> str:
    from ray_tpu_torch.utils.config import get_config

    return get_config().temp_dir


def read_address(temp_dir: str | None = None) -> str:
    """The address of the head ``start --head`` runs (``init("auto")``)."""
    path = os.path.join(temp_dir or default_temp_dir(), "head.addr")
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        raise ConnectionError(
            f"no running head found ({path} is missing): start one with "
            "`python -m ray_tpu_torch start --head`") from None


def _node_resources(num_cpus: float | None, resources_json: str | None
                    ) -> dict[str, float]:
    from ray_tpu_torch.accelerators.gpu import GpuAcceleratorManager

    totals = {"CPU": float(num_cpus if num_cpus is not None
                           else (os.cpu_count() or 1))}
    totals.update(GpuAcceleratorManager().get_current_node_resources())
    if resources_json:
        totals.update({k: float(v)
                       for k, v in json.loads(resources_json).items()})
    return totals


def _node_labels(labels_json: str | None) -> dict[str, str]:
    from ray_tpu_torch.accelerators.gpu import GpuAcceleratorManager

    labels = GpuAcceleratorManager().get_current_node_labels()
    if labels_json:
        labels.update(json.loads(labels_json))
    return labels


def _write(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)  # readers never see a partial file


def _serve_until_signal(stop_cb) -> int:
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    stop_cb()
    return 0


def serve_head(args) -> int:
    """Run a head and a node daemon in this process until signalled."""
    from ray_tpu_torch.core.cluster.client import start_head, start_node
    from ray_tpu_torch.core.cluster.protocol import EventLoopThread

    temp = args.temp_dir
    os.makedirs(temp, exist_ok=True)
    head = start_head(host=args.host, port=args.port)
    daemon = start_node(head.rpc.host, head.rpc.port,
                        _node_resources(args.num_cpus, args.resources),
                        _node_labels(args.labels), node_id=uuid.uuid4().hex)
    _write(os.path.join(temp, "head.pid"), str(os.getpid()))
    _write(os.path.join(temp, "head.addr"), head.address)
    print(f"ray_tpu_torch head serving at {head.address}", flush=True)

    def stop():
        io = EventLoopThread.get()
        for part in (daemon, head):
            try:
                io.run(part.stop(), 60)
            except Exception:  # noqa: BLE001 - already stopped
                pass
        for name in ("head.addr", "head.pid"):
            try:
                os.unlink(os.path.join(temp, name))
            except OSError:
                pass

    return _serve_until_signal(stop)


def serve_node(args) -> int:
    """Run a node daemon joined to ``--address`` until signalled."""
    from ray_tpu_torch.core.cluster.client import start_node
    from ray_tpu_torch.core.cluster.protocol import EventLoopThread

    temp = args.temp_dir
    os.makedirs(temp, exist_ok=True)
    host, port = args.address.rsplit(":", 1)
    node_id = args.node_id or uuid.uuid4().hex
    daemon = start_node(host, int(port),
                        _node_resources(args.num_cpus, args.resources),
                        _node_labels(args.labels), node_id=node_id)
    _write(os.path.join(temp, f"node-{node_id}.pid"), str(os.getpid()))
    _write(os.path.join(temp, f"node-{node_id}.ready"),
           f"{daemon.rpc.host}:{daemon.rpc.port}")
    print(f"ray_tpu_torch node {node_id} joined {args.address}", flush=True)

    def stop():
        try:
            EventLoopThread.get().run(daemon.stop(), 60)
        except Exception:  # noqa: BLE001 - already stopped
            pass

    return _serve_until_signal(stop)


def _spawn_detached(serve_cmd: str, args, ready_file: str, log_name: str,
                    timeout: float = 60.0) -> str:
    """Start ``python -m ray_tpu_torch <serve_cmd> ...`` in a session of
    its own; wait for its readiness file and return what it holds."""
    temp = args.temp_dir
    os.makedirs(temp, exist_ok=True)
    if os.path.exists(ready_file):
        os.unlink(ready_file)
    argv = [sys.executable, "-m", "ray_tpu_torch", serve_cmd,
            "--temp-dir", temp]
    for attr, flag in (("host", "--host"), ("port", "--port"),
                       ("address", "--address"), ("num_cpus", "--num-cpus"),
                       ("resources", "--resources"), ("labels", "--labels"),
                       ("node_id", "--node-id")):
        val = getattr(args, attr, None)
        if val is not None:
            argv += [flag, str(val)]
    from ray_tpu_torch.core.cluster.node_daemon import worker_pythonpath

    env = dict(os.environ, PYTHONPATH=worker_pythonpath())
    with open(os.path.join(temp, log_name), "ab") as log:
        proc = subprocess.Popen(argv, stdout=log, stderr=log, env=env,
                                stdin=subprocess.DEVNULL,
                                start_new_session=True)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(ready_file):
            with open(ready_file) as f:
                return f.read().strip()
        if proc.poll() is not None:
            with open(os.path.join(temp, log_name), "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
            raise RuntimeError(
                f"{serve_cmd} exited with {proc.returncode}:\n{tail}")
        time.sleep(0.05)
    proc.kill()
    proc.wait()
    raise TimeoutError(f"{serve_cmd} did not become ready in {timeout}s")


def cmd_start(args) -> int:
    args.address = getattr(args, "address", None)
    if args.head == bool(args.address):
        print("error: pass --head to start a head, or --address=<head> to "
              "join one (not both)", file=sys.stderr)
        return 2
    if args.head:
        if args.block:
            return serve_head(args)
        addr = _spawn_detached(
            "serve-head", args, os.path.join(args.temp_dir, "head.addr"),
            "head.log")
        print(f"ray_tpu_torch head started at {addr}")
        print(f'connect with ray_tpu_torch.init(address="{addr}") or '
              f'init(address="auto"); add nodes with\n'
              f"  python -m ray_tpu_torch start --address={addr}")
        return 0
    args.node_id = getattr(args, "node_id", None) or uuid.uuid4().hex
    if args.block:
        return serve_node(args)
    _spawn_detached(
        "serve-node", args,
        os.path.join(args.temp_dir, f"node-{args.node_id}.ready"),
        f"node-{args.node_id}.log")
    print(f"ray_tpu_torch node {args.node_id} joined {args.address}")
    return 0


def _is_ours(pid: int) -> bool:
    """Only signal a pid whose command line is still one of ours (a pid
    file can outlive its process, and the number be reused)."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return b"ray_tpu_torch" in f.read()
    except OSError:
        return False


def cmd_stop(args) -> int:
    """Stop every process recorded under the temp dir."""
    temp = args.temp_dir
    if not os.path.isdir(temp):
        print("nothing to stop")
        return 0
    pids = {}
    for name in sorted(os.listdir(temp)):
        if not name.endswith(".pid"):
            continue
        path = os.path.join(temp, name)
        try:
            with open(path) as f:
                pid = int(f.read().strip())
        except (OSError, ValueError):
            pid = None
        if pid is not None and _is_ours(pid):
            try:
                os.kill(pid, signal.SIGTERM)
                pids[name] = pid
            except OSError:
                pass
        try:
            os.unlink(path)
        except OSError:
            pass
    signalled = len(pids)
    deadline = time.monotonic() + args.grace_period
    while pids and time.monotonic() < deadline:
        for name, pid in list(pids.items()):
            if not _is_ours(pid) or _zombie(pid):
                del pids[name]
        time.sleep(0.1)
    for pid in pids.values():
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    for name in os.listdir(temp):
        if name.endswith((".ready", ".addr")):
            try:
                os.unlink(os.path.join(temp, name))
            except OSError:
                pass
    print(f"stopped {signalled} process(es)"
          + (f" ({len(pids)} force-killed)" if pids else ""))
    return 0


def _zombie(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def add_parsers(sub) -> None:
    st = sub.add_parser("start", help="start a head or a node")
    st.add_argument("--head", action="store_true")
    st.add_argument("--address", default=argparse.SUPPRESS,
                    help="head host:port to join (a node)")
    st.add_argument("--host", default="127.0.0.1")
    st.add_argument("--port", type=int, default=6379)
    st.add_argument("--num-cpus", type=float, default=None, dest="num_cpus")
    st.add_argument("--resources", default=None,
                    help='JSON resource overrides, e.g. \'{"GPU": 4}\'')
    st.add_argument("--labels", default=None, help="JSON node labels")
    st.add_argument("--block", action="store_true",
                    help="serve in the foreground")
    st.add_argument("--temp-dir", default=default_temp_dir(), dest="temp_dir")
    st.add_argument("--node-id", default=None, dest="node_id")
    st.set_defaults(_fn=cmd_start)

    sp = sub.add_parser("stop", help="stop this host's cluster processes")
    sp.add_argument("--temp-dir", default=default_temp_dir(), dest="temp_dir")
    sp.add_argument("--grace-period", type=float, default=10.0,
                    dest="grace_period")
    sp.set_defaults(_fn=cmd_stop)

    for name, fn in (("serve-head", serve_head), ("serve-node", serve_node)):
        pp = sub.add_parser(name)
        pp.add_argument("--host", default="127.0.0.1")
        pp.add_argument("--port", type=int, default=6379)
        pp.add_argument("--address", default=None)
        pp.add_argument("--num-cpus", type=float, default=None,
                        dest="num_cpus")
        pp.add_argument("--resources", default=None)
        pp.add_argument("--labels", default=None)
        pp.add_argument("--temp-dir", default=default_temp_dir(),
                        dest="temp_dir")
        pp.add_argument("--node-id", default=None, dest="node_id")
        pp.set_defaults(_fn=fn)
