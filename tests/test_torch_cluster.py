"""ray_tpu_torch's cluster runtime against ray_tpu's, on the CPU.

The programs of tests/test_cluster.py run under ``ray_tpu.cluster_utils.
Cluster`` and then under ``ray_tpu_torch.cluster_utils.Cluster`` (one
node of 4 CPUs and a 4-unit custom resource, head and daemons on the test
process's io loop, every worker a real process), each side shut down
before the other starts. A module fixture runs every program once a side,
in the same order (some add nodes), and each test compares one program's
result: values equal, exception class names the same. Where a program
reaches into a runtime (an arena's object count, deleting an arena copy),
the side's own names are used.

Port-only: a worker's ``sys.modules`` holds no ``jax``, ``ray_tpu`` or
``cloudpickle``; an open handle raises at submit; ``init(address=
"local-cluster")`` runs a task and an actor in processes of their own and
leaves none behind at ``shutdown``; ``cancel(force=True)`` and
``kill(no_restart=False)`` kill the worker process.
"""

import os
import pickle
import sys
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

RESULTS_TIMEOUT_S = 60


def _pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _err(e: BaseException) -> str:
    return type(e).__name__


# -- the programs: prog(api, cluster, rt, side) -> a comparable value -------

def prog_process_boundary(api, c, rt, side):
    @api.remote
    def whoami():
        return os.getpid()

    return api.get(whoami.remote(), timeout=60) != os.getpid()


def prog_args_and_refs(api, c, rt, side):
    @api.remote
    def add(a, b):
        return a + b

    ref = api.put(10)
    nested = api.put([1, 2])

    @api.remote
    def first(box):
        return api.get(box[0])[1]

    return api.get(add.remote(ref, 5), timeout=60), \
        api.get(first.remote([nested]), timeout=60)


def prog_lease_reuse(api, c, rt, side):
    @api.remote
    def sq(x):
        return x * x

    return api.get([sq.remote(i) for i in range(20)], timeout=60)


def prog_large_object(api, c, rt, side):
    @api.remote
    def big():
        return np.ones(300_000, dtype=np.float32)

    arr = api.get(big.remote(), timeout=60)
    return arr.shape, float(arr[0])


def prog_arena(api, c, rt, side):
    before = rt.shm.stats()["num_objects"]
    ref = api.put(np.arange(200_000, dtype=np.float32))
    after_put = rt.shm.stats()["num_objects"] - before

    @api.remote
    def consume(a):
        return float(a.sum())

    total = api.get(consume.remote(ref), timeout=60)

    @api.remote
    def produce():
        return np.full(150_000, 2.0, dtype=np.float32)

    out_ref = produce.remote()
    first = float(api.get(out_ref, timeout=60)[0])
    grew = rt.shm.stats()["num_objects"] >= before + 2
    del ref, out_ref
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and \
            rt.shm.stats()["num_objects"] > before:
        time.sleep(0.05)
    return (after_put, total, first, grew,
            rt.shm.stats()["num_objects"] - before)


def prog_remote_traceback(api, c, rt, side):
    @api.remote
    def boom():
        raise ValueError("cluster kaboom")

    try:
        api.get(boom.remote(), timeout=60)
    except api.TaskError as e:
        return _err(e), "cluster kaboom" in str(e), "ValueError" in str(e)
    return None


def prog_nested(api, c, rt, side):
    @api.remote
    def inner(x):
        return x + 1

    @api.remote
    def outer(x):
        return api.get(inner.remote(x)) + 10

    return api.get(outer.remote(1), timeout=60)


def prog_actor_lifecycle(api, c, rt, side):
    @api.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self):
            self.n += 1
            return self.n

        def pid(self):
            return os.getpid()

    a = Counter.options(name=f"c1-{side}").remote(0)
    got = api.get([a.inc.remote() for _ in range(5)], timeout=60)
    h = api.get_actor(f"c1-{side}")
    again = api.get(h.inc.remote(), timeout=30)
    other = api.get(a.pid.remote(), timeout=30) != os.getpid()
    api.kill(a)
    time.sleep(0.5)
    try:
        api.get(a.inc.remote(), timeout=30)
        dead = None
    except Exception as e:  # noqa: BLE001 - its class is the result
        dead = _err(e)
    return got, again, other, dead


def prog_actor_restart(api, c, rt, side):
    @api.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.calls = 0

        def count(self):
            self.calls += 1
            return self.calls

        def die(self):
            os._exit(1)

    p = Phoenix.remote()
    first = api.get(p.count.remote(), timeout=60)
    p.die.remote()
    time.sleep(1.0)
    deadline = time.monotonic() + 90
    val = None
    while time.monotonic() < deadline:
        try:
            val = api.get(p.count.remote(), timeout=30)
            break
        except api.ActorDiedError:
            time.sleep(0.5)
    return first, val


def prog_kill_with_restart(api, c, rt, side):
    @api.remote(max_restarts=1)
    class K:
        def pid(self):
            return os.getpid()

    k = K.remote()
    pid = api.get(k.pid.remote(), timeout=60)
    api.kill(k, no_restart=False)
    deadline = time.monotonic() + 60
    new = None
    while time.monotonic() < deadline:
        try:
            new = api.get(k.pid.remote(), timeout=30)
            if new != pid:
                break
        except api.ActorDiedError:
            time.sleep(0.2)
    return new is not None and new != pid, _pid_alive(pid)


def prog_spillback(api, c, rt, side):
    c.add_node(num_cpus=2, resources={"special": 1.0})
    time.sleep(0.3)

    @api.remote(resources={"special": 1.0})
    def on_special():
        return "spilled"

    return api.get(on_special.remote(), timeout=60)


def prog_resources(api, c, rt, side):
    total = api.cluster_resources()
    return total["CPU"] >= 4.0, total["TPU"], total.get("special")


def prog_kv(api, c, rt, side):
    rt.kv_put("k1", b"v1")
    got = rt.kv_get("k1")
    rt.kv_del("k1")
    return got, rt.kv_get("k1")


def prog_node_death(api, c, rt, side):
    node = c.add_node(num_cpus=1, labels={"doomed": "yes"})
    time.sleep(0.3)
    nid = node.node_id
    alive = rt.head.call("list_nodes")[nid]["alive"]
    c.remove_node(node)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if not rt.head.call("list_nodes")[nid]["alive"]:
            break
        time.sleep(0.2)
    return alive, rt.head.call("list_nodes")[nid]["alive"]




def prog_cancel_running(api, c, rt, side):
    spin = api.remote(_spin_local())
    ref = spin.remote()
    time.sleep(1.0)
    api.cancel(ref)
    try:
        api.get(ref, timeout=20)
    except Exception as e:  # noqa: BLE001 - its class is the result
        return _err(e)
    return None


def _spin_local():
    def spin():
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30:
            time.sleep(0.01)
        return "finished"

    return spin


def prog_cancel_force(api, c, rt, side):
    @api.remote
    def spin_pid(path):
        with open(path, "w") as f:
            f.write(str(os.getpid()))
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30:
            time.sleep(0.01)
        return "finished"

    path = os.path.join(rt_tmp(), f"spin-{side}.pid")
    ref = spin_pid.remote(path)
    deadline = time.monotonic() + 30
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.05)
    time.sleep(0.2)
    with open(path) as f:
        pid = int(f.read())
    api.cancel(ref, force=True)
    try:
        api.get(ref, timeout=20)
        err = None
    except Exception as e:  # noqa: BLE001 - its class is the result
        err = _err(e)
    # ray_tpu interrupts the task and keeps its worker; the port kills the
    # worker process (test_force_cancel_kills_the_worker_process).
    deadline = time.monotonic() + 10
    while side == "torch" and _pid_alive(pid) and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    _TMP[f"force_pid_alive_{side}"] = _pid_alive(pid)
    return err


_TMP = {}


def rt_tmp() -> str:
    return _TMP["dir"]


def prog_cancel_queued(api, c, rt, side):
    @api.remote(resources={"TPU": 4.0})
    def hold(sec):
        time.sleep(sec)
        return "held"

    holder = hold.remote(3.0)
    time.sleep(0.5)
    victim = hold.remote(0.0)
    api.cancel(victim)
    try:
        api.get(victim, timeout=20)
        err = None
    except Exception as e:  # noqa: BLE001 - its class is the result
        err = _err(e)
    return err, api.get(holder, timeout=20)


def prog_stream(api, c, rt, side):
    @api.remote(num_returns="streaming")
    def slow_gen(n):
        for i in range(n):
            time.sleep(0.05)
            yield i

    t0 = time.monotonic()
    arrivals, items = [], []
    for ref in slow_gen.remote(4):
        items.append(api.get(ref))
        arrivals.append(time.monotonic() - t0)

    @api.remote(num_returns="streaming")
    def big(n):
        for i in range(n):
            yield np.full(200_000, i, np.float32)

    large = [int(api.get(r)[0]) for r in big.remote(3)]
    return items, arrivals[0] < arrivals[-1] - 0.1, large


def prog_lineage(api, c, rt, side):
    @api.remote
    def build(seed):
        return np.full(300_000, seed, np.float32)

    ref = build.remote(7)
    first = float(api.get(ref, timeout=60)[0])
    if side == "jax":
        rt.store.delete(ref.id)
    rt.shm.delete(ref.id.binary())
    killed = c.kill_workers()
    time.sleep(0.5)
    again = api.get(ref, timeout=120)
    return first, killed >= 1, float(again[0]), again.shape


def prog_put_not_reconstructable(api, c, rt, side):
    ref = api.put(b"x" * 200_000)
    if side == "jax":
        rt.store.delete(ref.id)
        rt._locations[ref.id] = "00" * 16
    rt.shm.delete(ref.id.binary())
    try:
        api.get(ref, timeout=10)
    except (api.ObjectLostError, api.GetTimeoutError):
        return "lost"
    return "read"


PROGRAMS = [prog_process_boundary, prog_args_and_refs, prog_lease_reuse,
            prog_large_object, prog_arena, prog_remote_traceback,
            prog_nested, prog_actor_lifecycle, prog_actor_restart,
            prog_kill_with_restart, prog_cancel_running, prog_cancel_force,
            prog_cancel_queued, prog_stream, prog_lineage,
            prog_put_not_reconstructable, prog_spillback, prog_resources,
            prog_kv, prog_node_death]


def _side(side: str) -> dict:
    if side == "jax":
        from ray_tpu.cluster_utils import Cluster
        from ray_tpu.core.worker import global_worker
        from ray_tpu.utils import config as config_mod
        from ray_tpu.utils.ids import JobID
        api = ray_tpu
    else:
        from ray_tpu_torch.cluster_utils import Cluster
        from ray_tpu_torch.core.worker import global_worker
        from ray_tpu_torch.utils import config as config_mod
        from ray_tpu_torch.utils.ids import JobID
        api = ray_tpu_torch
    api.shutdown()
    config_mod.set_config(config_mod.Config.load())
    c = Cluster()
    c.add_node(num_cpus=4, resources={"TPU": 4.0}, labels={"zone": "a"})
    rt = c.connect()
    saved = (global_worker.runtime, global_worker.worker_id,
             global_worker.node_id, global_worker.job_id, global_worker.mode)
    global_worker.runtime = rt
    global_worker.worker_id = rt.worker_id
    global_worker.node_id = getattr(rt, "node_id", global_worker.node_id)
    global_worker.job_id = JobID.from_random()
    global_worker.mode = "cluster"
    out = {}
    try:
        for prog in PROGRAMS:
            try:
                out[prog.__name__] = ("ok", prog(api, c, rt, side))
            except Exception as e:  # noqa: BLE001 - compared across sides
                out[prog.__name__] = ("raised", _err(e), str(e)[:500])
    finally:
        pids = list(c.worker_pids()) if side == "torch" else []
        rt.shutdown()
        c.shutdown()
        (global_worker.runtime, global_worker.worker_id,
         global_worker.node_id, global_worker.job_id,
         global_worker.mode) = saved
        config_mod.set_config(config_mod.Config.load())
    out["_pids"] = pids
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _TMP["dir"] = str(tmp_path_factory.mktemp("cluster"))
    env = {"RTPU_WORKER_IDLE_TTL_S": "120",
           "RTPU_HEALTH_CHECK_PERIOD_S": "0.2"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield {side: _side(side) for side in ("jax", "torch")}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("prog", [p.__name__ for p in PROGRAMS])
def test_program_matches_ray_tpu(runs, prog):
    jax_out, torch_out = runs["jax"][prog], runs["torch"][prog]
    assert torch_out[0] == "ok", torch_out
    assert jax_out[0] == "ok", jax_out
    assert torch_out == jax_out


def test_force_cancel_kills_the_worker_process(runs):
    assert runs["torch"]["prog_cancel_force"] == ("ok", "TaskCancelledError")
    assert _TMP["force_pid_alive_torch"] is False


def test_every_worker_process_is_gone_after_shutdown(runs):
    pids = runs["torch"]["_pids"]
    assert pids
    time.sleep(0.2)
    assert [p for p in pids if _pid_alive(p)] == []


@pytest.fixture
def local_cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(address="local-cluster", num_cpus=2)
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


def test_worker_imports_no_jax_ray_tpu_or_cloudpickle(local_cluster):
    @ray_tpu_torch.remote
    def loaded():
        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "ray_tpu", "cloudpickle"))

    @ray_tpu_torch.remote
    class A:
        def loaded(self):
            return sorted(m for m in sys.modules if m.split(".")[0] in
                          ("jax", "ray_tpu", "cloudpickle"))

    assert ray_tpu_torch.get(loaded.remote(), timeout=60) == []
    assert ray_tpu_torch.get(A.remote().loaded.remote(), timeout=60) == []


def test_local_cluster_runs_tasks_and_actors_in_processes_it_reaps():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(address="local-cluster", num_cpus=2)
    try:
        @ray_tpu_torch.remote
        def pid():
            return os.getpid()

        @ray_tpu_torch.remote
        class A:
            def pid(self):
                return os.getpid()

        t = ray_tpu_torch.get(pid.remote(), timeout=60)
        a = ray_tpu_torch.get(A.remote().pid.remote(), timeout=60)
        rt = ray_tpu_torch.core.worker.global_worker.runtime
        _, daemons = rt.local_cluster
        pids = [p for d in daemons for p in d.all_pids()]
    finally:
        ray_tpu_torch.shutdown()
    assert t != os.getpid() and a != os.getpid() and t != a
    assert t in pids and a in pids
    assert [p for p in pids if _pid_alive(p)] == []


def test_open_handle_raises_at_submit(local_cluster):
    lock = threading.Lock()

    @ray_tpu_torch.remote
    def uses_lock():
        with lock:
            return 1

    with pytest.raises(pickle.PicklingError, match="open handle"):
        uses_lock.remote()
    with pytest.raises(pickle.PicklingError, match="open handle"):
        ray_tpu_torch.put({"f": open(os.devnull)})

    @ray_tpu_torch.remote
    def ident(x):
        return x

    with pytest.raises(pickle.PicklingError, match="open handle"):
        ident.remote((i for i in range(3)))


def test_lambda_closure_and_main_function_run_by_value(local_cluster):
    k = 5
    add_k = ray_tpu_torch.remote(lambda x: x + k)
    assert ray_tpu_torch.get(add_k.remote(1), timeout=60) == 6
    ns: dict = {"__name__": "__main__"}
    exec("def triple(x):\n    return 3 * x\n", ns)
    assert ns["triple"].__module__ == "__main__"
    assert ray_tpu_torch.get(ray_tpu_torch.remote(ns["triple"]).remote(4),
                             timeout=60) == 12
