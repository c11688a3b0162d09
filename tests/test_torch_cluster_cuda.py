"""Process workers on a CUDA card.

Marked ``cuda``: they skip without a card. On one, a
``num_gpus=1`` task runs rms_norm's kernel (K1) in a worker process of
``init(address="local-cluster", resources={"GPU": 1})`` and holds it
against the plain version there (phase 3's bf16 tolerance), and a task
holding 2 GiB of the card is cancelled with ``force=True``: its process
dies and the card's free memory comes back within 64 MiB in 10 s. This
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cluster_cuda.py -m cuda
"""

import os
import time

import pytest
import torch

import ray_tpu_torch

HOLD_BYTES = 2 * 2 ** 30
MEM_SLACK = 64 * 2 ** 20
BACK_S = 10.0


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


@pytest.fixture
def card_cluster():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: rms_norm's kernel runs there only")
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(address="local-cluster", num_cpus=4,
                       resources={"GPU": 1})
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.cuda
def test_k1_runs_in_a_worker_process_against_its_plain_version(card_cluster):
    @ray_tpu_torch.remote(num_gpus=1)
    def k1():
        import torch
        from ray_tpu_torch.ops import norms

        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        x = (torch.randn((8192, 2048), generator=gen, device="cuda") * 3
             + 0.5).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn((2048,), generator=gen, device="cuda")
             ).to(torch.bfloat16)
        norms.rms_norm.launches = 0
        y = norms.rms_norm(x, w, 1e-5)
        ref = norms.rms_norm_reference(x, w, 1e-5)
        err = (y.float() - ref.float()).abs()
        bad = int((err > 1e-2 + 8e-3 * ref.float().abs()).sum())
        return os.getpid(), norms.rms_norm.launches, bad

    pid, launches, bad = ray_tpu_torch.get(k1.remote(), timeout=300)
    assert pid != os.getpid() and launches == 1 and bad == 0


@pytest.mark.cuda
def test_force_cancel_gives_the_cards_memory_back(card_cluster):
    from ray_tpu_torch.core.worker import global_worker

    @ray_tpu_torch.remote(num_gpus=1)
    def hold(nbytes):
        import torch
        from ray_tpu_torch.core.worker import global_worker as gw

        x = torch.ones(nbytes, dtype=torch.uint8, device="cuda")
        torch.cuda.synchronize()
        gw.runtime.kv_put("hold", str(os.getpid()).encode())
        while x is not None:
            time.sleep(0.05)

    rt = global_worker.runtime
    torch.cuda.init()
    free0 = torch.cuda.mem_get_info()[0]
    ref = hold.remote(HOLD_BYTES)
    deadline = time.monotonic() + 120
    while rt.kv_get("hold") is None:
        assert time.monotonic() < deadline, "the task never held its bytes"
        time.sleep(0.05)
    pid = int(rt.kv_get("hold"))
    assert torch.cuda.mem_get_info()[0] < free0 - HOLD_BYTES
    ray_tpu_torch.cancel(ref, force=True)
    with pytest.raises(ray_tpu_torch.TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=60)
    t0 = time.monotonic()
    while (_alive(pid) or torch.cuda.mem_get_info()[0] < free0 - MEM_SLACK) \
            and time.monotonic() - t0 < BACK_S:
        time.sleep(0.02)
    assert not _alive(pid)
    assert torch.cuda.mem_get_info()[0] >= free0 - MEM_SLACK
