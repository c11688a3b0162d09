"""A capture's device trace on a CUDA card: K1 (the CUDA RMSNorm) launched
on the main thread while ``capture_profile`` runs on a side thread lands in
the capture's device trace and in the merged chrome trace.

Marked ``cuda``: it skips without a card. This file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_profiling_cuda.py -m cuda
"""

import threading

import pytest
import torch

from ray_tpu_torch.ops import norms
from ray_tpu_torch.profiling import capture_profile, merge_chrome_trace


@pytest.mark.cuda
def test_capture_holds_a_k1_launch_in_its_device_trace(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: rms_norm's kernel runs there only")
    x = torch.randn(4096, 2048, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(2048, device="cuda", dtype=torch.bfloat16)
    norms.rms_norm(x, w)
    torch.cuda.synchronize()
    result = {}
    t = threading.Thread(target=lambda: result.update(
        cap=capture_profile(1.0, xla_logdir=str(tmp_path),
                            meta={"kind": "driver"})))
    t.start()
    # Launch until the capture ends: a process's first device trace
    # starts late (CUPTI's init), after a fixed burst could be over.
    while t.is_alive():
        norms.rms_norm(x, w)
    torch.cuda.synchronize()
    t.join()
    cap = result["cap"]
    dev_trace = {k: v for k, v in cap["xla_trace"].items() if k != "events"}
    assert dev_trace["status"] == "captured", dev_trace
    assert dev_trace["kernels"] > 0 and dev_trace["launches"] > 0, dev_trace
    assert (tmp_path / "trace.json").exists()
    rows = [e for e in merge_chrome_trace([cap])["traceEvents"]
            if str(e.get("pid", "")).startswith("device ")
            and e.get("ph") == "X"]
    assert any("rms_norm" in e["name"] for e in rows), \
        sorted({e["name"] for e in rows})[:20]
    dev = cap["memory"]["device"]
    assert dev["status"] == "captured"
    assert dev["devices"]["cuda:0"]["bytes"] > 0


@pytest.mark.cuda
def test_back_to_back_captures_keep_their_kernels_and_leave_no_file(
        tmp_path, monkeypatch):
    """Three captures in one process, the last a short one: each holds
    the kernels launched in its window (counted against their launches),
    and one given no logdir leaves nothing in the temporary directory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: rms_norm's kernel runs there only")
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    x = torch.randn(4096, 2048, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(2048, device="cuda", dtype=torch.bfloat16)
    norms.rms_norm(x, w)
    torch.cuda.synchronize()
    for seconds in (1.0, 1.0, 0.2):
        result = {}
        t = threading.Thread(target=lambda: result.update(
            cap=capture_profile(seconds, meta={"kind": "driver"})))
        t.start()
        while t.is_alive():
            norms.rms_norm(x, w)
        torch.cuda.synchronize()
        t.join()
        dev_trace = {k: v for k, v in result["cap"]["xla_trace"].items()
                     if k != "events"}
        assert dev_trace["status"] == "captured", (seconds, dev_trace)
        assert dev_trace["kernels"] > 0, (seconds, dev_trace)
        assert "trace_file" not in dev_trace
        assert list(tmp_path.iterdir()) == []
