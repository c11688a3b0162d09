"""What a ``capture_profile`` costs the training step it watches, on the
card: the 1.1B step (Llama-3.2-1B's geometry with a 32128-token
vocabulary, b4 s2048, remat ``attn+``, ``adamw_lowmem``, the flash
kernels), each step timed on the host to its loss, before, during and
after each of:

- ``capture_profile(2.0)`` (the stack sampler at 100 Hz and the device
  trace, from a side thread, as ``util.state.profile_cluster`` runs it);
- ``capture_profile(2.0, sample_hz=1)`` (the sampler nearly off);
- a bare ``torch.profiler`` session with CPU and CUDA activity from a
  side thread (the device trace alone);
- ``capture_profile(2.0)`` again with the heap frozen out of the
  garbage collector (``gc.freeze``);

with the generation-2 collections counted in each window. A window's
last step also holds the session's stop and its trace export.

Run on a machine with a CUDA card:
``python3 -m ray_tpu_torch.devbench.capture_cost``. It prints the card's
name and power limit, then one line per window.
"""

from __future__ import annotations

import gc
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

# The 1.1B geometry of the port's training phases.
GEOMETRY = dict(vocab_size=32128, hidden_size=2048, intermediate_size=8192,
                num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
                tie_embeddings=True, dtype="bfloat16", max_seq_len=2048)
BATCH, SEQ, SEED = 4, 2048, 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("capture_cost: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    with tempfile.TemporaryDirectory() as tmp:
        measure(tmp)
    return 0


def _step(device):
    """The step and its (token, target) batch, on ``device``."""
    import numpy as np

    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train import adamw_lowmem, make_llama_train_step

    cfg = LlamaConfig(**GEOMETRY)
    step, init, shard = make_llama_train_step(
        cfg, optimizer=adamw_lowmem(3e-4, weight_decay=0.1),
        attn_impl="flash", remat="attn+", seed=SEED, device=device)
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
    return step, init, shard(tokens), shard(np.roll(tokens, -1, axis=1))


def measure(tmp: str) -> None:
    """The windows, printed one a line."""
    import torch
    from ray_tpu_torch.profiling import capture_profile

    # TF32 off, as in chip_smoke.py's phases.
    torch.backends.cuda.matmul.allow_tf32 = False
    step, init, tok, tgt = _step(torch.device("cuda"))
    state = init()
    gen2 = [0]

    def count(phase, info):
        if phase == "start" and info["generation"] == 2:
            gen2[0] += 1

    gc.callbacks.append(count)

    def steps(n: int) -> list:
        nonlocal state
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            state, m = step(state, tok, tgt)
            float(m["loss"])
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def during(fn) -> list:
        t = threading.Thread(target=fn)
        t.start()
        ms = []
        while t.is_alive():
            ms += steps(1)
        t.join()
        return ms

    def bare_profiler():
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            time.sleep(2.0)
            torch.cuda.synchronize()
        p.export_chrome_trace(os.path.join(tmp, "bare.json"))

    def window(label: str, fn=None, n: int = 6) -> None:
        g0 = gen2[0]
        ms = during(fn) if fn is not None else steps(n)
        print(f"{label}: median {statistics.median(ms):.2f} ms over "
              f"{len(ms)} steps, gen2 collections {gen2[0] - g0}: "
              + " ".join(f"{x:.1f}" for x in ms), flush=True)

    steps(3)  # warm
    window("no capture")
    window("capture_profile 100 Hz", lambda: capture_profile(2.0))
    window("after it")
    window("capture_profile 1 Hz", lambda: capture_profile(
        2.0, sample_hz=1))
    window("after it")
    window("bare torch.profiler", bare_profiler)
    window("after it")
    gc.collect()
    gc.freeze()
    window("capture_profile 100 Hz, heap frozen",
           lambda: capture_profile(2.0))
    window("after it")
    gc.unfreeze()


if __name__ == "__main__":
    sys.exit(main())
