#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing its own lines; any
failure raises and the script exits non-zero without a result line:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel from ray_tpu_torch/csrc (rms_norm, flash_fwd,
   flash_bwd, flash_bwd_dq, flash_bwd_dkv, flash_chunk_fwd,
   flash_chunk_bwd, chunk_tile_bounds, flash_packed_fwd), one nvcc each,
   all at once, for sm_90a; ptxas registers and spills by kernel
   instantiation (any spill of a flash, chunk or pre-pass kernel fails)
   and each flash kernel's dynamic shared memory;
3. kernel vs plain: rms_norm's kernel against rms_norm_reference over a
   grid of row counts, widths and dtypes, plus times at the engine's and
   the trainer's shapes (kernel, plain version, torch.nn.functional.
   rms_norm, bound: device time per call, and host time per eager call);
4. kernel vs plain: flash_fwd (K2) and flash_bwd (K3, the Hopper designs:
   TMA rings, wgmma, 128-row tiles, K3's dq summed across its CTAs by
   float4 reductions and its delta made inside it) against their plain
   twins over causal/non-causal, GQA rep 1/4, head_dim 64/128, S 2048 and
   a ragged length, and the training shape; K3's dk/dv bit-identical on
   repeat there and its dq within tolerance of a second run; each build's
   registers; B 65536 (H1 S64 D64, causal and not) through K2, K3, K6 and
   K7 against their twins (more batch rows than a grid's y or z dimension
   holds); then times at the training shape (B4 H32 Hkv8 S2048 D64 causal
   bf16): kernel, twin, bound, and scaled_dot_product_attention (forward;
   forward + backward, and its backward alone, for flash_bwd) as the
   yardstick;
4b. kernel vs plain: the split backward, flash_bwd_dq (K4) and
   flash_bwd_dkv (K5, which folds the GQA heads inside the kernel)
   against flash_bwd_split_plain over causal/non-causal, GQA rep 1/4,
   head_dim 64/128 and S 2048, 197 (ViT-B/16's tokens) and a ragged 1000,
   then rep 2 and 8, the 128-row tile edges (S 127, 128, 129, 257), S 1,
   and B * H = 65544 (B5462 H12 S8); two launches on the same inputs
   bit-identical at head_dim 64 and 128, causal and not; then K4 and K5
   timed at the training shape, and the whole split backward through its
   wrapper beside K3's (both compute delta), the twins, the bound and
   scaled_dot_product_attention's backward alone;
4c. kernel vs plain: the head-packed forward kernels packed_fwd_epi (K8),
   packed_fwd_inl (K9) and packed_fwd (K10) of the profiling entry point
   ray_tpu_torch.devbench.prof_flash_pack against their twins over
   causal/non-causal, GQA rep 1/4, head_dim 64/128 and every (pack,
   block_q, block_k) each takes (B1 H8 S512), and at the profiling shape
   (B4 H32 Hkv8 S2048 D64 causal, the defaults pack 2, block_q 64,
   block_k 64), and packed_fwd at B * H / pack = 65536 (B65536 H2 Hkv1
   S64); each at block_k 64 against K2 on the same inputs
   (bit-identity printed); times of the defaults beside the bound, the
   twin, K2 and causal SDPA; then the entry point's check and its sweep
   of K2 and the 25 packed variants (launch counts reset right before the
   sweep and read right after);
5. kernel vs plain: the ring's chunk kernels flash_chunk_fwd (K6) and
   flash_chunk_bwd (K7, nonzero lse cotangent), and their tile-bounds
   pre-pass chunk_tile_bounds, against their twins over causal/non-causal,
   GQA rep 1/4, head_dim 64/128 and nine position cases (the diagonal
   chunk, a past, a future and an offset chunk, ragged lengths partly and
   wholly masked, and the tile classes' cases: rows that see no key beside
   rows that do, shuffled positions, S 1024 causal; there rows that see no
   key keep lse < -1e29 and K7's dk/dv repeat bit for bit), the sp = 4
   ring's past, diagonal and future chunks (B1 H32 Hkv8 Sq=Skv=4096 D64)
   and the CP step's own shape (B1 H32 Hkv8 S16384 D64, positions 0..S-1,
   causal); then times at the CP step's shape and at the ring's past
   chunk: kernel, twin, bound (the FLOPs the mask keeps), TFLOP/s over the
   kept pairs and at the full-pass rate, the (q tile, kv tile) pairs each
   kernel skips, masks and takes whole, and scaled_dot_product_attention
   (forward for K6, its backward alone for K7) as the yardstick; the
   pre-pass's time at the CP step's positions;
6. the ring's schedule at sp = 4 in one process: B1 H32 Hkv8 S16384 D64
   bf16 in four chunks, every (virtual rank, step) pair through the flash
   ring step (16 K6 launches, 16 K7 through autograd), output and dq/dk/dv
   against flash_fwd/flash_bwd on the whole sequence, chunk by chunk;
7. the serving path: the LLM engine at Llama-3.2-1B width (bf16, seeded
   random weights) serving a warm-up wave and then WAVES timed waves of
   concurrent greedy requests (median and range reported), a two-chunk
   prefill, prefix-cache hits and chained decode bursts; kernel launch
   counts are reset right before it and read right after; then the host
   vs device split of one 16-step decode burst;
8. the training path: make_llama_train_step at the 1.1B bench geometry
   (bench.py), b4 s2048, remat attn+, adamw_lowmem, seeded random weights
   and tokens: 2 warm-up and 10 timed steps with counts reset right before
   and read right after (they must equal what the remat policy predicts);
   with the earlier phases' heap frozen out of the garbage collector:
   tokens/s, step ms and MFU over the whole timed window, the per-step
   spread, peak memory and its split, the loss trajectory (finite,
   falling) and a profiler split of three steps;
8b. the same trainer with the split backward (K4 + K5): first the loss and
   every parameter's gradient against the fused backward on the same
   params and batch (each run twice beside it), then 2 warm-up and 5
   timed steps, launches per step as predicted (K4/K5 for K3), the first
   loss bit-equal to phase 8's;
9. the context-parallel training path: first one forward + backward with
   sp_axis = a one-rank NCCL group (ring attention through K6/K7) against
   sp_axis=None (K2/K3) on the same params and batch (the loss, the final
   hidden states row by row, every parameter's gradient); then
   make_train_step over loss_fn with that sp_axis at the 1.1B geometry,
   b1 s16384, remat attn+, adamw_lowmem: 2 warm-up and 3 timed steps,
   launches per step against the prediction (16 K6, 16 K7, no K2/K3),
   step ms, tokens/s, peak memory, the losses, a profiler split of one
   step;
9b. the ViT-B/16 training path: make_vit_train_step at ViT-B/16 (224 px,
   patch 16, hidden 768, 12 layers, 12 heads, 86.4M params, bf16), b128,
   remat none, adamw_lowmem, seeded images and labels, once with the
   fused and once with the split backward: 2 warm-up and 10 timed steps
   each, launches per step as predicted, images/s, step ms, MFU
   (vit_train_flops), peak memory, a profiler split of one step, the
   first losses bit-equal, and for each run the device time by PyTorch
   op; then the loss and every parameter's gradient at b128, the split
   backward against the fused one and each against plain f32 attention
   (blockwise_attention); then K2, K3, K4, K5 against their twins at its
   attention (B128 H12 S197 D64, non-causal), K4/K5 bit-identical on
   repeat, and K2-K5 and both whole backwards timed there beside
   non-causal SDPA;
10. with two or more cards visible, the ring over ranks, one card each
   (NCCL; the largest power of two of them): ring attention at S16384
   against one card's flash_fwd/flash_bwd, and the phase-9 model's
   forward + backward with all-reduced gradients against one card's
   sp_axis=None, then timed; with one card it prints that it skipped;
11. cross-device: f32 engines at tiny width (d=64) and at 1B width with
   two layers (d=2048), CUDA (kernel) vs CPU (plain) greedy token streams
   must be equal; a bf16 trainer at small width, 3 steps on the card
   (kernels) vs 3 on the CPU (plain twins) from one param tree: losses
   agree and the norm weights' gradients are non-zero and agree; a bf16
   ViT (head_dim 64, 65 tokens) under each backward choice: every
   parameter's gradient of one forward + backward and the losses of 3
   steps, on the card vs on the CPU, agree;
12. a JSON line of the kernels, then the JSON result line.

Exits non-zero when no CUDA device is visible or when run outside a
checkout. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
SEED = 0


def _phase(name: str) -> None:
    print(f"== {name}", flush=True)


def device_ms(fn, iters: int = 200, reps: int = 5) -> float:
    """Device time per call of ``fn`` in ms: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between two CUDA events (so the
    host's launch cost is not in the number). Inputs stay hot in L2, as
    they are when the engine's previous op just wrote them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (reps * iters)


def host_us(fn, calls: int = 2000) -> float:
    """Host time per call of ``fn`` in us: ``calls`` calls issued without a
    sync between them (the eager dispatch cost the engine's Python loop
    pays); the device runs behind and is drained only after the clock
    stops."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def rms_bound_ms(rows: int, d: int, x_bytes: int, w_bytes: int):
    """Least time for one rms_norm: x read once, y written once, w read
    once, over HBM bandwidth; vs ~4 f32 flops per element over the f32
    peak. Returns (ms, "bytes" | "operations")."""
    t_bytes = (2 * rows * d * x_bytes + d * w_bytes) / HBM_BYTES_PER_S
    t_ops = 4 * rows * d / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device():
    import torch

    _phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}")
    # The engine's f32 lm head and the tests' tolerances assume full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return kind, smi[0]


def phase_build():
    from ray_tpu_torch._native import build

    _phase("build")
    t0 = time.perf_counter()
    paths = build.build_all()
    dt = time.perf_counter() - t0
    print(f"built {len(paths)} kernel librar{'y' if len(paths) == 1 else 'ies'}"
          f" in {dt:.2f} s with {build.nvcc_path()}: "
          + ", ".join(os.path.relpath(p) for p in paths))
    # Libraries whose every instantiation must not spill.
    no_spill = ("flash_fwd", "flash_bwd", "flash_packed_fwd",
                "flash_chunk_fwd", "flash_chunk_bwd", "chunk_tile_bounds",
                "flash_bwd_dq", "flash_bwd_dkv")
    spilled = []
    for name, log in build.BUILD_LOGS.items():
        entry = ""
        for line in log.splitlines():
            if "entry function" in line:
                entry = _ptxas_entry(line)
                entry += " " if entry else ""
            spill = "spill" in line and " 0 bytes spill" not in line
            if "Used" in line or spill or "error" in line.lower():
                print(f"  [{name}] {entry}{line.strip()}")
            if spill and name in no_spill:
                spilled.append(f"{name}: {entry}")
    if spilled:
        raise AssertionError(f"kernels spill registers: {spilled}")
    from ray_tpu_torch.devbench.prof_flash_pack import MAX_ROWS, smem_bytes
    from ray_tpu_torch.ops.attention import kernel_smem_bytes
    for name in ("flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_chunk_fwd", "flash_chunk_bwd"):
        print(f"  [{name}] dynamic shared memory per CTA: "
              + ", ".join(f"D={d}: {kernel_smem_bytes(name, d)} B"
                          for d in (64, 128)))
    print("  [flash_packed_fwd] dynamic shared memory per CTA at its most "
          "rows (256 at D 64, 128 at D 128): "
          + ", ".join(f"D={d} block_k={bk}: {smem_bytes(d, bk, MAX_ROWS[d])}"
                      " B" for d in (64, 128) for bk in (64, 128)))


def _ptxas_entry(line: str) -> str:
    """The kernel a ptxas "entry function" line names, with its integer and
    bool template arguments (flash_fwd_kernel<64,2>); "" if it has none."""
    m = re.search(r"([A-Za-z_]+_kernel)I((?:L[ib]\d+E)+)E", line)
    return (f"{m.group(1)}<" + ",".join(re.findall(r"\d+", m.group(2)))
            + ">") if m else ""


def build_registers(name: str) -> dict:
    """{kernel<template arguments>: registers} from ptxas's report of this
    process's build of library ``name`` (empty when it was cached)."""
    from ray_tpu_torch._native import build

    regs, entry = {}, ""
    for line in build.BUILD_LOGS.get(name, "").splitlines():
        if "entry function" in line:
            entry = _ptxas_entry(line)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
    return regs


def phase_kernel():
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import norms

    _phase("kernel vs plain: rms_norm")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    tol = {torch.bfloat16: (8e-3, 1e-2), torch.float32: (1e-5, 1e-5)}
    worst = {}
    cases = [(r, d, dt, dt) for dt in (torch.bfloat16, torch.float32)
             for r in (1, 8, 33, 512, 4099) for d in (64, 2048, 4096)]
    cases.append((33, 2048, torch.bfloat16, torch.float32))  # mixed dtypes
    for rows, d, dt, wdt in cases:
        x = (torch.randn((rows, d), generator=gen, device="cuda") * 3 + 0.5
             ).to(dt)
        w = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
             ).to(wdt)
        y = norms.rms_norm(x, w, 1e-5)
        ref = norms.rms_norm_reference(x, w, 1e-5)
        torch.cuda.synchronize()
        rtol, atol = tol[dt]
        err = (y.float() - ref.float()).abs()
        bad = err > atol + rtol * ref.float().abs()
        if bad.any():
            raise AssertionError(
                f"rms_norm kernel disagrees at rows={rows} d={d} {dt}/{wdt}:"
                f" max abs err {err.max().item():.3e} "
                f"({int(bad.sum())} elements past rtol={rtol} atol={atol})")
        worst[dt] = max(worst.get(dt, 0.0), err.max().item())
    for dt, e in worst.items():
        print(f"rms_norm kernel == plain over {len(cases)} cases; max abs "
              f"err {dt}: {e:.3e} (tolerance rtol={tol[dt][0]} "
              f"atol={tol[dt][1]})")
    try:
        norms.rms_norm(torch.zeros((4, 60), device="cuda"),
                       torch.ones((60,), device="cuda"))
    except ValueError:
        print("rms_norm rejects d=60 (not a multiple of 8): ok")
    else:
        raise AssertionError("rms_norm accepted d=60")

    times = []
    for rows in (8, 512, 8192):  # decode step, prefill chunk, train batch
        d = 2048
        x = torch.randn((rows, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.ones((d,), device="cuda", dtype=torch.bfloat16)
        ms = device_ms(lambda: norms.rms_norm(x, w, 1e-5))
        plain_ms = device_ms(lambda: norms.rms_norm_reference(x, w, 1e-5))
        lib = getattr(F, "rms_norm", None)
        lib_ms = (device_ms(lambda: lib(x, (d,), w, 1e-5))
                  if lib is not None else None)
        bound, by = rms_bound_ms(rows, d, 2, 2)
        host = host_us(lambda: norms.rms_norm(x, w, 1e-5))
        plain_host = host_us(lambda: norms.rms_norm_reference(x, w, 1e-5))
        lib_host = (host_us(lambda: lib(x, (d,), w, 1e-5))
                    if lib is not None else None)
        times.append({"rows": rows, "d": d, "dtype": "bfloat16", "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound, "bound_by": by, "host_us": host,
                      "plain_host_us": plain_host,
                      "library_host_us": lib_host})
        print(f"rms_norm rows={rows} d={d} bf16: device: kernel "
              f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, F.rms_norm "
              f"{'n/a' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}, "
              f"bound {bound * 1e3:.4f} us ({by}); host per eager call: "
              f"kernel wrapper {host:.2f} us, plain {plain_host:.2f} us, "
              f"F.rms_norm "
              f"{'n/a' if lib_host is None else f'{lib_host:.2f} us'}")
    return max(worst.values()), times


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def run_wave(eng, prompts, sampling, concurrency: int = 8):
    """Closed loop: ``concurrency`` clients each submit the next prompt as
    soon as their last one finished. Returns ([(index, request)], wall s,
    [TTFT s], output tokens). Raises if a request fails."""
    done = []
    lock = threading.Lock()
    queue_ = list(enumerate(prompts))

    def client():
        while True:
            with lock:
                if not queue_:
                    return
                i, p = queue_.pop(0)
            req = eng.submit(p, sampling)
            if not req.done.wait(600):
                raise TimeoutError("request timed out")
            with lock:
                done.append((i, req))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wave_s = time.perf_counter() - t0
    if len(done) != len(prompts) or any(t.is_alive() for t in threads):
        raise AssertionError(f"{len(done)}/{len(prompts)} requests done")
    for i, req in done:
        if req.error or req.finish_reason not in ("length", "stop"):
            raise AssertionError(f"request {i} ended {req.finish_reason}"
                                 f" ({req.error})")
    ttft = [req.first_token_ts - req.submit_ts for _, req in done]
    out_toks = sum(len(req.out_tokens) for _, req in done)
    return done, wave_s, ttft, out_toks


def _spread(vals):
    return (f"median {statistics.median(vals):.1f} "
            f"[min {min(vals):.1f}, max {max(vals):.1f}]")


WAVES = 5  # timed waves after the warm-up wave


def phase_engine(rms_host_us: float):
    import numpy as np
    import torch
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.llm.engine import decode_burst, init_kv_cache
    from ray_tpu_torch.ops import norms

    _phase("engine: llama3_1b width, bf16, seeded random weights")
    cfg = LLMConfig(model="llama3_1b", dtype="bfloat16", max_num_seqs=8,
                    max_seq_len=1024, decode_burst=16, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = LLMEngine(cfg, device="cuda")
    torch.cuda.synchronize()
    mc = eng.model_cfg
    print(f"engine up in {time.perf_counter() - t0:.2f} s: "
          f"{mc.num_params() / 1e9:.3f}B params, hidden {mc.hidden_size}, "
          f"{mc.num_layers} layers, heads {mc.num_heads}/{mc.num_kv_heads}"
          f", vocab {mc.vocab_size}")
    rng = np.random.default_rng(SEED)
    greedy64 = SamplingParams(max_tokens=64, temperature=0.0)
    short = [int(t) for t in rng.integers(0, 256, 12)]  # < PREFIX_COPY_MIN
    wave = [[int(t) for t in rng.integers(0, 256, int(n))]
            for n in rng.integers(32, 201, 15)] + [short]
    long_prompt = [int(t) for t in rng.integers(0, 256, 700)]
    prefix = [int(t) for t in rng.integers(0, 256, 128)]
    shared = [prefix + [int(t) for t in rng.integers(0, 256, 20)]
              for _ in range(3)]
    results = {}
    try:
        norms.rms_norm.launches = 0  # count the main path only
        wall0 = time.perf_counter()

        solo = eng.generate(short, greedy64)

        # Warm-up wave: also the solo/repeat/concurrent determinism check.
        done, wave_s, _, out_toks = run_wave(eng, wave, greedy64)
        concurrent_short = next(r for i, r in done if i == len(wave) - 1)
        again = eng.generate(short, greedy64)
        if not (solo.token_ids == again.token_ids
                == eng._result(concurrent_short).token_ids):
            raise AssertionError("short prompt: solo, repeated and "
                                 "concurrent tokens differ")
        print(f"warm-up wave: {out_toks / wave_s:.1f} tok/s; repeated "
              f"prompt and solo-vs-concurrent tokens identical: ok")
        # Timed waves: the same prompt lengths with fresh tokens each time,
        # so no wave re-hits the prefix cache of an earlier one.
        rates, p50s, maxs = [], [], []
        for _ in range(WAVES):
            prompts = [[int(t) for t in rng.integers(0, 256, len(p))]
                       for p in wave]
            _, wave_s, ttft, out_toks = run_wave(eng, prompts, greedy64)
            rates.append(out_toks / wave_s)
            p50s.append(statistics.median(ttft) * 1e3)
            maxs.append(max(ttft) * 1e3)
            print(f"  wave: {out_toks} output tokens in {wave_s:.3f} s = "
                  f"{rates[-1]:.1f} tok/s; TTFT p50 {p50s[-1]:.1f} ms, max "
                  f"{maxs[-1]:.1f} ms")
        print(f"{WAVES} waves of {len(wave)} requests at concurrency 8 "
              f"(prompts 12-200 tokens, max_tokens 64): tok/s "
              f"{_spread(rates)}; TTFT p50 ms {_spread(p50s)}; TTFT max ms "
              f"{_spread(maxs)}")

        chunks0 = eng.stats()["prefill_chunks"]
        res = eng.generate(long_prompt, greedy64)
        chunks = eng.stats()["prefill_chunks"] - chunks0
        if chunks != 2 or res.finish_reason not in ("length", "stop"):
            raise AssertionError(f"700-token prompt: {chunks} chunks, "
                                 f"{res.finish_reason}")
        print(f"700-token prompt: {chunks} prefill chunks, "
              f"{len(res.token_ids)} tokens, {res.finish_reason}")

        hits0 = eng.stats()["prefix_hits"]
        donor = eng.submit(shared[0], greedy64)
        deadline = time.time() + 120
        while not eng._prefix_live and time.time() < deadline:
            time.sleep(0.002)  # the donor's prefill completes
        second = eng.generate(shared[1], greedy64)
        if not donor.done.wait(300):
            raise TimeoutError("prefix donor timed out")
        third = eng.generate(shared[2], greedy64)
        st = eng.stats()
        for r in (donor, second, third):
            fr = r.finish_reason
            if fr not in ("length", "stop"):
                raise AssertionError(f"shared-prefix request ended {fr}")
        if st["prefix_hits"] - hits0 < 2:
            raise AssertionError(f"prefix hits {st['prefix_hits'] - hits0}"
                                 " < 2 for three 128-token-prefix prompts")
        wall = time.perf_counter() - wall0
        launches = norms.rms_norm.launches
        print(f"prefix cache: {st['prefix_hits'] - hits0} hits, "
              f"{st['prefix_tokens_saved']} prompt tokens reused")
        if st["decode_bursts"] < 1 or st["chained_bursts"] < 1:
            raise AssertionError(f"bursts {st['decode_bursts']}, chained "
                                 f"{st['chained_bursts']}")
        if launches < 1:
            raise AssertionError("rms_norm kernel never launched on the "
                                 "main path")
        print(f"main path wall {wall:.3f} s; stats {json.dumps(st)}; "
              f"rms_norm kernel launches {launches} "
              f"(= {launches / 33:.1f} forwards x 33)")
        gib = 2.0 ** 30
        peak = torch.cuda.max_memory_allocated() / gib
        weights = sum(t.numel() * t.element_size() for t in
                      _leaves(eng.params)) / gib
        kv = sum(t.numel() * t.element_size()
                 for t in eng.cache.values()) / gib
        head = eng._weights.head_f32.numel() * 4 / gib
        print(f"peak device memory {peak:.3f} GiB: weights {weights:.3f}, "
              f"f32 head copy {head:.3f}, KV cache {kv:.3f}, the rest "
              f"activations and allocator slack")
        results.update(launches=launches, wall_s=wall, peak_gib=peak,
                       waves=WAVES, tok_per_s=statistics.median(rates),
                       tok_per_s_min=min(rates), tok_per_s_max=max(rates),
                       ttft_p50_ms=statistics.median(p50s),
                       ttft_p50_ms_min=min(p50s), ttft_p50_ms_max=max(p50s))

        _phase("burst split: one 16-step decode burst, 8 slots at 600")
        cache = init_kv_cache(mc, 8, 1024, "cuda")
        tokens = np.arange(8, dtype=np.int64)
        pos = np.full(8, 600, np.int64)
        write = np.ones(8, bool)
        temps, top_ps = np.zeros(8, np.float32), np.ones(8, np.float32)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)

        def burst():
            return decode_burst(mc, eng._weights, cache, tokens, pos, write,
                                temps, top_ps, gen, 16, False)[1]

        burst()
        torch.cuda.synchronize()
        host, walls = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            burst()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host.append((t1 - t0) * 1e3)
            walls.append((time.perf_counter() - t0) * 1e3)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            burst()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        by_name: dict[str, float] = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
        wall_ms = min(walls)
        rms_ms = 16 * 33 * rms_host_us / 1e3
        print(f"burst of 16 steps: host enqueue {min(host):.2f} ms, wall "
              f"{wall_ms:.2f} ms, launches/step "
              f"{len(kern) / 16:.0f} (profiler); rms_norm wrapper host time "
              f"528 x {rms_host_us:.2f} us = {rms_ms:.2f} ms "
              f"({100 * rms_ms / min(host):.1f}% of the host enqueue)")
        if busy_ms > 0:
            print(f"device busy {busy_ms:.2f} ms = "
                  f"{100 * busy_ms / wall_ms:.1f}% of wall (idle "
                  f"{100 - 100 * busy_ms / wall_ms:.1f}%)")
            for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
                print(f"  {ms:8.3f} ms  {name[:100]}")
        else:
            print("device busy: not measured (profiler saw no kernels)")
        results.update(burst_host_ms=min(host), burst_wall_ms=wall_ms,
                       burst_busy_ms=busy_ms or None,
                       burst_rms_norm_host_ms=rms_ms)
    finally:
        eng.shutdown()
    return results


def phase_cross_device():
    from dataclasses import replace

    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    _phase("cross-device: f32, CUDA kernel path vs CPU plain path")
    # tiny (d=64) runs the warp-per-row kernel; the 1B width (d=2048, two
    # layers, small vocab) runs the CTA-per-row kernel the main path uses.
    wide = replace(LlamaConfig.llama3_1b(), num_layers=2, vocab_size=512,
                   max_seq_len=128, dtype="float32")
    prompts = ["hello from the port", "x",
               "a prompt long enough to run over two prefill chunks of 32",
               "hello from the port"]  # the repeat re-hits the prefix cache
    for name, model in (("tiny", "tiny"), ("1b-width 2-layer", wide)):
        cfg = LLMConfig(model=model, max_num_seqs=4, max_seq_len=128,
                        decode_burst=8, prefill_chunk=32, seed=SEED)
        params = init_params(cfg.model_config(), generator=7, device="cpu")
        streams = {}
        for dev in ("cuda", "cpu"):
            eng = LLMEngine(cfg, params=params, device=dev)
            try:
                streams[dev] = [eng.generate(p, SamplingParams(max_tokens=24))
                                .token_ids for p in prompts]
            finally:
                eng.shutdown()
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"{name}: greedy streams differ: {streams}")
        print(f"{name} (d={cfg.model_config().hidden_size}): {len(prompts)}"
              f" greedy streams identical on cuda and cpu "
              f"({sum(map(len, streams['cuda']))} tokens)")


def events_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call of ``fn`` in ms from CUDA events around an
    eager loop of ``iters`` calls (for calls of a hundred microseconds and
    more, whose host cost hides behind the device's)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


# Tolerances of the flash kernels against their plain twins (bf16): out,
# dq, dk, dv within 1e-2 of the largest value (one bf16 ulp where sums in
# another order round apart; dq's atomics add in no fixed order); lse
# within 2e-3 (f32 sums of the same bf16 p in another order).
FLASH_REL_TOL = 1e-2
FLASH_LSE_TOL = 2e-3
# lse of rows that see few keys (causal S 64 over B 65536, 4M rows): one p
# in [0.5, 1) that rounds to the other side of a bf16 step in the kernel
# than in the twin (s summed in another order) moves l >= 1 by 2^-8, so
# lse by up to 2^-8 (2.1e-3 read there on an H100). Only the big-batch
# causal checks take it.
FEW_KEYS_LSE_TOL = 2 ** -8
MAIN_ATTN = dict(b=4, h=32, hkv=8, s=2048, d=64)  # the trainer's shape
BIG_BATCH = dict(b=65536, h=1, hkv=1, s=64, d=64)  # past a grid's y/z limit


# The kernels line's note of K2's and K3's designs.
FLASH_DESIGN = {
    "flash_fwd": "Hopper design: 128 q rows a CTA (two consumer "
                 "warpgroups + a producer warp), TMA ring of K/V tiles, "
                 "wgmma for both products, static tile classes, linear grid",
    "flash_bwd": "Hopper design: 128 kv rows a CTA (two consumer "
                 "warpgroups), TMA ring of q/dO/O tiles, wgmma for all five "
                 "products (dq from ds^T in shared memory), delta made in "
                 "the kernel, dq summed across CTAs by float4 reductions, "
                 "dk/dv over the GQA heads in registers, linear grid"}


def _flash_inputs(gen, b, h, hkv, s, d):
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    return rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d), \
        rnd(b, h, s, d)


def _flash_check(q, k, v, do, causal, label, worst, lse_tol=FLASH_LSE_TOL):
    """Both kernels against their twins on one input; raises past the
    tolerance, folds the max abs errors into ``worst``."""
    import torch
    from ray_tpu_torch.ops import attention as att

    scale = q.shape[-1] ** -0.5
    out, lse = att.flash_fwd_cuda(q, k, v, causal, scale)
    p_out, p_lse = att.flash_fwd_plain(q, k, v, causal, scale)
    grads = att.flash_bwd_cuda(q, k, v, p_out, p_lse, do, causal, scale)
    plain = att.flash_bwd_plain(q, k, v, p_out, p_lse, do, causal, scale)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (p_out, *plain)):
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        if not rel < FLASH_REL_TOL:
            raise AssertionError(f"flash {name} disagrees with its twin at "
                                 f"{label}: max abs err {err:.3e} = {rel:.3e}"
                                 f" of the largest value (> {FLASH_REL_TOL})")
        errs[name] = err
    errs["lse"] = (lse - p_lse).abs().max().item()
    if not errs["lse"] < lse_tol:
        raise AssertionError(f"flash lse disagrees at {label}: "
                             f"{errs['lse']:.3e} > {lse_tol}")
    worst["flash_fwd"] = max(worst["flash_fwd"], errs["out"], errs["lse"])
    worst["flash_bwd"] = max(worst["flash_bwd"], errs["dq"], errs["dk"],
                             errs["dv"])
    return errs


def flash_bounds(b, h, hkv, s, d, causal: bool = True):
    """(fwd, bwd) least times in ms with what bounds each: the FLOPs (half
    of them when causal) over the bf16 peak vs bytes (each input read once,
    each output written once) over HBM bandwidth. The backward does five
    products per tile pair to the forward's two."""
    from ray_tpu_torch.accelerators.flops import attention_flops, peak_flops

    fl = attention_flops(b, h, s, d, causal=causal)
    qb, kvb, rows = b * h * s * d * 2, b * hkv * s * d * 2, b * h * s * 4
    out = {}
    for name, flops, nbytes in (
            ("flash_fwd", fl, 2 * qb + 2 * kvb + rows),
            # q, k, v, out, dO, lse in; dq, dk, dv out
            ("flash_bwd", 2.5 * fl, 4 * qb + 4 * kvb + rows)):
        t_ops = flops / peak_flops("h100", "bf16")
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes",
                     flops, nbytes)
    return out


def phase_flash():
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as att

    _phase("kernel vs plain: flash_fwd / flash_bwd")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    worst = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    n = 0
    for causal in (True, False):
        for rep in (1, 4):
            for d in (64, 128):
                for s in (2048, 1000):  # 1000: a ragged tail of 40 rows
                    q, k, v, do = _flash_inputs(gen, 1, 8, 8 // rep, s, d)
                    _flash_check(q, k, v, do, causal,
                                 f"causal={causal} rep={rep} d={d} s={s}",
                                 worst)
                    n += 1
    m = MAIN_ATTN
    q, k, v, do = _flash_inputs(gen, m["b"], m["h"], m["hkv"], m["s"],
                                m["d"])
    errs = _flash_check(q, k, v, do, True, "the training shape", worst)
    print(f"flash kernels == plain twins over {n} cases + the training "
          f"shape (bf16); max abs err: flash_fwd {worst['flash_fwd']:.3e}, "
          f"flash_bwd {worst['flash_bwd']:.3e}; at the training shape "
          + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items())
          + f" (tolerance {FLASH_REL_TOL} of the largest value, lse "
          f"{FLASH_LSE_TOL})")

    # K3 twice on the same inputs: dk/dv are summed in one CTA's registers
    # (the same bits), dq across CTAs in no fixed order (within tolerance).
    scale = m["d"] ** -0.5
    out, lse = att.flash_fwd_cuda(q, k, v, True, scale)
    runs = [att.flash_bwd_cuda(q, k, v, out, lse, do, True, scale)
            for _ in range(2)]
    torch.cuda.synchronize()
    if not (torch.equal(runs[0][1], runs[1][1])
            and torch.equal(runs[0][2], runs[1][2])):
        raise AssertionError("K3: dk/dv of two launches on the same inputs "
                             "differ")
    dq_repeat = ((runs[0][0].float() - runs[1][0].float()).abs().max()
                 / runs[1][0].float().abs().max()).item()
    if not dq_repeat < FLASH_REL_TOL:
        raise AssertionError(f"K3: dq of two launches differs by "
                             f"{dq_repeat:.3e} of its largest value")
    del runs
    regs = {n: build_registers(n) for n in ("flash_fwd", "flash_bwd")}
    print(f"K3 at the training shape, two launches: dk/dv bit-identical, dq "
          f"{dq_repeat:.3e} of its largest value apart (tolerance "
          f"{FLASH_REL_TOL}); registers a thread (ptxas): "
          + "; ".join(f"{n} " + ", ".join(f"{e} {r}" for e, r in x.items())
                      for n, x in regs.items()))

    # More batch rows than a grid's y or z dimension holds: K2, K3, K6 and
    # K7 on linear grids, each against its twin.
    big = BIG_BATCH
    chunk_worst = dict.fromkeys(("flash_chunk_fwd", "flash_chunk_bwd",
                                 "flash_chunk_fwd rel",
                                 "flash_chunk_bwd rel"), 0.0)
    big_errs = {}
    for causal in (True, False):
        lse_tol = FEW_KEYS_LSE_TOL if causal else FLASH_LSE_TOL
        label = f"B{big['b']} H1 S{big['s']} D64 causal={causal}"
        qb, kb, vb, dob = _flash_inputs(gen, big["b"], big["h"], big["hkv"],
                                        big["s"], big["d"])
        big_errs[f"K2/K3 causal={causal}"] = _flash_check(
            qb, kb, vb, dob, causal, label, worst, lse_tol)
        pos = torch.arange(big["s"], dtype=torch.int32, device="cuda")
        big_errs[f"K6/K7 causal={causal}"] = _chunk_check(
            (qb, kb, vb, pos, pos, dob.float(),
             torch.randn(qb.shape[:3], generator=gen, device="cuda")),
            causal, label, chunk_worst, lse_tol=lse_tol)
        del qb, kb, vb, dob
    print(f"B {big['b']} (H1 S{big['s']} D64): K2, K3, K6, K7 == their twins"
          f" on linear grids, causal and not; max abs err "
          + "; ".join(f"{n}: " + ", ".join(f"{k_} {e:.3e}"
                                            for k_, e in x.items())
                      for n, x in big_errs.items())
          + f" (lse {FEW_KEYS_LSE_TOL:.3e} causal, {FLASH_LSE_TOL} not)")

    kr, vr = att._repeat_kv(k, m["h"]), att._repeat_kv(v, m["h"])
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, kr, vr))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), do)

    # SDPA's backward alone: one forward, then its saved graph replayed.
    o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd_ms = events_ms(lambda: torch.autograd.grad(
        o_lib, (qg, kg, vg), do, retain_graph=True), 20)
    del o_lib

    times = {
        "flash_fwd": (
            events_ms(lambda: att.flash_fwd_cuda(q, k, v, True, scale), 20),
            events_ms(lambda: att.flash_fwd_plain(q, k, v, True, scale), 3),
            events_ms(lambda: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=True), 20)),
        "flash_bwd": (
            events_ms(lambda: att.flash_bwd_cuda(q, k, v, out, lse, do, True,
                                                 scale), 20),
            events_ms(lambda: att.flash_bwd_plain(q, k, v, out, lse, do,
                                                  True, scale), 3),
            events_ms(sdpa_fwd_bwd, 20)),
    }
    bounds = flash_bounds(**m)
    rows = {}
    for name, (ms, plain_ms, lib_ms) in times.items():
        bound, by, flops, nbytes = bounds[name]
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound, "bound_by": by,
                      "max_abs_err": worst[name],
                      "tflops": flops / (ms * 1e-3) / 1e12}
        rows[name]["registers"] = regs[name]
        if name == "flash_bwd":
            rows[name]["library_bwd_ms"] = lib_bwd_ms
            rows[name]["dk_dv_bit_identical"] = True
            rows[name]["dq_repeat_rel"] = dq_repeat
        print(f"{name} B4 H32 Hkv8 S2048 D64 causal bf16: kernel {ms:.4f} ms"
              f" ({flops / 1e9:.1f} GFLOP, {rows[name]['tflops']:.1f} "
              f"TFLOP/s = {100 * bound / ms:.1f}% of the bound), plain twin "
              f"{plain_ms:.4f} ms, scaled_dot_product_attention"
              f"{' fwd+bwd' if name == 'flash_bwd' else ''} {lib_ms:.4f} ms"
              f" (k/v repeated to 32 heads beforehand), bound "
              f"{bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB)")
    print(f"flash_bwd against scaled_dot_product_attention's backward alone "
          f"{lib_bwd_ms:.4f} ms: {times['flash_bwd'][0] / lib_bwd_ms:.2f}x "
          f"its time; flash_fwd against its forward: "
          f"{times['flash_fwd'][0] / times['flash_fwd'][2]:.2f}x")
    return rows


def split_bounds(b, h, hkv, sq, skv, d, causal: bool):
    """(K4, K5) least times in ms with what bounds each: the FLOPs of the
    (q, k) pairs the mask keeps (K4 three products, 6 * D FLOPs a pair; K5
    four, 8 * D) over the bf16 peak vs bytes (each input read once, each
    output written once: K5's dk/dv per kv head, folded) over HBM
    bandwidth."""
    from ray_tpu_torch.accelerators.flops import peak_flops

    pairs = b * h * (sq * (sq + 1) // 2 if causal and sq == skv
                     else sq * skv)
    qb, kvb, rows = b * h * sq * d * 2, b * hkv * skv * d * 2, b * h * sq * 4
    out = {}
    for name, flops, nbytes in (
            # q, k, v, dO, lse, delta in; dq out
            ("flash_bwd_dq", 6.0 * d * pairs, 3 * qb + 2 * kvb + 2 * rows),
            # q, k, v, dO, lse, delta in; dk, dv per kv head out
            ("flash_bwd_dkv", 8.0 * d * pairs, 2 * qb + 4 * kvb + 2 * rows)):
        t_ops = flops / peak_flops("h100", "bf16")
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes",
                     flops, nbytes)
    return out


def _split_check(q, k, v, do, causal, label, worst):
    """K4 and K5 (dk/dv folded inside it) against flash_bwd_split_plain
    (fold_heads of K5's per-head twin) on the twin's residuals; raises past
    the tolerance, folds the max abs and relative errors into ``worst``."""
    import torch
    from ray_tpu_torch.ops import attention as att

    scale = q.shape[-1] ** -0.5
    out, lse = att.flash_fwd_plain(q, k, v, causal, scale)
    delta = (do.float() * out.float()).sum(-1)
    dq = att.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
    dk, dv = att.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    plain = att.flash_bwd_split_plain(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    # At S 1 a row's softmax has one key: p = 1 and dp = delta, so dq and dk
    # vanish in exact arithmetic and hold rounding noise alone; there each
    # output is held to the tolerance of the twin's largest gradient.
    floor = (max(w.float().abs().max().item() for w in plain)
             if q.shape[2] == 1 else 0.0)
    errs = {}
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"split {name} not finite at {label}")
        err = (got.float() - want.float()).abs().max().item()
        rel = err / max(want.float().abs().max().item(), floor)
        if not rel < FLASH_REL_TOL:
            raise AssertionError(f"split {name} disagrees with its twin at "
                                 f"{label}: max abs err {err:.3e} = {rel:.3e}"
                                 f" of the largest value (> {FLASH_REL_TOL})")
        errs[name] = (err, rel)
    for kname, keys in (("flash_bwd_dq", ("dq",)),
                        ("flash_bwd_dkv", ("dk", "dv"))):
        worst[kname] = max([worst[kname]] + [errs[n][0] for n in keys])
        worst[kname + " rel"] = max([worst[kname + " rel"]]
                                    + [errs[n][1] for n in keys])
    return {n: e for n, (e, _) in errs.items()}


def phase_split():
    import torch
    from ray_tpu_torch.ops import attention as att

    _phase("kernel vs plain: flash_bwd_dq / flash_bwd_dkv (split backward)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
             "flash_bwd_dq rel": 0.0, "flash_bwd_dkv rel": 0.0}
    n = 0
    for causal in (True, False):
        for rep in (1, 4):
            for d in (64, 128):
                # 197: ViT-B/16's tokens; 1000: a ragged tail of 40 rows
                for s in (2048, 197, 1000):
                    q, k, v, do = _flash_inputs(gen, 1, 8, 8 // rep, s, d)
                    _split_check(q, k, v, do, causal,
                                 f"causal={causal} rep={rep} d={d} s={s}",
                                 worst)
                    n += 1
    # rep 2 and 8 (H8 Hkv1); the kernels' 128-row tile edges and S 1; more
    # (batch, head) pairs than a grid's y dimension holds.
    extra = [(1, 8, 8 // rep, 256, d, causal) for causal in (True, False)
             for rep in (2, 8) for d in (64, 128)]
    extra += [(1, 8, 2, s, d, causal) for causal in (True, False)
              for d in (64, 128) for s in (1, 127, 128, 129, 257)]
    extra.append((5462, 12, 12, 8, 64, False))
    for b, h, hkv, s, d, causal in extra:
        q, k, v, do = _flash_inputs(gen, b, h, hkv, s, d)
        _split_check(q, k, v, do, causal, f"causal={causal} b={b} h={h} "
                     f"hkv={hkv} d={d} s={s}", worst)
        n += 1
    # Two launches on the same inputs, the same bits: both head dims.
    for d in (64, 128):
        for causal in (True, False):
            q, k, v, do = _flash_inputs(gen, 2, 8, 2, 1000, d)
            scale = d ** -0.5
            out, lse = att.flash_fwd_cuda(q, k, v, causal, scale)
            runs = [att.flash_bwd_split_cuda(q, k, v, out, lse, do, causal,
                                             scale) for _ in range(2)]
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError(f"K4/K5 at d={d} causal={causal}: two "
                                     f"launches on the same inputs differ")
    m = MAIN_ATTN
    q, k, v, do = _flash_inputs(gen, m["b"], m["h"], m["hkv"], m["s"],
                                m["d"])
    errs = _split_check(q, k, v, do, True, "the training shape", worst)
    print(f"split kernels (K5 folds inside) == flash_bwd_split_plain over "
          f"{n} cases + the training shape (bf16); bit-identical on repeat "
          f"at d 64 and 128, causal and not; max abs err: flash_bwd_dq "
          f"{worst['flash_bwd_dq']:.3e}, flash_bwd_dkv "
          f"{worst['flash_bwd_dkv']:.3e} (= {worst['flash_bwd_dq rel']:.3e}"
          f" and {worst['flash_bwd_dkv rel']:.3e} of the case's largest "
          f"value); at the training shape "
          + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items())
          + f" (tolerance {FLASH_REL_TOL} of the largest value)")

    scale = m["d"] ** -0.5
    out, lse = att.flash_fwd_cuda(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1)
    runs = [(att.flash_bwd_dq_cuda(q, k, v, do, lse, delta, True, scale),
             *att.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True, scale))
            for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("K4/K5: two launches on the same inputs differ")
    k3 = [att.flash_bwd_cuda(q, k, v, out, lse, do, True, scale)
          for _ in range(2)]
    k3_same = [torch.equal(a, b) for a, b in zip(*k3)]
    del runs, k3
    print(f"two launches on the same inputs: K4 dq and K5 dk/dv bit-"
          f"identical; K3 dq/dk/dv identical {k3_same} (dq summed across "
          f"CTAs in no fixed order)")

    kr, vr = att._repeat_kv(k, m["h"]), att._repeat_kv(v, m["h"])
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, kr, vr))
    o_lib = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, is_causal=True)
    lib_bwd_ms = events_ms(lambda: torch.autograd.grad(
        o_lib, (qg, kg, vg), do, retain_graph=True), 20)
    del o_lib, qg, kg, vg
    ms = {
        "flash_bwd": events_ms(lambda: att.flash_bwd_cuda(
            q, k, v, out, lse, do, True, scale), 20),
        "flash_bwd_dq": events_ms(lambda: att.flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, True, scale), 20),
        "flash_bwd_dkv": events_ms(lambda: att.flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, True, scale), 20),
        "split": events_ms(lambda: att.flash_bwd_split_cuda(
            q, k, v, out, lse, do, True, scale), 20),
        "flash_bwd_dq plain": events_ms(lambda: att.flash_bwd_dq_plain(
            q, k, v, do, lse, delta, True, scale), 2),
        "flash_bwd_dkv plain": events_ms(lambda: att._dkv_folded_plain(
            q, k, v, do, lse, delta, True, scale), 2),
    }
    bounds = split_bounds(m["b"], m["h"], m["hkv"], m["s"], m["s"], m["d"],
                          True)
    rows = {}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        bound, by, flops, nbytes = bounds[name]
        rows[name] = {
            "ms": ms[name], "plain_ms": ms[name + " plain"],
            "library_ms": lib_bwd_ms, "bound_ms": bound, "bound_by": by,
            "max_abs_err": worst[name], "max_rel_err": worst[name + " rel"],
            "tflops": flops / (ms[name] * 1e-3) / 1e12,
            "split_total_ms": ms["split"],
            "k3_ms": ms["flash_bwd"], "bit_identical": True}
        print(f"{name} B4 H32 Hkv8 S2048 D64 causal bf16: kernel "
              f"{ms[name]:.4f} ms ({flops / 1e9:.1f} GFLOP the mask keeps, "
              f"{rows[name]['tflops']:.1f} TFLOP/s = "
              f"{100 * bound / ms[name]:.1f}% of the bound), plain twin "
              f"{ms[name + ' plain']:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB)")
    kernels = ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]
    k3_ms = ms["flash_bwd"]
    print(f"split backward: K4 {ms['flash_bwd_dq']:.4f} + K5 (the fold "
          f"inside) {ms['flash_bwd_dkv']:.4f} = "
          f"{kernels:.4f} ms with delta given; whole backwards, each "
          f"through its wrapper with delta, buffers and casts: split "
          f"{ms['split']:.4f} ms against K3 {k3_ms:.4f} ms in this call "
          f"({ms['split'] / k3_ms:.2f}x) and scaled_dot_product_attention's "
          f"backward alone {lib_bwd_ms:.4f} ms "
          f"({ms['split'] / lib_bwd_ms:.2f}x; k/v repeated to 32 heads "
          f"beforehand)")
    return rows


# The head-packed forward kernels (ray_tpu_torch/devbench/prof_flash_pack.py):
# kernel name on the kernels line -> (schedule, the TPU kernel's line).
PACKED = {"packed_fwd_epi": ("epi", 59), "packed_fwd_inl": ("inl", 123),
          "packed_fwd": ("masked", 262)}
PACKED_CHECK = dict(b=1, h=8, s=512)  # the correctness cases' batch, heads, S


def _packed_tiles(kind, rep, d):
    """(pack, block_q, block_k) that kernel ``kind`` takes at GQA rep and
    head_dim d."""
    from ray_tpu_torch.devbench import prof_flash_pack as pfp

    return [(p, bq, bk) for p in pfp.PACKS if rep % p == 0
            for bq in pfp.BLOCKS for bk in pfp.BLOCKS
            if p * bq <= pfp.MAX_ROWS[d] and (kind != "inl" or bq == bk)]


def _packed_errs(got, want):
    """(max abs err of out, relative to want's largest value, lse err)."""
    (out, lse), (p_out, p_lse) = got, want
    err = (out.float() - p_out.float()).abs().max().item()
    return err, err / p_out.float().abs().max().item(), \
        (lse - p_lse).abs().max().item()


def phase_packed():
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.devbench import prof_flash_pack as pfp
    from ray_tpu_torch.ops import attention as att

    _phase("kernel vs plain: packed_fwd / packed_fwd_epi / packed_fwd_inl "
           "(head-packed flash forward, the profiling entry point)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    worst = {name: [0.0, 0.0, 0.0] for name in PACKED}  # abs, rel, lse
    n = 0

    def hold(name, got, want, label, lse_tol=FLASH_LSE_TOL):
        if not torch.isfinite(got[0].float()).all():
            raise AssertionError(f"{name} out not finite at {label}")
        errs = _packed_errs(got, want)
        if not (errs[1] < FLASH_REL_TOL and errs[2] < lse_tol):
            raise AssertionError(
                f"{name} disagrees with its twin at {label}: out max abs err "
                f"{errs[0]:.3e} = {errs[1]:.3e} of the largest value (> "
                f"{FLASH_REL_TOL}) or lse {errs[2]:.3e} (> {lse_tol})")
        worst[name] = [max(a, b) for a, b in zip(worst[name], errs)]
        return errs

    c = PACKED_CHECK
    for causal in (True, False):
        for rep in (1, 4):
            for d in (64, 128):
                q, k, v, _ = _flash_inputs(gen, c["b"], c["h"], c["h"] // rep,
                                           c["s"], d)
                scale = d ** -0.5
                for name, (kind, _) in PACKED.items():
                    fn, twin = pfp.KERNELS[kind]
                    twins = {}
                    for pack, bq, bk in _packed_tiles(kind, rep, d):
                        if (bq, bk) not in twins:  # pack groups rows only
                            twins[bq, bk] = twin(q, k, v, causal, scale, pack,
                                                 bq, bk)
                        hold(name, fn(q, k, v, causal, scale, pack, bq, bk),
                             twins[bq, bk], f"causal={causal} rep={rep} "
                             f"d={d} pack={pack} bq={bq} bk={bk}")
                        n += 1
    m = MAIN_ATTN
    q, k, v, _ = _flash_inputs(gen, m["b"], m["h"], m["hkv"], m["s"], m["d"])
    scale = m["d"] ** -0.5
    main_errs, plain = {}, {}
    for name, (kind, _) in PACKED.items():
        fn, twin = pfp.KERNELS[kind]
        plain[name] = twin(q, k, v, True, scale)
        main_errs[name] = hold(name, fn(q, k, v, True, scale), plain[name],
                               "the profiling shape")
    print(f"packed kernels == plain twins over {n} cases (causal/non-causal, "
          f"rep 1 and 4, D 64/128, every pack x (block_q, block_k) each "
          f"takes, B1 H8 S512) + the profiling shape (B4 H32 Hkv8 S2048 D64 "
          f"causal, the defaults pack 2 block_q 64 block_k 64); max abs err "
          + ", ".join(f"{k_} {w[0]:.3e} (= {w[1]:.3e} of the largest value), "
                      f"lse {w[2]:.3e}" for k_, w in worst.items())
          + f"; at the profiling shape " + ", ".join(
              f"{k_} {e[0]:.3e} / lse {e[2]:.3e}" for k_, e in
              main_errs.items())
          + f" (tolerance {FLASH_REL_TOL} of the largest value, lse "
          f"{FLASH_LSE_TOL})")
    if not all(torch.equal(o, plain["packed_fwd"][0])
               and torch.equal(l, plain["packed_fwd"][1])
               for o, l in plain.values()):
        raise AssertionError("the three twins differ at the profiling shape")
    # More packs of heads than a grid's y dimension holds: B * H / pack =
    # 65536 on a linear grid (causal S 64: rows that see few keys).
    big = BIG_BATCH
    qb, kb, vb, _ = _flash_inputs(gen, big["b"], 2, 1, big["s"], big["d"])
    fn, twin = pfp.KERNELS["masked"]
    big_errs = hold("packed_fwd", fn(qb, kb, vb, True, 0.125, 2, 64, 64),
                    twin(qb, kb, vb, True, 0.125, 2, 64, 64),
                    f"B{big['b']} H2 Hkv1 pack 2 S{big['s']}",
                    FEW_KEYS_LSE_TOL)
    del qb, kb, vb
    print(f"packed_fwd at B * H / pack = {big['b']} (B{big['b']} H2 Hkv1 "
          f"pack 2 S{big['s']} D64 causal) == its twin on a linear grid: out"
          f" {big_errs[0]:.3e}, lse {big_errs[2]:.3e} (lse tolerance "
          f"{FEW_KEYS_LSE_TOL:.3e})")

    # Against K2 at block_k 64, on the same inputs: within the flash
    # tolerance, and whether bit-identical (same arithmetic, same tiles).
    k2 = att.flash_fwd_cuda(q, k, v, True, scale)
    same = {}
    for name, (kind, _) in PACKED.items():
        fn = pfp.KERNELS[kind][0]
        for pack, bq, bk in _packed_tiles(kind, m["h"] // m["hkv"],
                                          m["d"]):
            if bk != 64:
                continue
            got = fn(q, k, v, True, scale, pack, bq, bk)
            torch.cuda.synchronize()
            errs = _packed_errs(got, k2)
            if not (errs[1] < FLASH_REL_TOL and errs[2] < FLASH_LSE_TOL):
                raise AssertionError(f"{name} pack={pack} bq={bq} disagrees "
                                     f"with K2: {errs}")
            same[f"{name} pack{pack}_bq{bq}_bk64"] = (
                torch.equal(got[0], k2[0]) and torch.equal(got[1], k2[1]))
    print(f"against K2 (flash_fwd_cuda) at block_k 64, the profiling shape: "
          f"within tolerance; bit-identical: "
          + ", ".join(f"{k_} {v_}" for k_, v_ in same.items()))

    kr, vr = att._repeat_kv(k, m["h"]), att._repeat_kv(v, m["h"])
    k2_ms = events_ms(lambda: att.flash_fwd_cuda(q, k, v, True, scale), 20)
    lib_ms = events_ms(lambda: F.scaled_dot_product_attention(
        q, kr, vr, is_causal=True), 20)
    bound, by, flops, nbytes = flash_bounds(**m)["flash_fwd"]
    rows = {}
    for name, (kind, _) in PACKED.items():
        fn, twin = pfp.KERNELS[kind]
        ms = events_ms(lambda: fn(q, k, v, True, scale), 20)
        plain_ms = events_ms(lambda: twin(q, k, v, True, scale), 2)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound, "bound_by": by, "k2_ms": k2_ms,
                      "max_abs_err": worst[name][0],
                      "max_rel_err": worst[name][1],
                      "lse_err": worst[name][2],
                      "tflops": flops / (ms * 1e-3) / 1e12,
                      "k2_bit_identical": {k_: v_ for k_, v_ in same.items()
                                           if k_.startswith(name + " ")}}
        print(f"{name} (pack 2, block_q 64, block_k 64) B4 H32 Hkv8 S2048 "
              f"D64 causal bf16: kernel {ms:.4f} ms ({flops / 1e9:.1f} GFLOP,"
              f" {rows[name]['tflops']:.1f} TFLOP/s = {100 * bound / ms:.1f}% "
              f"of the bound), plain twin {plain_ms:.4f} ms, K2 {k2_ms:.4f} ms"
              f" ({ms / k2_ms:.2f}x K2), scaled_dot_product_attention forward"
              f" {lib_ms:.4f} ms (k/v repeated to 32 heads beforehand; "
              f"{ms / lib_ms:.2f}x), bound {bound:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB)")

    # The entry point's own check, then its sweep: the main path of this
    # slice, with the launch counts reset right before and read right after.
    errs = pfp.check("cuda", print_fn=lambda line: None)
    print(f"prof_flash_pack check (B1 H8 Hkv2 S1024 D64 causal against f32 "
          f"attention_reference, limit {pfp.CHECK_TOL} of its largest value):"
          f" {len(errs)} variants, max abs err {max(errs.values()):.3e}")
    fns = {name: pfp.KERNELS[kind][0] for name, (kind, _) in PACKED.items()}
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    sweep = pfp.sweep()
    launches = {name: fn.launches for name, fn in fns.items()}
    best = min(sweep[1:], key=lambda r: r["ms"])
    print(f"prof_flash_pack sweep: {len(sweep)} variants in "
          f"{time.perf_counter() - t0:.1f} s; best {best['name']} "
          f"{best['ms']:.4f} ms = {best['ms'] / sweep[0]['ms']:.2f}x prod "
          f"(K2) {sweep[0]['ms']:.4f} ms; launches {launches}")
    for name, (kind, _) in PACKED.items():
        if not launches[name]:
            raise AssertionError(f"the sweep launched {name} no time")
        prefix = {"masked": "pack", "epi": "epi_", "inl": "inl_"}[kind]
        rows[name].update(launches=launches[name], sweep_ms={
            r["name"]: r["ms"] for r in sweep
            if r["name"].startswith(prefix)})
    return rows, sweep


# K6/K7 position cases (Sq, Skv, qpos offset, kpos offset): the diagonal
# chunk, a wholly visible past chunk, a wholly masked future chunk, offsets
# that are no multiple of 64, and ragged lengths partly and wholly masked.
CHUNK_POS = {"diagonal": (2048, 2048, 2048, 2048),
             "past": (2048, 2048, 2048, 0),
             "future": (2048, 2048, 0, 2048),
             "offset": (2048, 2048, 1000, 37),
             "ragged": (1000, 936, 300, 0),
             "ragged future": (1000, 936, 0, 2000),
             # The tile classes' cases: rows that see no key sharing tiles
             # with rows that do; the diagonal's positions permuted (seeded),
             # so a tile's min and max are not its ends; S 1024 causal, 16
             # tiles a side with every class present.
             "mixed": (2048, 2048, 0, 30),
             "shuffled": (2048, 2048, 2048, 2048),
             "long causal": (1024, 1024, 0, 0)}
TILE_CASES = ("mixed", "shuffled", "long causal")
# The JAX bench's 1.1B geometry (bench.py:292-297); max_seq_len per phase.
BENCH_GEOMETRY = dict(vocab_size=32128, hidden_size=2048,
                      intermediate_size=8192, num_layers=16, num_heads=32,
                      num_kv_heads=8, head_dim=64, tie_embeddings=True,
                      dtype="bfloat16")
CP_SEQ = 16384  # the context-parallel phases' sequence (b1)
# K6/K7 at the CP step's shape (one rank: the whole sequence, positions
# 0..S-1, causal) and at the sp = 4 ring's chunk shape (a quarter of it).
CP_ATTN = dict(b=1, h=32, hkv=8, s=CP_SEQ, d=64)
RING_CHUNK = dict(CP_ATTN, s=CP_SEQ // 4)


def _chunk_inputs(gen, b, h, hkv, sq, skv, d, q0, k0, shuffle=False):
    """bf16 q/k/v, int32 global positions (each vector permuted, seeded,
    with ``shuffle``), and f32 cotangents of out and lse (the lse one
    nonzero, as the ring's combine makes it)."""
    import torch

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    qpos = torch.arange(sq, dtype=torch.int32, device="cuda") + q0
    kpos = torch.arange(skv, dtype=torch.int32, device="cuda") + k0
    if shuffle:
        perm = torch.Generator().manual_seed(SEED + 11)
        qpos = qpos[torch.randperm(sq, generator=perm).cuda()]
        kpos = kpos[torch.randperm(skv, generator=perm).cuda()]
    return (rnd(b, h, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d), qpos,
            kpos, rnd(b, h, sq, d, dtype=torch.float32),
            rnd(b, h, sq, dtype=torch.float32))


def _chunk_check(inputs, causal, label, worst, strict=False,
                 lse_tol=FLASH_LSE_TOL):
    """K6 and K7 against their twins on one input (K7 on the twin's
    residuals), and the tile-bounds pre-pass against its twin; raises past
    the tolerance, folds the max abs errors into ``worst``. ``strict``
    also holds rows that see no key finite with lse < -1e29 and K7's dk/dv
    to the same bits on a second launch."""
    import torch
    from ray_tpu_torch.ops import attention as att

    q, k, v, qpos, kpos, g_out, g_lse = inputs
    scale = q.shape[-1] ** -0.5
    if not torch.equal(att.chunk_tile_bounds_cuda(qpos, kpos),
                       att.chunk_tile_bounds_plain(qpos, kpos)):
        raise AssertionError(f"chunk_tile_bounds disagrees with its twin at "
                             f"{label}")
    out, lse = att.flash_chunk_fwd_cuda(q, k, v, qpos, kpos, causal, scale)
    p_out, p_lse = att.flash_chunk_fwd_plain(q, k, v, qpos, kpos, causal,
                                             scale)
    grads = att.flash_chunk_bwd_cuda(q, k, v, qpos, kpos, p_out, p_lse,
                                     g_out, g_lse, causal, scale)
    plain = att.flash_chunk_bwd_plain(q, k, v, qpos, kpos, p_out, p_lse,
                                      g_out, g_lse, causal, scale)
    torch.cuda.synchronize()
    errs, rels = {}, {}
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (p_out, *plain)):
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"flash chunk {name} not finite at {label}")
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        rels[name] = rel
        if not rel < FLASH_REL_TOL:
            raise AssertionError(f"flash chunk {name} disagrees with its "
                                 f"twin at {label}: max abs err {err:.3e} = "
                                 f"{rel:.3e} of the largest value (> "
                                 f"{FLASH_REL_TOL})")
        errs[name] = err
    errs["lse"] = (lse - p_lse).abs().max().item()
    if not errs["lse"] < lse_tol:
        raise AssertionError(f"flash chunk lse disagrees at {label}: "
                             f"{errs['lse']:.3e} > {lse_tol}")
    if strict:
        nokey = qpos < kpos.min() if causal else torch.zeros_like(qpos).bool()
        if not (lse[..., nokey] < -1e29).all():
            raise AssertionError(f"rows that see no key lost lse ~ -6.9e29 "
                                 f"at {label}")
        again = att.flash_chunk_bwd_cuda(q, k, v, qpos, kpos, p_out, p_lse,
                                         g_out, g_lse, causal, scale)
        if not (torch.equal(again[1], grads[1])
                and torch.equal(again[2], grads[2])):
            raise AssertionError(f"K7's dk/dv differ between two launches "
                                 f"at {label}")
    worst["flash_chunk_fwd"] = max(worst["flash_chunk_fwd"], errs["out"],
                                   errs["lse"])
    worst["flash_chunk_bwd"] = max(worst["flash_chunk_bwd"], errs["dq"],
                                   errs["dk"], errs["dv"])
    for name, keys in (("flash_chunk_fwd", ("out",)),
                       ("flash_chunk_bwd", ("dq", "dk", "dv"))):
        worst[name + " rel"] = max([worst[name + " rel"]]
                                   + [rels[k] for k in keys])
    return errs


def chunk_bounds(b, h, hkv, qpos, kpos, d, causal):
    """(K6, K7) least times in ms with what bounds each: the FLOPs that
    these positions need (4 and 10 * B*H*D per visible (q, k) pair: the
    pairs the mask keeps, kpos ascending) over the bf16 peak vs bytes (each
    input read once, each output written once) over HBM bandwidth. Also the
    full pass's FLOPs, for its rate beside the kept pairs'."""
    import torch
    from ray_tpu_torch.accelerators.flops import peak_flops

    sq, skv = qpos.numel(), kpos.numel()
    pairs = (int(torch.searchsorted(kpos, qpos, right=True).sum())
             if causal else sq * skv)  # kpos ascending
    qb, kvb = b * h * sq * d * 2, b * hkv * skv * d * 2
    rows, pos = b * h * sq * 4, (sq + skv) * 4
    out = {}
    for name, flops, nbytes in (
            # q, k, v, qpos, kpos in; out f32, lse out
            ("flash_chunk_fwd", 4.0 * b * h * d * pairs,
             qb + 2 * kvb + pos + 2 * qb + rows),
            # q, k, v, qpos, kpos, out f32, lse, g_out f32, g_lse in;
            # dq, dk, dv out
            ("flash_chunk_bwd", 10.0 * b * h * d * pairs,
             qb + 2 * kvb + pos + 4 * qb + 2 * rows + qb + 2 * kvb)):
        t_ops = flops / peak_flops("h100", "bf16")
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes",
                     flops, nbytes, 4.0 * b * h * d * sq * skv
                     * (2.5 if name == "flash_chunk_bwd" else 1.0))
    return out


def tile_pairs(qpos, kpos, causal: bool) -> dict:
    """{kernel: {"skipped", "partial", "visible": pairs}} over one head's
    (q tile, kv tile) pairs in each kernel's own geometry, counted on the
    host from the positions: K6 classes 64-row q halves against 64-wide kv
    tiles, K7 64-row q tiles against its 128-row kv tiles. Skipped: kmin >
    qmax and every row of the q tile sees a key (qmin >= min kpos);
    visible: kmax <= qmin with whole tiles (K6 needs only the kv tile
    whole); partial: the rest, masked per element."""
    import numpy as np

    qp, kp = qpos.cpu().numpy(), kpos.cpu().numpy()
    cmin = kp.min()

    def blocks(pos, n):
        nb = -(-pos.size // n)
        pad = np.concatenate([pos, np.full(nb * n - pos.size, pos[-1])])
        full = np.arange(nb) * n + n <= pos.size
        return pad.reshape(nb, n).min(1), pad.reshape(nb, n).max(1), full

    out = {}
    for name, bk, need_q_whole in (("flash_chunk_fwd", 64, False),
                                   ("flash_chunk_bwd", 128, True)):
        qlo, qhi, qfull = (a[:, None] for a in blocks(qp, 64))
        klo, khi, kfull = (a[None, :] for a in blocks(kp, bk))
        whole = kfull & (qfull if need_q_whole else True)
        if causal:
            skipped = (klo > qhi) & (qlo >= cmin)
            visible = (khi <= qlo) & whole & ~skipped
        else:
            skipped = np.zeros(qlo.shape[0] * klo.shape[1], bool).reshape(
                qlo.shape[0], klo.shape[1])
            visible = np.broadcast_to(whole, skipped.shape)
        n = skipped.size
        out[name] = {"skipped": int(skipped.sum()),
                     "visible": int(visible.sum()),
                     "partial": int(n - skipped.sum() - visible.sum())}
    return out


def _chunk_times(inputs, m, causal, lib_causal, iters):
    """K6/K7, their twins and scaled_dot_product_attention (on k/v
    repeated to q's heads; its forward for K6, its backward alone for K7;
    ``lib_causal`` when the positions make the mask the diagonal's) on one
    input: {name: (ms, plain ms, library ms)}."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as att

    q, k, v, qpos, kpos, g_out, g_lse = inputs
    scale = m["d"] ** -0.5
    out, lse = att.flash_chunk_fwd_cuda(q, k, v, qpos, kpos, causal, scale)
    kr, vr = att._repeat_kv(k, m["h"]), att._repeat_kv(v, m["h"])
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, kr, vr))
    do = g_out.to(torch.bfloat16)
    # SDPA's backward alone: one forward, its graph replayed.
    o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=lib_causal)
    lib_bwd_ms = events_ms(lambda: torch.autograd.grad(
        o_lib, (qg, kg, vg), do, retain_graph=True), iters)
    del o_lib
    return {
        "flash_chunk_fwd": (
            events_ms(lambda: att.flash_chunk_fwd_cuda(
                q, k, v, qpos, kpos, causal, scale), iters),
            events_ms(lambda: att.flash_chunk_fwd_plain(
                q, k, v, qpos, kpos, causal, scale), 2),
            events_ms(lambda: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=lib_causal), iters)),
        "flash_chunk_bwd": (
            events_ms(lambda: att.flash_chunk_bwd_cuda(
                q, k, v, qpos, kpos, out, lse, g_out, g_lse, causal, scale),
                iters),
            events_ms(lambda: att.flash_chunk_bwd_plain(
                q, k, v, qpos, kpos, out, lse, g_out, g_lse, causal, scale),
                2),
            lib_bwd_ms),
    }


def phase_chunk():
    import torch
    from ray_tpu_torch.ops import attention as att

    _phase("kernel vs plain: flash_chunk_fwd / flash_chunk_bwd (ring step)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    worst = {"flash_chunk_fwd": 0.0, "flash_chunk_bwd": 0.0,
             "flash_chunk_fwd rel": 0.0, "flash_chunk_bwd rel": 0.0}
    n = 0
    for causal in (True, False):
        for rep in (1, 4):
            for d in (64, 128):
                for where, (sq, skv, q0, k0) in CHUNK_POS.items():
                    tile = where in TILE_CASES
                    _chunk_check(_chunk_inputs(gen, 1, 8, 8 // rep, sq, skv,
                                               d, q0, k0,
                                               shuffle=where == "shuffled"),
                                 causal,
                                 f"causal={causal} rep={rep} d={d} {where}",
                                 worst, strict=tile)
                    n += 1
    # The sp = 4 schedule's three kinds of chunk pair at its shape, then the
    # CP step's own inputs (the main path's shape).
    r, c = RING_CHUNK, CP_ATTN
    ring = {where: _chunk_inputs(gen, r["b"], r["h"], r["hkv"], r["s"],
                                 r["s"], r["d"], q0, k0)
            for where, (q0, k0) in (("past", (r["s"], 0)),
                                    ("diagonal", (r["s"], r["s"])),
                                    ("future", (0, r["s"])))}
    ring_errs = {where: _chunk_check(inputs, True, f"the ring's {where} "
                                     f"chunk", worst, strict=True)
                 for where, inputs in ring.items()}
    main = _chunk_inputs(gen, c["b"], c["h"], c["hkv"], c["s"], c["s"],
                         c["d"], 0, 0)
    main_errs = _chunk_check(main, True, "the CP step's shape", worst,
                             strict=True)
    print(f"flash chunk kernels == plain twins over {n} cases (the tile "
          f"classes' {', '.join(TILE_CASES)} with no-key rows and K7's "
          f"dk/dv repeat checked), the sp=4 "
          f"ring's past/diagonal/future chunks (B1 H32 Hkv8 4096x4096 D64) "
          f"and the CP step's shape (B1 H32 Hkv8 S16384 D64, positions "
          f"0..16383, causal); bf16, nonzero lse cotangent; max abs err: "
          f"flash_chunk_fwd {worst['flash_chunk_fwd']:.3e}, flash_chunk_bwd "
          f"{worst['flash_chunk_bwd']:.3e} (= "
          f"{worst['flash_chunk_fwd rel']:.3e}"
          f" and {worst['flash_chunk_bwd rel']:.3e} of the case's largest "
          f"value; tolerance {FLASH_REL_TOL} of the largest value, lse "
          f"{FLASH_LSE_TOL}); chunk_tile_bounds == its twin on every case")
    for where, errs in (*ring_errs.items(), ("CP step", main_errs)):
        print(f"  at the {where} shape: "
              + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items()))

    rows = {}
    for label, m, inputs, lib_causal, iters in (
            ("CP step", c, main, True, 5),
            ("ring chunk", r, ring["past"], False, 10)):
        times = _chunk_times(inputs, m, True, lib_causal, iters)
        bounds = chunk_bounds(m["b"], m["h"], m["hkv"], inputs[3],
                              inputs[4], m["d"], True)
        pairs = tile_pairs(inputs[3], inputs[4], True)
        for name, (ms, plain_ms, lib_ms) in times.items():
            bound, by, flops, nbytes, full = bounds[name]
            row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound, "bound_by": by,
                   "tflops": flops / (ms * 1e-3) / 1e12,
                   "tflops_full_pass": full / (ms * 1e-3) / 1e12,
                   "tile_pairs": pairs[name]}
            if label == "CP step":
                rows[name] = dict(row, max_abs_err=worst[name],
                                  max_rel_err=worst[name + " rel"],
                                  main_shape_errs=main_errs)
            else:
                rows[name]["chunk_4096"] = row
            print(f"{name} {label}: kernel {ms:.4f} ms ({row['tflops']:.1f} "
                  f"TFLOP/s over the {flops / 1e9:.1f} GFLOP the mask keeps;"
                  f" full-pass rate {row['tflops_full_pass']:.1f} TFLOP/s of "
                  f"{full / 1e9:.1f} GFLOP; {100 * bound / ms:.1f}% of the "
                  f"bound), plain twin {plain_ms:.4f} ms, "
                  f"{'causal' if lib_causal else 'non-causal'} "
                  f"scaled_dot_product_attention "
                  + ("backward alone" if name == "flash_chunk_bwd"
                     else "forward")
                  + f" {lib_ms:.4f} ms (k/v repeated to 32 heads beforehand; "
                  f"{ms / lib_ms:.2f}x), bound {bound:.4f} ms ({by}; "
                  f"{nbytes / 1e6:.1f} MB); tile pairs a head (skipped / "
                  f"partial / visible): {pairs[name]['skipped']} / "
                  f"{pairs[name]['partial']} / {pairs[name]['visible']}")
    # The pre-pass at the CP step's positions: bytes bound (the positions
    # read once, the bounds written once).
    qpos, kpos = main[3], main[4]
    out = att.chunk_tile_bounds_cuda(qpos, kpos)
    nbytes = (qpos.numel() + kpos.numel() + out.numel()) * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    pre = {"ms": events_ms(lambda: att.chunk_tile_bounds_cuda(qpos, kpos),
                           200),
           "plain_ms": events_ms(
               lambda: att.chunk_tile_bounds_plain(qpos, kpos), 50),
           "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
           "max_abs_err": 0}
    rows["chunk_tile_bounds"] = pre
    print(f"chunk_tile_bounds CP step: kernel {pre['ms']:.4f} ms (one CTA; "
          f"exact, == its twin), plain twin {pre['plain_ms']:.4f} ms, bound "
          f"{bound:.6f} ms (bytes; {nbytes / 1e3:.1f} KB); no single "
          f"PyTorch call computes it")
    return rows


# Limits on the ring against flash_fwd/flash_bwd on the whole sequence,
# each a block's error over that block's norm (chunk_rel_err), so the
# chunks of small values count as much as the large ones; about three
# times the readings on an H100 (PERF.md).
RING_CHUNK_TOL = {"out": 8e-3, "dq": 1.5e-2, "dk": 1.5e-2, "dv": 1.5e-2}


def row_rel_err(got, want) -> float:
    """The largest error of any row (the last axis), relative to that row's
    norm: max over rows of ||got_r - want_r|| / ||want_r||."""
    g = got.detach().float().reshape(-1, got.shape[-1])
    w = want.detach().float().reshape(-1, want.shape[-1])
    return ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max() \
        .item()


def chunk_rel_err(got, want, n: int) -> float:
    """The largest error of any (batch row, head, chunk) block of a
    [B, H, S, D] tensor whose sequence is split into the ring's n chunks,
    relative to that block's norm. A chunk pair the ring got wrong shows
    whole in its block; single rows whose exact value is near 0 (dq of
    the first query: ds = dp - delta cancels) do not drown the reading."""
    b, h, s, d = want.shape
    g = got.detach().float().reshape(b, h, n, s // n * d)
    w = want.detach().float().reshape(b, h, n, s // n * d)
    return ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max() \
        .item()


def ring_errors(got, want, n: int) -> dict:
    """{name: (chunk_rel_err, max abs err over the largest value)} of the
    ring's (out, dq, dk, dv) over n chunks against flash_fwd/flash_bwd's."""
    return {name: (chunk_rel_err(g, w, n),
                   ((g.float() - w.float()).abs().max()
                    / w.float().abs().max()).item())
            for name, g, w in zip(("out", "dq", "dk", "dv"), got, want)}


def check_ring_errors(errs: dict, label: str) -> None:
    bad = {k: e for k, (e, _) in errs.items() if not e < RING_CHUNK_TOL[k]}
    if bad:
        raise AssertionError(f"{label}: chunks off flash_attention's past "
                             f"{RING_CHUNK_TOL}: {bad}")


def phase_ring_schedule():
    import torch
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.ops.ring_attention import simulate_ring

    _phase("ring schedule: sp = 4 in one process, B1 H32 Hkv8 S16384 D64")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    m, sp = CP_ATTN, 4

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v = (rnd(m["b"], h, m["s"], m["d"]).requires_grad_()
               for h in (m["h"], m["hkv"], m["hkv"]))
    do = rnd(m["b"], m["h"], m["s"], m["d"])
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = att.flash_attention(*ref, True)
    want.backward(do)
    counters = _counters()
    for c in counters.values():
        c.launches = 0  # count the schedule only
    t0 = time.perf_counter()
    out = simulate_ring(q, k, v, sp)
    out.backward(do)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k_: c.launches for k_, c in counters.items()}
    if (launches["flash_chunk_fwd"], launches["flash_chunk_bwd"]) != \
            (sp * sp, sp * sp) or launches["flash_fwd"] or \
            launches["flash_bwd"]:
        raise AssertionError(f"ring schedule launches {launches}, want "
                             f"{sp * sp} K6 and {sp * sp} K7, no K2/K3")
    errs = ring_errors((out, q.grad, k.grad, v.grad),
                       (want, *(r.grad for r in ref)), sp)
    print(f"sp={sp} schedule: {launches['flash_chunk_fwd']} K6 + "
          f"{launches['flash_chunk_bwd']} K7 launches, no K2/K3, "
          f"{wall * 1e3:.1f} ms forward + backward (first run); against "
          f"flash_fwd/flash_bwd on the whole sequence, worst (head, chunk)"
          f" block's error over its norm (max abs err over the largest "
          f"value): "
          + ", ".join(f"{k_} {e:.3e} ({g:.3e})" for k_, (e, g) in errs.items())
          + f"; limits {RING_CHUNK_TOL}")
    check_ring_errors(errs, f"sp={sp} schedule")
    return {"launches": launches, "errs": errs}


TRAIN_WARMUP = 2   # steps before the clock starts
TRAIN_STEPS = 10   # timed steps
PROFILED_STEPS = 3  # steps under torch.profiler after the timed ones


def predicted_launches(remat, num_layers: int, ring: int = 0,
                       split: bool = False) -> dict:
    """Kernel launches per training step under a uniform remat policy, for
    Llama and ViT alike (both run two rms_norms a layer plus a final one).
    Forward: the norms, one flash forward a layer. The backward recomputes
    the norms of the checkpointed segments (attn: attention inputs + MLP;
    attn+: attention inputs, gate, rest of the MLP; full: the layer, the
    flash forward included) and runs one flash backward a layer; rms_norm's
    backward is plain tensor ops (no launch). The flash kernels are K2/K3,
    K2 and K4 + K5 with ``split`` (the split backward), or with ``ring`` >
    0 (context parallel over that many ranks: as many ring steps a layer)
    K6/K7, each after its tile-bounds pre-pass."""
    recompute = 0 if remat in (False, "none") else 2
    full = remat not in (False, "none", "attn", "attn+")
    fwd, bwd = num_layers * (2 if full else 1), num_layers
    flat = 0 if ring else 1
    return {"rms_norm": 2 * num_layers + 1 + recompute * num_layers,
            "flash_fwd": fwd * flat,
            "flash_bwd": 0 if split else bwd * flat,
            "flash_bwd_dq": bwd * flat if split else 0,
            "flash_bwd_dkv": bwd * flat if split else 0,
            "flash_chunk_fwd": fwd * ring, "flash_chunk_bwd": bwd * ring,
            # K6 and K7 each launch the tile-bounds pre-pass first
            "chunk_tile_bounds": (fwd + bwd) * ring}


def kernel_category(name: str) -> str:
    """Coarse class of a CUDA kernel name from the profiler."""
    low = name.lower()
    for cat, keys in (("flash", ("flash_",)), ("rms_norm", ("rms_norm",)),
                      ("gemm", ("nvjet", "gemm", "cutlass", "cublas")),
                      ("copy/cast", ("copy", "cat_", "catarray")),
                      ("reduction", ("reduce", "softmax", "logsumexp")),
                      ("elementwise", ("elementwise",)),
                      ("index/scatter", ("index", "scatter", "gather",
                                         "embedding"))):
        if any(k in low for k in keys):
            return cat
    return "other"


def _counters():
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.ops import norms

    return {"rms_norm": norms.rms_norm, "flash_fwd": att.flash_fwd_cuda,
            "flash_bwd": att.flash_bwd_cuda,
            "flash_bwd_dq": att.flash_bwd_dq_cuda,
            "flash_bwd_dkv": att.flash_bwd_dkv_cuda,
            "flash_chunk_fwd": att.flash_chunk_fwd_cuda,
            "flash_chunk_bwd": att.flash_chunk_bwd_cuda,
            "chunk_tile_bounds": att.chunk_tile_bounds_cuda}


@contextlib.contextmanager
def backward_choice(fused: bool):
    """A context in which flash_attention's backward is K3 (``fused``) or
    K4 + K5; the attention module's ``FUSED_BWD`` is restored on
    exit."""
    from ray_tpu_torch.ops import attention as att

    old = att.FUSED_BWD
    att.FUSED_BWD = fused
    try:
        yield
    finally:
        att.FUSED_BWD = old


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


TOP_OPS = 16  # PyTorch ops listed by the device time they launched


def profile_steps(step, state, tok, tgt, steps: int, step_s: float,
                  counters) -> tuple:
    """``steps`` training steps under torch.profiler: prints the device
    busy share (of the profiled wall, which carries the profiler's own
    host cost, and of the unprofiled window's ``step_s``), each counted
    kernel's and each category's device ms per step, the largest kernels
    and the PyTorch ops that launched the most device time themselves.
    Returns (state, the numbers)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _m = step(state, tok, tgt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kern:  # per step
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / steps
    busy_ms = sum(by_name.values())
    share = {key: sum(ms for n, ms in by_name.items()
                      if re.search(rf"\b{key}(_cta|_warp)?_kernel\b", n))
             for key in counters}
    cats: dict[str, float] = {}
    for name, ms in by_name.items():
        cat = kernel_category(name)
        cats[cat] = cats.get(cat, 0.0) + ms
    if busy_ms > 0:
        print(f"{steps} profiled step{'s' if steps > 1 else ''}, per step: "
              f"wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms = "
              f"{100 * busy_ms / wall_ms:.1f}% of the profiled wall (idle "
              f"{100 - 100 * busy_ms / wall_ms:.1f}%), "
              f"{100 * busy_ms / (step_s * 1e3):.1f}% of the unprofiled "
              f"window's {step_s * 1e3:.2f} ms step, "
              f"{len(kern) // steps} kernels; "
              + ", ".join(f"{k} {ms:.2f} ms ({100 * ms / busy_ms:.1f}%)"
                          for k, ms in share.items()))
        print("by category: " + ", ".join(
            f"{c} {ms:.2f} ms ({100 * ms / busy_ms:.1f}%)"
            for c, ms in sorted(cats.items(), key=lambda kv: -kv[1])))
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            print(f"  {ms:8.3f} ms  {name[:100]}")
    else:
        print("device busy: not measured (profiler saw no kernels)")
    ops = {}  # host-side ops only: the kernels' own rows repeat them
    for e in prof.key_averages() if busy_ms else ():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CPU and us > 0:
            ops[e.key] = us / 1e3 / steps
    if ops:
        print("by PyTorch op (device ms per step of the kernels each op "
              "launched itself): " + ", ".join(
                  f"{k[:40]} {ms:.2f}" for k, ms in sorted(
                      ops.items(), key=lambda kv: -kv[1])[:TOP_OPS]))
    return state, {"profiled_wall_ms": wall_ms, "busy_ms": busy_ms or None,
                   "kernel_ms_per_step": share if busy_ms else None,
                   "category_ms_per_step": cats if busy_ms else None,
                   **({"op_ms_per_step": ops} if ops else {})}


def phase_train():
    import gc
    import math

    import numpy as np
    import torch
    from ray_tpu_torch.accelerators.flops import (
        generation_of,
        llama_train_flops,
        peak_flops,
    )
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train import adamw_lowmem, make_llama_train_step
    from ray_tpu_torch._device import tree_leaves
    from ray_tpu_torch.train.optim import optimizer_state_bytes

    _phase("train: the 1.1B bench geometry, b4 s2048, remat attn+, "
           "adamw_lowmem, seeded random weights and tokens")
    cfg = LlamaConfig(**BENCH_GEOMETRY, max_seq_len=2048)
    batch, seq, remat = 4, 2048, "attn+"
    opt = adamw_lowmem(3e-4, weight_decay=0.1)
    torch.cuda.reset_peak_memory_stats()
    step, init, shard = make_llama_train_step(
        cfg, optimizer=opt, attn_impl="flash", remat=remat, seed=SEED,
        device="cuda")
    t0 = time.perf_counter()
    state = init()
    torch.cuda.synchronize()
    print(f"state up in {time.perf_counter() - t0:.2f} s: "
          f"{cfg.num_params() / 1e9:.3f}B params, hidden {cfg.hidden_size}, "
          f"{cfg.num_layers} layers, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads}, vocab {cfg.vocab_size}, tied")
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    tok, tgt = shard(tokens), shard(np.roll(tokens, -1, axis=1))

    counters = _counters()
    for c in counters.values():
        c.launches = 0  # count the training path only
    losses, norms_ = [], []
    for _ in range(TRAIN_WARMUP):
        state, m = step(state, tok, tgt)
        losses.append(m["loss"])
        norms_.append(m["grad_norm"])
    # The phases before this one leave a large heap; a full garbage
    # collection of it inside the timed window idles the device for
    # hundreds of ms. Freeze it out of the collector until the phase ends.
    gc.collect()
    gc.freeze()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(TRAIN_STEPS):
        state, m = step(state, tok, tgt)
        marks[i + 1].record()  # no sync: the host runs ahead as it can
        losses.append(m["loss"])
        norms_.append(m["grad_norm"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    launches = {k: c.launches for k, c in counters.items()}
    steps = TRAIN_WARMUP + TRAIN_STEPS
    want = predicted_launches(remat, cfg.num_layers)
    per_step = {k: n / steps for k, n in launches.items()}
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"launches per step {per_step} != the remat "
                             f"policy's {want}")
    loss_vals = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in loss_vals) or \
            not loss_vals[-1] < loss_vals[0]:
        raise AssertionError(f"loss trajectory not finite and falling: "
                             f"{loss_vals}")
    step_s = dt / TRAIN_STEPS  # the whole window: all tokens, all time
    flops = llama_train_flops(cfg, batch, seq)
    rate = peak_flops(generation_of(torch.cuda.get_device_name(0)) or "")
    if not rate:
        raise AssertionError("no peak rate for this card in "
                             "ray_tpu_torch/accelerators/flops.py")
    toks, mfu = batch * seq / step_s, flops / step_s / rate
    print(f"{TRAIN_STEPS} timed steps after {TRAIN_WARMUP} warm-up, whole "
          f"window on the host clock: {step_s * 1e3:.2f} ms a step, "
          f"{toks:.1f} tokens/s, MFU {100 * mfu:.2f}% ({flops / 1e12:.2f} "
          f"TFLOP per step counted as 6*N*tokens + attention, against "
          f"{rate / 1e12:.0f} TFLOP/s); per step between CUDA events "
          f"{_spread(step_ms)} ms")
    print("loss " + " ".join(f"{x:.4f}" for x in loss_vals)
          + "; grad_norm " + " ".join(f"{float(x):.4f}" for x in norms_))
    print(f"launches per step: " + ", ".join(
        f"{k} {v:g}" for k, v in per_step.items())
          + f" (= the {remat} policy's prediction over {steps} steps)")
    gib = 2.0 ** 30
    peak = torch.cuda.max_memory_allocated() / gib
    p_bytes = _nbytes(tree_leaves(state.params)) / gib
    m_bytes = optimizer_state_bytes(opt, state.params) / gib
    print(f"peak device memory {peak:.3f} GiB: params {p_bytes:.3f}, grads "
          f"{p_bytes:.3f} (bf16, freed after each update), moments "
          f"{m_bytes:.3f} (bf16), activations, the update's f32 transients "
          f"and allocator slack {peak - 2 * p_bytes - m_bytes:.3f}")

    state, prof = profile_steps(step, state, tok, tgt, PROFILED_STEPS,
                                step_s, counters)
    gc.unfreeze()
    del state
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_per_step": per_step,
            "step_ms": step_s * 1e3, "step_ms_events": step_ms,
            "tokens_per_s": toks, "mfu": mfu,
            "peak_gib": peak, "params_gib": p_bytes, "moments_gib": m_bytes,
            "losses": loss_vals,
            **prof}


SPLIT_STEPS = 5  # timed steps of the split-backward trainer
# Limit on each parameter's gradient under the split backward against the
# fused one on the same params and batch: its error's norm over its norm.
# On an H100 the readings were 8.9e-3 to 1.44e-2, and the fused backward
# against itself 8.4e-3 to 1.40e-2 (K3's dq atomics); the split one
# against itself 0. The limit is about 3.5x the worst reading, as CP's.
SPLIT_GRAD_TOL = 5e-2


def _loss_grads(loss_call, leaves):
    """One forward + backward: (loss, the leaves' gradients); the leaves'
    .grad is left None."""
    loss = loss_call()
    loss.backward()
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return float(loss.detach()), grads


def _grad_errs(names, grads, ref_grads) -> dict:
    return {name: ((g.float() - w.float()).norm() / w.float().norm()).item()
            for name, g, w in zip(names, grads, ref_grads)}


def split_against_fused(loss_call, params) -> dict:
    """The loss and every parameter's gradient under the split backward
    against the fused one, from the same params and batch; beside them each
    backward run twice (the fused one's dq atomics add in no fixed order,
    the split one has none)."""
    from ray_tpu_torch._device import tree_leaves

    leaves = tree_leaves(params)
    names = list(_leaf_names(params))
    runs = {}
    for name, fused in (("fused", True), ("split", False)):
        with backward_choice(fused):
            runs[name] = [_loss_grads(loss_call, leaves) for _ in range(2)]
    (ref_loss, ref), (ref_loss2, ref2) = runs["fused"]
    (loss, got), (loss2, got2) = runs["split"]
    return {"loss": loss, "ref_loss": ref_loss,
            "losses_repeat_equal": loss == loss2 and ref_loss == ref_loss2,
            "grad_errs": _grad_errs(names, got, ref),
            "fused_repeat_errs": _grad_errs(names, ref2, ref),
            "split_repeat_errs": _grad_errs(names, got2, got)}


def check_split(res: dict, label: str) -> None:
    """Prints ``split_against_fused``'s readings, then holds them: the
    first loss bit-equal (the forward is K2 either way), each gradient
    within SPLIT_GRAD_TOL of the fused one's."""
    errs = res["grad_errs"]
    print(f"{label}: split backward against fused on the same params and "
          f"batch: loss {res['loss']!r} vs {res['ref_loss']!r}; each "
          f"parameter's gradient error over its norm (limit "
          f"{SPLIT_GRAD_TOL}; in brackets fused run twice, then split run "
          f"twice): " + ", ".join(
              f"{k} {e:.3e} [{res['fused_repeat_errs'][k]:.3e}, "
              f"{res['split_repeat_errs'][k]:.3e}]" for k, e in errs.items()))
    bad = {k: e for k, e in errs.items() if not e < SPLIT_GRAD_TOL}
    if bad or res["loss"] != res["ref_loss"] or not math.isfinite(
            res["loss"]):
        raise AssertionError(f"{label}: split backward off the fused one: "
                             f"{res}")


def phase_train_split(fused: dict):
    import gc

    import numpy as np
    import torch
    from ray_tpu_torch.accelerators.flops import (
        generation_of,
        llama_train_flops,
        peak_flops,
    )
    from ray_tpu_torch.models.llama import LlamaConfig, loss_fn
    from ray_tpu_torch.train import adamw_lowmem, make_llama_train_step

    _phase("train, split backward (K4 + K5): the 1.1B bench geometry, b4 "
           "s2048, remat attn+, adamw_lowmem, the phase before's weights "
           "and tokens")
    cfg = LlamaConfig(**BENCH_GEOMETRY, max_seq_len=2048)
    batch, seq, remat = 4, 2048, "attn+"
    opt = adamw_lowmem(3e-4, weight_decay=0.1)
    torch.cuda.reset_peak_memory_stats()
    step, init, shard = make_llama_train_step(
        cfg, optimizer=opt, attn_impl="flash", remat=remat, seed=SEED,
        device="cuda")
    state = init()
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    tok, tgt = shard(tokens), shard(np.roll(tokens, -1, axis=1))
    check = split_against_fused(
        lambda: loss_fn(cfg, state.params, tok, tgt, remat=remat),
        state.params)
    check_split(check, "Llama 1.1B b4 s2048")

    counters = _counters()
    with backward_choice(False):
        for c in counters.values():
            c.launches = 0  # count the split trainer only
        losses = []
        for _ in range(TRAIN_WARMUP):
            state, m = step(state, tok, tgt)
            losses.append(m["loss"])
        gc.collect()
        gc.freeze()
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(SPLIT_STEPS + 1)]
        t0 = time.perf_counter()
        marks[0].record()
        for i in range(SPLIT_STEPS):
            state, m = step(state, tok, tgt)
            marks[i + 1].record()
            losses.append(m["loss"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / SPLIT_STEPS
        launches = {k: c.launches for k, c in counters.items()}
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        state, prof = profile_steps(step, state, tok, tgt, 1, step_s,
                                    counters)
        gc.unfreeze()
    steps = TRAIN_WARMUP + SPLIT_STEPS
    per_step = {k: n / steps for k, n in launches.items()}
    want = predicted_launches(remat, cfg.num_layers, split=True)
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"launches per step {per_step} != the split "
                             f"prediction {want}")
    loss_vals = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in loss_vals) or \
            loss_vals[0] != fused["losses"][0] or \
            loss_vals[0] != check["ref_loss"]:
        raise AssertionError(f"split losses {loss_vals}: not finite, or the "
                             f"first is not the fused trainer's "
                             f"{fused['losses'][0]!r} bit for bit")
    flops = llama_train_flops(cfg, batch, seq)
    rate = peak_flops(generation_of(torch.cuda.get_device_name(0)) or "")
    toks, mfu = batch * seq / step_s, flops / step_s / rate
    peak = torch.cuda.max_memory_allocated() / 2.0 ** 30
    print(f"{SPLIT_STEPS} timed steps after {TRAIN_WARMUP} warm-up, whole "
          f"window on the host clock: {step_s * 1e3:.2f} ms a step, "
          f"{toks:.1f} tokens/s, MFU {100 * mfu:.2f}% (the fused trainer: "
          f"{fused['step_ms']:.2f} ms, {fused['tokens_per_s']:.1f} tokens/s);"
          f" per step between CUDA events {_spread(step_ms)} ms (the fused "
          f"trainer: {_spread(fused['step_ms_events'])} ms); peak device "
          f"memory {peak:.3f} GiB (the check's four gradient sets "
          f"included)")
    print("loss " + " ".join(f"{x:.4f}" for x in loss_vals)
          + f"; the first bit-equal to the fused trainer's")
    print(f"launches per step: " + ", ".join(
        f"{k} {v:g}" for k, v in per_step.items())
          + f" (= the split prediction over {steps} steps)")
    del state
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_per_step": per_step,
            "step_ms": step_s * 1e3, "step_ms_events": step_ms,
            "tokens_per_s": toks, "mfu": mfu, "peak_gib": peak,
            "losses": loss_vals, "check": check, **prof}


CP_WARMUP = 2  # context-parallel steps before the clock starts
CP_STEPS = 3   # timed context-parallel steps
# Limits on a context-parallel forward + backward against sp_axis=None on
# the same params and batch (cp_against_plain): the loss, relative; the
# final hidden states, row_rel_err; each parameter's gradient, its error's
# norm over its norm. Two sp_axis=None runs already differ by up to 1.4e-2
# there (K3's dq atomics add in no fixed order; the bf16 backward carries
# that through 16 layers), and over several ranks each rank's partial
# gradients round to bf16 before the sum (PERF.md holds the readings).
CP_LOSS_TOL = 1e-4
CP_HIDDEN_TOL = 4e-3
CP_GRAD_TOL = 5e-2


def cp_loss_and_grads(cfg, params, tokens, group):
    """One context-parallel forward + backward of this rank's shard of the
    (1, S) batch ``tokens`` (targets: the tokens shifted by one) at its
    global positions, the loss and the gradients averaged over ``group``
    (equal shards). Returns (loss, grads); the leaves' .grad is left
    None."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch._device import tree_leaves
    from ray_tpu_torch.models.llama import loss_fn

    n, r = dist.get_world_size(group), dist.get_rank(group)
    c = tokens.shape[1] // n
    pos = torch.arange(r * c, (r + 1) * c, device=tokens.device)
    tgt = torch.roll(tokens, -1, dims=1)
    loss = loss_fn(cfg, params, tokens[:, pos], tgt[:, pos], positions=pos,
                   sp_axis=group, remat="attn+")
    loss.backward()
    grads = []
    for p in tree_leaves(params):
        dist.all_reduce(p.grad, group=group)
        grads.append(p.grad.div_(n))
        p.grad = None
    loss = loss.detach()
    dist.all_reduce(loss, group=group)
    return float(loss) / n, grads


def cp_against_plain(cfg, params, tokens, group) -> dict:
    """``cp_loss_and_grads`` and this rank's shard of the final hidden
    states against sp_axis=None (K2/K3) on the whole sequence, from the
    same params (leaves that require grad). Returns the readings that
    ``check_cp`` holds to their limits."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch._device import tree_leaves
    from ray_tpu_torch.models.llama import forward_hidden, loss_fn

    n, r = dist.get_world_size(group), dist.get_rank(group)
    c = tokens.shape[1] // n
    pos = torch.arange(r * c, (r + 1) * c, device=tokens.device)
    with torch.no_grad():
        want = forward_hidden(cfg, params, tokens, remat="attn+")[:, pos]
        got = forward_hidden(cfg, params, tokens[:, pos], positions=pos,
                             sp_axis=group, remat="attn+")
        hidden = row_rel_err(got, want)
        del want, got
    leaves, names = tree_leaves(params), list(_leaf_names(params))

    def plain():  # sp_axis=None's loss and gradients
        return _loss_grads(lambda: loss_fn(
            cfg, params, tokens, torch.roll(tokens, -1, dims=1),
            remat="attn+"), leaves)

    ref_loss, ref_grads = plain()
    # The plain path against itself: what K3's atomics (dq in no fixed
    # order) and the bf16 backward make of it, the floor of the CP reading.
    floor = _grad_errs(names, plain()[1], ref_grads)
    loss, grads = cp_loss_and_grads(cfg, params, tokens, group)
    return {"loss": loss, "ref_loss": ref_loss, "hidden_row_err": hidden,
            "grad_errs": _grad_errs(names, grads, ref_grads),
            "plain_grad_errs": floor,
            "grad_norm": float(torch.stack(
                [g.float().square().sum() for g in grads]).sum().sqrt()),
            "ref_grad_norm": float(torch.stack(
                [g.float().square().sum() for g in ref_grads]).sum().sqrt())}


def _leaf_names(tree, prefix: str = ""):
    """The leaves' paths, in tree_leaves' order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_names(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix


def check_cp(res: dict, label: str) -> None:
    """Prints ``cp_against_plain``'s readings, then holds them to their
    limits."""
    loss_rel = abs(res["loss"] - res["ref_loss"]) / abs(res["ref_loss"])
    errs = res["grad_errs"]
    print(f"{label} against sp_axis=None (K2/K3) on the same params and "
          f"batch: loss {res['loss']:.6f} vs {res['ref_loss']:.6f} "
          f"({loss_rel:.3e} relative, limit {CP_LOSS_TOL}); final hidden "
          f"states' worst row {res['hidden_row_err']:.3e} of its norm "
          f"(limit {CP_HIDDEN_TOL}); grad norm {res['grad_norm']:.6f} vs "
          f"{res['ref_grad_norm']:.6f}; each parameter's gradient error "
          f"over its norm (limit {CP_GRAD_TOL}; in brackets sp_axis=None "
          f"run twice): " + ", ".join(
              f"{k} {e:.3e} [{res['plain_grad_errs'][k]:.3e}]"
              for k, e in errs.items()))
    bad = {k: e for k, e in errs.items() if not e < CP_GRAD_TOL}
    if bad or not (math.isfinite(res["loss"]) and loss_rel <= CP_LOSS_TOL
                   and res["hidden_row_err"] < CP_HIDDEN_TOL):
        raise AssertionError(f"{label} disagrees with sp_axis=None: {res}")


def phase_cp_train():
    import gc
    from functools import partial

    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.accelerators.flops import (
        generation_of,
        llama_train_flops,
        peak_flops,
    )
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.train import adamw_lowmem, make_train_step

    _phase("context-parallel train: the 1.1B bench geometry, b1 s16384, "
           "sp_axis = a one-rank NCCL group, remat attn+, adamw_lowmem")
    cfg = LlamaConfig(**BENCH_GEOMETRY, max_seq_len=CP_SEQ)
    batch, seq, remat = 1, CP_SEQ, "attn+"
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        positions = torch.arange(seq, device="cuda")  # the one shard's
        opt = adamw_lowmem(3e-4, weight_decay=0.1)
        step, init, shard = make_train_step(
            loss=lambda p, tok, tgt: loss_fn(
                cfg, p, tok, tgt, sp_axis=group, positions=positions,
                remat=remat),
            init_fn=partial(init_params, cfg, device="cuda"),
            optimizer=opt, seed=SEED, device="cuda")
        state = init()
        rng = np.random.default_rng(SEED + 2)
        tokens = rng.integers(0, cfg.vocab_size, (batch, seq),
                              dtype=np.int32)
        tok, tgt = shard(tokens), shard(np.roll(tokens, -1, axis=1))
        # The same params and batch through sp_axis=None (K2/K3). With one
        # rank the ring's single step does K2's arithmetic (a full pass
        # whose masked tiles add exact zeros, then an exact combine); the
        # gradients differ where K7's delta = rowsum(dO * out) reads the
        # f32 out and K3's the bf16 one.
        check = cp_against_plain(cfg, state.params, tok, group)
        check_cp(check, "one-rank CP forward + backward")
        torch.cuda.reset_peak_memory_stats()
        counters = _counters()
        for c in counters.values():
            c.launches = 0  # count the context-parallel path only
        losses = []
        for _ in range(CP_WARMUP):
            state, m = step(state, tok, tgt)
            losses.append(m["loss"])
        gc.collect()
        gc.freeze()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CP_STEPS):
            state, m = step(state, tok, tgt)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / CP_STEPS
        launches = {k: c.launches for k, c in counters.items()}
        steps = CP_WARMUP + CP_STEPS
        per_step = {k: n / steps for k, n in launches.items()}
        want = predicted_launches(remat, cfg.num_layers, ring=1)
        if per_step != {k: float(v) for k, v in want.items()}:
            raise AssertionError(f"launches per step {per_step} != the "
                                 f"prediction {want}")
        loss_vals = [float(x) for x in losses]
        if not all(math.isfinite(x) for x in loss_vals) or not \
                abs(loss_vals[0] - check["loss"]) <= CP_LOSS_TOL * abs(
                    check["loss"]):
            raise AssertionError(f"CP losses {loss_vals}: not finite, or "
                                 f"the first is off the checked "
                                 f"{check['loss']}")
        flops = llama_train_flops(cfg, batch, seq)
        rate = peak_flops(generation_of(torch.cuda.get_device_name(0)) or "")
        toks, mfu = batch * seq / step_s, flops / step_s / rate
        gib = 2.0 ** 30
        peak = torch.cuda.max_memory_allocated() / gib
        print(f"{CP_STEPS} timed steps after {CP_WARMUP} warm-up, whole "
              f"window on the host clock: {step_s * 1e3:.2f} ms a step, "
              f"{toks:.1f} tokens/s, MFU {100 * mfu:.2f}% "
              f"({flops / 1e12:.2f} TFLOP per step counted as 6*N*tokens + "
              f"causal attention; the ring's kernels skip the tiles the "
              f"mask hides wholly); peak device memory "
              f"{peak:.3f} GiB")
        print(f"loss " + " ".join(f"{x:.4f}" for x in loss_vals))
        print(f"launches per step: " + ", ".join(
            f"{k} {v:g}" for k, v in per_step.items())
              + f" (= the prediction over {steps} steps)")
        state, prof = profile_steps(step, state, tok, tgt, 1, step_s,
                                    counters)
        gc.unfreeze()
        del state
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"launches": launches, "launches_per_step": per_step,
            "step_ms": step_s * 1e3, "tokens_per_s": toks, "mfu": mfu,
            "peak_gib": peak, "losses": loss_vals, "check": check, **prof}


VIT_BATCH = 128  # a card's share of DeiT-B's 1024 images over 8 GPUs
VIT_STEPS = 10   # timed ViT steps, after TRAIN_WARMUP
VIT_ATTN = dict(b=VIT_BATCH, h=12, hkv=12, s=197, d=64)  # ViT-B/16's


def _vit_run(cfg, images, labels, fused: bool) -> dict:
    """make_vit_train_step under one backward choice: TRAIN_WARMUP + VIT_STEPS
    steps with the counts reset right before and read right after, then one
    profiled step."""
    import gc

    import torch
    from ray_tpu_torch.accelerators.flops import (
        generation_of,
        peak_flops,
        vit_train_flops,
    )
    from ray_tpu_torch.train import adamw_lowmem, make_vit_train_step

    torch.cuda.reset_peak_memory_stats()
    step, init, shard = make_vit_train_step(
        cfg, optimizer=adamw_lowmem(3e-4, weight_decay=0.1), seed=SEED,
        device="cuda")
    state = init()
    img, lab = shard(images), shard(labels)
    counters = _counters()
    with backward_choice(fused):
        for c in counters.values():
            c.launches = 0  # count this run's steps only
        losses = []
        for _ in range(TRAIN_WARMUP):
            state, m = step(state, img, lab)
            losses.append(m["loss"])
        gc.collect()
        gc.freeze()
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(VIT_STEPS + 1)]
        t0 = time.perf_counter()
        marks[0].record()
        for i in range(VIT_STEPS):
            state, m = step(state, img, lab)
            marks[i + 1].record()
            losses.append(m["loss"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / VIT_STEPS
        launches = {k: c.launches for k, c in counters.items()}
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        peak = torch.cuda.max_memory_allocated() / 2.0 ** 30
        state, prof = profile_steps(step, state, img, lab, 1, step_s,
                                    counters)
        gc.unfreeze()
    steps = TRAIN_WARMUP + VIT_STEPS
    per_step = {k: n / steps for k, n in launches.items()}
    want = predicted_launches(False, cfg.num_layers, split=not fused)
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"ViT launches per step {per_step} != the "
                             f"prediction {want}")
    loss_vals = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in loss_vals):
        raise AssertionError(f"ViT losses not finite: {loss_vals}")
    rate = peak_flops(generation_of(torch.cuda.get_device_name(0)) or "")
    flops = vit_train_flops(cfg, VIT_BATCH)
    res = {"launches": launches, "launches_per_step": per_step,
           "step_ms": step_s * 1e3, "step_ms_events": step_ms,
           "images_per_s": VIT_BATCH / step_s,
           "mfu": flops / step_s / rate, "tflop_per_step": flops / 1e12,
           "peak_gib": peak, "losses": loss_vals, **prof}
    print(f"{'fused (K3)' if fused else 'split (K4 + K5)'} backward: "
          f"{VIT_STEPS} timed steps after {TRAIN_WARMUP} warm-up, whole "
          f"window on the host clock: {res['step_ms']:.2f} ms a step, "
          f"{res['images_per_s']:.1f} images/s, MFU {100 * res['mfu']:.2f}% "
          f"({flops / 1e12:.3f} TFLOP a step, vit_train_flops); per step "
          f"between CUDA events {_spread(step_ms)} ms; peak device memory "
          f"{peak:.3f} GiB; launches per step " + ", ".join(
              f"{k} {v:g}" for k, v in per_step.items() if v)
          + "; loss " + " ".join(f"{x:.4f}" for x in loss_vals))
    del state
    torch.cuda.empty_cache()
    return res


def _vit_attn_times() -> dict:
    """K2, K3, K4, K5 at ViT-B/16's attention (B128 H12 S197 D64,
    non-causal, bf16): first each against its plain twin and K4/K5 run
    twice (bit-identical), then timed beside non-causal
    scaled_dot_product_attention's forward and its backward alone, and
    each kernel's bound."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as att

    m = VIT_ATTN
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    q, k, v, do = _flash_inputs(gen, m["b"], m["h"], m["hkv"], m["s"],
                                m["d"])
    label = "ViT-B/16's attention"
    worst = dict.fromkeys(("flash_fwd", "flash_bwd", "flash_bwd_dq",
                           "flash_bwd_dkv", "flash_bwd_dq rel",
                           "flash_bwd_dkv rel"), 0.0)
    errs = {**_flash_check(q, k, v, do, False, label, worst),
            **{f"split {n}": e for n, e in _split_check(
                q, k, v, do, False, label, worst).items()}}
    scale = m["d"] ** -0.5
    out, lse = att.flash_fwd_cuda(q, k, v, False, scale)
    delta = (do.float() * out.float()).sum(-1)
    runs = [(att.flash_bwd_dq_cuda(q, k, v, do, lse, delta, False, scale),
             *att.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, False, scale))
            for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"K4/K5 at {label}: two launches on the same "
                             f"inputs differ")
    del runs
    print(f"K2, K3, K4, K5 (K3 and K4/K5 on the twin's residuals) == their "
          f"plain twins at {label} (B128 H12 S197 D64 non-causal bf16); max "
          f"abs err " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (tolerance {FLASH_REL_TOL} of the largest value, lse "
          f"{FLASH_LSE_TOL}); K4/K5 bit-identical on repeat")
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qg, kg, vg)
    lib_bwd = events_ms(lambda: torch.autograd.grad(
        o_lib, (qg, kg, vg), do, retain_graph=True), 20)
    del o_lib
    ms = {"flash_fwd": (events_ms(lambda: att.flash_fwd_cuda(
              q, k, v, False, scale), 20),
              events_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)),
          "flash_bwd": (events_ms(lambda: att.flash_bwd_cuda(
              q, k, v, out, lse, do, False, scale), 20), lib_bwd),
          "flash_bwd_dq": (events_ms(lambda: att.flash_bwd_dq_cuda(
              q, k, v, do, lse, delta, False, scale), 20), lib_bwd),
          "flash_bwd_dkv": (events_ms(lambda: att.flash_bwd_dkv_cuda(
              q, k, v, do, lse, delta, False, scale), 20), lib_bwd)}
    split_ms = events_ms(lambda: att.flash_bwd_split_cuda(
        q, k, v, out, lse, do, False, scale), 20)
    bounds = {**{k_: v_[:2] for k_, v_ in flash_bounds(
        m["b"], m["h"], m["hkv"], m["s"], m["d"], causal=False).items()},
        **{k_: v_[:2] for k_, v_ in split_bounds(
            m["b"], m["h"], m["hkv"], m["s"], m["s"], m["d"],
            False).items()}}
    rows = {}
    for name, (t, lib) in ms.items():
        bound, by = bounds[name]
        rows[name] = {"ms": t, "library_ms": lib, "bound_ms": bound,
                      "bound_by": by, "max_abs_err": worst[name]}
        if name in ("flash_bwd_dq", "flash_bwd_dkv"):
            rows[name]["split_total_ms"] = split_ms
        print(f"{name} at ViT-B/16's attention (B128 H12 S197 D64 non-causal "
              f"bf16): kernel {t:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"non-causal scaled_dot_product_attention "
              f"{'forward' if name == 'flash_fwd' else 'backward alone'} "
              f"{lib:.4f} ms")
    split = ms["flash_bwd_dq"][0] + ms["flash_bwd_dkv"][0]
    k3 = ms["flash_bwd"][0]
    print(f"at ViT-B/16's attention: K4 + K5 {split:.4f} ms with delta "
          f"given (rep 1: no fold); whole backwards through their wrappers "
          f"(delta, buffers, casts): split {split_ms:.4f} ms against K3 "
          f"{k3:.4f} ms ({split_ms / k3:.2f}x) and SDPA's backward alone "
          f"{lib_bwd:.4f} ms ({split_ms / lib_bwd:.2f}x)")
    return rows


# Limits on ViT-B/16's loss and each parameter's gradient through the
# kernels against plain attention (blockwise_attention: f32 scores and
# softmax, autograd) on the same params and batch: the loss relative, each
# gradient its error's norm over its norm. On an H100 the loss read 6.2e-5
# and the gradients 6.6e-3 to 1.7e-2, but wq and wk 4.6e-2 under either
# backward (the flash contract rounds p and ds to bf16; the plain path
# keeps them in f32). The limits are about 3x the worst readings.
VIT_PLAIN_LOSS_TOL = 2e-4
VIT_PLAIN_GRAD_TOL = 0.15


def vit_grads_check(cfg, images, labels) -> dict:
    """ViT-B/16's loss and every parameter's gradient at the trainer's
    batch, from seeded params: the split backward against the fused one
    (``split_against_fused``), then each against plain attention."""
    import torch
    from ray_tpu_torch._device import tree_leaves, tree_map
    from ray_tpu_torch.models.vit import init_params, loss_fn

    params = tree_map(lambda t: t.requires_grad_(),
                      init_params(cfg, generator=SEED, device="cuda"))
    img = torch.as_tensor(images, device="cuda")
    lab = torch.as_tensor(labels, device="cuda")
    leaves, names = tree_leaves(params), list(_leaf_names(params))
    check = split_against_fused(lambda: loss_fn(cfg, params, img, lab),
                                params)
    check_split(check, f"ViT-B/16 b{VIT_BATCH}")
    plain_loss, plain = _loss_grads(lambda: loss_fn(
        cfg, params, img, lab, attn_impl="blockwise"), leaves)
    errs = {}
    for name, fused in (("fused", True), ("split", False)):
        with backward_choice(fused):
            errs[name] = _grad_errs(names, _loss_grads(
                lambda: loss_fn(cfg, params, img, lab), leaves)[1], plain)
    loss_rel = abs(check["ref_loss"] - plain_loss) / abs(plain_loss)
    print(f"ViT-B/16 b{VIT_BATCH} through the kernels against plain "
          f"attention (blockwise_attention, f32 scores, autograd) on the "
          f"same params and batch: loss {check['ref_loss']!r} vs "
          f"{plain_loss!r} ({loss_rel:.3e} relative, limit "
          f"{VIT_PLAIN_LOSS_TOL}); each parameter's gradient error over its "
          f"norm (limit {VIT_PLAIN_GRAD_TOL}; fused, split): " + ", ".join(
              f"{n} {errs['fused'][n]:.3e}, {errs['split'][n]:.3e}"
              for n in names))
    bad = {(k, n): e for k, d in errs.items() for n, e in d.items()
           if not e < VIT_PLAIN_GRAD_TOL}
    if bad or not loss_rel <= VIT_PLAIN_LOSS_TOL:
        raise AssertionError(f"ViT-B/16 gradients off plain attention's: "
                             f"loss {loss_rel:.3e} relative, {bad}")
    del params, plain
    torch.cuda.empty_cache()
    return {"split_vs_fused": check, "plain_loss": plain_loss,
            "plain_grad_errs": errs}


def phase_vit():
    from dataclasses import replace

    import numpy as np
    from ray_tpu_torch.models.vit import ViTConfig

    cfg = replace(ViTConfig.base16(), dtype="bfloat16")
    _phase(f"ViT-B/16 train: {cfg.num_params() / 1e6:.1f}M params, 224 px, "
           f"patch 16, b{VIT_BATCH}, remat none, adamw_lowmem, seeded "
           f"random weights, images and labels; fused then split backward")
    rng = np.random.default_rng(SEED + 5)
    images = rng.uniform(0, 1, (VIT_BATCH, cfg.image_size, cfg.image_size,
                                cfg.num_channels)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, VIT_BATCH)
    runs = {"fused": _vit_run(cfg, images, labels, True),
            "split": _vit_run(cfg, images, labels, False)}
    first = [runs[k]["losses"][0] for k in ("fused", "split")]
    if first[0] != first[1]:
        raise AssertionError(f"ViT first losses differ: {first}")
    print(f"first losses bit-equal: {first[0]!r}; split step "
          f"{runs['split']['step_ms'] / runs['fused']['step_ms']:.3f}x the "
          f"fused step")
    runs["grads"] = vit_grads_check(cfg, images, labels)
    runs["attention"] = _vit_attn_times()
    return runs


# Limit on each parameter's gradient of the small ViT, card (kernels)
# against CPU (twins), its error's norm over its norm: on an H100 the
# readings were 3.1e-3 to 1.16e-2 under either backward.
VIT_XDEV_GRAD_TOL = 5e-2


def phase_cross_device_vit():
    import math

    import numpy as np
    import torch
    from ray_tpu_torch._device import tree_leaves, tree_map
    from ray_tpu_torch.models.vit import ViTConfig, init_params, loss_fn
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.train import adamw_lowmem, make_vit_train_step

    _phase("cross-device: bf16 ViT trainer, CUDA kernels vs CPU plain twins,"
           " fused and split backward")
    # head_dim 64, 65 tokens (64 patches + the class token).
    cfg = ViTConfig(image_size=32, patch_size=4, hidden_size=128,
                    intermediate_size=256, num_layers=2, num_heads=2,
                    num_classes=10, dtype="bfloat16")
    params = init_params(cfg, generator=9, device="cpu")
    rng = np.random.default_rng(SEED + 8)
    images = rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, 8)
    # Tolerances (bf16 end to end; matmul outputs round apart where the two
    # devices sum in other orders): losses within 1e-2 relative; each
    # parameter's gradient from one forward + backward, its error's norm
    # over its norm, within VIT_XDEV_GRAD_TOL.
    names = list(_leaf_names(params))
    for fused in (True, False):
        kern = att.flash_bwd_cuda if fused else att.flash_bwd_dq_cuda
        before = kern.launches
        losses, grads = {}, {}
        with backward_choice(fused):
            for dev in ("cuda", "cpu"):
                leaves = tree_map(
                    lambda t: t.to(dev).clone().requires_grad_(), params)
                grads[dev] = [g.cpu() for g in _loss_grads(
                    lambda: loss_fn(cfg, leaves,
                                    torch.from_numpy(images).to(dev),
                                    torch.from_numpy(labels).to(dev)),
                    tree_leaves(leaves))[1]]
                step, init, shard = make_vit_train_step(
                    cfg, optimizer=adamw_lowmem(1e-3, weight_decay=0.1),
                    device=dev)
                state = init(params)
                losses[dev] = [float(step(state, shard(images),
                                          shard(labels))[1]["loss"])
                               for _ in range(3)]
        if kern.launches - before != 4 * cfg.num_layers:
            raise AssertionError(f"the card's ViT loss and trainer launched "
                                 f"{kern.launches - before} backward kernels,"
                                 f" want {4 * cfg.num_layers}")
        for a, b in zip(losses["cuda"], losses["cpu"]):
            if not (math.isfinite(a) and abs(a - b) <= 1e-2 * abs(b)):
                raise AssertionError(f"ViT loss trajectories differ: "
                                     f"{losses}")
        errs = _grad_errs(names, grads["cuda"], grads["cpu"])
        print(f"{'fused' if fused else 'split'} backward: losses cuda "
              f"{['%.5f' % x for x in losses['cuda']]} vs cpu "
              f"{['%.5f' % x for x in losses['cpu']]} (within 1e-2 "
              f"relative); each parameter's gradient, card vs CPU, error "
              f"over its norm (limit {VIT_XDEV_GRAD_TOL}): " + ", ".join(
                  f"{n} {e:.3e}" for n, e in errs.items()))
        bad = {n: e for n, e in errs.items() if not e < VIT_XDEV_GRAD_TOL}
        if bad:
            raise AssertionError(f"ViT gradients, card vs CPU: {bad}")


def phase_cross_device_train():
    import math

    import numpy as np
    import torch
    from ray_tpu_torch._device import tree_map
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.train import adamw_lowmem, make_llama_train_step

    _phase("cross-device: bf16 trainer, CUDA kernels vs CPU plain twins")
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      max_seq_len=256, dtype="bfloat16")
    params = init_params(cfg, generator=7, device="cpu")
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (2, 256), dtype=np.int32)
    targets = np.roll(tokens, -1, axis=1)
    # Tolerances (bf16 end to end; matmul outputs round apart where the two
    # devices sum in other orders): losses within 1e-2 relative; norm
    # weight gradients within 5e-2 of their largest value.
    losses, norm_grads = {}, {}
    fwd0 = att.flash_fwd_cuda.launches
    for dev in ("cuda", "cpu"):
        leaves = tree_map(lambda t: t.to(dev).clone().requires_grad_(),
                          params)
        tok = torch.from_numpy(tokens).to(dev)
        tgt = torch.from_numpy(targets).to(dev)
        loss_fn(cfg, leaves, tok, tgt, remat="attn+").backward()
        norm_grads[dev] = {
            "attn_norm": leaves["layers"]["attn_norm"].grad,
            "mlp_norm": leaves["layers"]["mlp_norm"].grad,
            "final_norm": leaves["final_norm"].grad}
        step, init, shard = make_llama_train_step(
            cfg, optimizer=adamw_lowmem(1e-3, weight_decay=0.1),
            remat="attn+", device=dev)
        state = init(params)
        losses[dev] = [float(step(state, tok, tgt)[1]["loss"])
                       for _ in range(3)]
    if att.flash_fwd_cuda.launches == fwd0:
        raise AssertionError("the card's trainer launched no flash kernel")
    for a, b in zip(losses["cuda"], losses["cpu"]):
        if not (math.isfinite(a) and abs(a - b) <= 1e-2 * abs(b)):
            raise AssertionError(f"loss trajectories differ: {losses}")
    worst = 0.0
    for name, want in norm_grads["cpu"].items():
        got = norm_grads["cuda"][name]
        if got is None or not got.float().abs().sum().item() > 0:
            raise AssertionError(f"{name}: no gradient on the card")
        err = ((got.cpu().float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        if not err < 5e-2:
            raise AssertionError(f"{name} gradient: card vs CPU {err:.3e} "
                                 f"of the largest value (> 5e-2)")
        worst = max(worst, err)
    print(f"losses cuda {['%.5f' % x for x in losses['cuda']]} vs cpu "
          f"{['%.5f' % x for x in losses['cpu']]} (within 1e-2 relative); "
          f"norm weight gradients non-zero on the card, worst "
          f"{worst:.3e} of the largest value off the CPU's (< 5e-2)")


RANKS_TIMEOUT_S = 600


def _rank_main(rank: int, world: int, store: str, out_path: str) -> None:
    """One rank of ``phase_ranks``, on card ``rank``; rank 0 writes its
    readings to ``out_path``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch._device import tree_leaves
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.ops.ring_attention import (
        ring_attention_local,
        ring_attention_sharded,
    )

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world, device_id=dev)
    res = {}

    def sync():
        torch.cuda.synchronize()
        dist.barrier()

    # 1. Ring attention over the ranks against one card's flash.
    gen = torch.Generator().manual_seed(SEED + 3)
    m = CP_ATTN
    q, k, v, do = (torch.randn((m["b"], h, m["s"], m["d"]), generator=gen)
                   .to(dev, torch.bfloat16)  # the same on every rank
                   for h in (m["h"], m["hkv"], m["hkv"], m["h"]))
    for t in (q, k, v):
        t.requires_grad_()
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out = ring_attention_sharded(q, k, v, impl="flash")
    # Each rank takes 1/world of the global loss; all_gather's backward
    # sums the ranks' cotangents.
    ((out.float() * do.float()).sum() / world).backward()
    grads = [t.grad for t in (q, k, v)]
    for g in grads:
        dist.all_reduce(g)  # each rank holds its own shard's rows
    sync()
    res["ring_launches"] = {k_: c.launches for k_, c in counters.items()}
    if rank == 0:
        ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        want = att.flash_attention(*ref, True)
        want.backward(do)
        res["ring_errs"] = ring_errors((out, *grads),
                                       (want, *(r.grad for r in ref)), world)
        del ref, want
    # The ring alone on this rank's shard, forward + backward, timed on
    # the host clock around a barrier (the shifts wait on peers).
    rows = slice(rank * m["s"] // world, (rank + 1) * m["s"] // world)
    ql, kl, vl = (t.detach()[:, :, rows].clone().requires_grad_()
                  for t in (q, k, v))

    def ring_step():
        ring_attention_local(ql, kl, vl, None, impl="flash").backward(
            do[:, :, rows])

    ring_step()
    sync()
    t0 = time.perf_counter()
    for _ in range(3):
        ring_step()
    sync()
    res["ring_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    del q, k, v, do, out, grads, ql, kl, vl
    torch.cuda.empty_cache()

    # 2. The context-parallel Llama forward + backward, gradients
    # all-reduced, against one card's sp_axis=None; then timed.
    cfg = LlamaConfig(**BENCH_GEOMETRY, max_seq_len=CP_SEQ)
    params = init_params(cfg, generator=SEED, device=dev)
    for p in tree_leaves(params):
        p.requires_grad_()
    tokens = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab_size, (1, CP_SEQ))).to(dev)
    torch.cuda.reset_peak_memory_stats()
    res["check"] = cp_against_plain(cfg, params, tokens, dist.group.WORLD)
    for c in counters.values():
        c.launches = 0
    sync()
    t0 = time.perf_counter()
    for _ in range(3):
        cp_loss_and_grads(cfg, params, tokens, dist.group.WORLD)
    sync()
    res["cp_step_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    res["cp_launches"] = {k_: c.launches / 3 for k_, c in counters.items()}
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2.0 ** 30
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def phase_ranks(world: int) -> dict:
    """The ring over ``world`` ranks, one card each (NCCL): ring attention
    at B1 H32 Hkv8 S16384 D64 against flash_fwd/flash_bwd on rank 0's card
    (RING_CHUNK_TOL), and the context-parallel Llama at the 1.1B geometry, b1
    s16384 (s16384 / world tokens a rank), forward + backward with
    all-reduced gradients, against one card's sp_axis=None (check_cp),
    then timed."""
    import tempfile

    from ray_tpu_torch._spawn import run_ranks

    _phase(f"ring over {world} ranks, one card each: attention at "
           f"S{CP_SEQ} and the context-parallel Llama at s{CP_SEQ}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        run_ranks(_rank_main, world, tmp, (out_path,), RANKS_TIMEOUT_S)
        with open(out_path) as f:
            res = json.load(f)
    wall = time.perf_counter() - t0
    errs = res["ring_errs"]
    print(f"ring attention over {world} ranks: "
          f"{res['ring_launches']['flash_chunk_fwd']} K6 + "
          f"{res['ring_launches']['flash_chunk_bwd']} K7 launches on rank 0;"
          f" against flash_fwd/flash_bwd on one card, worst (head, chunk) "
          f"block's error over its norm (max abs err over the largest "
          f"value): "
          + ", ".join(f"{k} {e:.3e} ({g:.3e})" for k, (e, g) in errs.items())
          + f"; the ring alone on rank 0's shard, forward + backward: "
          f"{res['ring_ms']:.2f} ms")
    want = {"flash_chunk_fwd": world, "flash_chunk_bwd": world}
    if any(res["ring_launches"][k] != n for k, n in want.items()) or \
            res["ring_launches"]["flash_fwd"]:
        raise AssertionError(f"ring launches {res['ring_launches']}, want "
                             f"{want} a rank")
    check_ring_errors(errs, f"ring over {world} ranks")
    check_cp(res["check"], f"CP forward + backward over {world} ranks")
    toks = CP_SEQ / (res["cp_step_ms"] / 1e3)
    want = {k: float(n) for k, n in
            predicted_launches("attn+", BENCH_GEOMETRY["num_layers"],
                               ring=world).items()}
    print(f"context-parallel Llama over {world} ranks, forward + backward + "
          f"gradient all-reduce (no optimizer): "
          f"{res['cp_step_ms']:.2f} ms a step on rank 0's host clock = "
          f"{toks:.1f} tokens/s; launches a step on rank 0 "
          + ", ".join(f"{k} {n:g}" for k, n in res["cp_launches"].items())
          + f"; peak device memory {res['peak_gib']:.3f} GiB on rank 0; "
          f"phase wall {wall:.1f} s")
    if res["cp_launches"] != want:
        raise AssertionError(f"CP launches a step on rank 0 "
                             f"{res['cp_launches']} != the prediction {want}")
    res["tokens_per_s"] = toks
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "ray_tpu_torch")):
        print("chip_smoke: run from a checkout holding ray_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    kind, smi = phase_device()
    phase_build()
    max_err, times = phase_kernel()
    flash = phase_flash()
    split = phase_split()
    packed, sweep = phase_packed()
    chunk = phase_chunk()
    ring = phase_ring_schedule()
    eng = phase_engine(times[0]["host_us"])
    train = phase_train()
    train_split = phase_train_split(train)
    cp = phase_cp_train()
    vit = phase_vit()
    # The ring over ranks needs a card a rank: all the cards visible, in a
    # power of two (the sequence splits evenly).
    world = 1 << (torch.cuda.device_count().bit_length() - 1)
    if world >= 2:
        torch.cuda.empty_cache()
        ranks = phase_ranks(world)
    else:
        _phase("ring over ranks: skipped (one card visible)")
        ranks = None
    phase_cross_device()
    phase_cross_device_train()
    phase_cross_device_vit()
    main_shape = times[0]  # rows 8: the decode step's shape
    kernels = [{
        "name": "rms_norm", "route": "cuda",
        "source": "ray_tpu_torch/csrc/rms_norm.cu",
        "replaces": "ray_tpu/ops/norms.py:27",
        "tpu": "ray_tpu/ops/norms.py:_rms_kernel", "checked": True,
        "launches": train["launches"]["rms_norm"],
        "launches_by_path": {"engine": eng["launches"],
                             "train": train["launches"]["rms_norm"],
                             "train_split":
                                 train_split["launches"]["rms_norm"],
                             "cp_train": cp["launches"]["rms_norm"],
                             "vit_fused":
                                 vit["fused"]["launches"]["rms_norm"],
                             "vit_split":
                                 vit["split"]["launches"]["rms_norm"]},
        "max_abs_err": max_err,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape": [main_shape["rows"], main_shape["d"]], "dtype": "bfloat16",
        "host_us": main_shape["host_us"],
        "library_host_us": main_shape["library_host_us"],
        "shapes": times,
    }]
    for name, replaces, tpu in (
            ("flash_fwd", "ray_tpu/ops/attention.py:222",
             "_flash_fwd_kernel"),
            ("flash_bwd", "ray_tpu/ops/attention.py:476",
             "_flash_bwd_fused_kernel")):
        row = flash[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "tpu": f"ray_tpu/ops/attention.py:{tpu}",
            "checked": True, "launches": train["launches"][name],
            "launches_by_path": {
                "train": train["launches"][name],
                "train_split": train_split["launches"][name],
                "vit_fused": vit["fused"]["launches"][name],
                "vit_split": vit["split"]["launches"][name]},
            "max_abs_err": max(row["max_abs_err"],
                               vit["attention"][name]["max_abs_err"]),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **({"library_bwd_ms": row["library_bwd_ms"]}
               if "library_bwd_ms" in row else {}),
            "shape": [4, 32, 8, 2048, 64], "dtype": "bfloat16",
            "causal": True, "tflops": row["tflops"],
            "design": FLASH_DESIGN[name], "registers": row["registers"],
            **{k_: row[k_] for k_ in ("dk_dv_bit_identical",
                                      "dq_repeat_rel") if k_ in row},
            "vit_shape": vit["attention"][name]})
    for name, replaces, tpu in (
            ("flash_bwd_dq", "ray_tpu/ops/attention.py:387",
             "_flash_bwd_dq_kernel"),
            ("flash_bwd_dkv", "ray_tpu/ops/attention.py:431",
             "_flash_bwd_dkv_kernel")):
        row = split[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "tpu": f"ray_tpu/ops/attention.py:{tpu}",
            "checked": True, "launches": train_split["launches"][name],
            "launches_by_path": {"train_split": train_split["launches"][name],
                                 "vit_split": vit["split"]["launches"][name]},
            "max_abs_err": max(row["max_abs_err"],
                               vit["attention"][name]["max_abs_err"]),
            "max_rel_err": row["max_rel_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_compares": "scaled_dot_product_attention's backward "
                                "alone against split_total_ms (K4 and K5, "
                                "which folds inside, through their "
                                "wrapper)",
            "split_total_ms": row["split_total_ms"],
            "k3_ms": row["k3_ms"], "bit_identical": row["bit_identical"],
            "shape": [4, 32, 8, 2048, 64], "dtype": "bfloat16",
            "causal": True, "tflops": row["tflops"],
            "vit_shape": vit["attention"][name]})
    for name, replaces, tpu in (
            ("flash_chunk_fwd", "ray_tpu/ops/attention.py:735",
             "_flash_chunk_fwd_kernel"),
            ("flash_chunk_bwd", "ray_tpu/ops/attention.py:779",
             "_flash_chunk_bwd_kernel")):
        row = chunk[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "tpu": f"ray_tpu/ops/attention.py:{tpu}",
            "checked": True, "launches": cp["launches"][name],
            "launches_by_path": {"ring_schedule": ring["launches"][name],
                                 "cp_train": cp["launches"][name]},
            "max_abs_err": row["max_abs_err"],
            "max_rel_err": row["max_rel_err"],
            "main_shape_errs": row["main_shape_errs"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": [1, 32, 8, CP_SEQ, CP_SEQ, 64], "dtype": "bfloat16",
            "positions": "0..S-1, causal (the CP step's)",
            "tflops": row["tflops"],
            "tflops_full_pass": row["tflops_full_pass"],
            "tile_pairs": row["tile_pairs"], "chunk_4096": row["chunk_4096"]})
    row = chunk["chunk_tile_bounds"]
    kernels.append({
        "name": "chunk_tile_bounds", "route": "cuda",
        "source": "ray_tpu_torch/csrc/chunk_tile_bounds.cu",
        "replaces": "ray_tpu/ops/attention.py:735",
        "tpu": "none: the pre-pass of K6/K7 (ray_tpu/ops/attention.py:735, "
               ":779), whose tile classes the TPU kernels do not have",
        "checked": True, "launches": cp["launches"]["chunk_tile_bounds"],
        "launches_by_path": {
            "ring_schedule": ring["launches"]["chunk_tile_bounds"],
            "cp_train": cp["launches"]["chunk_tile_bounds"]},
        **row, "shape": [CP_SEQ, CP_SEQ], "dtype": "int32"})
    for name, (sched, line) in PACKED.items():
        row = packed[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_packed_fwd.cu",
            "replaces": f"devbench/prof_flash_pack.py:{line}",
            "tpu": "devbench/prof_flash_pack.py:_packed_fwd"
                   + {"masked": "", "epi": "_epi", "inl": "_inl"}[sched]
                   + "_kernel",
            "checked": True, "launches": row["launches"],
            "launches_by_path": {"prof_flash_pack": row["launches"]},
            **{k_: v_ for k_, v_ in row.items() if k_ != "launches"},
            "shape": [4, 32, 8, 2048, 64], "dtype": "bfloat16",
            "causal": True, "variant": "pack2_bq64_bk64"})
    summary = {k: v for k, v in eng.items() if k != "launches"}
    vit_summary = {k: v for k, v in vit.items() if k != "attention"}
    print(json.dumps({"card": smi, "engine": summary, "train": train,
                      "train_split": train_split, "ring_schedule": ring,
                      "cp_train": cp, "vit": vit_summary,
                      "prof_flash_pack": sweep, "ranks": ranks}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
