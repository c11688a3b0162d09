#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing its own lines; any
failure raises and the script exits non-zero without a result line:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel from ray_tpu_torch/csrc (rms_norm, flash_fwd,
   flash_bwd), one nvcc each, all at once, for sm_90a; ptxas registers and
   each flash kernel's dynamic shared memory;
3. kernel vs plain: rms_norm's kernel against rms_norm_reference over a
   grid of row counts, widths and dtypes, plus times at the engine's and
   the trainer's shapes (kernel, plain version, torch.nn.functional.
   rms_norm, bound: device time per call, and host time per eager call);
4. kernel vs plain: flash_fwd and flash_bwd against their plain twins over
   causal/non-causal, GQA rep 1/4, head_dim 64/128, S 2048 and a ragged
   length, then times at the training shape (B4 H32 Hkv8 S2048 D64 causal
   bf16): kernel, twin, bound, and scaled_dot_product_attention (forward;
   forward + backward, and its backward alone, for flash_bwd) as the
   yardstick;
5. the serving path: the LLM engine at Llama-3.2-1B width (bf16, seeded
   random weights) serving a warm-up wave and then WAVES timed waves of
   concurrent greedy requests (median and range reported), a two-chunk
   prefill, prefix-cache hits and chained decode bursts; kernel launch
   counts are reset right before it and read right after; then the host
   vs device split of one 16-step decode burst;
6. the training path: make_llama_train_step at the 1.1B bench geometry
   (bench.py), b4 s2048, remat attn+, adamw_lowmem, seeded random weights
   and tokens: 2 warm-up and 10 timed steps with counts reset right before
   and read right after (they must equal what the remat policy predicts);
   with the earlier phases' heap frozen out of the garbage collector:
   tokens/s, step ms and MFU over the whole timed window, the per-step
   spread, peak memory and its split, the loss trajectory (finite,
   falling) and a profiler split of three steps;
7. cross-device: f32 engines at tiny width (d=64) and at 1B width with
   two layers (d=2048), CUDA (kernel) vs CPU (plain) greedy token streams
   must be equal; a bf16 trainer at small width, 3 steps on the card
   (kernels) vs 3 on the CPU (plain twins) from one param tree: losses
   agree and the norm weights' gradients are non-zero and agree;
8. a JSON line of the kernels, then the JSON result line.

Exits non-zero when no CUDA device is visible or when run outside a
checkout. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
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
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line and " 0 bytes spill" not in \
                    line or "error" in line.lower():
                print(f"  [{name}] {line.strip()}")
    from ray_tpu_torch.ops.attention import kernel_smem_bytes
    for name in ("flash_fwd", "flash_bwd"):
        print(f"  [{name}] dynamic shared memory per CTA: "
              + ", ".join(f"D={d}: {kernel_smem_bytes(name, d)} B"
                          for d in (64, 128)))


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
MAIN_ATTN = dict(b=4, h=32, hkv=8, s=2048, d=64)  # the trainer's shape


def _flash_inputs(gen, b, h, hkv, s, d):
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    return rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d), \
        rnd(b, h, s, d)


def _flash_check(q, k, v, do, causal, label, worst):
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
    if not errs["lse"] < FLASH_LSE_TOL:
        raise AssertionError(f"flash lse disagrees at {label}: "
                             f"{errs['lse']:.3e} > {FLASH_LSE_TOL}")
    worst["flash_fwd"] = max(worst["flash_fwd"], errs["out"], errs["lse"])
    worst["flash_bwd"] = max(worst["flash_bwd"], errs["dq"], errs["dk"],
                             errs["dv"])
    return errs


def flash_bounds(b, h, hkv, s, d):
    """(fwd, bwd) least times in ms with what bounds each: causal FLOPs
    over the bf16 peak vs bytes (each input read once, each output written
    once) over HBM bandwidth. The backward does five products per tile
    pair to the forward's two."""
    from ray_tpu_torch.accelerators.flops import attention_flops, peak_flops

    fl = attention_flops(b, h, s, d, causal=True)
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

    scale = m["d"] ** -0.5
    out, lse = att.flash_fwd_cuda(q, k, v, True, scale)
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
        if name == "flash_bwd":
            rows[name]["library_bwd_ms"] = lib_bwd_ms
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


TRAIN_WARMUP = 2   # steps before the clock starts
TRAIN_STEPS = 10   # timed steps
PROFILED_STEPS = 3  # steps under torch.profiler after the timed ones


def predicted_launches(remat, num_layers: int) -> dict:
    """Kernel launches per training step under a uniform remat policy.
    Forward: two rms_norms a layer plus the final one, one flash_fwd a
    layer. The backward recomputes the norms of the checkpointed segments
    (attn: attention inputs + MLP; attn+: attention inputs, gate, rest of
    the MLP; full: the layer, flash_fwd included) and runs one flash_bwd a
    layer; rms_norm's backward is plain tensor ops (no launch)."""
    recompute = 0 if remat in (False, "none") else 2
    full = remat not in (False, "none", "attn", "attn+")
    return {"rms_norm": 2 * num_layers + 1 + recompute * num_layers,
            "flash_fwd": num_layers * (2 if full else 1),
            "flash_bwd": num_layers}


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
            "flash_bwd": att.flash_bwd_cuda}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    cfg = LlamaConfig(vocab_size=32128, hidden_size=2048,
                      intermediate_size=8192, num_layers=16, num_heads=32,
                      num_kv_heads=8, head_dim=64, max_seq_len=2048,
                      tie_embeddings=True, dtype="bfloat16")
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

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            state, m = step(state, tok, tgt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    gc.unfreeze()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kern:  # per step
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / PROFILED_STEPS
    busy_ms = sum(by_name.values())
    share = {key: sum(ms for n, ms in by_name.items() if f"{key}_" in n)
             for key in counters}
    cats: dict[str, float] = {}
    for name, ms in by_name.items():
        cat = kernel_category(name)
        cats[cat] = cats.get(cat, 0.0) + ms
    if busy_ms > 0:
        # The profiled wall carries the profiler's own host cost; the timed
        # window's step carries none, so both denominators are printed.
        print(f"{PROFILED_STEPS} profiled steps, per step: wall "
              f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms = "
              f"{100 * busy_ms / wall_ms:.1f}% of the profiled wall (idle "
              f"{100 - 100 * busy_ms / wall_ms:.1f}%), "
              f"{100 * busy_ms / (step_s * 1e3):.1f}% of the unprofiled "
              f"window's {step_s * 1e3:.2f} ms step, "
              f"{len(kern) // PROFILED_STEPS} kernels; "
              + ", ".join(f"{k} {ms:.2f} ms ({100 * ms / busy_ms:.1f}%)"
                          for k, ms in share.items()))
        print("by category: " + ", ".join(
            f"{c} {ms:.2f} ms ({100 * ms / busy_ms:.1f}%)"
            for c, ms in sorted(cats.items(), key=lambda kv: -kv[1])))
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            print(f"  {ms:8.3f} ms  {name[:100]}")
    else:
        print("device busy: not measured (profiler saw no kernels)")
    del state
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_per_step": per_step,
            "step_ms": step_s * 1e3, "step_ms_events": step_ms,
            "tokens_per_s": toks, "mfu": mfu,
            "peak_gib": peak, "params_gib": p_bytes, "moments_gib": m_bytes,
            "losses": loss_vals,
            "profiled_wall_ms": wall_ms,
            "busy_ms": busy_ms or None,
            "kernel_ms_per_step": share if busy_ms else None,
            "category_ms_per_step": cats if busy_ms else None}


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
    eng = phase_engine(times[0]["host_us"])
    train = phase_train()
    phase_cross_device()
    phase_cross_device_train()
    main_shape = times[0]  # rows 8: the decode step's shape
    kernels = [{
        "name": "rms_norm", "route": "cuda",
        "source": "ray_tpu_torch/csrc/rms_norm.cu",
        "replaces": "ray_tpu/ops/norms.py:27",
        "tpu": "ray_tpu/ops/norms.py:_rms_kernel", "checked": True,
        "launches": train["launches"]["rms_norm"],
        "launches_by_path": {"engine": eng["launches"],
                             "train": train["launches"]["rms_norm"]},
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
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **({"library_bwd_ms": row["library_bwd_ms"]}
               if "library_bwd_ms" in row else {}),
            "shape": [4, 32, 8, 2048, 64], "dtype": "bfloat16",
            "causal": True, "tflops": row["tflops"]})
    summary = {k: v for k, v in eng.items() if k != "launches"}
    print(json.dumps({"card": smi, "engine": summary, "train": train}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
