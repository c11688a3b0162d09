#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing its own lines; any
failure raises and the script exits non-zero without a result line:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel from ray_tpu_torch/csrc, with nvcc, for sm_90a;
3. kernel vs plain: rms_norm's kernel against rms_norm_reference over a
   grid of row counts, widths and dtypes, plus times at the engine's
   shapes (kernel, plain version, torch.nn.functional.rms_norm, bound:
   device time per call, and host time per eager call);
4. the main path: the LLM engine at Llama-3.2-1B width (bf16, seeded
   random weights) serving a warm-up wave and then WAVES timed waves of
   concurrent greedy requests (median and range reported), a two-chunk
   prefill, prefix-cache hits and chained decode bursts; kernel launch
   counts are reset right before it and read right after; then the host
   vs device split of one 16-step decode burst;
5. cross-device: f32 engines at tiny width (d=64) and at 1B width with
   two layers (d=2048), CUDA (kernel) vs CPU (plain) greedy token streams
   must be equal;
6. a JSON line of the kernels, then the JSON result line.

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
            if "Used" in line or "error" in line.lower():
                print(f"  [{name}] {line.strip()}")


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
    for rows in (8, 512):
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
    eng = phase_engine(times[0]["host_us"])
    phase_cross_device()
    main_shape = times[0]  # rows 8: the decode step's shape
    kernel = {
        "name": "rms_norm", "route": "cuda",
        "source": "ray_tpu_torch/csrc/rms_norm.cu",
        "replaces": "ray_tpu/ops/norms.py:27",
        "tpu": "ray_tpu/ops/norms.py:_rms_kernel", "checked": True,
        "launches": eng["launches"], "max_abs_err": max_err,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape": [main_shape["rows"], main_shape["d"]], "dtype": "bfloat16",
        "host_us": main_shape["host_us"],
        "library_host_us": main_shape["library_host_us"],
        "shapes": times,
    }
    summary = {k: v for k, v in eng.items() if k != "launches"}
    print(json.dumps({"card": smi, "engine": summary}))
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
