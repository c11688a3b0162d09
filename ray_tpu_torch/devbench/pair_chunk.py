"""The ring's chunk kernels K6/K7 of this tree against an earlier build of
them, in turns on one card (other, this, this, other), at the CP step's
shape and at the sp = 4 ring's 4096 past and diagonal chunks.

    git show <commit>:ray_tpu_torch/csrc/flash_chunk_fwd.cu > DIR/flash_chunk_fwd.cu
    git show <commit>:ray_tpu_torch/csrc/flash_chunk_bwd.cu > DIR/flash_chunk_bwd.cu
    python3 -m ray_tpu_torch.devbench.pair_chunk --other DIR

DIR's sources may have any of three C interfaces: before the tile bounds
(commits up to 7e022cd, no ``bounds`` pointer), with them (later
commits, whose launches then take this tree's pre-pass output too), and
K7 with dq's turn counters too (this tree's: dq summed in a fixed
order, where earlier K7s used atomics). Both builds get the same inputs;
each side's launches include the tile-bounds pre-pass where it takes
one, and K7's the zeroing its wrapper does (the dq buffer, and the
ordered one's turn counters). Prints
each build's worst difference from the other (out, lse, dq, dk, dv), the
times in ms (CUDA events), the card's name and power limit, and a JSON
line last. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

SHAPES = (("CP step S16384 causal", 16384, 0, 0, 5),
          ("ring past chunk 4096", 4096, 4096, 0, 20),
          ("ring diagonal chunk 4096", 4096, 4096, 4096, 20))


def _other_libs(src_dir: str):
    """Build and load DIR's two sources with this tree's nvcc flags; also
    whether they take the pre-pass's tile bounds."""
    from ray_tpu_torch._native import build

    with open(os.path.join(src_dir, "flash_chunk_fwd.cu")) as f:
        bounds = "const void* bounds" in f.read()
    with open(os.path.join(src_dir, "flash_chunk_bwd.cu")) as f:
        turns = "void* dq_sem" in f.read()

    procs = {n: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
         os.path.join(src_dir, f"lib{n}.so"), os.path.join(src_dir, f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in ("flash_chunk_fwd", "flash_chunk_bwd")}
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for n, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc build of {src_dir}/{n}.cu failed:\n{out}")
        lib = ctypes.CDLL(os.path.join(src_dir, f"lib{n}.so"))
        fn = getattr(lib, f"rtt_{n}")
        fn.argtypes = ([p_] * (7 + bounds) + [i_] * 6 + [f_, i_, p_]
                       if n.endswith("fwd")
                       else [p_] * (12 + bounds + turns) + [i_] * 6
                       + [f_, f_, i_, p_])
        fn.restype = i_
        libs[n] = fn
    return libs, bounds, turns


def _events_ms(fn, iters: int) -> float:
    import torch

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


def pair(src_dir: str, h: int = 32, hkv: int = 8, d: int = 64) -> list:
    import torch

    from ray_tpu_torch.ops import attention as att

    other, other_bounds, other_turns = _other_libs(src_dir)
    this_fwd = att._library("flash_chunk_fwd").rtt_flash_chunk_fwd
    this_bwd = att._library("flash_chunk_bwd").rtt_flash_chunk_bwd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    scale = d ** -0.5
    rows = []
    for label, s, q0, k0, iters in SHAPES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        q, k, v = (rnd(1, n, s, d).bfloat16() for n in (h, hkv, hkv))
        g_out, g_lse = rnd(1, h, s, d), rnd(1, h, s)
        qpos = torch.arange(s, dtype=torch.int32, device="cuda") + q0
        kpos = torch.arange(s, dtype=torch.int32, device="cuda") + k0
        bufs = {w: dict(out=torch.empty((1, h, s, d), device="cuda"),
                        lse=torch.empty((1, h, s), device="cuda"),
                        dq=torch.zeros((1, h, s, d), device="cuda"),
                        dk=torch.empty_like(k), dv=torch.empty_like(v))
                for w in ("other", "this")}

        def ptrs(*ts):
            return [t.data_ptr() for t in ts]

        def fwd(who):
            b = bufs[who]
            stream = torch.cuda.current_stream().cuda_stream
            bounds = att.chunk_tile_bounds_cuda(qpos, kpos)
            if who == "other":
                return other["flash_chunk_fwd"](
                    *ptrs(q, k, v, qpos, kpos,
                          *([bounds] if other_bounds else []), b["out"],
                          b["lse"]), 1, h, hkv, s, s, d, scale * att.LOG2E, 1,
                    stream)
            return this_fwd(*ptrs(q, k, v, qpos, kpos, bounds, b["out"],
                                  b["lse"]), 1, h, hkv, s, s, d,
                            scale * att.LOG2E, 1, stream)

        for who in ("other", "this"):
            if fwd(who):
                raise RuntimeError(f"{who} K6 launch failed at {label}")
        # K7 on this tree's forward residuals, for both builds.
        out, lse = bufs["this"]["out"], bufs["this"]["lse"]
        delta = (g_out * out).sum(-1)
        do = g_out.bfloat16()

        def turns():  # zeroed dq turn counters, 8 a 64-row q tile
            return [torch.zeros(h * -(-s // 64) * 8, dtype=torch.int32,
                                device="cuda")]

        def bwd(who):
            b = bufs[who]
            stream = torch.cuda.current_stream().cuda_stream
            bounds = att.chunk_tile_bounds_cuda(qpos, kpos)
            b["dq"].zero_()
            ordered = who == "this" or other_turns
            fn = this_bwd if who == "this" else other["flash_chunk_bwd"]
            return fn(*ptrs(q, k, v, qpos, kpos,
                            *([bounds] if who == "this" or other_bounds
                              else []), do, lse, delta, g_lse, b["dq"],
                            *(turns() if ordered else []), b["dk"], b["dv"]),
                      1, h, hkv, s, s, d, scale, scale * att.LOG2E, 1, stream)

        for who in ("other", "this"):
            if bwd(who):
                raise RuntimeError(f"{who} K7 launch failed at {label}")
        torch.cuda.synchronize()
        diff = {n: ((bufs["this"][n] - bufs["other"][n]).float().abs().max()
                    / bufs["other"][n].float().abs().max()).item()
                for n in ("out", "lse", "dq", "dk", "dv")}
        row = {"shape": label, "diff_over_largest": diff}
        for name, fn in (("K6", fwd), ("K7", bwd)):
            t = [_events_ms(lambda: fn(w), iters)
                 for w in ("other", "this", "this", "other")]
            row[name] = {"other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                         "speedup": (t[0] + t[3]) / (t[1] + t[2])}
            print(f"{label} {name}: other {t[0]:.4f} this {t[1]:.4f} this "
                  f"{t[2]:.4f} other {t[3]:.4f} ms: {row[name]['speedup']:.2f}x")
        print(f"{label}: this against other, max abs difference over the "
              "largest value: "
              + ", ".join(f"{n} {e:.3e}" for n, e in diff.items()))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="directory holding the other build's sources")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("pair_chunk: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    rows = pair(args.other)
    print(json.dumps({"card": card, "pairs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
