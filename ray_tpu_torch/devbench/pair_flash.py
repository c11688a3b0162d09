"""The flash forward K2 and the fused flash backward K3 of this tree against
an earlier build of them, in turns on one card (other, this, this, other),
at the training shape (B4 H32 Hkv8 S2048 D64, causal) and at ViT-B/16's
attention (B128 H12 S197 D64, non-causal); then three ablations of this
tree's design, each built from this tree's source with one edit and timed
in turns against the kernel as it stands (default, variant, variant,
default): K2 at 192 q rows a CTA (three consumer warpgroups, also at S
1024 to 16384, B1-8 H32 Hkv8), K3 with no dq sum across its CTAs (what
that sum costs), and K3 with no wait for dq's turn (what the fixed order
costs; its dq is then racy); and the PyTorch delta that K3 makes inside
itself.

    DIR=ray_tpu_torch/_native/_build/parent; mkdir -p $DIR
    git show <commit>:ray_tpu_torch/csrc/flash_fwd.cu > $DIR/flash_fwd.cu
    git show <commit>:ray_tpu_torch/csrc/flash_bwd.cu > $DIR/flash_bwd.cu
    git show <commit>:ray_tpu_torch/csrc/hopper.cuh > $DIR/hopper.cuh
    python3 -m ray_tpu_torch.devbench.pair_flash --other $DIR

DIR's K3 may take any of three C interfaces, read from its source: delta
= rowsum(dO * O) f32 [B,H,Sq] in the pointer slot where later K3s take O
(builds before 4ff303a), O with no dq turn counters (dq summed by
atomics, up to e3857e2), or this tree's (dq's turn counters). Both
builds get the same inputs; K3 runs on this tree's forward residuals on
both sides, and each side's backward is timed as its wrapper runs it
(the other's delta in PyTorch, the zeroed f32 dq buffer and, for this
tree's, the zeroed turn counters, the kernel, the cast). Prints each
build's worst difference from the other (out, lse, dq, dk, dv, over the
largest value), the times in ms (CUDA events), the card's name and power
limit, and a JSON line last. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

from ray_tpu_torch.devbench.pair_chunk import _events_ms

# label, B, H, Hkv, S, causal, timed launches a turn
SHAPES = (("training B4 H32 Hkv8 S2048 D64 causal", 4, 32, 8, 2048, True, 20),
          ("ViT-B/16 B128 H12 S197 D64 non-causal", 128, 12, 12, 197, False,
           20))
NAMES = ("flash_fwd", "flash_bwd")
# An ablation: this tree's source with one edit (the text, its
# replacement), built apart from it.
ABLATIONS = {
    "K2 at 192 rows a CTA": ("flash_fwd", "launch<64, kWG>(",
                             "launch<64, 3>("),
    "K3 with no dq sum": ("flash_bwd",
                          "      if (row < Sq)\n        atomicAdd(",
                          "      if (false)\n        atomicAdd("),
    "K3 with no turn wait": ("flash_bwd", "    turn_wait(turn, kt);",
                             "    (void)turn;"),
}
# K2's rows a CTA beyond the two shapes: label, B, S, causal (H32 Hkv8).
ROWS_SHAPES = (("B8 S1024 causal", 8, 1024, True),
               ("B4 S4096 causal", 4, 4096, True),
               ("B1 S8192 causal", 1, 8192, True),
               ("B1 S8192 non-causal", 1, 8192, False),
               ("B1 S16384 causal", 1, 16384, True))


def _compile(jobs: dict) -> dict:
    """Build each job's (source directory, kernel name) with this tree's
    nvcc flags, all at once, and load each library."""
    from ray_tpu_torch._native import build

    procs = {key: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
         os.path.join(d, f"lib{n}.so"), os.path.join(d, f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, (d, n) in jobs.items()}
    libs = {}
    for key, proc in procs.items():
        out, _ = proc.communicate()
        d, n = jobs[key]
        if proc.returncode:
            raise RuntimeError(f"nvcc build of {d}/{n}.cu failed:\n{out}")
        libs[key] = ctypes.CDLL(os.path.join(d, f"lib{n}.so"))
    return libs


def k3_interface(src_dir: str) -> tuple[bool, bool]:
    """(takes O, takes dq turn counters) of the K3 source in ``src_dir``."""
    with open(os.path.join(src_dir, "flash_bwd.cu")) as f:
        src = f.read()
    return "const void* out" in src, "void* dq_sem" in src


def _build(jobs: dict) -> dict:
    """``_compile`` the jobs and bind each library's rtt_<name> entry (a
    K3 without turn counters takes one pointer less)."""
    from ray_tpu_torch.ops.attention import _ARGTYPES

    fns = {}
    for key, lib in _compile(jobs).items():
        d, n = jobs[key]
        fn = getattr(lib, f"rtt_{n}")
        argtypes = list(_ARGTYPES[n])
        if n == "flash_bwd" and not k3_interface(d)[1]:
            del argtypes[7]  # no turn counters
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def _ablation_dirs(ablations: dict = ABLATIONS,
                   sub: str = "ablation") -> dict:
    """Each ablation's sources, this tree's with its one edit, in a
    directory of its own under the build directory's ``sub``."""
    from ray_tpu_torch._native import build

    jobs = {}
    for i, (label, (name, old, new)) in enumerate(ablations.items()):
        d = os.path.join(build.BUILD_DIR, sub, str(i))
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(build.SRC_DIR, "hopper.cuh"), d)
        with open(os.path.join(build.SRC_DIR, f"{name}.cu")) as f:
            src = f.read()
        if src.count(old) != 1:
            raise RuntimeError(f"ablation {label!r}: {old!r} is not once in "
                               f"{name}.cu")
        with open(os.path.join(d, f"{name}.cu"), "w") as f:
            f.write(src.replace(old, new))
        jobs[label] = (d, name)
    return jobs


def _turns(o_fn, t_fn, iters: int) -> dict:
    t = [_events_ms(fn, iters) for fn in (o_fn, t_fn, t_fn, o_fn)]
    return {"other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
            "speedup": (t[0] + t[3]) / (t[1] + t[2])}


def _show(label: str, name: str, r: dict, other="other", this="this") -> None:
    print(f"{label} {name}: {other} {r['other_ms'][0]:.4f} {this} "
          f"{r['this_ms'][0]:.4f} {this} {r['this_ms'][1]:.4f} {other} "
          f"{r['other_ms'][1]:.4f} ms: {r['speedup']:.2f}x")


def pair(src_dir: str, d: int = 64) -> list:
    import torch

    from ray_tpu_torch.ops import attention as att

    libs = _build({**{n: (src_dir, n) for n in NAMES}, **_ablation_dirs()})
    other_takes_out, other_turns = k3_interface(src_dir)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    scale = d ** -0.5
    rows = []
    for label, b, h, hkv, s, causal, iters in SHAPES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").bfloat16()

        q, k, v, do = rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d), \
            rnd(b, h, s, d)
        fwd_args = (b, h, hkv, s, s, d, scale * att.LOG2E, int(causal))

        def fwd_of(key):  # a built K2, as its wrapper runs it
            def run():
                out = torch.empty_like(q)
                lse = torch.empty((b, h, s), dtype=torch.float32,
                                  device="cuda")
                err = libs[key](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), lse.data_ptr(), *fwd_args,
                                torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{key} failed at {label}: {err}")
                return out, lse
            return run

        def this_fwd():
            return att.flash_fwd_cuda(q, k, v, causal, scale)

        out, lse = this_fwd()

        def bwd_of(key, takes_out, turns):
            """A built K3, as its wrapper runs it."""
            def run():
                sixth = (out if takes_out
                         else (do.float() * out.float()).sum(-1))
                dq = torch.zeros((b, h, s, d), dtype=torch.float32,
                                 device="cuda")
                sem = [torch.zeros(b * h * -(-s // 64) * 8,
                                   dtype=torch.int32,
                                   device="cuda").data_ptr()] if turns else []
                dk, dv = torch.empty_like(k), torch.empty_like(v)
                err = libs[key](
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), sixth.data_ptr(), dq.data_ptr(), *sem,
                    dk.data_ptr(), dv.data_ptr(), b, h, hkv, s, s, d, scale,
                    scale * att.LOG2E, int(causal),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{key} failed at {label}: {err}")
                return dq.to(q.dtype), dk, dv
            return run

        def this_bwd():
            return att.flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)

        other_fwd = fwd_of("flash_fwd")
        other_bwd = bwd_of("flash_bwd", other_takes_out, other_turns)
        got = {"other": (*other_fwd(), *other_bwd()),
               "this": (out, lse, *this_bwd())}
        torch.cuda.synchronize()
        diff = {n: ((x.float() - y.float()).abs().max()
                    / y.float().abs().max()).item()
                for n, x, y in zip(("out", "lse", "dq", "dk", "dv"),
                                   got["this"], got["other"])}
        del got
        row = {"shape": label, "diff_over_largest": diff}
        for name, fns in (("K2", (other_fwd, this_fwd)),
                          ("K3 through its wrapper", (other_bwd, this_bwd))):
            row[name] = _turns(*fns, iters)
            _show(label, name, row[name])
        print(f"{label}: this against other, max abs difference over the "
              "largest value: "
              + ", ".join(f"{n} {e:.3e}" for n, e in diff.items()))

        # What K3's in-kernel delta saves: the wrapper's PyTorch delta.
        row["delta in PyTorch ms"] = _events_ms(
            lambda: (do.float() * out.float()).sum(-1), iters)
        print(f"{label}: delta = (dO.float() * O.float()).sum(-1) in "
              f"PyTorch, as the other's wrapper makes it: "
              f"{row['delta in PyTorch ms']:.4f} ms")

        # The ablations, each in turns against this tree's kernel; K2 at
        # 192 rows gives the same bits, each K3 variant the same dk, dv.
        k2_192 = fwd_of("K2 at 192 rows a CTA")
        k3_variants = {n: bwd_of(n, True, True)
                       for n in ("K3 with no dq sum", "K3 with no turn wait")}
        same = {"K2 at 192 rows a CTA": all(
                    torch.equal(x, y) for x, y in zip(k2_192(), this_fwd())),
                **{n: all(torch.equal(x, y)
                          for x, y in zip(fn()[1:], this_bwd()[1:]))
                   for n, fn in k3_variants.items()}}
        row["ablations"] = {}
        for name, variant in (("K2 at 192 rows a CTA", k2_192),
                              *k3_variants.items()):
            r = _turns(*((this_fwd, variant) if name.startswith("K2")
                         else (this_bwd, variant)), iters)
            r["same_bits"] = same[name]
            row["ablations"][name] = r
            _show(label, name, r, "default", "variant")
            print(f"{label} {name}: the same bits as the default's "
                  f"{'out, lse' if name.startswith('K2') else 'dk, dv'}: "
                  f"{same[name]}")
        rows.append(row)
    rows.append(_rows_192(libs["K2 at 192 rows a CTA"], d))
    return rows


def _rows_192(fn, d: int) -> dict:
    """K2 at 192 rows a CTA against this tree's 128, in turns, at
    ROWS_SHAPES."""
    import torch

    from ray_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    out = {}
    for label, b, s, causal in ROWS_SHAPES:
        q, k, v = (torch.randn((b, n, s, d), generator=gen, device="cuda")
                   .bfloat16() for n in (32, 8, 8))

        def variant():
            o = torch.empty_like(q)
            lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), b, 32, 8, s, s, d,
                     d ** -0.5 * att.LOG2E, int(causal),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"K2 at 192 rows failed at {label}: {err}")

        r = _turns(lambda: att.flash_fwd_cuda(q, k, v, causal, d ** -0.5),
                   variant, 10)
        out[label] = r
        _show(f"{label} H32 Hkv8 D{d}", "K2 at 192 rows a CTA", r, "default",
              "variant")
    return {"shape": "K2 rows a CTA", "K2 at 192 rows a CTA": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="directory holding the other build's sources")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("pair_flash: needs a CUDA card", file=sys.stderr)
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
