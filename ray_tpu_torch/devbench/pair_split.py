"""The split backward's kernels K4 (dq) and K5 (dk/dv) of this tree against
an earlier build of them, in turns on one card (other, this, this, other),
at the training shape (B4 H32 Hkv8 S2048 D64, causal) and at ViT-B/16's
attention (B128 H12 S197 D64, non-causal).

    DIR=ray_tpu_torch/_native/_build/parent; mkdir -p $DIR
    git show <commit>:ray_tpu_torch/csrc/flash_bwd_dq.cu > $DIR/flash_bwd_dq.cu
    git show <commit>:ray_tpu_torch/csrc/flash_bwd_dkv.cu > $DIR/flash_bwd_dkv.cu
    python3 -m ray_tpu_torch.devbench.pair_split --other $DIR

DIR's sources must have the C interface of the kernels before the GQA fold
moved into K5 (commits up to 3270802: K5 writes dk/dv per q head and takes
no fold scratch); their K5 is timed with ``fold_heads`` after it, as the
wrapper ran it then. Both builds get the same inputs, lse and delta. Prints
each build's worst difference from the other (dq, dk, dv, over the largest
value), the times in ms (CUDA events: K4, K5 with the fold, their sum), the
card's name and power limit, and a JSON line last. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

from ray_tpu_torch.devbench.pair_chunk import _events_ms

# label, B, H, Hkv, S, causal, timed launches a turn
SHAPES = (("training B4 H32 Hkv8 S2048 D64 causal", 4, 32, 8, 2048, True, 20),
          ("ViT-B/16 B128 H12 S197 D64 non-causal", 128, 12, 12, 197, False,
           20))
NAMES = ("flash_bwd_dq", "flash_bwd_dkv")


def _other_libs(src_dir: str) -> dict:
    """Build and load DIR's two sources with this tree's nvcc flags."""
    from ray_tpu_torch._native import build

    procs = {n: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
         os.path.join(src_dir, f"lib{n}.so"), os.path.join(src_dir, f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in NAMES}
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {}
    for n, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc build of {src_dir}/{n}.cu failed:\n{out}")
        fn = getattr(ctypes.CDLL(os.path.join(src_dir, f"lib{n}.so")),
                     f"rtt_{n}")
        fn.argtypes = ([p_] * (7 if n == "flash_bwd_dq" else 8) + [i_] * 6
                       + [f_, f_, i_, p_])
        fn.restype = i_
        fns[n] = fn
    return fns


def pair(src_dir: str, d: int = 64) -> list:
    import torch

    from ray_tpu_torch.ops import attention as att

    other = _other_libs(src_dir)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    scale = d ** -0.5
    rows = []
    for label, b, h, hkv, s, causal, iters in SHAPES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").bfloat16()

        q, k, v, do = rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d), \
            rnd(b, h, s, d)
        out, lse = att.flash_fwd_cuda(q, k, v, causal, scale)
        delta = (do.float() * out.float()).sum(-1)
        shape_args = (b, h, hkv, s, s, d, scale, scale * att.LOG2E,
                      int(causal))

        def launch(name, *outs):
            err = other[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                              *outs, *shape_args,
                              torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"other {name} launch failed at {label}: "
                                   f"error {err}")

        def other_dq():
            dq = torch.empty_like(q)
            launch("flash_bwd_dq", dq.data_ptr())
            return dq

        def other_dkv():  # per q head, then the wrapper's fold
            dk_h = torch.empty((b, h, s, d), dtype=q.dtype, device="cuda")
            dv_h = torch.empty_like(dk_h)
            launch("flash_bwd_dkv", dk_h.data_ptr(), dv_h.data_ptr())
            return att.fold_heads(dk_h, hkv), att.fold_heads(dv_h, hkv)

        def this_dq():
            return att.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal,
                                         scale)

        def this_dkv():
            return att.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal,
                                          scale)

        got = {"other": (other_dq(), *other_dkv()),
               "this": (this_dq(), *this_dkv())}
        torch.cuda.synchronize()
        diff = {n: ((x.float() - y.float()).abs().max()
                    / y.float().abs().max()).item()
                for n, x, y in zip(("dq", "dk", "dv"), got["this"],
                                   got["other"])}
        del got
        row = {"shape": label, "diff_over_largest": diff}
        fns = {"K4": (other_dq, this_dq), "K5 with the fold": (other_dkv,
                                                               this_dkv),
               "K4 + K5": (lambda: (other_dq(), other_dkv()),
                           lambda: (this_dq(), this_dkv()))}
        for name, (o_fn, t_fn) in fns.items():
            t = [_events_ms(fn, iters) for fn in (o_fn, t_fn, t_fn, o_fn)]
            row[name] = {"other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                         "speedup": (t[0] + t[3]) / (t[1] + t[2])}
            print(f"{label} {name}: other {t[0]:.4f} this {t[1]:.4f} this "
                  f"{t[2]:.4f} other {t[3]:.4f} ms: "
                  f"{row[name]['speedup']:.2f}x")
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
        print("pair_split: needs a CUDA card", file=sys.stderr)
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
