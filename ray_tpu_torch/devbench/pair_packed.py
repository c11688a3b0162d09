"""The head-packed forward kernels K8, K9 and K10 of this tree against an
earlier build of them, in turns on one card (other, this, this, other), at
the profiling shape (B4 H32 Hkv8 S2048 D64 causal): each kernel at the
defaults (pack 2, block_q 64, block_k 64), and the variant the earlier
build's sweep found fastest, epi_pack4_bq64_bk64, on both sides; K2 is
timed after each pair in the same call. Then two ablations of this tree's
design, each built from this tree's source with one edit and timed in turns
against the kernel as it stands (default, variant, variant, default) at
the defaults and at epi_pack4_bq64_bk64: a ring of 2 stages at D 64 in
place of 3, and the grid with the q tile fastest (the order the earlier
build used) in place of the pack of heads.

    DIR=ray_tpu_torch/_native/_build/parent; mkdir -p $DIR
    git show <commit>:ray_tpu_torch/csrc/flash_packed_fwd.cu > $DIR/flash_packed_fwd.cu
    git show <commit>:ray_tpu_torch/csrc/hopper.cuh > $DIR/hopper.cuh
    python3 -m ray_tpu_torch.devbench.pair_packed --other DIR

(hopper.cuh only where that commit's source includes it.) DIR's source
keeps the C interface of rtt_packed_fwd{,_epi,_inl}. Both builds get the
same inputs and run through the same launch code (prof_flash_pack's
``_launch``). Prints each pair's worst difference (out over its largest
value, lse) and whether the bits are the same, the times in ms (CUDA
events), the card's name and power limit, and a JSON line last. Exits 2
without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from ray_tpu_torch.devbench.pair_chunk import _events_ms
from ray_tpu_torch.devbench.pair_flash import (_ablation_dirs, _compile,
                                               _show, _turns)

# label, schedule, pack, block_q, block_k
VARIANTS = (("K8 epi_pack2_bq64_bk64", "epi", 2, 64, 64),
            ("K9 inl_pack2_bq64", "inl", 2, 64, 64),
            ("K10 pack2_bq64_bk64", "masked", 2, 64, 64),
            ("K8 epi_pack4_bq64_bk64", "epi", 4, 64, 64))
ITERS = 20  # timed launches a turn
# An ablation: this tree's source with one edit (the text, its
# replacement), built apart from it.
ABLATIONS = {
    "a 2-stage ring at D 64": (
        "flash_packed_fwd", "kStages = D == 64 ? 3 : 2;", "kStages = 2;"),
    "the q tile fastest in the grid": (
        "flash_packed_fwd",
        "const int qx = blockIdx.x / npacks;\n"
        "  const int qi = causal ? nq - 1 - qx : qx;\n"
        "  const int m0 = qi * block_q;\n"
        "  const int bh0 = (blockIdx.x % npacks) * pack;",
        "const int qx = blockIdx.x % nq;\n"
        "  const int qi = causal ? nq - 1 - qx : qx;\n"
        "  const int m0 = qi * block_q;\n"
        "  const int bh0 = (blockIdx.x / nq) * pack;"),
}


def _diff(got, want) -> dict:
    """out's max abs difference over want's largest value, lse's max abs
    difference, and whether both are the same bits."""
    import torch

    (out, lse), (w_out, w_lse) = got, want
    return {"out": ((out.float() - w_out.float()).abs().max()
                    / w_out.float().abs().max()).item(),
            "lse": (lse - w_lse).abs().max().item(),
            "same_bits": torch.equal(out, w_out) and torch.equal(lse, w_lse)}


def pair(src_dir: str) -> list:
    import torch

    from ray_tpu_torch.devbench import prof_flash_pack as pfp
    from ray_tpu_torch.ops import attention as att

    with ThreadPoolExecutor(1) as pool:  # this tree's build meanwhile
        this_build = pool.submit(pfp._library)
        libs = {key: pfp.bind(lib) for key, lib in _compile(
            {"other": (src_dir, "flash_packed_fwd"),
             **_ablation_dirs(ABLATIONS, "ablation_packed")}).items()}
        this_build.result()
    q, k, v = pfp.make_inputs(pfp.B, pfp.H, pfp.KV, pfp.S, pfp.HD,
                              torch.device("cuda"))
    scale = pfp.HD ** -0.5

    def k2():
        return att.flash_fwd_cuda(q, k, v, True, scale)

    rows = []
    for label, kind, pack, bq, bk in VARIANTS:
        def built(key):
            return lambda: pfp._launch(kind, q, k, v, True, scale, pack, bq,
                                       bk, lib=libs[key])

        def this():
            return pfp.KERNELS[kind][0](q, k, v, True, scale, pack, bq, bk)

        got = this()
        row = {"variant": label, "against_other": _diff(got, built("other")()),
               "against_k2": _diff(got, k2()) if bk == 64 else None}
        torch.cuda.synchronize()
        row["turns"] = _turns(built("other"), this, ITERS)
        row["k2_ms"] = _events_ms(k2, ITERS)
        _show(label, "against the other build", row["turns"])
        d = row["against_other"]
        print(f"{label}: this against other: out {d['out']:.3e} of the "
              f"largest value, lse {d['lse']:.3e}, same bits "
              f"{d['same_bits']}; K2 {row['k2_ms']:.4f} ms in the same call"
              + ("" if row["against_k2"] is None else
                 f", the same bits as K2: {row['against_k2']['same_bits']}"))
        row["ablations"] = {}
        for name in ABLATIONS:
            r = _turns(this, built(name), ITERS)
            r.update(_diff(built(name)(), got))
            row["ablations"][name] = r
            _show(label, name, r, "default", "variant")
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="directory holding the other build's source")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("pair_packed: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    rows = pair(args.other)
    print(json.dumps({"card": card, "shape": "B4 H32 Hkv8 S2048 D64 causal",
                      "pairs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
