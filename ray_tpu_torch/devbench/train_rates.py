"""Loss trajectories of ``chip_smoke.py`` phase 22b's one-card references
at several learning rates, on the card: the Llama-3-8B width at 8 layers,
global b2 s8192 (``adamw_lowmem``), and Mixtral 8x7B width at 2 and 4
layers, b4 s2048 (the step factory's adamw with bf16 moments, and at 2
layers plain SGD too), 4 steps each from the phase's seeded params and
batch. It is how phase 22b's rates were chosen: ones where each model's
loss falls step by step, so that every step of a run over ranks can be
held against one card's.

Run from the repository root on a machine with a CUDA card:
``python3 -m ray_tpu_torch.devbench.train_rates``. It prints the card's
name and power limit, then one line per (model, depth, rate): the
losses, the grad norms, ms a step and the peak memory (an out-of-memory
is printed, not raised).
"""

from __future__ import annotations

import os
import subprocess
import sys

LLAMA_RATES = (1e-4, 5e-5, 2e-5)
MIXTRAL_RATES = {2: (3e-4, 1e-4, 5e-5), 4: (1e-4,)}
MIXTRAL_SGD_RATES = (1e-2, 3e-2, 1e-1, 3e-1)  # at 2 layers


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_rates: no CUDA device visible", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from dataclasses import replace

    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.train import make_mixtral_train_step
    from ray_tpu_torch.train.backend import free_port, init_distributed
    from ray_tpu_torch.train.optim import adamw, sgd

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    cs.phase_build()
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    cfg = replace(cs.cfg_8b(cs.P22B_LAYERS), max_seq_len=cs.P22B_SEQ)
    tokens = np.random.default_rng(cs.SEED + 8).integers(
        0, cfg.vocab_size, (cs.P22B_BATCH, cs.P22B_SEQ), dtype=np.int32)
    params = init_params(cfg, generator=cs.SEED, device="cuda")
    for lr in LLAMA_RATES:
        r = cs.train_run(cfg, None, params, tokens, {}, 1, 3, None, lr=lr)
        print(f"llama {cfg.num_layers} layers lr {lr}: loss {r['losses']} "
              f"norm {r['norms']} {r['step_ms']:.1f} ms peak "
              f"{r['peak_gib']:.2f}", flush=True)
    del params
    torch.cuda.empty_cache()
    for layers, rates in MIXTRAL_RATES.items():
        mcfg = cs.cfg_mixtral(layers)
        mtok = np.random.default_rng(cs.SEED + 7).integers(
            0, mcfg.vocab_size, (cs.P15_BATCH, cs.P15_SEQ), dtype=np.int32)
        mp = mixtral.init_params(mcfg, generator=cs.SEED, device="cuda")
        opts = [("adamw", lr, adamw(lr, weight_decay=0.1,
                                    mu_dtype=torch.bfloat16))
                for lr in rates]
        if layers == 2:
            opts += [("sgd", lr, sgd(lr)) for lr in MIXTRAL_SGD_RATES]
        for name, lr, opt in opts:
            try:
                step, init, shard = make_mixtral_train_step(
                    mcfg, None, optimizer=opt, attn_impl="flash",
                    remat=True, seed=cs.SEED,
                    device=torch.device("cuda", 0))
                r = cs.timed_steps(step, init, mp, shard(mtok),
                                   shard(np.roll(mtok, -1, axis=1)), 1, 3,
                                   None, quiet=True)
                print(f"mixtral {layers} layers {name} lr {lr}: loss "
                      f"{r['losses']} norm {r['norms']} "
                      f"{r['step_ms']:.1f} ms peak {r['peak_gib']:.2f}",
                      flush=True)
            except torch.OutOfMemoryError as e:
                print(f"mixtral {layers} layers {name} lr {lr}: out of "
                      f"memory: {str(e)[:240]}", flush=True)
            step = init = shard = None
            torch.cuda.empty_cache()
        del mp
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
