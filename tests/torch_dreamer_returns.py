"""Dreamer's returns at ``DreamerConfig()`` defaults on CartPole-v1, on
the CPU, the port beside ray_tpu's: a witness for where the port's
learning curve parts from JAX's. Not a test (pytest does not collect it).

Two modes, each over ``--seeds`` for ``--iters`` iterations:

* ``lockstep``: ray_tpu's Dreamer and the port's, the port started from
  JAX's params and fed the draws JAX takes from its key (as
  ``test_dreamer_trainable_follows_jax_step_for_step_given_its_draws``
  does at the tiny geometry). Prints both returns and the port's largest
  param difference from JAX's after every iteration.
* ``own``: the port alone, drawing from its own ``torch.Generator``.

Run from the repo root, one process a seed and mode:

    JAX_PLATFORMS=cpu python tests/torch_dreamer_returns.py lockstep --seeds 0
    JAX_PLATFORMS=cpu python tests/torch_dreamer_returns.py own --seeds 0

The last line of each run is one JSON object of the returns.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ray_tpu_torch._device import tree_map  # noqa: E402
from ray_tpu_torch.rl import DreamerConfig  # noqa: E402
from ray_tpu_torch.rl.ppo import params_from_jax  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _max_diff(ours, theirs) -> float:
    import jax

    diffs = []
    tree_map(lambda a, b: diffs.append(float(np.abs(
        a.detach().numpy() - b).max())), ours,
        jax.tree.map(np.asarray, theirs))
    return max(diffs)


def lockstep(seed: int, iters: int) -> dict:
    import jax
    from ray_tpu.rl.dreamer import DreamerConfig as JConfig

    jalgo = JConfig(seed=seed).build()
    ours = DreamerConfig(seed=seed, device="cpu").build()
    ours.params = params_from_jax(jalgo.params, "cpu")
    ours.opt_state = ours.optimizer.init(ours.params)
    cfg, acts = ours.cfg, ours.num_actions
    B, T, H, L = cfg.batch_seqs, cfg.seq_len, cfg.horizon, cfg.latent
    key = [jax.random.split(jax.random.PRNGKey(seed))[0]]

    def next_key():
        key[0], k = jax.random.split(key[0])
        return k

    def act_noise():
        ka, kz = jax.random.split(next_key())
        return {"eps": _t(jax.random.normal(kz, (cfg.num_envs, L))),
                "gumbel": _t(jax.random.gumbel(ka, (cfg.num_envs, acts)))}

    def update_noise():
        k_seq, k_img, _ = jax.random.split(next_key(), 3)
        eps = np.stack([np.asarray(jax.random.normal(k, (B, L)))
                        for k in jax.random.split(k_seq, T)])
        gum = np.stack([np.asarray(jax.random.gumbel(
            jax.random.split(k)[0], (B * T, acts)))
            for k in jax.random.split(k_img, H)])
        return {"eps": _t(eps), "gumbel": _t(gum)}

    ours._act_noise = act_noise
    ours._update_noise = update_noise
    out = {"jax": [], "port": [], "max_param_diff": [], "same_ring": []}
    for it in range(iters):
        jm, tm = jalgo.step(), ours.step()
        out["jax"].append(jm["episode_return_mean"])
        out["port"].append(tm["episode_return_mean"])
        out["max_param_diff"].append(_max_diff(ours.params, jalgo.params))
        out["same_ring"].append(bool(np.array_equal(ours._act, jalgo._act)))
        print(f"seed {seed} it {it}: jax {out['jax'][-1]:.2f} port "
              f"{out['port'][-1]:.2f} max |dparam| "
              f"{out['max_param_diff'][-1]:.3e} same actions "
              f"{out['same_ring'][-1]}", flush=True)
    return out


def own(seed: int, iters: int) -> dict:
    torch.manual_seed(seed)
    algo = DreamerConfig(seed=seed, device="cpu").build()
    rets = []
    for it in range(iters):
        rets.append(algo.step()["episode_return_mean"])
        print(f"seed {seed} it {it}: port {rets[-1]:.2f}", flush=True)
    return {"port": rets}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("lockstep", "own"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    result = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = (lockstep if args.mode == "lockstep" else own)(seed, args.iters)
        for k in ("jax", "port"):
            if k in r:
                r[f"{k}_max_last6"] = max(r[k][-6:])
        r["seconds"] = time.perf_counter() - t0
        result[str(seed)] = r
    print(json.dumps({"mode": args.mode, "iters": args.iters,
                      "seeds": result}))


if __name__ == "__main__":
    main()
