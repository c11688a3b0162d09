"""Run one function as every rank of a process group on this host.

``run_ranks(target, world, tmp, args)`` starts ``world`` processes with
the spawn method; rank r calls ``target(r, world, store_path, *args)``,
where ``store_path`` is a file under ``tmp`` for
``dist.init_process_group(store=dist.FileStore(store_path, world), ...)``
(no TCP port to pick). All ranks must end within one time limit: a ring
that deadlocks is killed and reported, never waited on; and when a rank
fails, the others are killed at once (they would wait on it in their
next collective until NCCL's own ten-minute timeout).
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import time
import traceback


def _entry(target, rank: int, world: int, tmp: str, args: tuple) -> None:
    try:
        target(rank, world, os.path.join(tmp, "store"), *args)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(target, world: int, tmp: str, args: tuple = (),
              timeout_s: float = 120.0) -> None:
    """Run ``target`` as ranks 0..world-1 (a module-level function: the
    spawned processes import it). Raises RuntimeError naming the ranks
    that did not end within ``timeout_s`` (killed), were killed because
    another rank failed, or exited non-zero, with each failed rank's
    traceback."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, world, tmp, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    running = {p.sentinel: p for p in procs}
    failed_first = False
    while running and not failed_first:
        left = deadline - time.monotonic()
        if left <= 0:
            break
        for s in multiprocessing.connection.wait(list(running), left):
            p = running.pop(s)
            p.join()
            failed_first = failed_first or p.exitcode != 0
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    failed = [r for r, p in enumerate(procs)
              if r not in hung and p.exitcode != 0]
    if hung or failed:
        why = ("were killed when another rank failed" if failed_first
               else f"did not end within {timeout_s} s (a deadlocked "
               "ring?) and were killed")
        msg = [f"ranks {hung} {why}"] if hung else []
        for r in failed:
            err = os.path.join(tmp, f"rank{r}.err")
            msg.append(f"rank {r} exited {procs[r].exitcode}:\n"
                       + (open(err).read() if os.path.exists(err) else ""))
        raise RuntimeError("\n".join(msg))
