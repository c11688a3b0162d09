"""Straggler attribution for training: who is slow, and why.

Port of ray_tpu/profiling/straggler.py, a straight copy. In the port the
table is this process's own (``util.state.stragglers`` reads
``train.session.collect_train_stats``); the head that would gather it
from many processes waits for the process workers.

Input: the head's train-stats table — per-worker step-time/sync-time decile
summaries streamed with every telemetry push (train/session.py collects
them from ``session.report()`` call intervals; reference capability: the
Pathways paper's centralized attribution of per-step variance across
islands, PAPERS.md).

Output: workers ranked by median step time against the fleet median, each
attributed as compute-bound vs collective-wait-bound from its reported
compute/sync share, with the lagging HOST named (the telemetry row's
node_id) — the thing an operator actually restarts.

Attribution logic: in a synchronous data-parallel step the LAGGING worker
shows a high compute share and LOW collective-wait share (everyone else
waits for it at the allreduce); a worker showing high sync share is the
victim, not the cause. ``cause`` encodes exactly that reading.
"""

from __future__ import annotations

import time


def _median(xs: list[float]) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


def build_report(sources: dict, threshold: float = 1.15,
                 max_age_s: float = 300.0) -> dict:
    """``sources``: the head table ``{source: {node_id, ts, stats: {rank:
    {...}}}}`` (see HeadServer._report_telemetry). Returns the ranked
    report; ``threshold`` is the median-vs-fleet ratio above which a worker
    is flagged."""
    now = time.time()
    workers: list[dict] = []
    for source, row in (sources or {}).items():
        if now - float(row.get("ts", now)) > max_age_s:
            continue
        for rank, st in (row.get("stats") or {}).items():
            deciles = list(st.get("deciles") or [])
            workers.append({
                "rank": int(rank),
                "source": source,
                "node_id": row.get("node_id", ""),
                "steps": int(st.get("steps", 0)),
                "median_step_s": float(st.get("median_step_s") or
                                       (_median(deciles) if deciles else 0)),
                "p90_step_s": float(deciles[9]) if len(deciles) >= 10
                else 0.0,
                "deciles": deciles,
                "sync_share": st.get("sync_share"),
                "compute_share": st.get("compute_share"),
                "world_size": int(st.get("world_size", 0)),
            })
    if not workers:
        return {"fleet": {"workers": 0, "median_step_s": 0.0},
                "workers": [], "stragglers": [], "lagging_host": None}

    fleet_median = _median([w["median_step_s"] for w in workers]) or 1e-12
    known_sync = [w["sync_share"] for w in workers
                  if w["sync_share"] is not None]
    fleet_sync = (sum(known_sync) / len(known_sync)) if known_sync else None
    for w in workers:
        w["vs_fleet"] = w["median_step_s"] / fleet_median
        if w["vs_fleet"] < threshold:
            w["cause"] = "ok"
        elif w["sync_share"] is None or fleet_sync is None:
            w["cause"] = "slow (no sync/compute split reported)"
        elif w["sync_share"] <= fleet_sync:
            # Slow AND not waiting on collectives: this worker IS the drag.
            w["cause"] = "compute-bound (others wait on it)"
        else:
            w["cause"] = "collective-wait (victim of another straggler)"
    workers.sort(key=lambda w: -w["vs_fleet"])
    stragglers = [w for w in workers if w["vs_fleet"] >= threshold]
    # The lagging host: prefer a compute-bound straggler (the cause) over a
    # collective-wait one (a victim).
    lagging = next((w for w in stragglers
                    if w["cause"].startswith("compute")), None) or \
        (stragglers[0] if stragglers else None)
    return {
        "fleet": {
            "workers": len(workers),
            "median_step_s": fleet_median,
            "mean_sync_share": fleet_sync,
        },
        "threshold": threshold,
        "workers": workers,
        "stragglers": stragglers,
        "lagging_host": lagging["node_id"] if lagging else None,
        "lagging_rank": lagging["rank"] if lagging else None,
    }


def format_report(report: dict) -> str:
    """Human-readable table for the ``stragglers`` CLI verb."""
    fleet = report.get("fleet") or {}
    lines = [
        f"fleet: {fleet.get('workers', 0)} worker(s), median step "
        f"{fleet.get('median_step_s', 0.0) * 1e3:.1f} ms",
    ]
    rows = report.get("workers") or []
    if not rows:
        lines.append("(no train stats reported yet)")
        return "\n".join(lines)
    hdr = (f"{'rank':>4}  {'host':<12} {'median_ms':>9} {'p90_ms':>8} "
           f"{'vs_fleet':>8} {'sync%':>6}  cause")
    lines += [hdr, "-" * len(hdr)]
    for w in rows:
        sync = (f"{w['sync_share'] * 100:.0f}"
                if w.get("sync_share") is not None else "-")
        lines.append(
            f"{w['rank']:>4}  {w['node_id'][:12]:<12} "
            f"{w['median_step_s'] * 1e3:>9.1f} {w['p90_step_s'] * 1e3:>8.1f} "
            f"{w['vs_fleet']:>7.2f}x {sync:>6}  {w['cause']}")
    host = report.get("lagging_host")
    if host:
        lines.append(f"lagging host: {host} (rank {report['lagging_rank']})")
    else:
        lines.append("no straggler above threshold "
                     f"{report.get('threshold')}x")
    return "\n".join(lines)
