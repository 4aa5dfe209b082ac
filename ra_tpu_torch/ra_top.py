"""ra_top: curses-free periodic terminal view over api.cluster_health().

A `top`-style health view for the cluster health plane
(docs/INTERNALS.md §14): per-node anomaly counts plus the top-K worst
groups along each dimension (commit→apply gap, follower match gap,
admission backlog, term churn, commit rate), refreshed on an interval
by plainly reprinting — no curses, so it works in CI logs, `watch`,
and dumb terminals alike.

Sources (the feed is in-process state, so the tool either joins the
process or reads an exported snapshot):

- ``--from-json health.json``  — render a ``cluster_health()`` dict
  that another process exported (re-read every interval, so a workload
  that periodically rewrites the file gets a live view);
- ``--demo``                   — spin up a small in-process 3-node
  batch cluster with background traffic and watch it live (the
  zero-setup way to see the surface).

Usage:
    python -m ra_tpu_torch.ra_top --demo [--device DEV]
    python -m ra_tpu_torch.ra_top --from-json health.json -n 2 --top 5

``--device`` places the demo cluster's coordinators (default ``cuda``,
which fails without a card; ``cpu`` runs the plain torch-op step).
"""
import argparse
import json
import sys
import time

# the worst-group dimensions rendered, as (title, row key, reverse)
DIMENSIONS = (
    ("commit→apply gap", "commit_gap", True),
    ("follower match gap", "match_gap", True),
    ("admission backlog", "backlog", True),
    ("term churn", "churn", True),
    ("commit rate (slowest)", "commit_rate", False),
)

_STATE_ORDER = ("stuck", "flapping", "lagging", "quiet")


def _reads_total(s: dict) -> int:
    r = s.get("reads", {})
    return (r.get("read_lease_served", 0) + r.get("read_quorum_fallback", 0)
            + r.get("read_local_bounded", 0))


def render(health: dict, top_k: int = 5, prev: dict = None,
           dt: float = None) -> str:
    """Render one cluster_health() snapshot as a plain-text panel.

    ``prev``/``dt`` (the previous snapshot and the seconds between
    them) turn the cumulative per-node read totals — lease-served +
    quorum-fallback consistent reads + bounded local reads,
    docs/INTERNALS.md §20 — into a reads/s column.
    """
    lines = []
    nodes = health.get("nodes", {})
    lines.append(f"== ra_top · {len(nodes)} nodes · "
                 f"{sum(n.get('groups', 0) for n in nodes.values())} groups ==")
    prev_nodes = (prev or {}).get("nodes", {})
    for name, s in sorted(nodes.items()):
        st = s.get("states", {})
        badges = " ".join(
            f"{k}={st.get(k, 0)}" for k in _STATE_ORDER if st.get(k)
        ) or "all quiet"
        reads = _reads_total(s)
        if name in prev_nodes and dt:
            rate = max(0, reads - _reads_total(prev_nodes[name])) / dt
            reads_col = f"reads/s={rate:<8.1f}"
        else:
            reads_col = f"reads={reads:<8d}"
        lease_pct = ""
        served = s.get("reads", {}).get("read_lease_served", 0)
        fallback = s.get("reads", {}).get("read_quorum_fallback", 0)
        if served + fallback:
            lease_pct = f"lease%={100.0 * served / (served + fallback):.0f} "
        lines.append(
            f"  {name:<14s} [{s.get('backend', '?'):<15s}] "
            f"groups={s.get('groups', 0):<5d} scans={s.get('scans', 0):<6d} "
            f"{reads_col} {lease_pct}{badges}"
        )
    rows = [
        r
        for cl in health.get("clusters", {}).values()
        for r in cl.get("groups", {}).values()
    ]
    anomalies = health.get("anomalies", [])
    if anomalies:
        lines.append(f"-- anomalies ({len(anomalies)}) --")
        for r in anomalies[:top_k]:
            lines.append(
                f"  {r['state']:<8s} {r['group']}@{r['node']} "
                f"({r['cluster']}) role={r['role']} term={r['term']} "
                f"commit_gap={r['commit_gap']} backlog={r['backlog']} "
                f"match_gap={r['match_gap']} churn={r['churn']}"
            )
    if rows:
        for title, key, rev in DIMENSIONS:
            ranked = sorted(rows, key=lambda r: r.get(key, 0), reverse=rev)
            worst = [r for r in ranked[:top_k] if rev and r.get(key, 0)]
            if not rev:
                # slowest commit rate only means something for groups
                # that are actually leading traffic
                worst = [
                    r for r in ranked if r["role"] == "leader"
                ][:top_k]
            if not worst:
                continue
            lines.append(f"-- top {len(worst)} by {title} --")
            for r in worst:
                lines.append(
                    f"  {r.get(key, 0):>10} {r['group']}@{r['node']} "
                    f"({r['cluster']}) {r['state']}/{r['role']} "
                    f"rate={r['commit_rate']}/s "
                    f"leader_age={r['leader_age_s']}s"
                )
    return "\n".join(lines)


def _demo_cluster(device=None):
    """3 in-process batch coordinators, 8 groups, background traffic."""
    import threading

    from ra_tpu_torch import api
    from ra_tpu_torch.machine import SimpleMachine
    from ra_tpu_torch.ops import consensus as C
    from ra_tpu_torch.protocol import ElectionTimeout
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    coords = [
        BatchCoordinator(f"top{i}", capacity=8, num_peers=3,
                         tick_interval_s=0.5, device=device)
        for i in range(3)
    ]
    for c in coords:
        c.start()
    groups = [f"tg{g}" for g in range(8)]
    for g in groups:
        members = [(g, f"top{i}") for i in range(3)]
        for c in coords:
            c.add_group(g, f"topcl{g}", members,
                        SimpleMachine(lambda cm, s: s + cm, 0))
        coords[0].deliver((g, "top0"), ElectionTimeout(), None)
    deadline = time.time() + 30
    while time.time() < deadline and not all(
        coords[0].by_name[g].role == C.R_LEADER for g in groups
    ):
        time.sleep(0.05)

    stop = threading.Event()

    def traffic():
        k = 0
        while not stop.is_set():
            k += 1
            try:
                api.process_command((groups[k % len(groups)], "top0"), 1,
                                    timeout=5.0)
            except Exception:  # noqa: BLE001
                pass
            time.sleep(0.02)

    t = threading.Thread(target=traffic, daemon=True)
    t.start()

    def teardown():
        stop.set()
        for c in coords:
            c.stop()

    return teardown


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--from-json", metavar="PATH",
                     help="render an exported cluster_health() JSON "
                          "snapshot (re-read every interval)")
    src.add_argument("--demo", action="store_true",
                     help="spin up a small in-process cluster and "
                          "watch it live")
    ap.add_argument("--device", default=None,
                    help="torch device of the --demo cluster (default: "
                         "cuda)")
    ap.add_argument("--top", type=int, default=5, help="rows per dimension")
    ap.add_argument("-i", "--interval", type=float, default=2.0)
    ap.add_argument("-n", "--iterations", type=int, default=0,
                    help="stop after N refreshes (0 = forever)")
    args = ap.parse_args()

    teardown = None
    if args.demo:
        teardown = _demo_cluster(args.device)
    try:
        i = 0
        prev, prev_t = None, None
        while True:
            i += 1
            if args.from_json:
                with open(args.from_json) as f:
                    health = json.load(f)
            else:
                from ra_tpu_torch import api

                health = api.cluster_health()
            now = time.monotonic()
            dt = (now - prev_t) if prev_t is not None else None
            print(f"\n{time.strftime('%H:%M:%S')}  (refresh {i})")
            print(render(health, top_k=args.top, prev=prev, dt=dt))
            prev, prev_t = health, now
            sys.stdout.flush()
            if args.iterations and i >= args.iterations:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        if teardown is not None:
            teardown()


if __name__ == "__main__":
    sys.exit(main())
