"""Hot-threads sampling: periodic stack snapshots aggregated per thread.

Reference: ``monitor/jvm/HotThreads.java:41`` — N snapshots at a fixed
interval, threads ranked by CPU time between first and last snapshot,
common stack suffixes grouped ("M/N snapshots sharing following K
elements"). The JVM's per-thread CPU counters have no exact CPython
analog, so busyness here is the fraction of snapshots in which a thread
was runnable outside known-idle frames (waiter/selector/sleep) — the same
ranking signal, sampled rather than counted. The output text follows the
reference's format so ``_nodes/hot_threads`` consumers parse unchanged.

The stack walk and the idle/busy classifier are shared with the
continuous profiler (``common/contprof.py``) — one sampling core, so
the on-demand snapshot and the always-on flamegraph can never disagree
about what "parked" means.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List, Tuple

from ..common.contprof import IDLE_HINTS, classify_idle, sample_stacks

#: frames that mean "parked, not burning cpu" (re-exported from the
#: shared classifier for backward compatibility)
_IDLE_HINTS = IDLE_HINTS


def _is_idle(stack: List[traceback.FrameSummary]) -> bool:
    return classify_idle(stack)


def hot_threads(threads: int = 3, interval_ms: float = 500.0,
                snapshots: int = 10, ignore_idle: bool = True,
                node_name: str = "node", node_id: str = "") -> str:
    """Sample and render the reference's text format."""
    names = {t.ident: t.name for t in threading.enumerate()}
    #: tid -> list of sampled stacks (only busy samples kept)
    samples: Dict[int, List[Tuple[str, ...]]] = {}
    seen: Dict[int, int] = {}
    step = max(interval_ms / 1e3 / max(snapshots, 1), 0.001)
    for _ in range(snapshots):
        for tid, stack in sample_stacks().items():
            seen[tid] = seen.get(tid, 0) + 1
            if ignore_idle and _is_idle(stack):
                continue
            sig = tuple(f"{fs.filename.rsplit('/', 1)[-1]}:{fs.lineno} "
                        f"{fs.name}" for fs in stack[-10:])
            samples.setdefault(tid, []).append(sig)
        time.sleep(step)
    rows = []
    for tid, sigs in samples.items():
        busy_frac = len(sigs) / max(seen.get(tid, snapshots), 1)
        # most common stack for the "sharing following elements" block
        counts: Dict[Tuple[str, ...], int] = {}
        for s in sigs:
            counts[s] = counts.get(s, 0) + 1
        common, n_common = max(counts.items(), key=lambda kv: kv[1])
        rows.append((busy_frac, tid, len(sigs), n_common, common))
    rows.sort(key=lambda r: -r[0])
    ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime())
    out = [f"::: {{{node_name}}}{{{node_id}}}",
           f"   Hot threads at {ts}Z, interval={interval_ms:.0f}ms, "
           f"busiestThreads={threads}, ignoreIdleThreads="
           f"{str(ignore_idle).lower()}:"]
    for busy_frac, tid, n_busy, n_common, common in rows[:threads]:
        ms = busy_frac * interval_ms
        name = names.get(tid, f"thread-{tid}")
        out.append("")
        out.append(f"   {busy_frac * 100:.1f}% ({ms:.1f}ms out of "
                   f"{interval_ms:.0f}ms) cpu usage by thread "
                   f"'{name}'")
        out.append(f"     {n_common}/{n_busy} snapshots sharing "
                   f"following {len(common)} elements")
        for line in common:
            out.append(f"       {line}")
    return "\n".join(out) + "\n"
