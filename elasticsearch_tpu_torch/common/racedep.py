"""Runtime race witness: happens-before + lockset, checked.

The static analyzer (``devtools/rules_races``, ESTP-R01/R02) proves
lockset coverage at the AST; this module is the runtime half of the
cross-check, an Eraser × FastTrack hybrid scaled to the package's needs:

- **vector clocks** per thread, advanced on every witnessed lock
  release and joined on acquire (a release→acquire pair on one lock is
  a happens-before edge), plus fork edges — a package-created
  ``threading.Thread`` child starts with its parent's clock, and
  ``join()`` merges the child's final clock back into the joiner;
- **locksets** per tracked key: the set of witnessed locks held at the
  access, intersected Eraser-style across that key's access history.

A CANDIDATE RACE is reported when two accesses to one key, at least one
a write, are (a) unordered by happens-before AND (b) share no lock.
Requiring both kills the two classic false-positive families: the
lockset alone flags publication patterns (init → fork, result → done
flip under a condition), and happens-before alone misses races the
schedule happened not to exercise — a lock-free access pair that
*today* ran in a benign order still has an empty lockset and only
escapes when an HB edge genuinely orders it.

Tracking is OPT-IN per access site: package code calls
:func:`note_read`/:func:`note_write` (no-ops unless the witness is
installed — one module-global load and a truth test on the serving
path) on the shared state the static family audits: the serving-plane
generation registry, the micro-batcher stats, the monitoring tick.
``key`` should be ``(logical_name, id(owner))`` — :func:`note_read`
builds that from its ``owner=`` argument — so two instances never
cross-contaminate locksets.

Semantics:

- ``ES_TPU_RACEDEP=record`` collects candidates
  (``report()["candidates"]``, both access stacks included);
  ``ES_TPU_RACEDEP=raise`` (or ``1``/``true``) raises
  :class:`CandidateDataRace` at the second access. ``install()`` is
  called by ``tests/conftest.py`` BEFORE package modules create their
  locks (it force-installs the lockdep witness to see lock events and
  wraps ``threading.Thread`` for package-frame creators to see fork/
  join edges).
- Evidence exports as the ``es_racedep_*`` telemetry families
  (TELEMETRY.md): tracked keys, witnessed accesses, threads carrying a
  vector clock, and candidate races (must stay 0).

Known limits (documented, conservative in the false-NEGATIVE direction
— the witness never invents a race): executor worker threads are
created by stdlib frames and carry no fork edge (their first witnessed
lock acquire seeds their clock); only witnessed (package-created) locks
contribute lockset/HB evidence; only instrumented sites are checked.
"""

from __future__ import annotations

import os
import threading
import traceback
import weakref
from typing import Dict, List, Optional, Tuple

from . import lockdep

# The Thread wrappers below call ``lockdep._package_caller()`` from
# THIS file's frames: without skipping them, every ``Thread.start`` in
# the process would look package-made and earn a fork edge — and a
# spurious fork edge ORDERS accesses, silently masking real races.
if os.path.abspath(__file__) not in lockdep._SKIP_FILES:
    lockdep._SKIP_FILES = lockdep._SKIP_FILES + (
        os.path.abspath(__file__),)

__all__ = ["CandidateDataRace", "RaceWitness", "WITNESS", "install",
           "uninstall", "installed", "note_read", "note_write", "report",
           "reset"]

#: bounded candidate evidence ring
_MAX_CANDIDATES = 64

#: frames kept per access stack (evidence, not a profiler)
_STACK_DEPTH = 6


class CandidateDataRace(RuntimeError):
    """Two unordered, lock-disjoint accesses (≥1 write) to one key."""


def _clock_leq(a: Dict[int, int], b: Dict[int, int]) -> bool:
    """a ≤ b pointwise — every event a has seen, b has seen."""
    for tid, c in a.items():
        if c > b.get(tid, 0):
            return False
    return True


class _Access:
    __slots__ = ("tid", "tname", "write", "clock", "lockset", "stack")

    def __init__(self, tid: int, tname: str, write: bool,
                 clock: Dict[int, int], lockset: frozenset, stack: str):
        self.tid = tid
        self.tname = tname
        self.write = write
        self.clock = clock
        self.lockset = lockset
        self.stack = stack


class _KeyState:
    __slots__ = ("last_by_tid", "reported")

    def __init__(self):
        #: last access per thread (the FastTrack-style bounded history:
        #: an access ordered after a thread's LAST access is ordered
        #: after all its earlier ones)
        self.last_by_tid: Dict[int, _Access] = {}
        self.reported = False


class RaceWitness:
    """Process-wide happens-before + lockset race witness."""

    def __init__(self, raise_on_race: Optional[bool] = None):
        if raise_on_race is None:
            raise_on_race = os.environ.get(
                "ES_TPU_RACEDEP", "").lower() not in ("record",)
        self.raise_on_race = raise_on_race
        # the witness's own mutex must be the REAL primitive: it is
        # taken from inside every hooked acquire — a witnessed lock here
        # would both recurse and pollute every tracked lockset
        self._mutex = lockdep._REAL_RLOCK()
        self._tls = threading.local()
        #: lock name -> clock snapshot at its last release
        self._lock_clocks: Dict[str, Dict[int, int]] = {}
        self._keys: Dict[object, _KeyState] = {}
        self.candidates: List[dict] = []
        self.candidate_count = 0
        self.accesses = 0
        self.threads_witnessed = 0
        self.fork_edges = 0

    # -- per-thread state ----------------------------------------------------

    def _state(self):
        st = getattr(self._tls, "st", None)
        if st is None:
            tid = threading.get_ident()
            seed = _FORK_SEEDS.pop(threading.current_thread(), None)
            clock = dict(seed) if seed else {}
            clock[tid] = clock.get(tid, 0) + 1
            st = self._tls.st = {"clock": clock, "held": []}
            with self._mutex:
                self.threads_witnessed += 1
                if seed:
                    self.fork_edges += 1
        return st

    # -- lock hooks (driven by the lockdep witness) --------------------------

    def on_acquire(self, name: str) -> None:
        st = self._state()
        st["held"].append(name)
        with self._mutex:
            rel = self._lock_clocks.get(name)
        if rel:
            clock = st["clock"]
            for tid, c in rel.items():
                if c > clock.get(tid, 0):
                    clock[tid] = c

    def on_release(self, name: str) -> None:
        st = self._state()
        held = st["held"]
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break
        tid = threading.get_ident()
        clock = st["clock"]
        clock[tid] = clock.get(tid, 0) + 1
        with self._mutex:
            self._lock_clocks[name] = dict(clock)

    # -- fork/join edges -----------------------------------------------------

    def on_fork(self, parent_clock: Dict[int, int],
                child: threading.Thread) -> None:
        _FORK_SEEDS[child] = dict(parent_clock)

    def on_join(self, child_final: Dict[int, int]) -> None:
        st = self._state()
        clock = st["clock"]
        for tid, c in child_final.items():
            if c > clock.get(tid, 0):
                clock[tid] = c

    def thread_clock(self) -> Dict[int, int]:
        return dict(self._state()["clock"])

    # -- tracked accesses ----------------------------------------------------

    def access(self, key: object, write: bool) -> None:
        st = self._state()
        tid = threading.get_ident()
        cur = _Access(tid, threading.current_thread().name, write,
                      dict(st["clock"]), frozenset(st["held"]),
                      "".join(traceback.format_stack(limit=_STACK_DEPTH)
                              [:-1]))
        race_doc = None
        with self._mutex:
            self.accesses += 1
            ks = self._keys.get(key)
            if ks is None:
                ks = self._keys[key] = _KeyState()
            for prev in ks.last_by_tid.values():
                if prev.tid == tid:
                    continue
                if not (prev.write or cur.write):
                    continue
                if prev.lockset & cur.lockset:
                    continue          # a common lock serializes them
                if _clock_leq(prev.clock, cur.clock):
                    continue          # ordered by happens-before
                if ks.reported:
                    break
                ks.reported = True
                self.candidate_count += 1
                race_doc = {
                    "key": repr(key),
                    "kind": ("write/write" if prev.write and cur.write
                             else "read/write"),
                    "first": {"thread": prev.tname,
                              "write": prev.write,
                              "lockset": sorted(prev.lockset),
                              "stack": prev.stack},
                    "second": {"thread": cur.tname,
                               "write": cur.write,
                               "lockset": sorted(cur.lockset),
                               "stack": cur.stack},
                }
                if len(self.candidates) < _MAX_CANDIDATES:
                    self.candidates.append(race_doc)
                break
            ks.last_by_tid[tid] = cur
        if race_doc is not None and self.raise_on_race:
            raise CandidateDataRace(
                f"candidate data race on {race_doc['key']} "
                f"({race_doc['kind']}): {race_doc['first']['thread']} "
                f"(lockset {race_doc['first']['lockset']}) vs "
                f"{race_doc['second']['thread']} (lockset "
                f"{race_doc['second']['lockset']}) — unordered by "
                f"happens-before and no common lock\n"
                f"first stack:\n{race_doc['first']['stack']}"
                f"second stack:\n{race_doc['second']['stack']}")

    # -- evidence ------------------------------------------------------------

    def report(self) -> dict:
        with self._mutex:
            return {
                "tracked_keys": len(self._keys),
                "accesses": self.accesses,
                "threads_witnessed": self.threads_witnessed,
                "fork_edges": self.fork_edges,
                "candidates": list(self.candidates),
                "candidate_count": self.candidate_count,
            }

    def reset(self) -> None:
        """Drop candidates + key history (tests); clocks/locks survive."""
        with self._mutex:
            self._keys.clear()
            self.candidates.clear()
            self.candidate_count = 0

    def telemetry_doc(self) -> dict:
        return {
            "es_racedep_tracked_keys": {
                "type": "gauge",
                "help": "shared-state keys under the race witness",
                "samples": [({}, len(self._keys))]},
            "es_racedep_accesses_total": {
                "type": "counter",
                "help": "witnessed tracked-state accesses",
                "samples": [({}, self.accesses)]},
            "es_racedep_threads_witnessed": {
                "type": "gauge",
                "help": "threads carrying a racedep vector clock",
                "samples": [({}, self.threads_witnessed)]},
            "es_racedep_candidate_races_total": {
                "type": "counter",
                "help": "unordered lock-disjoint access pairs with a "
                        "write (must stay 0)",
                "samples": [({}, self.candidate_count)]},
        }


#: process-wide witness
WITNESS = RaceWitness()

#: child Thread -> parent clock snapshot at start() (fork edges).
#: Weak-keyed: a forked thread that never touches a witnessed lock or
#: tracked key never pops its seed — the entry must die with the Thread
#: object, not pin it.
_FORK_SEEDS: "weakref.WeakKeyDictionary[threading.Thread, Dict[int, int]]" \
    = weakref.WeakKeyDictionary()

_INSTALLED = False
_REAL_START = threading.Thread.start
_REAL_RUN = threading.Thread.run
_REAL_JOIN = threading.Thread.join

#: threads forked by package frames (fork-edge tracked); value True
#: until the thread exits, then its final clock. Weak-keyed so an
#: unjoined daemon thread (plane warmup) doesn't pin its Thread object
#: and clock forever — once nobody holds the Thread, nobody can join
#: it, so dropping the entry loses no edge.
_FORK_TRACKED: "weakref.WeakKeyDictionary[threading.Thread, object]" \
    = weakref.WeakKeyDictionary()


def _start(self) -> None:
    """``Thread.start`` wrapper: a package-frame start is a fork edge —
    the child begins with the parent's clock (stdlib/third-party starts
    are untouched: real behavior, no edge)."""
    if lockdep._package_caller():
        WITNESS.on_fork(WITNESS.thread_clock(), self)
        _FORK_TRACKED[self] = True
    _REAL_START(self)


def _run(self) -> None:
    try:
        _REAL_RUN(self)
    finally:
        if _FORK_TRACKED.get(self) is True:
            _FORK_TRACKED[self] = WITNESS.thread_clock()


def _join(self, timeout: Optional[float] = None) -> None:
    _REAL_JOIN(self, timeout)
    if not self.is_alive():
        final = _FORK_TRACKED.pop(self, None)
        if isinstance(final, dict):
            WITNESS.on_join(final)


def enabled_by_env() -> bool:
    return os.environ.get("ES_TPU_RACEDEP", "").lower() in (
        "1", "true", "record", "raise")


def install(force: bool = False) -> bool:
    """Activate the race witness: force-install the lockdep witness (it
    feeds lock acquire/release events through its hook list) and wrap
    ``threading.Thread.start/run/join`` so package-frame forks and joins
    carry happens-before edges (subclasses overriding ``run`` lose the
    exit-clock capture — their join still merges nothing, which is
    conservative). Call EARLY — ``tests/conftest.py`` does, before
    package module-level locks exist."""
    global _INSTALLED
    if not force and not enabled_by_env():
        return False
    if _INSTALLED:
        return True
    lockdep.install(force=True)
    if (WITNESS.on_acquire, WITNESS.on_release) not in lockdep.RACE_HOOKS:
        lockdep.RACE_HOOKS.append((WITNESS.on_acquire, WITNESS.on_release))
    threading.Thread.start = _start
    threading.Thread.run = _run
    threading.Thread.join = _join
    _INSTALLED = True
    _ensure_collector()
    return True


def uninstall() -> None:
    global _INSTALLED
    try:
        lockdep.RACE_HOOKS.remove((WITNESS.on_acquire, WITNESS.on_release))
    except ValueError:
        pass
    threading.Thread.start = _REAL_START
    threading.Thread.run = _REAL_RUN
    threading.Thread.join = _REAL_JOIN
    _FORK_TRACKED.clear()
    _INSTALLED = False


def installed() -> bool:
    return _INSTALLED


# -- the opt-in instrumentation surface -------------------------------------


def note_read(name: str, owner: object = None) -> None:
    """Record a read of the shared state ``name`` (scoped per ``owner``
    instance). No-op unless the witness is installed."""
    if _INSTALLED:
        WITNESS.access((name, id(owner)) if owner is not None else name,
                       write=False)


def note_write(name: str, owner: object = None) -> None:
    """Record a write — see :func:`note_read`."""
    if _INSTALLED:
        WITNESS.access((name, id(owner)) if owner is not None else name,
                       write=True)


def report() -> dict:
    return WITNESS.report()


def reset() -> None:
    WITNESS.reset()


_COLLECTOR_REGISTERED = False


def _ensure_collector() -> None:
    """Register the es_racedep_* collector once (lazy + fault-tolerant,
    same contract as lockdep's)."""
    global _COLLECTOR_REGISTERED
    if _COLLECTOR_REGISTERED:
        return
    try:
        from . import telemetry
        reg = getattr(telemetry, "DEFAULT", None)
        if reg is None:
            return
        reg.register_collector("racedep",
                               lambda: WITNESS.telemetry_doc())
        _COLLECTOR_REGISTERED = True
    except Exception:   # noqa: BLE001 — witnessing must never break
        pass


def ensure_collector() -> None:
    """Public hook for the telemetry-lint workload: register the
    evidence families without installing the witness."""
    _ensure_collector()
