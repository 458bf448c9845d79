"""Runtime lockdep witness: observed lock-acquisition order, checked.

The static analyzer (``devtools/rules_locks``, ESTP-L01) proves the
*syntactic* lock graph cycle-free; this module is the runtime half of
the cross-check (modeled on the kernel's lockdep): under
``ES_TPU_LOCKDEP=1`` every ``threading.Lock()`` / ``threading.RLock()``
created by package code is wrapped in a witness that records which lock
classes are held when others are taken. The first acquisition that
would close a cycle in the OBSERVED order graph raises
:class:`LockOrderInversion` naming both witnessed directions — a
deadlock caught deterministically at test time instead of
probabilistically in production. The static graph and the runtime
evidence validate each other: an edge the analyzer missed (a lock
reached through a callback it could not resolve) still shows up here,
and a static cycle that can never execute never fires here.

Lock identity is the *creation site* (file:line of the package frame
that called the factory), the same per-declaration granularity the
static rules use, so the two graphs line up row for row. Two instances
of the same class share a node; same-node nesting (a parent→child
hierarchy of one class) is deliberately NOT an inversion — neither
analyzer can order instances, and raising there would ban legitimate
hierarchies (documented in STATIC_ANALYSIS.md).

Semantics:

- ``install()`` patches ``threading.Lock``/``threading.RLock`` with
  factories that witness locks whose creation site is inside the
  package and leave every other caller (stdlib, third-party) on the
  real primitives. No-op unless ``ES_TPU_LOCKDEP`` ∈ {1, true} or
  ``force=True``; ``uninstall()`` restores the real factories.
- ``ES_TPU_LOCKDEP_MODE=record`` downgrades inversions from raise to
  recorded-only (``report()["inversions"]``) for exploratory runs.
- The witness stamps its evidence into the telemetry registry
  (``es_lockdep_*`` families, catalogued in TELEMETRY.md): locks
  witnessed, acquisitions, max held-lock depth, longest hold, and
  inversions observed — so a CI run's lockdep posture is scrapable
  like any other health signal.

``threading.Condition`` needs no wrapping: it drives the wrapped lock
through ``acquire``/``release`` (and the ``_release_save`` /
``_acquire_restore`` / ``_is_owned`` protocol, which the RLock witness
forwards), so ``cond.wait()`` correctly drops and re-takes the witness
bookkeeping along with the lock.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["LockOrderInversion", "Witness", "WitnessLock", "WitnessRLock",
           "WITNESS", "install", "uninstall", "installed", "witness_lock",
           "report"]

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

#: bounded inversion evidence ring
_MAX_INVERSIONS = 64

#: (on_acquire(name), on_release(name)) observer pairs — the racedep
#: happens-before witness (``common/racedep.py``) registers here so one
#: set of wrapped factories feeds both witnesses. Hooks fire on EVERY
#: acquire/release call (including reentrant ones) so observers see a
#: balanced event stream; they must never raise.
RACE_HOOKS: List[Tuple] = []


class LockOrderInversion(RuntimeError):
    """Observed acquisition closes a cycle in the lock-order graph."""


class _Hold:
    __slots__ = ("lock_id", "name", "t0", "count")

    def __init__(self, lock_id: int, name: str, t0: float):
        self.lock_id = lock_id
        self.name = name
        self.t0 = t0
        self.count = 1


class Witness:
    """Process-wide observed lock-order graph + evidence stats."""

    def __init__(self, raise_on_inversion: Optional[bool] = None):
        if raise_on_inversion is None:
            raise_on_inversion = os.environ.get(
                "ES_TPU_LOCKDEP_MODE", "raise").lower() != "record"
        self.raise_on_inversion = raise_on_inversion
        # the witness's own mutex must be the REAL primitive — it is
        # consulted from inside every wrapped acquire
        self._mutex = _thread.allocate_lock()
        self._tls = threading.local()
        #: (held_name, acquired_name) -> (file, line-ish site info)
        self.edges: Dict[Tuple[str, str], str] = {}
        self._adj: Dict[str, Set[str]] = {}
        #: distinct inverting (acquired, held) pairs → evidence doc
        #: (bounded); re-occurrences bump counts, never duplicate docs
        self.inversions: List[dict] = []
        self._inversion_pairs: Set[Tuple[str, str]] = set()
        #: monotonic total across ALL detections (the telemetry counter
        #: — keeps counting past the evidence ring's cap)
        self.inversion_count = 0
        # evidence stats (GIL-atomic best-effort updates; they feed
        # gauges, not invariants)
        self.locks_witnessed = 0
        self.acquisitions = 0
        self.max_held_depth = 0
        self.longest_hold_ms = 0.0

    # -- per-thread hold stack ----------------------------------------------

    def _stack(self) -> List[_Hold]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def on_acquire(self, lock: "_WitnessBase") -> None:
        for acq, _rel in RACE_HOOKS:
            try:
                acq(lock.name)
            except Exception:   # noqa: BLE001 — observers are evidence,
                pass            # never control flow
        st = self._stack()
        lid = id(lock)
        for h in st:
            if h.lock_id == lid:
                h.count += 1          # reentrant re-acquire: no edges
                return
        held_names = []
        for h in st:
            if h.name != lock.name and h.name not in held_names:
                held_names.append(h.name)
        for h in held_names:
            self._edge(h, lock.name)
        st.append(_Hold(lid, lock.name, time.perf_counter()))
        self.acquisitions += 1
        if len(st) > self.max_held_depth:
            self.max_held_depth = len(st)

    def on_release(self, lock: "_WitnessBase") -> None:
        for _acq, rel in RACE_HOOKS:
            try:
                rel(lock.name)
            except Exception:   # noqa: BLE001
                pass
        st = self._stack()
        lid = id(lock)
        for i in range(len(st) - 1, -1, -1):
            if st[i].lock_id == lid:
                st[i].count -= 1
                if st[i].count <= 0:
                    hold_ms = (time.perf_counter() - st[i].t0) * 1e3
                    if hold_ms > self.longest_hold_ms:
                        self.longest_hold_ms = hold_ms
                    del st[i]
                return
        # release of a lock acquired before witnessing began: ignore

    # -- order graph ---------------------------------------------------------

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """A path src → … → dst in the current edge set (caller holds
        the witness mutex)."""
        todo = [(src, [src])]
        seen = {src}
        while todo:
            cur, path = todo.pop()
            for nxt in self._adj.get(cur, ()):
                if nxt == dst:
                    return path + [dst]
                if nxt not in seen:
                    seen.add(nxt)
                    todo.append((nxt, path + [nxt]))
        return None

    def _edge(self, held: str, acquired: str) -> None:
        key = (held, acquired)
        if key in self.edges:       # lock-free fast path (dict read)
            return
        site = _caller_site()
        with self._mutex:
            if key in self.edges:
                return
            back = self._path(acquired, held)
            if back is not None:
                self.inversion_count += 1
                doc = {
                    "acquiring": acquired, "while_holding": held,
                    "established_order": " -> ".join(back),
                    "site": site,
                    "reverse_sites": [
                        self.edges.get((back[i], back[i + 1]))
                        for i in range(len(back) - 1)],
                    "thread": threading.current_thread().name,
                    "count": 1,
                }
                pair = (acquired, held)
                if pair in self._inversion_pairs:
                    # recurring pair: bump its doc, don't fill the ring
                    for d in self.inversions:
                        if (d["acquiring"], d["while_holding"]) == pair:
                            d["count"] += 1
                            break
                elif len(self.inversions) < _MAX_INVERSIONS:
                    self._inversion_pairs.add(pair)
                    self.inversions.append(doc)
                if self.raise_on_inversion:
                    raise LockOrderInversion(
                        f"lock-order inversion: acquiring [{acquired}] "
                        f"while holding [{held}] at {site}, but the "
                        f"opposite order {' -> '.join(back)} was "
                        f"already witnessed at "
                        f"{doc['reverse_sites']}")
                return
            self.edges[key] = site
            self._adj.setdefault(held, set()).add(acquired)

    # -- evidence ------------------------------------------------------------

    def report(self) -> dict:
        with self._mutex:
            edges = {f"{a} => {b}": s for (a, b), s in self.edges.items()}
            inversions = list(self.inversions)
        return {
            "locks_witnessed": self.locks_witnessed,
            "acquisitions": self.acquisitions,
            "max_held_depth": self.max_held_depth,
            "longest_hold_ms": round(self.longest_hold_ms, 3),
            "edges": edges,
            "inversions": inversions,
            "inversion_count": self.inversion_count,
        }

    def telemetry_doc(self) -> dict:
        return {
            "es_lockdep_locks_witnessed": {
                "type": "gauge",
                "help": "locks created under the lockdep witness",
                "samples": [({}, self.locks_witnessed)]},
            "es_lockdep_acquisitions_total": {
                "type": "counter",
                "help": "witnessed lock acquisitions",
                "samples": [({}, self.acquisitions)]},
            "es_lockdep_max_held_depth": {
                "type": "gauge",
                "help": "max locks held simultaneously by one thread",
                "samples": [({}, self.max_held_depth)]},
            "es_lockdep_longest_hold_millis": {
                "type": "gauge",
                "help": "longest single witnessed lock hold",
                "samples": [({}, round(self.longest_hold_ms, 3))]},
            "es_lockdep_inversions_total": {
                "type": "counter",
                "help": "observed lock-order inversions (must stay 0)",
                "samples": [({}, self.inversion_count)]},
        }


#: process-wide witness (the installed factories and the telemetry
#: collector both read it)
WITNESS = Witness()


class _WitnessBase:
    """Shared acquire/release bookkeeping over an underlying primitive."""

    def __init__(self, witness: Witness, name: str, underlying):
        self._w = witness
        self.name = name
        self._lk = underlying
        witness.locks_witnessed += 1

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            try:
                self._w.on_acquire(self)
            except BaseException:
                # never leave the underlying lock held behind a raise
                # (the with-statement would skip __exit__)
                self._lk.release()
                raise
        return ok

    def release(self) -> None:
        self._w.on_release(self)
        self._lk.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name} of {self._lk!r}>"


class WitnessLock(_WitnessBase):
    def __init__(self, witness: Optional[Witness] = None,
                 name: Optional[str] = None):
        super().__init__(witness or WITNESS, name or _caller_site(),
                         _REAL_LOCK())


class WitnessRLock(_WitnessBase):
    def __init__(self, witness: Optional[Witness] = None,
                 name: Optional[str] = None):
        super().__init__(witness or WITNESS, name or _caller_site(),
                         _REAL_RLOCK())

    # threading.Condition's saved-state protocol (cond.wait on an RLock)
    def _release_save(self):
        self._w.on_release(self)
        return self._lk._release_save()

    def _acquire_restore(self, state) -> None:
        self._lk._acquire_restore(state)
        self._w.on_acquire(self)

    def _is_owned(self) -> bool:
        return self._lk._is_owned()

    def locked(self) -> bool:
        locked = getattr(self._lk, "locked", None)
        return locked() if locked is not None else False


# ---------------------------------------------------------------------------
# Factory installation
# ---------------------------------------------------------------------------

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP_FILES = (os.path.abspath(threading.__file__),
               os.path.abspath(__file__))
_INSTALLED = False


def _caller_site() -> str:
    """file:line of the nearest frame outside threading/lockdep — the
    creation (or acquisition) site that names a lock class."""
    f = sys._getframe(1)
    while f is not None:
        fname = f.f_code.co_filename
        if os.path.abspath(fname) not in _SKIP_FILES:
            try:
                rel = os.path.relpath(fname, os.path.dirname(_PACKAGE_DIR))
            except ValueError:   # different drive (windows)
                rel = fname
            if not rel.startswith(".."):
                return f"{rel}:{f.f_lineno}"
            return f"{os.path.basename(fname)}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>:0"


def _package_caller() -> bool:
    f = sys._getframe(1)
    while f is not None:
        fname = os.path.abspath(f.f_code.co_filename)
        if fname not in _SKIP_FILES:
            return fname.startswith(_PACKAGE_DIR + os.sep)
        f = f.f_back
    return False


def _lock_factory():
    if _package_caller():
        _ensure_collector()
        return WitnessLock(WITNESS)
    return _REAL_LOCK()


def _rlock_factory():
    if _package_caller():
        _ensure_collector()
        return WitnessRLock(WITNESS)
    return _REAL_RLOCK()


def enabled_by_env() -> bool:
    return os.environ.get("ES_TPU_LOCKDEP", "0").lower() in ("1", "true")


def install(force: bool = False) -> bool:
    """Patch the threading lock factories (package callers only). Returns
    True when installed. Call EARLY (before package modules create their
    module-level locks) — ``tests/conftest.py`` does this under
    ``ES_TPU_LOCKDEP=1``."""
    global _INSTALLED
    if not force and not enabled_by_env():
        return False
    if _INSTALLED:
        return True
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    _INSTALLED = True
    _ensure_collector()
    return True


def uninstall() -> None:
    global _INSTALLED
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    _INSTALLED = False


def installed() -> bool:
    return _INSTALLED


def witness_lock(name: Optional[str] = None,
                 witness: Optional[Witness] = None) -> WitnessLock:
    """An explicitly-witnessed lock (tests, the telemetry-lint workload)
    — works without installing the global factories."""
    _ensure_collector()
    return WitnessLock(witness or WITNESS, name or _caller_site())


def report() -> dict:
    return WITNESS.report()


_COLLECTOR_REGISTERED = False


def _ensure_collector() -> None:
    """Register the es_lockdep_* telemetry collector once (lazily — the
    lock factories fire DURING the telemetry module's own import when
    its registry/metric locks are created, so this must tolerate a
    partially-initialized telemetry module and retry later)."""
    global _COLLECTOR_REGISTERED
    if _COLLECTOR_REGISTERED:
        return
    try:
        from . import telemetry
        reg = getattr(telemetry, "DEFAULT", None)
        if reg is None:
            return            # telemetry mid-import: retry on next call
        reg.register_collector("lockdep", lambda: WITNESS.telemetry_doc())
        _COLLECTOR_REGISTERED = True
    except Exception:   # noqa: BLE001 — witnessing must never break
        pass            # lock creation; the collector is best-effort
