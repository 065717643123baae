"""The runtime lock-order sanitizer (utils/locksan.py of the JAX package).

With ``lock_check`` on (`telemetry.configure(lock_check=True)`, the JAX
package's ``PA_LOCK_CHECK=1``) `sanitized` wraps the service's locks (the
metrics `Registry.lock`, `SolveService._lock`) in a shim that records, per
thread, the nesting of acquisitions and, globally, every lock-order edge
(held -> newly acquired); the thread hammer tests read them. Off (the
default) `sanitized` returns the lock itself: the switch is read once per
lock construction and costs nothing per acquisition.

The shim forwards the private `threading.Condition` protocol
(``_is_owned`` / ``_release_save`` / ``_acquire_restore``): the service's
``Condition(self._lock)`` binds those at construction, and an RLock's
``_release_save`` drops every recursion level, so the shim's per-thread
bookkeeping pops all levels with it.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = [
    "lock_check_enabled",
    "sanitized",
    "observed_edges",
    "observed_events",
    "observed_max_nesting",
    "reset_observations",
    "find_cycle",
]

#: Bound on the global acquisition-event log: the hammer tests read the
#: edges (exact) and a recent-event window, not a history.
_EVENT_CAP = 4096

_state_lock = threading.Lock()
_edges: Dict[Tuple[str, str], int] = {}
_events: List[Tuple[str, str, str, Tuple[str, ...]]] = []
_max_nesting = 0

_tls = threading.local()


def lock_check_enabled() -> bool:
    """The telemetry config's ``lock_check`` (read at lock construction
    only, never on an acquire)."""
    from ..telemetry.config import config

    return bool(config().lock_check)


def sanitized(lock, name: str):
    """Wrap ``lock`` for order and nesting observation when ``lock_check``
    is on; return it untouched otherwise. ``name`` is the lock's
    ``Class.attr`` name."""
    if not lock_check_enabled():
        return lock
    return _SanitizedLock(lock, name)


def _held_stack() -> List[str]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _note_acquire(name: str) -> None:
    global _max_nesting
    stack = _held_stack()
    held = set(stack)
    with _state_lock:
        for h in held:
            if h != name:
                key = (h, name)
                _edges[key] = _edges.get(key, 0) + 1
        depth = len(held | {name})
        if depth > _max_nesting:
            _max_nesting = depth
        if len(_events) < _EVENT_CAP:
            _events.append(
                (threading.current_thread().name, "acquire", name,
                 tuple(stack))
            )
    stack.append(name)


def _note_release(name: str) -> None:
    stack = _held_stack()
    # release order may not mirror acquisition order (rare but legal);
    # drop the innermost matching entry
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == name:
            del stack[i]
            break


class _SanitizedLock:
    """Order/nesting-recording shim around a ``Lock``/``RLock``."""

    def __init__(self, inner, name: str):
        self._inner = inner
        self._name = name

    # -- the public lock protocol ------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquire(self._name)
        return got

    def release(self):
        self._inner.release()
        _note_release(self._name)

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<sanitized {self._name} around {self._inner!r}>"

    # -- the Condition(lock) protocol --------------------------------
    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # the stdlib fallback for plain Locks
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        # an RLock's _release_save drops EVERY recursion level — pop
        # every bookkeeping entry for this lock with it
        stack = _held_stack()
        n = stack.count(self._name)
        for _ in range(n):
            _note_release(self._name)
        if hasattr(self._inner, "_release_save"):
            return (self._inner._release_save(), n)
        self._inner.release()
        return (None, n)

    def _acquire_restore(self, state):
        inner_state, n = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        if n > 0:
            _note_acquire(self._name)  # re-entry records held->name edges
            stack = _held_stack()
            stack.extend([self._name] * (n - 1))


# ---------------------------------------------------------------------------
# observation accessors
# ---------------------------------------------------------------------------


def observed_edges() -> Set[Tuple[str, str]]:
    """Every (held, acquired) lock-order edge seen since the last
    `reset_observations`."""
    with _state_lock:
        return set(_edges)


def observed_events() -> List[Tuple[str, str, str, Tuple[str, ...]]]:
    """The (thread, op, lock, held-stack) acquisition log (bounded)."""
    with _state_lock:
        return list(_events)


def observed_max_nesting() -> int:
    with _state_lock:
        return _max_nesting


def reset_observations() -> None:
    global _max_nesting
    with _state_lock:
        _edges.clear()
        _events.clear()
        _max_nesting = 0


def find_cycle(
    edges: Sequence[Tuple[str, str]],
) -> Optional[List[str]]:
    """First cycle in a directed edge list as ``[a, b, ..., a]``, or
    None."""
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    parent: Dict[str, str] = {}

    def dfs(u: str) -> Optional[List[str]]:
        color[u] = GRAY
        for v in adj.get(u, ()):  # noqa: B007
            c = color.get(v, WHITE)
            if c == GRAY:
                cyc = [v, u]
                w = u
                while w != v:
                    w = parent[w]
                    cyc.append(w)
                cyc.reverse()
                return cyc
            if c == WHITE:
                parent[v] = u
                found = dfs(v)
                if found:
                    return found
        color[u] = BLACK
        return None

    for node in sorted(adj):
        if color.get(node, WHITE) == WHITE:
            found = dfs(node)
            if found:
                return found
    return None
