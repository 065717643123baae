"""Execution-model abstraction: backends, per-part data, `prun`.

The port's copy of `partitionedarrays_jl_tpu/parallel/backends.py`, the
reference's L1 layer (reference: src/Interfaces.jl:12-124). The core idea is preserved: all parallel
algorithms are written once against `AbstractPData` ("a value per part") and
executed by interchangeable backends:

* `SequentialBackend` (parallel/sequential.py) — all parts in one process,
  NumPy/host values, tasks run one after another. The development/debugging
  oracle, usable with arbitrary part counts.
* `GPUBackend` (parallel/gpu.py) — planning stays on the host; hot-path
  vectors live on one CUDA card as stacked ``(P, W)`` tensors and the
  banded SpMV runs as hand-written CUDA kernels.

Everything metadata-shaped (index sets, exchanger plans, neighbor graphs)
remains host-side NumPy *in both backends*: the planning/execution split is
the central design decision (see SURVEY.md §7).

Parts are 0-based; part `MAIN == 0` is the root. Part grids may be N-D
(Cartesian); linear part ids map to grid coordinates in C (row-major) order.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Tuple, Union

from ..utils.helpers import abstractmethod, check

MAIN = 0

PartShape = Union[int, Tuple[int, ...]]


def _as_shape(nparts: PartShape) -> Tuple[int, ...]:
    if isinstance(nparts, int):
        return (nparts,)
    return tuple(int(n) for n in nparts)


class AbstractBackend:
    """Tag type for the execution model.

    Contract (reference: src/Interfaces.jl:12-36): `get_part_ids` builds the
    `AbstractPData` of part ids (int part ids for 1-D grids; the grid shape is
    carried on the PData). `prun` is overridable per-backend for error
    handling.
    """

    def get_part_ids(self, nparts: PartShape) -> "AbstractPData":
        abstractmethod(self, "get_part_ids")

    def prun(self, driver: Callable, nparts: PartShape, *args, **kwargs):
        parts = self.get_part_ids(nparts)
        return driver(parts, *args, **kwargs)

    def prun_debug(self, driver: Callable, nparts: PartShape, *args, **kwargs):
        return self.prun(driver, nparts, *args, **kwargs)


def prun(driver: Callable, backend: AbstractBackend, nparts: PartShape, *args, **kwargs):
    """THE program entry point (reference: src/Interfaces.jl:33-36)."""
    return backend.prun(driver, nparts, *args, **kwargs)


def prun_debug(driver: Callable, backend: AbstractBackend, nparts: PartShape, *args, **kwargs):
    """The reference's debug entry point: `prun` on every backend here."""
    return backend.prun_debug(driver, nparts, *args, **kwargs)


class AbstractPData:
    """A value of type T per part, over an N-D grid of parts.

    Contract (reference: src/Interfaces.jl:50-96): `shape` (part-grid shape),
    `backend`, iteration, `map_parts`, `i_am_main`, `get_part`.
    """

    @property
    def backend(self) -> AbstractBackend:
        abstractmethod(self, "backend")

    @property
    def shape(self) -> Tuple[int, ...]:
        abstractmethod(self, "shape")

    @property
    def num_parts(self) -> int:
        return math.prod(self.shape)

    def __len__(self) -> int:
        return self.num_parts

    def map_parts(self, task: Callable, *others: "AbstractPData") -> "AbstractPData":
        abstractmethod(self, "map_parts")

    def get_part(self, part: int = None):
        """`get_part(a, p)` -> part p's value, visible to all parts (a
        broadcast under a distributed backend); `get_part(a)` -> this
        process's local chunk (sequential: only valid for 1 part)."""
        abstractmethod(self, "get_part")

    def i_am_main(self) -> bool:
        abstractmethod(self, "i_am_main")

    # --- host-side planning access -------------------------------------
    # Planning code (PRange/Exchanger construction) iterates part values on
    # the host in both backends. Device-resident PData overrides this to
    # fetch metadata-sized values only.
    def part_values(self) -> list:
        abstractmethod(self, "part_values")

    def __iter__(self):
        return iter(self.part_values())


def map_parts(task: Callable, *args) -> AbstractPData:
    """THE fundamental compute primitive: apply `task` per part to zipped
    PData arguments (reference: src/Interfaces.jl:86). Non-PData arguments
    are broadcast to every part."""
    first = _first_pdata(args)
    return first.map_parts(task, *args)


def _first_pdata(args) -> AbstractPData:
    for a in args:
        if isinstance(a, AbstractPData):
            return a
    raise TypeError("map_parts needs at least one AbstractPData argument")


def num_parts(a: AbstractPData) -> int:
    return a.num_parts


def get_part_ids(a_or_backend, nparts: PartShape = None) -> AbstractPData:
    """Part ids as PData. `get_part_ids(backend, nparts)` or
    `get_part_ids(pdata)` (same grid as an existing PData)."""
    if isinstance(a_or_backend, AbstractBackend):
        check(nparts is not None, "get_part_ids(backend, nparts)")
        return a_or_backend.get_part_ids(nparts)
    a = a_or_backend
    return a.backend.get_part_ids(a.shape)


def get_backend(a: AbstractPData) -> AbstractBackend:
    return a.backend


def get_part(a: AbstractPData, part: int = None):
    return a.get_part(part)


def get_main_part(a: AbstractPData):
    """Reference: src/Interfaces.jl:104-108."""
    return a.get_part(MAIN)


def i_am_main(a: AbstractPData) -> bool:
    return a.i_am_main()


def map_main(task: Callable, *args) -> AbstractPData:
    """Run `task` only on MAIN's values; other parts get None
    (reference: src/Interfaces.jl:110-124)."""
    parts = get_part_ids(_first_pdata(args))

    def _task(part, *vals):
        if part == MAIN:
            return task(*vals)
        return None

    return map_parts(_task, parts, *args)


def unzip(a: AbstractPData, n: int) -> Tuple[AbstractPData, ...]:
    """Split a PData of n-tuples into n PDatas (the analog of Julia
    destructuring over map_parts results)."""
    return tuple(map_parts(lambda t, _i=i: t[_i], a) for i in range(n))


class Token:
    """Completion handle for asynchronous exchanges.

    The reference chains Julia `Task`s (src/Interfaces.jl:342-373) purely for
    completion ordering. Here a Token is an opaque wait-able; the sequential
    and GPU backends complete eagerly.
    """

    def __init__(self, wait_fn: Callable = None, value: Any = None):
        self._wait_fn = wait_fn
        self._value = value
        self._done = wait_fn is None

    def wait(self):
        if not self._done:
            self._value = self._wait_fn()
            self._done = True
        return self._value


def schedule_and_wait(t) -> Any:
    """Blocking wrapper over tokens or PData-of-tokens
    (reference exchange!/exchange: src/Interfaces.jl:453-466)."""
    if isinstance(t, Token):
        return t.wait()
    if isinstance(t, AbstractPData):
        return map_parts(lambda tok: tok.wait() if isinstance(tok, Token) else tok, t)
    return t
