"""Exchanger: the halo-communication plan (L4).

The port's copy of `partitionedarrays_jl_tpu/parallel/exchanger.py`
(reference: src/Interfaces.jl:698-961), without the opt-in validation
seams. An Exchanger is pure host metadata, built once from a partition and
reused for every exchange:

* ``parts_rcv[p]`` — parts this part receives ghost data from (its owners)
* ``lids_rcv[p]`` — Table: per rcv-neighbor, which local lids get the data
* ``parts_snd[p]`` — parts this part must send owned data to
* ``lids_snd[p]`` — Table: per snd-neighbor, which local lids to pack

The host path below packs/copies/unpacks with NumPy; `parallel/gpu.py`
lowers the same plan to gather / copy / scatter rounds on stacked tensors.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..utils.helpers import check
from ..utils.table import INDEX_DTYPE, Table
from .backends import AbstractPData, Token, map_parts, schedule_and_wait
from .collectives import async_exchange_into, discover_parts_snd, exchange
from .index_sets import AbstractIndexSet


class Exchanger:
    __slots__ = ("parts_rcv", "parts_snd", "lids_rcv", "lids_snd", "_reverse")

    def __init__(self, parts_rcv, parts_snd, lids_rcv, lids_snd):
        self.parts_rcv = parts_rcv
        self.parts_snd = parts_snd
        self.lids_rcv = lids_rcv
        self.lids_snd = lids_snd
        self._reverse = None

    @classmethod
    def from_partition(
        cls,
        partition: AbstractPData,
        neighbors: Optional[AbstractPData] = None,
        reuse_parts_rcv: bool = False,
    ) -> "Exchanger":
        """Build the plan from per-part index sets
        (reference constructor: src/Interfaces.jl:723-786):

        1. group each part's ghost lids by owner -> `parts_rcv` + `lids_rcv`
           (+ the wanted gids),
        2. find who to send to (`discover_parts_snd`, or reuse `parts_rcv`
           for symmetric graphs, e.g. Cartesian stencil halos),
        3. exchange the wanted *gids* to the owners; owners map them to
           their lids -> `lids_snd`.
        """

        def _group_ghosts(iset: AbstractIndexSet):
            owners = iset.hid_to_part
            hlids = iset.hid_to_lid
            hgids = iset.hid_to_gid
            nbr, inv = np.unique(owners, return_inverse=True)
            order = np.argsort(inv, kind="stable")
            counts = np.bincount(inv, minlength=len(nbr)).astype(INDEX_DTYPE)
            ptrs = np.zeros(len(nbr) + 1, dtype=INDEX_DTYPE)
            np.cumsum(counts, out=ptrs[1:])
            return (
                nbr.astype(INDEX_DTYPE),
                Table(hlids[order].astype(INDEX_DTYPE), ptrs),
                Table(hgids[order], ptrs.copy()),
            )

        grouped = map_parts(_group_ghosts, partition)
        parts_rcv = map_parts(lambda g: g[0], grouped)
        lids_rcv = map_parts(lambda g: g[1], grouped)
        gids_rcv = map_parts(lambda g: g[2], grouped)

        if reuse_parts_rcv:
            parts_snd = parts_rcv
        else:
            parts_snd = discover_parts_snd(parts_rcv, neighbors)

        # Receivers ask their owners for the gids they want: the metadata
        # flows along the *reversed* graph (I send my request to those I
        # receive data from).
        gids_snd = exchange(gids_rcv, parts_snd, parts_rcv)

        def _to_lids(iset: AbstractIndexSet, gtable: Table):
            lids = iset.gids_to_lids(gtable.data)
            check((lids >= 0).all(), "exchanger: requested gid not local on owner")
            return Table(lids.astype(INDEX_DTYPE), gtable.ptrs)

        lids_snd = map_parts(_to_lids, partition, gids_snd)
        return cls(parts_rcv, parts_snd, lids_rcv, lids_snd)

    @classmethod
    def empty(cls, parts: AbstractPData) -> "Exchanger":
        """Reference: src/Interfaces.jl:788-794 (`empty_exchanger`)."""
        e_parts = map_parts(lambda _: np.empty(0, dtype=INDEX_DTYPE), parts)
        e_lids = map_parts(lambda _: Table.empty(INDEX_DTYPE), parts)
        return cls(e_parts, e_parts, e_lids, e_lids)

    def reverse(self) -> "Exchanger":
        """Halo-update plan -> ghost->owner assembly plan (cached): the
        senders become the receivers and the lid lists swap sides
        (exchanger.py:160 of the JAX package)."""
        if self._reverse is None:
            rev = Exchanger(self.parts_snd, self.parts_rcv, self.lids_snd, self.lids_rcv)
            rev._reverse = self
            self._reverse = rev
        return self._reverse

    # --- buffers (reference: src/Interfaces.jl:800-816) ----------------
    def allocate_rcv_buffer(self, dtype) -> AbstractPData:
        return map_parts(
            lambda t: Table(np.zeros(int(t.ptrs[-1]), dtype=dtype), t.ptrs.copy()),
            self.lids_rcv,
        )

    def allocate_snd_buffer(self, dtype) -> AbstractPData:
        return map_parts(
            lambda t: Table(np.zeros(int(t.ptrs[-1]), dtype=dtype), t.ptrs.copy()),
            self.lids_snd,
        )

    def __repr__(self):
        return "Exchanger(...)"


# ---------------------------------------------------------------------------
# Value exchange through a plan (sequential/NumPy execution path)
# ---------------------------------------------------------------------------


def async_exchange_values(
    values_rcv: AbstractPData,
    values_snd: AbstractPData,
    exchanger: Exchanger,
    combine_op: Optional[Callable] = None,
) -> Token:
    """Pack `values_snd[lids_snd]` -> exchange -> (on wait) unpack into
    `values_rcv[lids_rcv]`, combining with `combine_op` (default:
    overwrite). Reference: src/Interfaces.jl:846-889.

    The pack and wire copy happen eagerly; the *unpack* into `values_rcv`
    is deferred to `Token.wait()`, mirroring the reference's chained unpack
    task (its `t3`). `combine_op` must be a NumPy ufunc (e.g. ``np.add``)
    so ghost->owner assembly accumulates duplicates through ``ufunc.at``.
    """

    def _pack(vals, t: Table):
        return Table(np.asarray(vals)[t.data], t.ptrs)

    data_snd = map_parts(_pack, values_snd, exchanger.lids_snd)
    data_rcv = map_parts(
        lambda vals, t: Table(np.zeros(int(t.ptrs[-1]), dtype=np.asarray(vals).dtype), t.ptrs),
        values_rcv,
        exchanger.lids_rcv,
    )
    t = async_exchange_into(data_rcv, data_snd, exchanger.parts_rcv, exchanger.parts_snd)
    schedule_and_wait(t)

    def _unpack_all():
        def _unpack(vals, buf: Table, t: Table):
            vals = np.asarray(vals)
            if combine_op is None:
                vals[t.data] = buf.data[: t.ptrs[-1]]
            else:
                combine_op.at(vals, t.data, buf.data[: t.ptrs[-1]])
            return vals

        map_parts(_unpack, values_rcv, data_rcv, exchanger.lids_rcv)
        return values_rcv

    return Token(wait_fn=_unpack_all)


def exchange_values(
    values_rcv,
    values_snd=None,
    exchanger: Exchanger = None,
    combine_op: Optional[Callable] = None,
    combine: Optional[Callable] = None,
):
    """Blocking wrapper. The two-argument form ``exchange_values(values,
    exchanger)`` uses the same array as source and destination, the
    in-place halo update of the reference's `exchange!(values, exchanger)`
    (src/Interfaces.jl:818-835)."""
    if exchanger is None and isinstance(values_snd, Exchanger):
        exchanger, values_snd = values_snd, values_rcv
    if values_snd is None:
        check(exchanger is not None, "exchange_values: no exchanger given")
        values_snd = values_rcv
    if combine is not None:
        combine_op = combine
    t = async_exchange_values(values_rcv, values_snd, exchanger, combine_op)
    schedule_and_wait(t)
    return values_rcv


def allocate_rcv_buffer(dtype, e: Exchanger) -> AbstractPData:
    """Reference export parity (src/Interfaces.jl:800-807)."""
    return e.allocate_rcv_buffer(dtype)


def allocate_snd_buffer(dtype, e: Exchanger) -> AbstractPData:
    """Reference export parity (src/Interfaces.jl:809-816)."""
    return e.allocate_snd_buffer(dtype)


def empty_exchanger(parts: AbstractPData) -> Exchanger:
    return Exchanger.empty(parts)
