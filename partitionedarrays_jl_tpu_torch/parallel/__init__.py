"""Execution model, partitions, distributed vectors and matrices, the
reference's host API over them, and the GPU backend of the port."""
from .backends import (
    MAIN, AbstractBackend, AbstractPData, Token, get_backend, get_main_part, get_part, get_part_ids, i_am_main,
    map_main, map_parts, num_parts, prun, prun_debug, schedule_and_wait, unzip,
)
from .collectives import (
    ERROR_DISCOVER_PARTS_SND, abft_exchanges, async_exchange, async_exchange_into, discover_parts_snd, emit, exchange, exchange_into, gather, gather_all, iscan, iscan_all, iscan_main, preduce, reduce_all,
    reduce_main, scatter, sum_parts, xscan, xscan_all, xscan_main,
)
from .exchanger import (
    Exchanger, allocate_rcv_buffer, allocate_snd_buffer, async_exchange_values, empty_exchanger, exchange_values,
)
from .gpu import (
    DeviceMatrix, DeviceVector, GPUBackend, GPUData, device_matrix, gpu, gpu_block_cg, gpu_cg, make_block_cg_fn,
    make_cg_fn, make_exchange_fn, make_spmv_fn,
)
from .gpu_gmg import (
    gpu_fgmres_gmg, gpu_gmg_pcg, gpu_gmg_solve, make_fgmres_gmg_fn, make_gmg_pcg_fn, make_gmg_solve_fn,
)
from .gpu_lobpcg import gpu_lobpcg, make_lobpcg_fn
from .gpu_krylov import (
    gpu_bicgstab, gpu_chebyshev, gpu_gmres, gpu_minres, make_bicgstab_fn, make_chebyshev_fn, make_diff_solve_fn,
    make_gmres_fn, make_minres_fn,
)
from .index_sets import (
    GID_DTYPE, AbstractIndexSet, CartesianGidToPart, ExtendedIndexRange, IndexRange, IndexSet, LinearGidToPart, add_gid, get_gid_to_lid, get_hid_to_lid, get_lid_to_gid, get_lid_to_ohid,
    get_lid_to_part, get_oid_to_lid, num_gids, num_hids, num_lids, num_oids, touched_hids,
)
from .prange import (
    CartesianLocalIndices, NoGhost, PRange, WithGhost, add_gids, add_gids_inplace, p_cartesian_indices, to_gids,
    to_lids, cartesian_partition, hids_are_equal, lids_are_equal, no_ghost, oids_are_equal, prange,
    prange_eq, uniform_partition, variable_partition, with_ghost,
)
from .psparse import (
    PSparseMatrix, assemble_coo, assemble_matrix_from_coo, exchange_coo, psparse_global_triplets, matrix_exchanger, psparse_local_values, psparse_owned_triplets,
)
from .ptimers import PTimer, print_timer, tic, toc
from .pvector import (
    GlobalViewPart, LocalViewPart, PVector, assemble, async_assemble, chebyshev, cityblock, euclidean,
    exchange_pvector, global_view, local_view, minkowski, pvector, sqeuclidean,
)
from .faults import FaultClause, FaultSpec, FaultState, active_fault_state, faults_active, inject_faults
from .checkpoint import (
    CheckpointCorruptError, CheckpointShapeError, SolverCheckpointer, load_checkpoint, load_psparse,
    load_psparse_sharded, load_pvector, load_pvector_sharded, load_solver_state, save_checkpoint, save_psparse,
    save_psparse_sharded, save_pvector, save_pvector_sharded,
)
from .sequential import SequentialBackend, SequentialData, sequential

__all__ = [
    "CheckpointCorruptError", "CheckpointShapeError", "ERROR_DISCOVER_PARTS_SND", "FaultSpec", "FaultState",
    "SolverCheckpointer", "abft_exchanges", "active_fault_state", "discover_parts_snd", "faults_active",
    "inject_faults", "load_checkpoint", "load_psparse", "load_psparse_sharded", "load_pvector",
    "load_pvector_sharded", "load_solver_state", "pvector", "save_checkpoint", "save_psparse",
    "save_psparse_sharded", "save_pvector", "save_pvector_sharded",
    "MAIN", "AbstractBackend", "AbstractPData", "Exchanger", "ExtendedIndexRange", "GPUBackend", "GPUData",
    "GlobalViewPart", "LocalViewPart", "PRange", "PSparseMatrix", "PTimer", "PVector", "SequentialBackend",
    "add_gid", "add_gids", "allocate_rcv_buffer", "allocate_snd_buffer", "assemble", "async_assemble",
    "cartesian_partition", "chebyshev", "cityblock", "emit", "empty_exchanger", "euclidean", "exchange",
    "exchange_coo", "exchange_into", "exchange_pvector", "exchange_values", "gather", "gather_all",
    "get_backend", "get_gid_to_lid", "get_hid_to_lid", "get_lid_to_gid", "get_lid_to_ohid", "get_lid_to_part",
    "get_oid_to_lid", "get_part_ids", "global_view", "gpu", "gpu_bicgstab", "gpu_cg", "gpu_chebyshev",
    "gpu_fgmres_gmg", "gpu_gmg_pcg", "gpu_gmg_solve", "gpu_gmres", "gpu_lobpcg", "gpu_minres", "hids_are_equal", "iscan", "iscan_all",
    "iscan_main", "lids_are_equal", "local_view", "make_bicgstab_fn", "make_chebyshev_fn", "make_diff_solve_fn",
    "make_fgmres_gmg_fn", "make_gmg_pcg_fn", "make_gmg_solve_fn", "make_gmres_fn", "make_lobpcg_fn", "make_minres_fn", "map_main", "map_parts", "matrix_exchanger", "minkowski",
    "no_ghost", "num_gids", "num_hids", "num_lids", "num_oids", "oids_are_equal", "preduce", "prange",
    "prange_eq", "print_timer", "prun", "prun_debug", "psparse_local_values", "psparse_owned_triplets",
    "reduce_all", "reduce_main", "scatter", "sequential", "sqeuclidean", "sum_parts", "tic", "toc",
    "touched_hids", "uniform_partition", "unzip", "variable_partition", "with_ghost", "xscan", "xscan_all",
    "xscan_main",
    # the index sets and partitions, the backend and exchange primitives, the
    # COO assembly and the device layer the JAX package exports too
    "AbstractIndexSet", "CartesianGidToPart", "CartesianLocalIndices", "FaultClause", "GID_DTYPE", "IndexRange",
    "IndexSet", "LinearGidToPart", "NoGhost", "SequentialData", "Token", "WithGhost", "add_gids_inplace",
    "assemble_coo", "assemble_matrix_from_coo", "async_exchange", "async_exchange_into", "async_exchange_values",
    "get_main_part", "get_part", "i_am_main", "num_parts", "p_cartesian_indices", "psparse_global_triplets",
    "schedule_and_wait", "to_gids", "to_lids",
    "DeviceMatrix", "DeviceVector", "device_matrix", "gpu_block_cg", "make_block_cg_fn", "make_cg_fn",
    "make_exchange_fn", "make_spmv_fn",
]
