"""Execution model, partitions, distributed vectors and matrices, and the
GPU backend of the port."""
from .backends import MAIN, AbstractBackend, AbstractPData, get_part_ids, map_parts, prun
from .collectives import gather, preduce, scatter, xscan
from .exchanger import Exchanger
from .gpu import GPUBackend, GPUData, gpu, gpu_cg
from .prange import PRange, add_gids, cartesian_partition, no_ghost, prange, with_ghost
from .psparse import PSparseMatrix
from .pvector import PVector
from .sequential import SequentialBackend, sequential

__all__ = [
    "MAIN", "AbstractBackend", "AbstractPData", "Exchanger", "GPUBackend",
    "GPUData", "PRange", "PSparseMatrix", "PVector", "SequentialBackend",
    "add_gids", "cartesian_partition", "gather", "get_part_ids", "gpu",
    "gpu_cg", "map_parts", "no_ghost", "preduce", "prange", "prun",
    "scatter", "sequential", "with_ghost", "xscan",
]
