"""Host helpers: contract checks and the ragged `Table`."""
from .helpers import check, checks_enabled, notimplemented, notimplementedif, unreachable
from .table import (
    INDEX_DTYPE, Table, counts_to_ptrs, empty_table, get_data, get_ptrs, length_to_ptrs, ptrs_to_counts,
    rewind_ptrs,
)

__all__ = [
    "INDEX_DTYPE", "Table", "check", "checks_enabled", "counts_to_ptrs", "empty_table", "get_data", "get_ptrs",
    "length_to_ptrs", "notimplemented", "notimplementedif", "ptrs_to_counts", "rewind_ptrs", "unreachable",
]
