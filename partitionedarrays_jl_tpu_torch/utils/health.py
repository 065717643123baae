"""Typed solver-health errors.

The port's own copy of the error types of
`partitionedarrays_jl_tpu/parallel/health.py` that its solvers raise:
`SolverHealthError`, the base type a recovery driver catches, and
`NonFiniteError`, raised by a block solve (`parallel/gpu.py:gpu_block_cg`,
``column_errors="raise"``) on a column whose residual is NaN or Inf. The
JAX package's guards, environment switches and telemetry events are not
ported: the port reads no environment variable.
"""
from __future__ import annotations

from typing import Optional


class SolverHealthError(RuntimeError):
    """A solver detected a state it cannot continue from. ``diagnostics``
    carries what the raising guard knows (the context, the columns, the
    iterations, the residuals)."""

    def __init__(self, message: str, diagnostics: Optional[dict] = None):
        super().__init__(message)
        self.diagnostics = dict(diagnostics or {})


class NonFiniteError(SolverHealthError):
    """NaN/Inf detected in solver state."""


class LoweringConflictError(SolverHealthError):
    """Two requested solver-body forms cannot compose into one loop (the
    s-step body with ``fused``, ``pipelined``, ``precond``, a block of
    right-hand sides or strict mode), raised when the solve function is
    built, naming both sides under ``diagnostics["conflict"]``, instead of
    silently building another body than the caller asked for."""
