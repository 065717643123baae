"""Device-resident solve loops: the port's counterpart of `lax.while_loop`.

The JAX package runs each solve as one compiled program: ``while
cond(state): state = step(state)`` on the device (`parallel/tpu.py:4120`,
`parallel/tpu_gmg.py:969`). Here the state is a dict of device tensors
and the stopping test is a device flag ``live`` (int32), carried as ``live
<- live and cond(state)`` at the top of every step; a step whose flag
reads 0 is *frozen*: it writes nothing of the state that the solve
returns (the vector updates go through kernels that read the flag,
`ops/sweep.py` and the pipelined body's SpMV; the scalars through
``torch.where``). So running a few iterations past the stop changes no
result, and the host can read the flag once per block of iterations.

`DeviceLoop` runs blocks of ``block`` steps until the flag reads 0. On a
CUDA device the first block of the first run runs eagerly (it is also the
warm-up: every kernel computes its launch grid there), then the block is
captured once into a `torch.cuda.CUDAGraph` and replayed: one host launch
and one read of the flag a block. A first run that ended with its first
block captured nothing; the next run captures before its first block, so
a cached solve that always ends in one block replays a graph from its
second run on. A capture that fails raises; nothing falls back to the
eager loop. On the CPU, or with ``graph=False``, every
block runs eagerly: the same steps, the same frozen iterations, so the
results and the device iterations are the same.

Steps are written as functions of the state dict: a step may update a
state tensor in place (the persistent buffer that a graph captured) or
return a new tensor under its key; at the end of a block every rebound
key is copied back into its buffer. The returned state is the buffers:
the caller copies what it returns, since the next run overwrites them.

Block (multi-RHS) solves (`parallel/gpu.py:make_block_cg_fn`) carry per-
column state in the same loop (tpu.py:4473-4500): a (K,) int32 ``act``
mask computed at the top of every step (a column is active while its solo
loop would run), per-column iteration counts ``itk`` (K,) and an (H, K)
history, NaN past each column's freeze. Their ``live`` is "some column
active and it < maxiter", so capture and replay are the same.

Launch counts: a wrapper counts a launch in `dia.LAUNCHES` when it is
called, and a capture calls every wrapper of the block without running
it. So the counts a capture adds are taken back and kept as the graph's
tally, which every replay adds, and `dia.LAUNCHES` counts the launches the
card ran, in frozen iterations too.

Comms: the first block a loop runs (eagerly, or under the capture when the
run captures before its first block) runs inside a `telemetry.comms`
tally, kept as ``DeviceLoop.comms``: the exchanges and dot folds of one
block, the counted half of the comms accounting (`telemetry/comms.py`).
Later blocks and replays count nothing.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import dia
from ..telemetry import comms as tcomms

#: iterations a block (a graph replay) runs: CG's iterations take ~0.2 ms
#: of device work at 192^3, a GMG-PCG iteration ~1.3 ms
CG_BLOCK = 8
GMG_BLOCK = 1
#: the residual history's capacity: H = min(maxiter + 1, HIST_MAX) entries
#: (tpu.py:3605)
HIST_MAX = 4096

State = Dict[str, torch.Tensor]

#: CUDA graphs captured by every `DeviceLoop` since import (callers reset
#: or difference it): a cached solve function replays its graph and adds
#: none
STATS = {"captures": 0}


def history(h0: torch.Tensor, maxiter: int) -> torch.Tensor:
    """The fixed-shape residual history of a solve: H = min(maxiter + 1,
    HIST_MAX) entries, NaN but for entry 0, ``h0`` (a scalar, or (K,) for
    a block solve: an (H, K) history)."""
    hist = torch.full((min(int(maxiter) + 1, HIST_MAX),) + tuple(h0.shape), math.nan, dtype=h0.dtype,
                      device=h0.device)
    hist[0] = h0
    return hist


def record(hist: torch.Tensor, it: torch.Tensor, live: torch.Tensor, value: torch.Tensor) -> None:
    """Write ``value`` at row ``min(it, H - 1)`` of the history, in place,
    where ``live`` (it is the count after the step; for a block history
    ``live`` and ``value`` are (K,), a flag and a value a column); a frozen
    step (column) writes back the entry it finds."""
    idx = torch.clamp(it, max=hist.shape[0] - 1).to(torch.int64).reshape(1)
    keep = hist.index_select(0, idx)[0]
    hist.index_copy_(0, idx, torch.where(live != 0, value, keep).unsqueeze(0))


def trace_ring(depth: int, like: torch.Tensor, K: Optional[int] = None) -> torch.Tensor:
    """The α/β trace ring of a CG loop (tpu.py:3549-3555, :4417-4422): a
    zeroed ``(depth, 2)`` tensor, ``(depth, 2, K)`` for a block solve, in
    ``like``'s dtype and device."""
    shape = (int(depth), 2) if K is None else (int(depth), 2, int(K))
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def record_ab(ab: torch.Tensor, it: torch.Tensor, live: torch.Tensor, alpha: torch.Tensor,
              beta: torch.Tensor) -> None:
    """Write ``(alpha, beta)`` of iteration ``it`` (the count before the
    step) at row ``it % depth`` of the ring, in place, where ``live``;
    a frozen step writes back the row it finds. The index is a device
    tensor, so the write is one `index_copy_` inside a captured block and
    reads nothing on the host. The ring keeps the last ``depth``
    iterations (tpu.py:3912-3937, :4108-4123, :4900-4972)."""
    idx = torch.remainder(it, ab.shape[0]).to(torch.int64).reshape(1)
    keep = ab.index_select(0, idx)[0]
    ab.index_copy_(0, idx, torch.where(live != 0, torch.stack([alpha, beta]), keep).unsqueeze(0))


def unroll_ring(ab: np.ndarray, it: int) -> Tuple[np.ndarray, int, int]:
    """A downloaded ring in iteration order (tpu.py:5871-5887): ``(rows,
    n, trace_start)`` with ``rows[j]`` iteration ``trace_start + j`` for
    ``j < n = min(it, depth)``; past ``depth`` iterations the ring has
    wrapped and is rolled by ``it % depth``."""
    depth = ab.shape[0]
    n = min(int(it), depth)
    if it > depth:
        return np.roll(ab, -(int(it) % depth), axis=0), n, int(it) - depth
    return ab, n, 0


def sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a tensor, as NumPy's and the
    host loops' ``np.sqrt``: `torch.sqrt` on a CUDA tensor (IEEE), NumPy's
    on a CPU one, since PyTorch's vectorized CPU sqrt is not correctly
    rounded (about 1% of float64 values come out an ulp off), which put the
    device loop's residual history (and, at a threshold, its stopping test)
    an ulp away from the host loop's on the CPU."""
    if t.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(t.numpy())))
    return torch.sqrt(t)


def finish_step(out: State, S: State, live: torch.Tensor, rs_new: torch.Tensor) -> State:
    """The end of a step from state S with the new flag ``live``: rs, the
    iteration count and the flag into ``out`` (rs kept where the flag is
    0), and sqrt(rs_new) into the history where it is set."""
    out.update(rs=torch.where(live != 0, rs_new, S["rs"]), it=S["it"] + live, live=live)
    record(S["hist"], out["it"], live, sqrt_rn(rs_new))
    return out


def stop_bound(maxiter: int) -> int:
    """maxiter as the int32 iteration counter compares it."""
    return min(int(maxiter), 2**31 - 1)


class DeviceLoop:
    """Blocks of ``block`` calls of ``step(state) -> state`` until the
    state's ``live`` flag reads 0, on persistent state buffers; on a CUDA
    device (and with ``graph``) the block is a CUDA graph replayed after
    the first block. `stats` describes the last run."""

    def __init__(self, step: Callable[[State], State], block: int, graph: bool = True):
        if block < 1:
            raise ValueError(f"DeviceLoop: block must be >= 1, got {block}")
        self.step = step
        self.block = int(block)
        self.graph = bool(graph)
        self.base: Optional[State] = None
        self.layout = None
        self.cuda_graph = None
        self.tally: Dict[str, int] = {}
        self.capture_s: Optional[float] = None
        self.warm = False  # a block ran eagerly on these buffers: every kernel is warm
        self.stats: dict = {}
        self.comms: Optional[dict] = None  # the comms tally of one block (`telemetry.comms`)

    def run(self, init: State) -> Tuple[State, int]:
        """Load ``init`` (which must hold ``live``) into the state buffers and
        run blocks until the flag reads 0. Returns the buffers and the
        iterations the device ran (whole blocks, frozen ones included)."""
        layout = {k: (v.shape, v.dtype, v.device) for k, v in init.items()}
        if layout != self.layout:
            # new buffers: a captured graph would write the old ones
            self.base = {k: v.clone() for k, v in init.items()}
            self.layout = layout
            self.cuda_graph = None
            self.warm = False
        else:
            for k, v in init.items():
                self.base[k].copy_(v)
        use_graph = self.graph and self.base["live"].device.type == "cuda"
        n = replays = 0
        captured_now = False
        if use_graph and self.cuda_graph is None and self.warm:
            self._capture()
            captured_now = True
        while True:
            if self.cuda_graph is not None:
                self.cuda_graph.replay()
                for k, v in self.tally.items():
                    dia.LAUNCHES[k] += v
                replays += 1
            else:
                self._block()
                self.warm = True
            n += self.block
            if not bool(self.base["live"].item()):
                break
            if use_graph and self.cuda_graph is None:
                self._capture()
                captured_now = True
        self.stats.clear()  # in place: callers may hold the dict
        self.stats.update(
            loop="graph" if use_graph else "eager", block=self.block, device_iterations=n,
            replays=replays, capture_s=self.capture_s if captured_now else None,
        )
        return self.base, n

    def _block(self) -> None:
        if self.comms is None:
            with tcomms.counting() as tally:
                self._steps()
            self.comms = tally
        else:
            self._steps()

    def _steps(self) -> None:
        S = dict(self.base)
        for _ in range(self.block):
            S = self.step(S)
        # rebound keys back into their buffers; a source that is another
        # key's buffer is copied first, since the writes would overwrite it
        bufs = {id(t) for t in self.base.values()}
        moved = {k: (v.clone() if id(v) in bufs else v) for k, v in S.items() if v is not self.base[k]}
        for k, v in moved.items():
            self.base[k].copy_(v)

    def _capture(self) -> None:
        """Capture one block into a CUDA graph (torch's global capture error
        mode: a host read or a synchronising op raises). The launches the
        capture counted become the graph's tally. Python's cyclic garbage
        collector is off during the capture: a solve function cached on its
        operator or hierarchy sits in a reference cycle, and collecting a
        dead one destroys its graph, which no stream may do while another
        captures (the capture is then invalidated)."""
        before = dict(dia.LAUNCHES)
        t = time.perf_counter()
        g = torch.cuda.CUDAGraph()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(g):
                self._block()
        finally:
            if gc_on:
                gc.enable()
            tally = {k: dia.LAUNCHES[k] - before[k] for k in dia.LAUNCHES}
            dia.LAUNCHES.update(before)
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t
        STATS["captures"] += 1
        self.tally = {k: v for k, v in tally.items() if v}
        self.cuda_graph = g
