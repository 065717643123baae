#!/usr/bin/env python3
"""Smoke run of partitionedarrays_jl_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout (``build/pa_torch_kernels/``),
drives the port's paths — the 3-D Poisson CG solve at 192^3 in float32 on
one part (fused, then pipelined and standard) and the
multigrid-preconditioned CG at 192^3 float32, through `prun`,
`assemble_poisson`, `cg`, `pcg` and the lowerings; the unstructured
tet-elasticity Jacobi PCG at 64^3 nodes float64 (`assemble_elasticity_tet`,
a non-band lowering), strict-bits CG and the block solves on the non-band
lowerings and in strict mode; strict GMG-PCG, the 2-D Q1 FE model at
1024^2 nodes and the transient heat march at 96^3; the nonsymmetric
advection FV model at 192^3 float64 (BiCGStab, GMRES), MINRES, Chebyshev,
FGMRES with the V-cycle and the differentiable solve — and holds every kernel against its plain
PyTorch version (twenty-two kernels: K1-K4, the stencil, the CG sweep and
the V-cycle epilogue; K2 with minv, the sweep's precond and block forms,
the two block SpMMs and the block dot's products of Jacobi PCG and the
block solves; E1 (ELL, A_oo and boundary modes), E2 (node blocks, A_oo and
boundary modes) and E3 (the strict dot); the slab forms of E1's and E2's
A_oo, of E2's boundary mode and E3's block form). Every solve runs the device-resident
loop (`parallel/gpu_loop.py`): blocks of k iterations replayed as a CUDA
graph, the stopping test a device flag; so launch counts are stated in the
iterations the device ran (whole blocks, the frozen iterations after the
stop included; ``device_iterations`` of the solve's ``device_loop``), and
every path's graph solve is held torch.equal to the same loop run eagerly
on the card (a ``loop_graph_vs_eager`` line each: iterations, block,
device iterations, replays, capture seconds).
Phases, one JSON line each:

1. device and build: the nvidia-smi name/power-limit line, the device name,
   the nvcc build seconds and the ptxas register / shared-memory / spill
   lines of each kernel instantiation, failing on any spill (the coded
   kernel's shared memory is dynamic, so ptxas prints no shared-memory
   line for it: phase 2 prints the bytes each window plan takes);
2. kernels against their plain versions on the card at 192^3 f32: the
   coded-DIA SpMV, its CG direction-fold variant (y and p) and its
   lagged-axpy variant (y and the updated solution), each in row-class
   mode (the real Poisson staging) and in select-chain mode (a synthetic
   nibble-packed operator); then the same three at the odd size 193^3
   (operand windows off 16-byte alignment, a ragged last tile) on
   synthetic operators in both decodes, with frames wider than the band;
   each must be torch.equal to its plain version (torch.equal counts
   -0.0 == +0.0: the kernel's sums start from -0.0 and the row-class
   decode skips exact-zero coefficients that the plain version adds);
   the window plan (tile rows, shared-memory bytes) of each mode; K3 with
   its device flag 1 and 0 (0: the solution untouched), and the CG update
   sweep `cg_sweep` (x and r, r only; the flag 1 and 0: x, r, partials,
   rs) on the 192^3 frames;
2b. the GMG hierarchies of phases 4b and 4c (192^3 f32 on one part, 48^3
   f64 on (2,2,2) stacked parts), staged on the default routes (the box
   exchange plan, the matrix-free stencil transfers where they apply,
   else the structured ones with the strided-box embedding), with the
   staging seconds; the box stencil kernel torch.equal to its plain
   version on every stencil level of both, in the form the level's shape
   takes and in the other form (tiled, slab), after a box exchange of a
   random frame;
3. main path: assemble, lower, solve to tol=1e-5 on the fused body; the
   kernel launch counts are zeroed just before and read just after: the
   SpMV once (the initial residual), the direction-fold SpMV and the sweep
   once per device iteration; the same solve through the plain versions
   must take the same iterations and reach an error within 1.1x; graph
   against eager;
3b. pipelined CG on phase 3's operator (its cached lowering) to
   tol=1e-5, launch counts zeroed before and read after: the axpy kernel
   and the sweep once per device iteration, the plain SpMV once; the
   same iterations as the plain versions and as the standard body (its
   own counts: the SpMV 1 + 1 and the sweep 1 per device iteration),
   error within 1.1x of the plain solve's; graph against eager for the
   pipelined and the standard body;
4. stacked parts: the (2,2,2)-part 48^3 float64 driver on the one card, on
   the box exchange plan, with the launch counts zeroed just before and
   read just after (both must be > 0), must take the iterations of the
   port's sequential backend, error < 1e-5; both kernels are then held
   torch.equal against their plain versions on that path's float64
   operand with (8, W) frames, and the same solve through the plain
   versions and on the generic exchange plan must take the same
   iterations; the sweep held against its plain version on the (8, W)
   f64 frames; graph against eager; the box and the generic plan's
   ``set`` and ``add`` exchanges are timed (and agree: set exactly per
   lid, add to rounding), and fused CG seconds per iteration are read on
   both plans (the box plan in the graph and the eager loop);
4b. GMG-PCG at 192^3 f32 on the stencil route (phase 2b's hierarchy, set
   up as tools/bench_gmg.py does: assemble, scale by 1/16 in f32,
   b = A x̂, decouple_dirichlet, gmg_hierarchy with coarse_threshold=500):
   5 levels, every one on the stencil route; launch counts zeroed before
   `pcg` and read after must equal 1 + 3 per device iteration (coded: the
   initial residual, the outer A p and 2 on level 0 per V-cycle; no K1 on
   any S), 8 per device iteration (stream: 2 on each of levels 1-4), 10
   per device iteration (the stencil kernel: 2 on each level), 15 per
   device iteration (the V-cycle epilogue: init, residual and smooth on
   each level) and 1 sweep per device iteration; the same iterations as
   the plain versions, error within 1.1x of theirs; the streaming-DIA
   kernel held in both forms on every stream level, the epilogue in every
   mode on every level, and one V-cycle with the kernels against the
   V-cycle through the plain versions; graph against eager;
4b'. the same solve on the structured route (``stencil=False``): its
   staging seconds (S assembled and lowered on every level), the coded-DIA
   SpMV torch.equal to its plain version on every coded operator (level
   0's A and the stencils S of all 5 levels, select-chain decode), the
   epilogue (its residual into S's frame) and one V-cycle against their
   plain versions, launch counts 1 + 13 per device iteration coded (2
   with S on each level), 8 per device iteration stream, 15 epilogue and
   1 sweep; the stencil route must take its
   iterations (7) and reach an error within 1.1x of its; graph against
   eager;
4c. stacked-parts GMG-PCG, (2,2,2) parts, 48^3 float64 on the card (phase
   2b's hierarchy): the iterations of the port's sequential backend, of the
   plain versions and of the generic routes (``box=False``), coded, stream,
   stencil, sweep and epilogue launch counts by the routes' formula
   (`gmg_launches`) and > 0, the coded kernel torch.equal to its plain
   version on level 0's A and S, the stream kernel in both forms on both
   stream levels, the epilogue in every mode on every level and one
   V-cycle, on the default and the generic routes; graph against eager;
   seconds per iteration on both routes (the default routes in the graph
   and the eager loop);
4d. Jacobi PCG at 192^3 f32 on phase 2b's decoupled operator through
   `pcg(Ah, bh)` (the default diagonal minv), fused and standard bodies:
   launch counts by formula (fused: K1 once, K2 with minv and the precond
   sweep once per device iteration; standard: K1 1 + 1 per device
   iteration, the precond sweep 1), the plain path's iterations and error
   within 1.1x, graph against eager, K2 with minv and the precond sweep
   (the flag 1 and 0) torch.equal to their plain versions, seconds per
   iteration from fixed trips of 20 and 220;
4e. the block solves at 192^3 f32, K = 8 right-hand sides (column 0 the
   main path's b; the others A x̂_k from the seed, each started at its
   Dirichlet values): fused block CG on phase 3's coded operator, fused
   block CG and block Jacobi PCG on the variable-coefficient operator of
   the JAX package's multi-RHS benchmark (its own copy here,
   `assemble_varcoef_poisson`, decoupled; the streaming-DIA lowering),
   through `cg(A, B=...)` and `pcg(A, B=...)`: launch counts by formula
   (the SpMM 1 + 1 and the block sweep 1 per device iteration; the block
   dot's products 1 per device iteration and 1, with Jacobi 2, at the
   start), per-column iterations and solutions equal to each column's solo
   solve, errors against x̂_k, graph against eager, block, per-RHS and solo
   seconds per iteration; the block kernels torch.equal to their plain
   versions at the paths' shapes; and the default solo CG on the varcoef operator (the
   fused body, repaired: K4 1 + 1 and the sweep 1 per device iteration) with
   the standard body's iterations and both bodies' seconds per iteration;
4f. the non-band lowerings, the elasticity model and strict bits:
   elasticity Jacobi PCG at 64^3 nodes f64 through `pcg(A, b, x0=x0)` (tol
   1e-12, the driver's): the lowering it resolves to (BSR bs 3 in f64),
   host assembly and staging seconds, launches by formula (E2 1 + 1 and
   the precond sweep 1 per device iteration), error against x̂ < 1e-5, the
   plain path's iterations, graph against eager, seconds per iteration from
   fixed trips, a profile (E2's kernel one launch an SpMV), and E2's
   product in f64 at that shape (``bsr_spmv_f64``: flushed µs, plain,
   torch.sparse.mm, the bound of the bytes it moves: the real blocks,
   their int32 columns, the counts, x and y; the CSR's need); the same
   operator in f32 (values scaled as tools/bench_irregular.py scales
   them) in each lowering (SD, BSR, ELL): staging seconds, SpMV µs and
   GFLOP/s, torch.sparse.mm, E1 and E2 torch.equal to their plain
   versions and timed (E1 slot-major with int32 columns; each beside its
   bound and the CSR's need), SD's
   torch.bmm timed, every product against the f64 host product;
   elasticity on 4 stacked
   parts at 32^3 f64 in each lowering (SD with the node-block boundary,
   BSR, forced ELL): the sequential backend's iterations and solution,
   launches by formula (E2's boundary mode one launch an SpMV over all
   its width buckets), E1/E2 in both modes torch.equal to their plain
   versions, the boundary kernels timed; strict CG on 6^3 and 48^3 (2,2,2)
   f64 bit for bit against the sequential backend (iterations, residual
   history, solution), launches by formula (E1 1 + 1 and E1's boundary
   1 + 1 per device iteration, E3 1 + 2); strict Jacobi PCG on the
   N_STRICT_ELASTIC^3 elasticity system (b in strict mode) on 4 stacked
   parts, bit for bit the sequential backend's; strict CG's seconds per iteration
   against fused CG's at 192^3 f32 (and a profile: E3 one kernel a
   dot), E3 bit for bit its plain version and timed there, E1 timed on
   the strict lowering's 7 slots;
4g. the block (multi-RHS) solves on the non-band lowerings and in strict
   mode, on phase 4f's systems (no second 64^3 assembly): elasticity
   block Jacobi PCG at 64^3 f64, K = N_BLOCK (BSR; column 0 phase 4f's b,
   the others A x̂_k from the seed, started at their Dirichlet values)
   through `pcg(A, B=..., X0=...)`: launches by formula (E2's slab form
   1 + 1, the block sweep 1 per device iteration), every column's
   iterations and solution bit for bit its solo `pcg`, column 0's error
   under the model's gate and every column's relative error under 1e-5,
   graph against eager, block seconds per iteration per RHS against the
   solo ones, a profile (E2's slab kernel one launch an SpMV); the 32^3
   f64 4-part cell at K = N_BLOCK_MULTI in each lowering (SD with E2's
   boundary mode on slabs, BSR, forced ELL): the sequential backend's
   iterations per column, each column its solo solve on the card (bit for
   bit on BSR and ELL; on SD, where cuBLAS orders a K-column product its
   own way, to SD_X_REL_TOL and within SD_ITERATIONS_APART iterations of
   the solo and the sequential solves), launches by formula, graph
   against eager; strict block CG on
   48^3 (2,2,2) f64, STRICT_BLOCK_K ragged columns, each bit for bit the
   sequential backend's strict solo solve (launches: E1's slab and
   boundary forms 1 + 1, E3's block form 1 + 2 per device iteration),
   strict block Jacobi PCG on the 16^3 elasticity system on 4 parts, bit
   for bit, and strict block seconds per iteration per RHS at 192^3 f32, K
   = N_BLOCK, against phase 4f's strict solo (and a profile: E3's block
   form one kernel a dot); each slab form torch.equal to its plain version
   and to K launches of its frame form and timed at its path's shape (E2's
   at 64^3 f64 and E1's and E3's at 192^3 f32 strict, K = N_BLOCK, the
   boundary's at 32^3 f64 on 4 parts, K = N_BLOCK_MULTI; beside
   torch.sparse.mm on the (rows, K) slab, or torch.linalg.vecdot over the
   slab for E3);
4h. strict GMG-PCG, the Q1 FE model and the transient heat march:
   strict GMG-PCG (`pcg(Ah, bh, minv=h, strict=True)`: every level's A
   and S on the ELL lowering and the generic plan, E1 in both modes, E3's
   dots) on 12^3 and 48^3 (2,2,2) f64, decoupled, coarse_threshold 30 and
   500: the sequential strict solve's iterations, x and history within
   1e-12 (tests/test_torch_strict.py's tolerance: rounding, not bits),
   launches by formula (E1 1 + (1 + 4 L) and E3 1 + 3 per device
   iteration), the kernel path equal to the plain versions' path (so
   every E1 and E3 launch equals its plain version), E1 held on every
   level's A and S, graph against eager; the 192^3 f32 GMG hierarchy
   staged strict, E1 in both modes held on every level of it, its
   fixed-trip seconds per iteration against the default GMG-PCG's; the
   Q1 model (`fem_q1_driver` on (8,8) and (9,7), err < 1e-5; 512^2
   against the plain path; 1024^2 f64 on (2,2) through `assemble_fem_q1`
   and `cg`: assembly seconds with the COO migration apart, on the box
   and the generic plan the staging seconds, plan, lowering and decode,
   fixed-trip seconds per iteration and one solve to 1e-10; K1, K2, the
   boundary kernel and the sweep torch.equal to plain on its 9-diagonal
   operator's frames, K1 and K2 timed); the heat march
   (`heat_transient_driver` at 12^3 against the sequential march and the
   step-by-step march; 96^3 f64 on (2,2,2), 20 steps through the model's
   own functions: one staging, one solve function, one capture, each
   step's iterations and host-included seconds, launches by formula;
   every kernel held on the march's staged hierarchy; the last step
   through the plain versions and graph against eager; a later step's
   split between host sections and device time); the card's peak
   memory;
4i. the rest of the Krylov family (`parallel/gpu_krylov.py`, FGMRES-GMG)
   and the advection FV model (`models/advection_fv.py`): at 192^3 f64 on
   one part (the main cell's width, the JAX driver's velocity (1, 1.5, 2),
   D = 1) `advection_fv_driver`'s BiCGStab (tol 1e-12, maxiter 4000; error < 1e-5),
   right-Jacobi BiCGStab and GMRES(30) at a fixed maxiter (GMRES_MAXITER,
   the relative residual it reaches), each with K1 launches by formula
   (BiCGStab 1 + 2 per device iteration, GMRES 1 + 31 per cycle), the
   plain path's iterations and x (to 1e-12 of max |x|), graph against
   eager and fixed-trip seconds per iteration; a profile of a BiCGStab
   block split between K1 and the eager ops; K1 on the operator
   torch.equal to its plain version and timed (`advection_kernel_times`);
   at 48^3 f64 on (2,2,2) stacked parts `advection_fv_driver` on the box
   plan (K1 and E1's boundary mode by formula, both held against their
   plain versions) and `gpu_bicgstab` on the generic plan against the
   sequential backend (both converged, |Δ iterations| <= 2, errors < 1e-5,
   |Δ error| < 1e-8: tests/test_advection_fv.py:33-47 of the JAX
   package); on phase 2b's decoupled 192^3 f32 operator and hierarchy
   MINRES to 1e-5 beside CG's iterations, Chebyshev with the bounds of
   `lanczos_bounds` (at most CHEB_MAXITER iterations, the residual it
   reaches) and FGMRES-GMG (restart 10, tol 1e-5) beside GMG-PCG's
   iterations and seconds per iteration, launches by `gmg_launches` per
   Arnoldi step (`fgmres_gmg_launches`), each with the plain path and
   graph against eager (FGMRES-GMG over three fixed cycles); FGMRES-GMG on
   the 48^3 f64 (2,2,2) hierarchy against the host `fgmres(minv=h)`
   (|Δ iterations| <= 1, tests/test_gmg.py:360); the differentiable solve
   on a decoupled 48^3 f64 (2,2,2) Poisson: one forward and one backward on
   one cached solve function (one capture), the vector-Jacobian product
   torch.equal to a forward solve of the cotangent and a central finite
   difference along a seeded direction within DIFF_FD_RTOL;
4k. the resilience layer (`phase_resilience`): the SDC defense of the CG
   loops (`parallel/gpu_sdc.py`) at 192^3 f32 on phase 3's operator
   (generic plan) and on phase 2b's 48^3 f64 (2,2,2) system (clean solves
   torch.equal to the undefended ones, faults detected, rolled back and
   healed bit for bit, escalation, launches and exchanges a trip, block
   CG), NonFiniteError on a NaN in b, and the recovery drivers
   (`solve_with_recovery` in chunks, `resume_solve` on the sequential
   backend from the card's checkpoint);
4l. the serving path (`phase_serving`): the α/β trace ring of the CG loops
   on phase 3's operator, fused and standard, at depths RING_FULL (the
   whole solve) and RING_ROLLED (wrapped): x, rs, history and iterations
   torch.equal to the untraced solve, the graph loop's ring torch.equal to
   the eager loop's, the counted launches equal with and without the
   ring, seconds per iteration traced and untraced (fixed trips) and the
   ring's device ms an iteration (profiles); κ̂ against
   `poisson_fdm_analytic_extremes` at 192^3 f32 and on phase 2b's 48^3 f64
   (2,2,2) system (rolled ring), reported; the block ring of `cg(B=...)`
   at K = 8, each column's α/β torch.equal to its solo solve's; and
   `SolveService` at 192^3 f32: N_SERVE requests b_k = A x̂_k, request
   SERVE_POISON with a NaN in b and no retry, drained in a slab of 8 and
   a ragged slab of 1 (launches a slab by formula), the poisoned request
   failing NonFiniteError with one ``column_ejected`` event, every
   completed request's x torch.equal to its solo solve; the 8 clean
   requests again through the worker thread, submitted while it runs,
   the same bits; a chunked slab (deadlines, chunk SERVE_CHUNK)
   converging against the original target; captures and capture
   seconds, the throughput model's s/iteration a right-hand side against
   the solo solve's, the p50 of queue wait and solve seconds;
4m. the front door (`phase_frontdoor`): a `frontdoor.Gate` over two
   tenants, phase 3's 192^3 f32 operator (kmax 8) and phase 2b's 48^3 f64
   (2,2,2) system (kmax 4), under a memory budget that holds one of them,
   so alternating traffic pages them out and in (seconds, captures and the
   card's allocated/reserved bytes around each eviction; the structural
   footprint beside the bytes each tenant's first slab added); a paused
   backlog of GATE_P48 interactive requests with deadlines and GATE_P192
   batch requests (one with a NaN in b) at the shed watermark: a
   besteffort burst shed with `LoadShedded` (not `AdmissionRejected`), a
   duplicate idempotency key replayed (no second admission); EDF runs the
   interactive tenant first; the NaN request fails `NonFiniteError` and its
   7 neighbours are `torch.equal` to their solo solves; the block kernels'
   launches in each 192^3 slab by formula; per-RHS s/iteration of a steady
   K = 8 slab through the gate against a bare `SolveService`'s; a traced
   solo fused CG (K1 once, K2 each device iteration) measures the spectrum
   and an infeasible deadline is refused with `DeadlineInfeasible` at the
   door (no launch, no admission); both tenants resident with worker
   threads capture at once and take turns on the card (their slabs never
   overlap, their results their solo solves); GATE_HTTP requests over
   `GateServer` on 127.0.0.1 through `http_solve`, each bit for bit its
   in-process result (HTTP overhead a request); a journaled gate (fsync)
   dropped with one request completed, one in flight after one chunk and
   one queued, and `recover()` on a new gate: the recorded result bit for
   bit, the in-flight request resumed from its chunk checkpoint, the queued
   one re-entered, each once (journal append p50); two gates of a fleet
   with leases, one stops heartbeating with two requests queued and the
   survivor adopts its journal: zero lost, zero duplicated (`adopt()`
   seconds). `tools/run_phase_4m.py` runs this phase alone;
4n. the observability consoles (`phase_observability`), no new assembly:
   with records persisted to a temporary directory, the comms accounting of
   8 solves (phase 3's fused CG at 192^3; on phase 2b's 48^3 f64 (2,2,2)
   system fused, standard, generic-plan, pipelined, ABFT-defended, s-step
   s = 2 and K = 8 block CG, `OBS_CASES`): each record's ``comms`` (the
   model) against the solve function's counted program, no mismatch, and
   each body's kernel launched by formula (K2, K1, K3, the coded SpMM);
   `patrace` renders and lists the records; the exchange cost matrix of the
   48^3 system on the box and the generic plan, static and measured (each
   box direction and each generic round its own CUDA-graph chain, the
   whole exchange beside them), reconciled; the phase profile of fused CG
   at 192^3 and on both plans at 48^3 (2,2,2), by the `torch.profiler`
   trace (forced: a trace with no device time fails) and by the
   split-timer, each in its band and reconciled; `paprof --profile`,
   `pamon --check` and `paspec --check` in-process on the card.
   `tools/run_phase_4n.py` runs this phase alone;
4o. the elastic tier (`phase_elastic_shrink`): 192^3 f32 Poisson on (2,2,2)
   stacked parts (the bench.py workload, assembled here) solved clean, then
   by `solve_with_recovery` in chunks of ELASTIC_EVERY with part 6 lost at
   the third chunk's host exchange, the elastic config and the plan
   verifier's build-site gate on: the shrink 8 -> 4 from the checkpoint at
   200, converged with no restart, its error against x̂ within
   ELASTIC_ERR_FACTOR of the clean solve's, x torch.equal to a cold `cg` on
   the survivors from the same checkpointed iterate, the survivors' generic
   plan (2 colour rounds) verified at its build, K1 once, K2 and the sweep
   once per device iteration and E1's boundary mode with every SpMV of the
   resume, the event trail, grow-back on the next 8-part solve, and with the
   config off a typed `PartLossError` and no restart; the survivors'
   lowering and plan, the seconds of the host repartition, the plan
   verification, the staging and the capture, the resume's fixed-trip
   s/iteration against the 8-part solve's; K1, K2 and E1's boundary mode
   on the survivors torch.equal to plain and timed (library: torch.sparse.mm
   of the parts' block-diagonal A_oo, A_oh); the same ladder on phase 2b's
   48^3 f64 (2,2,2) system (x within RECOVERY_X_RTOL of the clean solve,
   the cold solve on a fresh repartition), that system's staged box and
   generic plans verified sound and one seeded defect of each check class
   caught; `pagate`, `padur`, `pafleet` and `paelastic --check --device
   cuda` in-process. `tools/run_phase_4o.py` runs this phase alone, and
   then the three `--drill`s on the card;
4p. the native host planner (`phase_planner`; `native/planning.cpp`, built
   by g++ beside the kernels in phase 1, which prints the compiler's
   version and the library's path): phase 2b's 48^3 f64 (2,2,2) system
   assembled on the COO-free route (the default, which every phase above
   assembles through) and on the COO route (`native.STENCIL_FAST` off):
   the global triplets equal bit for bit, b, x̂ and x0 within 1e-12 on
   their owned values, and the COO-free system's fused CG (K1 once, K2
   and the sweep once per device iteration, E1's boundary mode with every
   SpMV) within phase 2b's error gate, its iterations beside the COO
   route's; the main cell's assembly, hierarchy and staging seconds
   (phases 3 and 2b) with ``planner: "native"``;
5. times by CUDA events (median of 50 launches after warm-up, L2 flushed
   before each, and a spin queued after the flush so that no host launch
   latency falls inside the timed span): kernel, plain version,
   torch.sparse.mm on the CSR operator, the bound (bytes over 3.35 TB/s,
   operations over 67 TFLOP/s f32) and each kernel's share of its bound,
   for the four DIA kernels; the sweep (its plain version, the eager ops
   it replaces, its bound: x, p, r, q read and x, r written); fused,
   pipelined and standard CG and GMG-PCG (both routes) seconds per
   iteration from two fixed-trip solves each, in the graph and the eager
   loop (each function's first call, the capture, outside the timed span),
   and torch.profiler breakdowns of a fixed-trip CG and GMG-PCG iteration
   (both routes; fused CG and the stencil route also in the eager loop) by
   kernel, per device iteration (wall times include the profiler's own
   cost); an
   empty kernel's µs on the same timer (the launch floor), one line per
   coded GMG operator at 192^3 (the structured route's): its shape and
   band-sum instance, launches per solve, the coded kernel's flushed,
   warm-L2 and back-to-back µs, its plain version's and torch.sparse.mm's
   µs, the empty kernel launched as the coded kernel is, and the bound
   rows x (2 x 4 B + code bytes) over 3.35 TB/s; and one line per stencil
   level of both GMG hierarchies (192^3 f32, 48^3 f64 on (2,2,2) parts):
   the form the stencil kernel takes there, its grid, threads, planes a
   CTA, registers, shared memory and CTAs an SM, its flushed and
   back-to-back µs, the other form's flushed µs, its plain version's,
   conv3d of the extended boxes with the fixed 3x3x3 weight (cuDNN, TF32
   off), and the bound (the owned box read and the result written); one
   ``dia_stream_level`` line per streaming level of both hierarchies (the
   form its shape takes, vector loads, the unrolled sum, both forms'
   flushed µs, the plain version's, torch.sparse.mm's on one part, the
   bound: values, x and y) and one ``vcycle_epilogue_level`` line per
   level and mode of both (flushed µs, the plain version's, the bound;
   torch.sparse.mm on the stacked parts' block-diagonal CSR where a level
   has several); K2 with minv and the precond sweep at Jacobi PCG's shapes
   and the block kernels at K = 8 (`jacobi_kernel_times`,
   `block_kernel_times`: torch.sparse.mm of the operator's CSR on the
   (rows, 8) slab for the SpMMs);
6. the launch counts of phases 3, 3b, 4b, 4d and 4e (the sweep's of phase
   3).

In the kernels line, K4's times are level 1's of 192^3 (its stream form)
and the epilogue's level 0's smooth mode of 192^3; E1's and E2's A_oo
times the elasticity operator's at 64^3 f32, their boundary modes' the
4-part 32^3 f64 cell's (every call of one SpMV), E3's a 192^3 f32 dot.
Each new kernel's launches come from the path it runs on: E2 from the
64^3 elasticity solve, E2's boundary from the 4-part SD solve, E1 in both
modes and E3 from the 48^3 strict solve; the slab forms from phase 4g's
paths (E2's from the 64^3 block PCG, E2's boundary mode on slabs from the
4-part SD block PCG: the one boundary kernel's launches in that run, E1's
and E3's from the 48^3 strict block CG), their times at the shapes above
(K = 8; the boundary's K = 4, its path's).

It then prints the kernel table, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``. Any failed check exits non-zero; with no
CUDA device it exits non-zero before printing a result.
"""
import contextlib
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from partitionedarrays_jl_tpu_torch import (  # noqa: E402
    PSparseMatrix, PVector, add_gids, additive_schwarz, advection_fv_driver, assemble_advection_fv, assemble_poisson,
    bicgstab, cartesian_partition, cg, chebyshev_solve, decouple_dirichlet, fgmres, gather_pvector, gmg_hierarchy,
    gmg_solve, gmres, gpu_bicgstab, gpu_chebyshev, gpu_gmres, gpu_minres, jacobi_preconditioner, lanczos_bounds,
    lobpcg, make_diff_solve_fn, map_parts, minres, no_ghost, pcg, poisson_fdm_driver, prun, sequential,
)
from partitionedarrays_jl_tpu_torch.ops import dia  # noqa: E402
from partitionedarrays_jl_tpu_torch.ops.sparse import CSRMatrix  # noqa: E402
from partitionedarrays_jl_tpu_torch.parallel import gpu_gmg  # noqa: E402
from partitionedarrays_jl_tpu_torch.parallel.gpu import (  # noqa: E402
    GPUBackend,
    device_exchange_plan,
    device_layout,
    device_matrix,
    exchange_,
    gpu_cg,
    make_block_cg_fn,
    make_cg_fn,
    make_spmv_fn,
    _b_on_cols_layout,
    _block_on_cols_layout,
    DeviceVector,
)
from partitionedarrays_jl_tpu_torch.parallel.prange import p_cartesian_indices  # noqa: E402

N_MAIN = 192
N_MULTI = 48
TOL_MAIN = 1e-5
REPS = 50
SPIN_CYCLES = 1_000_000  # ~0.5 ms at the H100's clock: longer than a launch's host cost
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published
F64_FLOPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores, published
SEED = 0

N_GMG_MULTI = 48
GMG_LEVELS = 5  # 192, 96, 48, 24, 12 over a 6^3 coarse grid
GMG_ITERATIONS = 7  # 192^3 f32 GMG-PCG to TOL_MAIN on either route

GMG_TRIPS = (4, 24)  # fixed trips of the GMG-PCG seconds per iteration (2 and 12 drowned in host jitter)
CG_TRIPS = (20, 220)  # fixed trips of the CG, Jacobi PCG and block seconds per iteration
N_BLOCK = 8  # right-hand sides of the block phase

N_ELASTIC = 64  # tet-elasticity nodes a dimension: the JAX package's largest irregular size
N_ELASTIC_MULTI = 32  # the stacked-parts elasticity cell (4 parts)
TOL_ELASTIC = 1e-12  # elasticity_tet_driver's tolerance
ELASTIC_MAXITER = 3000  # elasticity_tet_driver's maxiter
N_STRICT_ELASTIC = 16  # strict elasticity PCG on 4 parts, against the sequential backend on the host
N_BLOCK_MULTI = 4  # right-hand sides of the 4-part block cell (each also solved on the host: ~8 s a column)
STRICT_BLOCK_K = 3  # ragged columns of the strict (2,2,2) block CG
#: strict GMG-PCG on (2,2,2) f64: (n, coarse_threshold) cases, the solve's
#: tolerance, and the agreement with the sequential strict solve that
#: tests/test_torch_strict.py states (rounding: not bits)
STRICT_GMG_CASES = ((12, 30), (12, 500), (48, 30), (48, 500))
TOL_STRICT_GMG = 1e-10
GMG_STRICT_RTOL = 1e-12
N_Q1 = 1024  # Q1 nodes a dimension (1,048,576 DOFs, f64, (2,2) parts; 2048^2 until the time budget of phase 4i)
N_Q1_CHECK = 512  # the Q1 cell held against the plain path
TOL_Q1 = 1e-10
Q1_MAXITER = 20000
N_HEAT = 96  # heat march cells a dimension (f64, (2,2,2) parts; 128^3 until the time budget of phase 4i)
HEAT_DT = 2.0
HEAT_STEPS = 20
TOL_HEAT = 1e-10
HEAT_CT = 500  # the march's coarse_threshold
N_ADV = 192  # the advection FV model on one part (f64, 7,077,888 DOFs), the main cell's width
N_ADV_MULTI = 48  # the advection model on (2,2,2) stacked parts (f64)
TOL_ADV = 1e-12  # advection_fv_driver's tolerance
ADV_MAXITER = 4000  # advection_fv_driver's maxiter
BICG_TRIPS = (20, 220)  # fixed trips of the BiCGStab seconds per iteration (blocks of 8)
GMRES_RESTART = 30
GMRES_MAXITER = 300  # GMRES(30) on the advection operator: ten cycles, the residual it reaches reported
GMRES_TRIPS = (60, 180)  # two and six cycles
CHEB_MAXITER = 1600  # Chebyshev at 192^3 f32: 100 legs at most
CHEB_TRIPS = (32, 352)  # two and 22 legs
FGMRES_RESTART = 10
FGMRES_TRIPS = (20, 40)  # two and four cycles (a first run of one block captures no graph)
TOL_FGMRES_MULTI = 1e-9  # tests/test_gmg.py:360's tolerance, on the 48^3 f64 (2,2,2) hierarchy
N_DIFF = 48  # the differentiable solve's decoupled Poisson, f64 on (2,2,2)
TOL_DIFF = 1e-10
DIFF_EPS = 1e-2  # the central difference's step along a direction scaled to |b|
DIFF_FD_RTOL = 1e-5  # the finite difference against the vector-Jacobian product (the loss is quadratic in b)

#: the forms the kernels line lists; bsr_spmv_boundary_slab is E2's
#: boundary kernel on the slabs of the 4-part SD block PCG (one kernel takes
#: frames and slabs, and counts both under bsr_spmv_boundary: the entry's
#: launches are that count in the slab path's run)
KERNELS = ("dia_coded_spmv", "dia_coded_spmv_pfold", "dia_coded_spmv_axpy", "dia_stream_spmv",
           "box_stencil_apply", "cg_sweep", "vcycle_epilogue", "dia_coded_spmv_pfold_minv", "cg_sweep_precond",
           "cg_sweep_block", "dia_coded_spmm", "dia_stream_spmm", "block_products", "ell_spmv", "ell_spmv_boundary",
           "bsr_spmv", "bsr_spmv_boundary", "pairwise_dot", "ell_spmm", "bsr_spmm", "bsr_spmv_boundary_slab",
           "pairwise_dot_block")
SRC = {
    "dia_coded_spmv": "partitionedarrays_jl_tpu_torch/csrc/dia_coded.cu",
    "dia_coded_spmv_pfold": "partitionedarrays_jl_tpu_torch/csrc/dia_coded.cu",
    "dia_coded_spmv_axpy": "partitionedarrays_jl_tpu_torch/csrc/dia_coded.cu",
    "dia_stream_spmv": "partitionedarrays_jl_tpu_torch/csrc/dia_stream.cu",
    "box_stencil_apply": "partitionedarrays_jl_tpu_torch/csrc/box_stencil.cu",
    "cg_sweep": "partitionedarrays_jl_tpu_torch/csrc/cg_sweep.cu",
    "vcycle_epilogue": "partitionedarrays_jl_tpu_torch/csrc/vcycle_epilogue.cu",
    "dia_coded_spmv_pfold_minv": "partitionedarrays_jl_tpu_torch/csrc/dia_coded.cu",
    "cg_sweep_precond": "partitionedarrays_jl_tpu_torch/csrc/cg_sweep.cu",
    "cg_sweep_block": "partitionedarrays_jl_tpu_torch/csrc/cg_sweep.cu",
    "dia_coded_spmm": "partitionedarrays_jl_tpu_torch/csrc/dia_coded_block.cu",
    "dia_stream_spmm": "partitionedarrays_jl_tpu_torch/csrc/dia_stream_block.cu",
    "block_products": "partitionedarrays_jl_tpu_torch/csrc/cg_sweep.cu",
    "ell_spmv": "partitionedarrays_jl_tpu_torch/csrc/ell_spmv.cu",
    "ell_spmv_boundary": "partitionedarrays_jl_tpu_torch/csrc/ell_spmv.cu",
    "bsr_spmv": "partitionedarrays_jl_tpu_torch/csrc/bsr_spmv.cu",
    "bsr_spmv_boundary": "partitionedarrays_jl_tpu_torch/csrc/bsr_spmv.cu",
    "pairwise_dot": "partitionedarrays_jl_tpu_torch/csrc/pairwise_dot.cu",
    "ell_spmm": "partitionedarrays_jl_tpu_torch/csrc/ell_spmv.cu",
    "bsr_spmm": "partitionedarrays_jl_tpu_torch/csrc/bsr_spmv.cu",
    "bsr_spmv_boundary_slab": "partitionedarrays_jl_tpu_torch/csrc/bsr_spmv.cu",
    "pairwise_dot_block": "partitionedarrays_jl_tpu_torch/csrc/pairwise_dot.cu",
}
#: the TPU kernel each replaces; box_stencil_apply, cg_sweep and
#: vcycle_epilogue have none: they stand for the XLA fusions of the JAX
#: package's `_stencil_apply`, of the fused CG body's update sweep
#: (`step_fused`) and of the V-cycle's smoothing sweep and residual
#: (`_vcycle_shard_body`, the sweep at :604; init :596, residuals :616, :686);
#: K2 with minv the Pallas SpMV (:523) with the jnp fold beside it
#: (tpu.py:3289-3290, the kernel's own fold being off with a
#: preconditioner); the precond sweep the fused PCG body's odot2 sweep; the
#: block sweep and SpMMs the block program's sweep and the XLA forms its
#: SpMV takes on a (W, K) operand (`_dia_coded_xla`, `_dia_rowsum`); the
#: block products the products of its per-column p.q dot; E1 (ell_spmv)
#: the padded-ELL fold `_ell_rowsum` of the ELL lowering and of the
#: boundary-row A_oh; E2 (bsr_spmv) the BSR gather and einsum and the
#: node-block boundary finish; E3 (pairwise_dot) strict mode's dot; the
#: slab forms of E1-E3 the same XLA forms on the block program's (W, K)
#: operands (`_ell_rowsum` with `_bc`, einsum("nlij,nljk->nik"), the
#: node-block finish on slabs, `_strict_partial_any` per column)
REPLACES = {
    "dia_coded_spmv": "partitionedarrays_jl_tpu/ops/pallas_dia.py:523",
    "dia_coded_spmv_pfold": "partitionedarrays_jl_tpu/ops/pallas_dia.py:500",
    "dia_coded_spmv_axpy": "partitionedarrays_jl_tpu/ops/pallas_dia.py:535",
    "dia_stream_spmv": "partitionedarrays_jl_tpu/ops/pallas_dia.py:110",
    "box_stencil_apply": "partitionedarrays_jl_tpu/parallel/tpu_gmg.py:292",
    "cg_sweep": "partitionedarrays_jl_tpu/parallel/tpu.py:4090",
    "vcycle_epilogue": "partitionedarrays_jl_tpu/parallel/tpu_gmg.py:604",
    "dia_coded_spmv_pfold_minv": "partitionedarrays_jl_tpu/ops/pallas_dia.py:523",
    "cg_sweep_precond": "partitionedarrays_jl_tpu/parallel/tpu.py:4096",
    "cg_sweep_block": "partitionedarrays_jl_tpu/parallel/tpu.py:4883",
    "dia_coded_spmm": "partitionedarrays_jl_tpu/parallel/tpu.py:3006",
    "dia_stream_spmm": "partitionedarrays_jl_tpu/parallel/tpu.py:2960",
    "block_products": "partitionedarrays_jl_tpu/parallel/tpu.py:4881",
    "ell_spmv": "partitionedarrays_jl_tpu/parallel/tpu.py:2916",
    "ell_spmv_boundary": "partitionedarrays_jl_tpu/parallel/tpu.py:3232",
    "bsr_spmv": "partitionedarrays_jl_tpu/parallel/tpu.py:3143",
    "bsr_spmv_boundary": "partitionedarrays_jl_tpu/parallel/tpu.py:3204",
    "pairwise_dot": "partitionedarrays_jl_tpu/parallel/tpu.py:2486",
    "ell_spmm": "partitionedarrays_jl_tpu/parallel/tpu.py:2916",
    "bsr_spmm": "partitionedarrays_jl_tpu/parallel/tpu.py:3156",
    "bsr_spmv_boundary_slab": "partitionedarrays_jl_tpu/parallel/tpu.py:3222",
    "pairwise_dot_block": "partitionedarrays_jl_tpu/parallel/tpu.py:2501",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sync() -> None:
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_device():
    require(torch.cuda.is_available(), "no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t = time.perf_counter()
    # the host planner's g++ build beside the kernels' nvcc builds
    planner = {}
    th = threading.Thread(target=_build_planner, args=(planner,))
    th.start()
    dia.build_kernels()
    build_s = time.perf_counter() - t
    th.join()
    ptxas = _ptxas_lines(dia.BUILD_LOG)
    emit({
        "phase": "device", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas,
    })
    require("error" not in planner, f"the native planner did not build: {planner.get('error')}")
    emit({"phase": "planner_build", **planner})
    spills = {k: ls for k, ls in ptxas.items() if any(re.search(r"\b[1-9]\d* bytes spill", ln) for ln in ls)}
    require(not spills, f"ptxas spilled registers: {spills}")
    return smi


def _build_planner(out):
    """Build and load the native planner (`native/planning.cpp` by g++),
    recording the compiler's version, the library's path and seconds."""
    from partitionedarrays_jl_tpu_torch import native

    t = time.perf_counter()
    try:
        out["cxx"] = native.compiler_version()
        out["flags"] = list(native.CXX_FLAGS)
        if not native.available():
            raise RuntimeError("the native planner is off (native.ENABLED)")
        out["library"] = str(native.LIBRARY)
    except Exception as e:  # noqa: BLE001 - reported by phase_device
        out["error"] = f"{type(e).__name__}: {e}"
    out["build_s"] = time.perf_counter() - t


def _ptxas_lines(log):
    """ptxas's register, shared-memory and spill lines per kernel
    instantiation, e.g. ``dia_coded_kernel<float,0,27>`` (mode 0 = plain,
    the select-chain sum for 27 diagonals) or
    ``dia_stream_kernel<float,27,4,1,256>`` (27 diagonals, 4 rows a
    thread, vector loads, 256 threads) or ``vcycle_epilogue_kernel<float,2>``
    (mode 2, smooth); a kernel that is no template by its mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '_Z\d+(\w+?)I([fd])((?:Li\d+E)(?:L[ib]\d+E)*)E", line)
        if m:
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(3)))
            name = f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'},{args}>"
            continue
        m = re.search(r"entry function '_Z\d+(\w+?)I([fd])Lb([01])E", line)
        if m:
            name = f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'},{'true' if m.group(3) == '1' else 'false'}>"
            continue
        m = re.search(r"entry function '_Z\d+(\w+?)I([fd])E", line)
        if m:
            name = f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}>"
            continue
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and ("registers" in line or "spill" in line or "smem" in line):
            out.setdefault(name, []).append(line.split("ptxas info    :")[-1].strip())
    return out


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _compare(name, got, want):
    sync()
    equal = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    require(equal, f"{name}: kernel differs from its plain version (max |diff| {err})")
    return err


def _select_chain_operator(n, device, rng):
    """A synthetic select-chain operand at n^3 rows: the 7-point offsets,
    two constant and five coded diagonals with 2..5 codebook values."""
    rows = n ** 3
    offsets = (-n * n, -n, -1, 0, 1, n, n * n)
    kk = (1, 3, 2, 5, 2, 3, 1)
    code_row = (-1, 0, 1, 2, 3, 4, -1)
    codes = np.zeros((5, rows), dtype=np.uint8)
    for d, k in enumerate(kk):
        if k > 1:
            codes[code_row[d]] = rng.integers(0, k, rows)
    cb = rng.standard_normal((1, 7, 5)).astype(np.float32)
    packed = dia.pack_nibble_codes(codes).view(np.uint8)
    return dia.CodedOperator(
        cb=torch.from_numpy(cb).to(device),
        no=torch.tensor([rows], dtype=torch.int32, device=device),
        codes=torch.from_numpy(np.ascontiguousarray(packed[None])).to(device),
        offsets=offsets, kk=kk, code_row=code_row, cls_pattern=None, o0=0,
    )


def _row_class_operator(n, device, rng):
    """A synthetic row-class operand at n^3 rows: the 7-point offsets, an
    interior class with random coefficients and an identity class, mixed
    at random over the rows."""
    rows = n ** 3
    offsets = (-n * n, -n, -1, 0, 1, n, n * n)
    cb = np.zeros((1, 7, 2), dtype=np.float32)
    cb[0, :, 0] = rng.standard_normal(7)
    cb[0, 3, 1] = 1.0
    codes = rng.integers(0, 2, (1, 1, rows)).astype(np.uint8)
    return dia.CodedOperator(
        cb=torch.from_numpy(cb).to(device),
        no=torch.tensor([rows], dtype=torch.int32, device=device),
        codes=torch.from_numpy(codes).to(device),
        offsets=offsets, kk=(2,) * 7, code_row=(0,) * 7,
        cls_pattern=((True,) * 7, tuple(d == 3 for d in range(7))), o0=0,
    )


def _hold_all(tag, o, x, r, pprev, beta, xacc, alpha, wy, errs):
    """K1, K2 (y and p) and K3 (y and xacc) on one operand against their
    plain versions, each torch.equal; the max |diff| lands in errs."""
    errs[f"dia_coded_spmv[{tag}]"] = _compare(
        f"dia_coded_spmv {tag}", dia.dia_coded_spmv(o, x, wy), dia.dia_coded_spmv_plain(o, x, wy)
    )
    yk, pk = dia.dia_coded_spmv_pfold(o, r, pprev, beta, wy)
    yp, pp = dia.dia_coded_spmv_pfold_plain(o, r, pprev, beta, wy)
    errs[f"dia_coded_spmv_pfold[{tag},y]"] = _compare(f"dia_coded_spmv_pfold {tag} y", yk, yp)
    errs[f"dia_coded_spmv_pfold[{tag},p]"] = _compare(f"dia_coded_spmv_pfold {tag} p", pk, pp)
    xk, xp = xacc.clone(), xacc.clone()
    yk = dia.dia_coded_spmv_axpy(o, x, xk, pprev, alpha, wy)
    yp = dia.dia_coded_spmv_axpy_plain(o, x, xp, pprev, alpha, wy)
    errs[f"dia_coded_spmv_axpy[{tag},y]"] = _compare(f"dia_coded_spmv_axpy {tag} y", yk, yp)
    errs[f"dia_coded_spmv_axpy[{tag},xacc]"] = _compare(f"dia_coded_spmv_axpy {tag} xacc", xk, xp)


def _hold_sweep(tag, x, r, p, q, n, errs):
    """The CG update sweep (both modes, the flag 1 and 0) torch.equal to
    its plain version on copies of the frames: x, r, the partials and rs;
    the max |diff| lands in errs."""
    from partitionedarrays_jl_tpu_torch.ops import sweep as sw

    alpha = torch.tensor(0.0625, dtype=r.dtype, device=r.device)
    for live in (1, 0):
        flag = torch.tensor(live, dtype=torch.int32, device=r.device)
        for mode in ("x_and_r", "r_only"):
            outs = []
            for k in (sw.cg_sweep, sw.cg_sweep_plain):
                xc, rc = x.clone(), r.clone()
                part = torch.full((r.shape[0], sw.chunks(n)), 0.5, dtype=r.dtype, device=r.device)
                kw = {"x": xc, "p": p} if mode == "x_and_r" else {}
                rs = k(rc, q, alpha, flag, part, 0, n, **kw)
                outs.append((xc, rc, part, rs))
            for what, a, b in zip(("x", "r", "partials", "rs"), *outs):
                errs[f"cg_sweep[{tag},{mode},live={live},{what}]"] = _compare(
                    f"cg_sweep {tag} {mode} live={live} {what}", a, b)
            if not live:
                require(torch.equal(outs[0][0], x) and torch.equal(outs[0][1], r),
                        f"cg_sweep {tag}: the kernel wrote with the flag 0")


def _hold_axpy_guard(tag, o, x, pprev, xacc, alpha, wy, errs):
    """K3 with its device flag 1 and 0 torch.equal to its plain version (y
    and the updated solution); with the flag 0 the solution is untouched."""
    for live in (1, 0):
        flag = torch.tensor(live, dtype=torch.int32, device=x.device)
        xk, xp = xacc.clone(), xacc.clone()
        yk = dia.dia_coded_spmv_axpy(o, x, xk, pprev, alpha, wy, flag)
        yp = dia.dia_coded_spmv_axpy_plain(o, x, xp, pprev, alpha, wy, flag)
        errs[f"dia_coded_spmv_axpy[{tag},live={live},y]"] = _compare(f"guarded axpy {tag} live={live} y", yk, yp)
        errs[f"dia_coded_spmv_axpy[{tag},live={live},xacc]"] = _compare(
            f"guarded axpy {tag} live={live} xacc", xk, xp)
        if not live:
            require(torch.equal(xk, xacc), f"guarded axpy {tag}: the solution changed with the flag 0")


def phase_kernels(backend, n, rng):
    """Every kernel of the path against its plain version on the card, at
    the main path's shapes. Returns the operands for the timing phase."""
    A, _, _, _ = prun(
        lambda parts: assemble_poisson(parts, (n, n, n), dtype=np.float32), backend, (1, 1, 1)
    )
    dA = device_matrix(A, backend)
    require(dA.dia_cls_pattern is not None, "the 192^3 Poisson operator did not take row-class mode")
    dev = backend.device
    op = dA.coded
    wx, wy = dA.col_layout.W, dA.row_layout.W

    def frame():
        return torch.from_numpy(rng.standard_normal((1, wx)).astype(np.float32)).to(dev)

    x, r, pprev, xacc = frame(), frame(), frame(), frame()
    beta = torch.tensor(0.37, dtype=torch.float32, device=dev)
    alpha = torch.tensor(-0.61, dtype=torch.float32, device=dev)
    errs = {}
    _hold_all("row_class", op, x, r, pprev, beta, xacc, alpha, wy, errs)
    _hold_axpy_guard("row_class", op, x, pprev, xacc, alpha, wy, errs)
    _hold_sweep(f"{n}^3 f32", x, r, pprev, xacc, dA.row_layout.no_max, errs)
    _hold_all("select_chain", _select_chain_operator(n, dev, rng), x, r, pprev, beta, xacc, alpha, wx, errs)
    # the odd size: every window starts off 16-byte alignment, the last
    # tile is ragged, and the frames are wider than the band (wx != wy)
    m = n + 1
    rows = m ** 3

    def odd_frame():
        return torch.from_numpy(rng.standard_normal((1, rows + 5)).astype(np.float32)).to(dev)

    ox, orr, opp, oxa = odd_frame(), odd_frame(), odd_frame(), odd_frame()
    for decode, make in (("row_class", _row_class_operator), ("select_chain", _select_chain_operator)):
        _hold_all(f"{decode},{m}^3", make(m, dev, rng), ox, orr, opp, beta, oxa, alpha, rows + 3, errs)
    del ox, orr, opp, oxa
    plans = {
        mode: {"tile": pl.tile, "windows": len(pl.windows), "smem_bytes": pl.smem_bytes}
        for mode in ("plain", "pfold", "axpy")
        for pl in [dia.plan_coded_windows(tuple(map(int, op.offsets)), 4, mode, op.codes.shape[1], op.cb.shape[2],
                                          n_cls=len(op.cls_pattern or ()))]
    }
    emit({"phase": "kernels_vs_plain", "n": n, "odd_n": m, "dtype": "float32", "equal": True,
          "max_abs_err": errs, "window_plans": plans})
    return {"A": A, "dA": dA, "x": x, "r": r, "pprev": pprev, "beta": beta, "xacc": xacc,
            "alpha": alpha, "errs": errs}


# ---------------------------------------------------------------------------
# phase 2b
# ---------------------------------------------------------------------------


def _other_form(op, dtype):
    """The operand bound to the kernel form its shape does not take, or
    None for a checkout with one form."""
    from partitionedarrays_jl_tpu_torch.ops import stencil as stn

    if not hasattr(stn, "FORMS"):
        return None
    form = op.launch[dtype][2].form
    return stn.bind_kernel(op, form=next(f for f in stn.FORMS if f != form))


def _stencil_check(lv, rng, name):
    """The box stencil kernel torch.equal to its plain version on a stencil
    level, in the form its shape takes and in the other form: a random
    frame, its ghost segments refreshed by the level's box exchange."""
    from partitionedarrays_jl_tpu_torch.ops import stencil as stn

    op = lv["stencil"]
    x = torch.from_numpy(rng.standard_normal((op.table.shape[0], op.W))).to(op.table.device, lv["dinv"].dtype)
    exchange_(lv["dA"].col_plan, x)
    want = stn.box_stencil_apply_plain(op, x)
    other = _other_form(op, x.dtype)
    return max(_compare(f"box_stencil_apply {name}", stn.box_stencil_apply(op, x), want),
               _compare(f"box_stencil_apply {name} (other form)", stn.box_stencil_apply(other, x), want))


def stage_routes(h, backend):
    """Stage a hierarchy on the default routes: the level operators first,
    then the transfers; seconds of each (the structured route's staging is
    timed in phase 4b', on the operators this one cached)."""
    t = time.perf_counter()
    for lvl in h.levels:
        device_matrix(lvl.A, backend)
    sync()
    operators_s = time.perf_counter() - t
    t = time.perf_counter()
    dh = gpu_gmg.device_hierarchy(h, backend)
    sync()
    return dh, {"operators_s": operators_s, "default_transfers_s": time.perf_counter() - t}


def phase_stencil_kernels(backend, rng):
    """The two GMG hierarchies of the run, staged on the default routes, and
    the box stencil kernel held on every stencil level of both."""
    runs = {
        "main": prun(gmg_driver, backend, (1, 1, 1), N_MAIN, True),
        "multi": prun(gmg_driver, backend, (2, 2, 2), N_GMG_MULTI, False),
    }
    errs, line = {}, {"phase": "stencil_kernel_vs_plain"}
    for key, run in runs.items():
        run["dh"], run["staging_s"] = stage_routes(run["h"], backend)
        routes = [gpu_gmg.route(lv) for lv in run["dh"]["levels"]]
        for li, lv in enumerate(run["dh"]["levels"]):
            if routes[li] == "stencil":
                errs[f"{key} S{li}"] = _stencil_check(lv, rng, f"{key} level {li}")
        line[key] = {"routes": routes, "grids": [lvl.nfs for lvl in run["h"].levels],
                     "dtype": str(run["dh"]["levels"][0]["dinv"].dtype), **run["staging_s"]}
    emit({**line, "equal": True, "max_abs_err": errs})
    require(line["main"]["routes"] == ["stencil"] * GMG_LEVELS,
            f"192^3 GMG routes {line['main']['routes']}, expected the stencil route on all {GMG_LEVELS} levels")
    require(any(r == "stencil" for r in line["multi"]["routes"]), "48^3 stacked GMG: no level on the stencil route")
    return runs, max(errs.values())


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def _rel_err(x, xe):
    return float((x - xe).norm() / xe.norm())


def main_driver(parts, n, tol):
    t = time.perf_counter()
    A, b, xe, x0 = assemble_poisson(parts, (n, n, n), dtype=np.float32)
    t_asm = time.perf_counter() - t
    t = time.perf_counter()
    device_matrix(A, parts.backend)
    sync()
    t_low = time.perf_counter() - t
    t = time.perf_counter()
    x, info = cg(A, b, x0=x0, tol=tol)
    t_solve = time.perf_counter() - t
    return {"A": A, "b": b, "xe": xe, "x0": x0, "info": info, "err": _rel_err(x, xe),
            "assembly_s": t_asm, "lowering_s": t_low, "solve_s": t_solve}


def device_iterations(info):
    """The iterations a solve's device loop ran: whole blocks, the frozen
    iterations after the stop included."""
    return info["device_loop"]["device_iterations"]


def graph_vs_eager(path, make_fn, b, x0, *args, per_step=None):
    """One solve through the device-resident loop replayed as CUDA graphs
    and through the same loop run eagerly on the card (``graph=False``): x
    torch.equal, equal iterations, rs and history (NaN past the last
    iteration in both); the graph loop's block, device iterations, replays
    and capture seconds. ``make_fn(graph)`` builds the solve function,
    called as ``fn(b, x0, *args)``; a block solve's iterations are per
    column (the line holds the most). The loops of CG, block CG and
    GMG-PCG compute their flag at the top of a step, so the device runs
    ``block`` * (iterations // block + 1) steps; those of `gpu_krylov.py`
    and FGMRES-GMG (``per_step``: the iterations a step takes, a Chebyshev
    leg or a restart cycle) at its end, so ``block`` * ceil(steps / block)
    with steps = ceil(iterations / per_step)."""
    fe, fg = make_fn(False), make_fn(True)
    xe, rse, _, ite, he = fe(b, x0, *args)
    xg, rsg, _, itg, hg = fg(b, x0, *args)
    sync()
    st = fg.stats
    equal = {"x": bool(torch.equal(xg, xe)), "rs": bool(torch.equal(rsg, rse)),
             "history": bool(np.array_equal(hg, he, equal_nan=True)),
             "iterations": bool(np.array_equal(np.asarray(itg), np.asarray(ite)))}
    itg, ite = int(np.max(itg)), int(np.max(ite))
    line = {"phase": "loop_graph_vs_eager", "path": path, "iterations": itg, "eager_iterations": ite,
            "block": st["block"], "device_iterations": st["device_iterations"], "replays": st["replays"],
            "capture_s": st["capture_s"], "equal": equal}
    if per_step is None:
        want = st["block"] * (itg // st["block"] + 1)
    else:
        line["iterations_a_step"] = per_step
        steps = -(-itg // per_step)
        want = st["block"] * -(-steps // st["block"])
    emit(line)
    require(st["loop"] == "graph" and fe.stats["loop"] == "eager", f"{path}: loop forms {st['loop']}, "
            f"{fe.stats['loop']}")
    require(itg == ite and all(equal.values()), f"{path}: graph and eager solves differ: {line}")
    require(st["device_iterations"] == want,
            f"{path}: {st['device_iterations']} device iterations for {itg} in blocks of {st['block']}")
    require(st["replays"] > 0, f"{path}: the graph loop replayed no block")
    return line


def staged(run, backend, box=True):
    """b and x0 of a run staged in the column frame of A's lowering."""
    dA = device_matrix(run["A"], backend, box)
    return _b_on_cols_layout(run["b"], dA), DeviceVector.from_pvector(run["x0"], backend, dA.col_layout).data


def phase_main(backend, n):
    dia.reset_launches()
    run = prun(main_driver, backend, (1, 1, 1), n, TOL_MAIN)
    launches = dict(dia.LAUNCHES)
    info = run["info"]
    dev_it = device_iterations(info)
    want = {"dia_coded_spmv": 1, "dia_coded_spmv_pfold": dev_it, "cg_sweep": dev_it}
    t = time.perf_counter()
    xp, info_p = gpu_cg(run["A"], run["b"], x0=run["x0"], tol=TOL_MAIN, plain=True)
    t_plain = time.perf_counter() - t
    err_p = _rel_err(xp, run["xe"])
    emit({
        "phase": "main_path", "n": n, "dofs": n ** 3, "dtype": "float32", "parts": 1,
        "tol": TOL_MAIN, "assembly_s": run["assembly_s"], "lowering_s": run["lowering_s"],
        "solve_s": run["solve_s"], "iterations": info["iterations"], "converged": info["converged"],
        "cg_body": info["cg_body"], "rel_err": run["err"], "plain_iterations": info_p["iterations"],
        "plain_rel_err": err_p, "plain_solve_s": t_plain, "device_loop": info["device_loop"],
        "kernels": launches, "expected_launches": want,
    })
    require(info["cg_body"] == "fused", "the main path did not run the fused CG body")
    require(info["device_loop"]["loop"] == "graph", "the main path did not run the graph loop")
    for k in want:
        require(launches[k] == want[k], f"main path: {launches[k]} {k} launches, expected {want[k]}")
    run["b_dev"], run["x0_dev"] = staged(run, backend)
    dA = device_matrix(run["A"], backend)
    maxiter = 4 * run["A"].rows.ngids
    line = graph_vs_eager(f"{n}^3 f32 fused CG", lambda g: make_cg_fn(dA, TOL_MAIN, maxiter, graph=g),
                          run["b_dev"], run["x0_dev"])
    require(line["iterations"] == info["iterations"], "fused CG: the graph-vs-eager solve took other iterations")
    require(info["converged"] and np.isfinite(run["err"]), "the 192^3 solve did not converge")
    require(info["iterations"] == info_p["iterations"], "kernel and plain paths took different iterations")
    require(run["err"] <= 1.1 * err_p, "kernel path error above 1.1x the plain path's")
    return run, launches


# ---------------------------------------------------------------------------
# phase 3b
# ---------------------------------------------------------------------------


def phase_pipelined(backend, run):
    """Pipelined CG on the main path's operator and cached lowering: its
    own launch counts, the plain path's and the standard body's
    iterations."""
    A, b, x0 = run["A"], run["b"], run["x0"]
    dia.reset_launches()
    t = time.perf_counter()
    x, info = cg(A, b, x0=x0, tol=TOL_MAIN, pipelined=True)
    sync()
    solve_s = time.perf_counter() - t
    launches = dict(dia.LAUNCHES)
    err = _rel_err(x, run["xe"])
    xp, info_p = gpu_cg(A, b, x0=x0, tol=TOL_MAIN, pipelined=True, plain=True)
    err_p = _rel_err(xp, run["xe"])
    dia.reset_launches()
    _, info_s = gpu_cg(A, b, x0=x0, tol=TOL_MAIN, fused=False)
    launches_s = dict(dia.LAUNCHES)
    it = info["iterations"]
    dev_it, dev_it_s = device_iterations(info), device_iterations(info_s)
    want = {"dia_coded_spmv": 1, "dia_coded_spmv_axpy": dev_it, "cg_sweep": dev_it}
    want_s = {"dia_coded_spmv": 1 + dev_it_s, "cg_sweep": dev_it_s}
    emit({
        "phase": "pipelined", "n": N_MAIN, "dtype": "float32", "tol": TOL_MAIN,
        "cg_body": info["cg_body"], "iterations": it, "converged": info["converged"],
        "rel_err": err, "solve_s": solve_s, "plain_iterations": info_p["iterations"],
        "plain_rel_err": err_p, "standard_iterations": info_s["iterations"],
        "fused_iterations": run["info"]["iterations"], "kernels": launches, "expected_launches": want,
        "device_loop": info["device_loop"], "standard_kernels": launches_s,
        "standard_expected_launches": want_s, "standard_device_loop": info_s["device_loop"],
    })
    require(info["cg_body"] == "pipelined", "the pipelined solve did not run the pipelined body")
    require(info["converged"] and np.isfinite(err), "the pipelined solve did not converge")
    require(it == info_p["iterations"], "pipelined: kernel and plain paths took different iterations")
    require(it == info_s["iterations"], "pipelined: iterations differ from the standard body's")
    require(err <= 1.1 * err_p, "pipelined: kernel path error above 1.1x the plain path's")
    for k in want:
        require(launches[k] == want[k], f"pipelined: {launches[k]} {k} launches, expected {want[k]}")
    for k in want_s:
        require(launches_s[k] == want_s[k], f"standard CG: {launches_s[k]} {k} launches, expected {want_s[k]}")
    dA = device_matrix(A, backend)
    maxiter = 4 * A.rows.ngids
    for name, kw in (("pipelined", {"pipelined": True}), ("standard", {"fused": False})):
        line = graph_vs_eager(f"{N_MAIN}^3 f32 {name} CG",
                              lambda g: make_cg_fn(dA, TOL_MAIN, maxiter, graph=g, **kw), run["b_dev"], run["x0_dev"])
        require(line["iterations"] == it, f"{name} CG: the graph-vs-eager solve took other iterations")
    return launches


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def exchange_times(rows, backend, rng):
    """The box and the generic plan's set and add exchanges over one range:
    results compared (set per lid exactly, add to rounding) and each timed
    on a random frame (µs)."""
    from partitionedarrays_jl_tpu_torch.parallel.gpu_box import BoxExchangePlan

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=backend.device)
    vals = [rng.standard_normal(i.num_lids) for i in rows.partition.part_values()]
    out = {}
    for combine in ("set", "add"):
        rev = combine == "add"
        res = {}
        for box in (True, False):
            plan = device_exchange_plan(rows, backend, reverse=rev, box=box)
            require(isinstance(plan, BoxExchangePlan) == box, f"stacked parts: box={box} gave {type(plan).__name__}")
            dv = DeviceVector.from_pvector(
                PVector(rows.partition._like([v.copy() for v in vals]), rows), backend, device_layout(rows, box))
            exchange_(plan, dv.data, combine)
            res[box] = [np.asarray(v) for v in dv.to_pvector().values.part_values()]
            frame = torch.from_numpy(rng.standard_normal(tuple(dv.data.shape))).to(dv.data.device)
            out[f"{combine}_{'box' if box else 'generic'}_us"] = time_ms(
                lambda: exchange_(plan, frame, combine), flush) * 1e3
            out[f"{'box' if box else 'generic'}_rounds"] = plan.R
        for a, b in zip(res[True], res[False]):
            if rev:
                require(np.allclose(a, b, rtol=1e-14, atol=1e-14), "stacked parts: box and generic add differ")
            else:
                require(np.array_equal(a, b), "stacked parts: box and generic set differ")
    return out


def phase_multi(backend, n, rng):
    """The stacked-parts path on the box plan: its own launch counts, both
    kernels held against their plain versions on its float64 operand and
    (P, W) frames, the same solve through the plain versions and on the
    generic plan, both plans' exchange times and CG seconds per
    iteration."""
    from partitionedarrays_jl_tpu_torch.parallel.gpu_box import BoxExchangePlan

    dia.reset_launches()
    err_g, info_g = prun(poisson_fdm_driver, backend, (2, 2, 2), (n, n, n), tol=1e-8)
    launches = dict(dia.LAUNCHES)
    err_s, info_s = prun(poisson_fdm_driver, sequential, (2, 2, 2), (n, n, n), tol=1e-8)
    dev_it = device_iterations(info_g)
    # A_oh on the boundary rows: E1's boundary mode once an SpMV
    want = {"dia_coded_spmv": 1, "dia_coded_spmv_pfold": dev_it, "cg_sweep": dev_it, "ell_spmv_boundary": 1 + dev_it}
    emit({"phase": "stacked_parts_launch_counts", "kernels": launches, "expected_launches": want,
          "device_loop": info_g["device_loop"]})
    for k in want:
        require(launches[k] == want[k], f"stacked parts: {launches[k]} {k} launches, expected {want[k]}")

    A, b, _, x0 = prun(lambda parts: assemble_poisson(parts, (n, n, n)), backend, (2, 2, 2))
    dA = device_matrix(A, backend)
    require(isinstance(dA.col_plan, BoxExchangePlan), "stacked parts: the path is not on the box exchange plan")
    op = dA.coded
    P, wx, wy = dA.col_layout.P, dA.col_layout.W, dA.row_layout.W
    require(op.cb.dtype == torch.float64, f"stacked parts: operator staged as {op.cb.dtype}")

    def frame():
        return torch.from_numpy(rng.standard_normal((P, wx))).to(backend.device)

    x, r, pprev = frame(), frame(), frame()
    beta = torch.tensor(0.37, dtype=torch.float64, device=backend.device)
    yk, pk = dia.dia_coded_spmv_pfold(op, r, pprev, beta, wy)
    yp, pp = dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta, wy)
    errs = {
        "dia_coded_spmv": _compare(
            "stacked parts dia_coded_spmv", dia.dia_coded_spmv(op, x, wy), dia.dia_coded_spmv_plain(op, x, wy)
        ),
        "dia_coded_spmv_pfold[y]": _compare("stacked parts dia_coded_spmv_pfold y", yk, yp),
        "dia_coded_spmv_pfold[p]": _compare("stacked parts dia_coded_spmv_pfold p", pk, pp),
    }
    _hold_sweep(f"{n}^3 f64 (2,2,2)", x, r, pprev, frame(), dA.row_layout.no_max, errs)
    bb, xb = staged({"A": A, "b": b, "x0": x0}, backend)
    graph_vs_eager(f"{n}^3 f64 (2,2,2) fused CG", lambda g: make_cg_fn(dA, 1e-8, 2000, graph=g), bb, xb)
    _, info_p = gpu_cg(A, b, x0=x0, tol=1e-8, maxiter=2000, plain=True)
    _, info_gen = gpu_cg(A, b, x0=x0, tol=1e-8, maxiter=2000, box=False)
    ex = exchange_times(A.cols, backend, rng)
    cg_s = {}
    for key, box, graph in (("box", True, True), ("box_eager", True, False), ("generic", False, True)):
        dAb = device_matrix(A, backend, box)
        bb, xb = staged({"A": A, "b": b, "x0": x0}, backend, box)
        cg_s[key], _ = fixed_trip_s_per_iter(lambda m: make_cg_fn(dAb, 0.0, m, graph=graph), bb, xb, 20, 220)
    emit({
        "phase": "stacked_parts", "n": n, "dtype": "float64", "parts": [2, 2, 2],
        "decode": "row_class" if dA.dia_cls_pattern is not None else "select_chain",
        "iterations": info_g["iterations"], "sequential_iterations": info_s["iterations"],
        "plain_iterations": info_p["iterations"], "generic_plan_iterations": info_gen["iterations"],
        "err": err_g, "sequential_err": err_s, "cg_body": info_g["cg_body"], "equal": True,
        "max_abs_err": errs, "exchange": ex, "cg_s_per_iter": cg_s,
    })
    require(info_g["iterations"] == info_s["iterations"], "stacked parts: iterations differ from the sequential backend")
    require(info_g["iterations"] == info_p["iterations"], "stacked parts: iterations differ from the plain path")
    require(info_g["iterations"] == info_gen["iterations"], "stacked parts: iterations differ on the generic plan")
    require(err_g < 1e-5, f"stacked parts: error {err_g} >= 1e-5")
    return max(v for k, v in errs.items() if k.startswith("cg_sweep["))


# ---------------------------------------------------------------------------
# phase 4b / 4c
# ---------------------------------------------------------------------------


def gmg_driver(parts, n, f32):
    """tools/bench_gmg.py:74-93: the Dirichlet Poisson operator (scaled by
    1/16 in float32, b = A x̂, when f32), decoupled, and its hierarchy."""
    t = time.perf_counter()
    A, b, xe, _ = assemble_poisson(parts, (n, n, n))
    if f32:
        vals = [CSRMatrix(M.indptr, M.indices, (M.data / 16.0).astype(np.float32), M.shape)
                for M in A.values.part_values()]
        A = PSparseMatrix(A.values._like(vals), A.rows, A.cols)
        xe = PVector(xe.values._like([np.asarray(v, np.float32) for v in xe.values.part_values()]), xe.rows)
        b = A @ xe
    Ah, bh = decouple_dirichlet(A, b)
    t_asm = time.perf_counter() - t
    t = time.perf_counter()
    h = gmg_hierarchy(parts, Ah, (n, n, n), coarse_threshold=500)
    return {"Ah": Ah, "bh": bh, "xe": xe, "h": h, "assembly_s": t_asm,
            "hierarchy_s": time.perf_counter() - t}


def _stream_args(dA, x):
    return (dA.stream_vals, x, dA.dia_offsets, dA.stream_no, dA.row_layout.o0, dA.row_layout.W)


def _stream_checks(dh, rng, tag):
    """The streaming-DIA kernel in both forms against its plain version on
    every stream level's operator (random operands in its column frame).
    Returns the max |diff| and level 1's operand."""
    errs, x1 = [], None
    for level, lv in enumerate(dh["levels"]):
        dA = lv["dA"]
        if dA.dia_mode != "stream":
            continue
        x = torch.from_numpy(rng.standard_normal((dA.col_layout.P, dA.col_layout.W))).to(
            dA.stream_vals.device, dA.stream_vals.dtype)
        want = dia.dia_stream_spmv_plain(*_stream_args(dA, x))
        for form in dia.STREAM_FORMS:
            errs.append(_compare(f"dia_stream_spmv {tag} level {level} {form} form",
                                 dia.dia_stream_spmv(*_stream_args(dA, x), form=form), want))
        x1 = x if level == 1 else x1
    require(errs, f"{tag}: no streaming-DIA level")
    return max(errs), x1


def _epilogue_calls(dh, level, omega, rng):
    """The V-cycle epilogue's three calls on a level as `make_vcycle` makes
    them (the residual into the level's column frame on the stencil route,
    into S's on the structured ones, into R's on the assembled one), on random frames: mode -> keywords
    (x and y drawn once; smooth updates x in place)."""
    lv = dh["levels"][level]
    LA, LAr = lv["dA"].col_layout, lv["dA"].row_layout
    dinv = lv["dinv"]

    def frame(w):
        return torch.from_numpy(rng.standard_normal((LA.P, w))).to(dinv.device, dinv.dtype)

    b, x, y = frame(LA.W), frame(LA.W), frame(LAr.W)
    band = {"b": b, "o0": LA.o0, "n": LA.no_max}
    into = lv.get("dS", lv.get("dR"))  # the structured routes' S, the assembled route's R
    res = {} if gpu_gmg.route(lv) == "stencil" else {"width": into.col_layout.W, "out_o0": into.col_layout.o0}
    return {
        "init": {"mode": "init", **band, "dinv": dinv, "omega": omega},
        "residual": {"mode": "residual", **band, "y": y, "yo0": LAr.o0, **res},
        "smooth": {"mode": "smooth", **band, "dinv": dinv, "y": y, "yo0": LAr.o0, "x": x, "omega": omega},
    }


def _epilogue_checks(h, dh, rng, tag):
    """The V-cycle epilogue torch.equal to its plain version in every mode
    on every level of a staged hierarchy (smooth on copies of x), and one
    whole V-cycle with every kernel torch.equal to the V-cycle through the
    plain versions (`make_vcycle(plain=True)`), on a random level-0 right-
    hand side. Returns the max |diff| of each."""
    from partitionedarrays_jl_tpu_torch.ops import epilogue as ep

    errs = []
    for level in range(len(dh["levels"])):
        for mode, kw in _epilogue_calls(dh, level, h.omega, rng).items():
            if mode == "smooth":
                got = ep.vcycle_epilogue(**{**kw, "x": kw["x"].clone()})
                want = ep.vcycle_epilogue_plain(**{**kw, "x": kw["x"].clone()})
            else:
                got, want = ep.vcycle_epilogue(**kw), ep.vcycle_epilogue_plain(**kw)
            errs.append(_compare(f"vcycle_epilogue {tag} level {level} {mode}", got, want))
    L0 = dh["levels"][0]["dA"].col_layout
    b = torch.zeros((L0.P, L0.W), dtype=dh["levels"][0]["dinv"].dtype, device=dh["levels"][0]["dinv"].device)
    b[:, L0.o0 : L0.o0 + L0.no_max] = torch.from_numpy(rng.standard_normal((L0.P, L0.no_max))).to(b)
    want = gpu_gmg.make_vcycle(h, dh, plain=True)(b.clone())
    got = gpu_gmg.make_vcycle(h, dh)(b.clone())
    return max(errs), _compare(f"V-cycle {tag} (kernels against plain versions)", got, want)


def gmg_coded_operators(dh):
    """The coded operators of a device hierarchy, finest first, by name:
    ``A<l>`` a level's operator (level 0's only, the others stream) and
    ``S<l>`` its interpolation stencil (levels on a structured route)."""
    out = []
    for l, lv in enumerate(dh["levels"]):
        for kind in ("A", "S"):
            if f"d{kind}" in lv and lv[f"d{kind}"].dia_mode == "coded":
                out.append((f"{kind}{l}", lv[f"d{kind}"]))
    return out


def _random_frame(dM, rng):
    op = dM.coded
    return torch.from_numpy(rng.standard_normal((dM.col_layout.P, dM.col_layout.W))).to(op.cb.device, op.cb.dtype)


def _k1_on_gmg_operators(dh, tag, rng, names=None):
    """K1 torch.equal to its plain version on the hierarchy's own coded
    operators (random operands in their column frames)."""
    errs = {}
    for name, dM in gmg_coded_operators(dh):
        if names is None or name in names:
            op, x, wy = dM.coded, _random_frame(dM, rng), dM.row_layout.W
            errs[name] = _compare(f"dia_coded_spmv {tag} {name}", dia.dia_coded_spmv(op, x, wy),
                                  dia.dia_coded_spmv_plain(op, x, wy))
    return errs


def gmg_launches(h, dh, dev_it):
    """The launches of a GMG-PCG solve of ``dev_it`` device iterations on a
    staged hierarchy: the initial residual and per iteration the outer A0
    SpMV, the sweep, and per level 2 SpMVs with its A (coded or stream), 2
    transfers (the stencil kernel, or SpMVs with a coded S) and the
    epilogue's pre + post + 1 (init, the smoothing sweeps, the
    residual)."""
    per = {"coded": 1, "stream": 0, "stencil": 0}
    for lv in dh["levels"]:
        per["coded" if lv["dA"].dia_mode == "coded" else "stream"] += 2
        if gpu_gmg.route(lv) == "stencil":
            per["stencil"] += 2
        else:
            per["coded" if lv["dS"].dia_mode == "coded" else "stream"] += 2
    epilogues = (h.pre + h.post + 1 if h.pre > 0 else h.post + 1) * len(dh["levels"])
    # E1's boundary mode once an SpMV of an operator with an A_oh block
    oh = [1 if lv["dA"].oh_nnz else 0 for lv in dh["levels"]]
    per_oh = oh[0] + 2 * sum(oh) + sum(2 * (1 if lv["dS"].oh_nnz else 0) for lv in dh["levels"]
                                        if gpu_gmg.route(lv) != "stencil")
    want = {"dia_coded_spmv": 1 + dev_it * per["coded"], "dia_stream_spmv": dev_it * per["stream"],
            "box_stencil_apply": dev_it * per["stencil"], "cg_sweep": dev_it,
            "vcycle_epilogue": dev_it * epilogues}
    if oh[0]:
        want["ell_spmv_boundary"] = oh[0] + dev_it * per_oh
    return want


def phase_gmg(backend, run, rng):
    """GMG-PCG at 192^3 f32 through `pcg(Ah, bh, minv=h)` on the default
    (stencil) route, phase 2b's hierarchy: its own launch counts by
    formula, the stream kernel on level 1 against its plain version, the
    plain path."""
    h, dh = run["h"], run["dh"]
    L = len(h.levels)
    routes = [gpu_gmg.route(lv) for lv in dh["levels"]]
    modes = [lv["dA"].dia_mode for lv in dh["levels"]]
    err_k4, x1 = _stream_checks(dh, rng, f"GMG {N_MAIN}^3 f32")
    err_epi, err_vc = _epilogue_checks(h, dh, rng, f"GMG {N_MAIN}^3 f32 stencil route")
    dia.reset_launches()
    t = time.perf_counter()
    x, info = pcg(run["Ah"], run["bh"], minv=h, tol=TOL_MAIN)
    sync()
    solve_s = time.perf_counter() - t
    launches = dict(dia.LAUNCHES)
    err = _rel_err(x, run["xe"])
    xp, info_p = gpu_gmg.gpu_gmg_pcg(h, run["bh"], tol=TOL_MAIN, plain=True)
    err_p = _rel_err(xp, run["xe"])
    it = info["iterations"]
    dev_it = device_iterations(info)
    n_stream = modes.count("stream")
    # every level on the stencil route, level 0 coded and the rest stream:
    # coded 1 + 3 per device iteration, stream 8, stencil 10, sweep 1,
    # epilogue 15
    want = gmg_launches(h, dh, dev_it)
    emit({
        "phase": "gmg_pcg", "route": "stencil", "n": N_MAIN, "dtype": "float32", "parts": 1, "tol": TOL_MAIN,
        "levels": L, "grids": [lvl.nfs[0] for lvl in h.levels], "coarse_size": h.coarse_A.rows.ngids,
        "routes": routes, "dia_modes": modes, "assembly_s": run["assembly_s"], "hierarchy_s": run["hierarchy_s"],
        "staging_s": run["staging_s"], "solve_s": solve_s, "iterations": it, "converged": info["converged"],
        "rel_err": err, "plain_iterations": info_p["iterations"], "plain_rel_err": err_p,
        "kernels": launches, "expected_launches": want, "stream_vs_plain_max_abs_err": err_k4,
        "epilogue_vs_plain_max_abs_err": err_epi, "vcycle_vs_plain_max_abs_err": err_vc,
        "device_loop": info["device_loop"],
    })
    require(L == GMG_LEVELS and h.coarse_A.rows.ngids == 216, f"GMG: {L} levels over {h.coarse_A.rows.ngids} coarse points, expected 5 over 216")
    require(modes[0] == "coded" and n_stream == L - 1, f"GMG: level modes {modes}")
    require(info["converged"] and np.isfinite(err), "the 192^3 GMG-PCG solve did not converge")
    require(it == info_p["iterations"], "GMG: kernel and plain paths took different iterations")
    require(err <= 1.1 * err_p, "GMG: kernel path error above 1.1x the plain path's")
    for k in want:
        require(launches[k] == want[k], f"GMG: {launches[k]} {k} launches, expected {want[k]}")
    b = _b_on_cols_layout(run["bh"], device_matrix(run["Ah"], backend))
    maxiter = 4 * run["Ah"].rows.ngids
    graph_vs_eager(f"{N_MAIN}^3 f32 GMG-PCG stencil route",
                   lambda g: gpu_gmg.make_gmg_pcg_fn(h, backend, TOL_MAIN, maxiter, graph=g), b, torch.zeros_like(b))
    return {"run": run, "dh": dh, "launches": launches, "err_k4": err_k4, "x1": x1, "iterations": it, "err": err,
            "device_iterations": dev_it, "err_epi": max(err_epi, err_vc)}


def phase_gmg_structured(backend, g, rng):
    """The same GMG-PCG on the structured route (``stencil=False``): its
    staging seconds, K1 on every coded operator against its plain version,
    its launch counts by formula; the stencil route's iterations and error
    held against it."""
    run = g["run"]
    h = run["h"]
    L = len(h.levels)
    t = time.perf_counter()
    dhs = gpu_gmg.device_hierarchy(h, backend, stencil=False)
    sync()
    staging_s = time.perf_counter() - t
    routes = [gpu_gmg.route(lv) for lv in dhs["levels"]]
    err_k1 = _k1_on_gmg_operators(dhs, f"GMG {N_MAIN}^3 f32 structured", rng)
    require(sorted(err_k1) == ["A0"] + [f"S{l}" for l in range(L)], f"GMG coded operators {sorted(err_k1)}")
    err_epi, err_vc = _epilogue_checks(h, dhs, rng, f"GMG {N_MAIN}^3 f32 structured route")
    dia.reset_launches()
    t = time.perf_counter()
    x, info = pcg(run["Ah"], run["bh"], minv=h, tol=TOL_MAIN, stencil=False)
    sync()
    solve_s = time.perf_counter() - t
    launches = dict(dia.LAUNCHES)
    err = _rel_err(x, run["xe"])
    it = info["iterations"]
    dev_it = device_iterations(info)
    # every S coded: coded 1 + 13 per device iteration, stream 8, sweep 1,
    # epilogue 15
    want = gmg_launches(h, dhs, dev_it)
    emit({
        "phase": "gmg_pcg_structured", "n": N_MAIN, "dtype": "float32", "routes": routes,
        "s_modes": [lv["dS"].dia_mode for lv in dhs["levels"]], "staging_s": staging_s, "solve_s": solve_s,
        "iterations": it, "converged": info["converged"], "rel_err": err, "stencil_route_iterations": g["iterations"],
        "stencil_route_rel_err": g["err"], "kernels": launches, "expected_launches": want,
        "coded_vs_plain_max_abs_err": err_k1, "epilogue_vs_plain_max_abs_err": err_epi,
        "vcycle_vs_plain_max_abs_err": err_vc, "device_loop": info["device_loop"],
    })
    # one part: every coarse point is its own part's even fine point, so the
    # structured route embeds through strided views (emb_fast)
    require(routes == ["emb_fast"] * L, f"GMG structured routes {routes}")
    require(info["converged"], "the 192^3 structured-route GMG-PCG did not converge")
    require(g["iterations"] == it == GMG_ITERATIONS,
            f"GMG: stencil route {g['iterations']}, structured {it} iterations, expected {GMG_ITERATIONS}")
    require(g["err"] <= 1.1 * err, "GMG: stencil route error above 1.1x the structured route's")
    for k in want:
        require(launches[k] == want[k], f"GMG structured: {launches[k]} {k} launches, expected {want[k]}")
    b = _b_on_cols_layout(run["bh"], device_matrix(run["Ah"], backend))
    maxiter = 4 * run["Ah"].rows.ngids
    graph_vs_eager(f"{N_MAIN}^3 f32 GMG-PCG structured route",
                   lambda g: gpu_gmg.make_gmg_pcg_fn(h, backend, TOL_MAIN, maxiter, stencil=False, graph=g),
                   b, torch.zeros_like(b))
    return {"dh": dhs, "err_k1": err_k1, "iterations": it, "device_iterations": dev_it,
            "err_epi": max(err_epi, err_vc)}


def phase_gmg_multi(backend, run, rng):
    """Stacked-parts GMG-PCG in f64 on phase 2b's hierarchy: card (default
    routes), sequential backend, plain versions and the generic routes
    (``box=False``) take the same iterations; K1 on level 0's A and S and
    the stream kernel on level 1 against their plain versions; seconds per
    iteration on both routes."""
    n = N_GMG_MULTI
    h = run["h"]
    dia.reset_launches()
    x, info = pcg(run["Ah"], run["bh"], minv=h, tol=1e-8)
    launches = dict(dia.LAUNCHES)
    err = _rel_err(x, run["xe"])

    def driver(parts):
        r = gmg_driver(parts, n, False)
        xs, info_s = pcg(r["Ah"], r["bh"], minv=r["h"], tol=1e-8)
        return info_s, _rel_err(xs, r["xe"])

    info_s, err_s = prun(driver, sequential, (2, 2, 2))
    dh = run["dh"]
    err_k4, _ = _stream_checks(dh, rng, f"stacked-parts GMG {n}^3 f64")
    err_epi = max(_epilogue_checks(h, dh, rng, f"stacked-parts GMG {n}^3 f64 default routes"))
    err_k1 = _k1_on_gmg_operators(dh, f"stacked-parts GMG {n}^3 f64", rng, ("A0", "S0"))
    require(sorted(err_k1) == ["A0", "S0"], f"stacked-parts GMG: coded operators {sorted(err_k1)}")
    _, info_p = gpu_gmg.gpu_gmg_pcg(h, run["bh"], tol=1e-8, plain=True)
    _, info_gen = gpu_gmg.gpu_gmg_pcg(h, run["bh"], tol=1e-8, box=False)
    err_epi = max(err_epi, *_epilogue_checks(h, gpu_gmg.device_hierarchy(h, backend, box=False), rng,
                                             f"stacked-parts GMG {n}^3 f64 generic routes"))
    it = info["iterations"]
    want = gmg_launches(h, dh, device_iterations(info))
    b = _b_on_cols_layout(run["bh"], device_matrix(run["Ah"], backend))
    graph_vs_eager(f"{n}^3 f64 (2,2,2) GMG-PCG default routes",
                   lambda g: gpu_gmg.make_gmg_pcg_fn(h, backend, 1e-8, 4 * run["Ah"].rows.ngids, graph=g),
                   b, torch.zeros_like(b))
    s_per_iter = {}
    for name, kw in (("default", {}), ("default_eager", {"graph": False}), ("generic", {"box": False})):
        dA0 = device_matrix(run["Ah"], backend, kw.get("box", True))
        b = _b_on_cols_layout(run["bh"], dA0)
        s_per_iter[name], _ = fixed_trip_s_per_iter(
            lambda m: gpu_gmg.make_gmg_pcg_fn(h, backend, 0.0, m, **kw), b, torch.zeros_like(b), *GMG_TRIPS)
    emit({
        "phase": "gmg_pcg_stacked_parts", "n": n, "dtype": "float64", "parts": [2, 2, 2],
        "levels": len(h.levels), "routes": [gpu_gmg.route(lv) for lv in dh["levels"]],
        "generic_routes": [gpu_gmg.route(lv) for lv in gpu_gmg.device_hierarchy(h, backend, box=False)["levels"]],
        "iterations": it, "sequential_iterations": info_s["iterations"], "plain_iterations": info_p["iterations"],
        "generic_iterations": info_gen["iterations"], "rel_err": err, "sequential_rel_err": err_s,
        "kernels": launches, "expected_launches": want, "device_loop": info["device_loop"],
        "s_per_iter": s_per_iter, "fixed_trips": GMG_TRIPS,
        "stream_vs_plain_max_abs_err": err_k4, "coded_vs_plain_max_abs_err": err_k1,
        "epilogue_and_vcycle_vs_plain_max_abs_err": err_epi,
        "coded_operators": {name: operator_info(dM.coded) for name, dM in gmg_coded_operators(dh)},
    })
    require(info["converged"], "stacked-parts GMG-PCG did not converge")
    require(it == info_s["iterations"], "stacked-parts GMG: iterations differ from the sequential backend")
    require(it == info_p["iterations"], "stacked-parts GMG: iterations differ from the plain path")
    require(it == info_gen["iterations"], "stacked-parts GMG: iterations differ on the generic routes")
    for k in want:
        require(launches[k] == want[k] > 0, f"stacked-parts GMG: {launches[k]} {k} launches, expected {want[k]}")
    # with it, the kernels line's max_abs_err of K1 covers these operators
    return {"stream": err_k4, "coded": max(err_k1.values()), "epilogue": err_epi, "iterations": it,
            "device_iterations": device_iterations(info)}


# ---------------------------------------------------------------------------
# phases 4d and 4e: Jacobi PCG and the block (multi-RHS) solves
# ---------------------------------------------------------------------------


def _frame(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(dtype)).to(dev)


def _hold_jacobi_kernels(dA, dmv, rng, errs):
    """K2 with minv (y and p) and the sweep's precond form (x, r, both
    series of partials, rz, rs; the flag 1 and 0) torch.equal to their
    plain versions on random frames of a path's shapes."""
    from partitionedarrays_jl_tpu_torch.ops import sweep as sw

    op, dev = dA.coded, dmv.device
    P, wx, wy, n = dA.col_layout.P, dA.col_layout.W, dA.row_layout.W, dA.row_layout.no_max
    r, pprev = _frame(rng, (P, wx), np.float32, dev), _frame(rng, (P, wx), np.float32, dev)
    beta = torch.tensor(0.37, dtype=torch.float32, device=dev)
    yk, pk = dia.dia_coded_spmv_pfold(op, r, pprev, beta, wy, minv=dmv)
    yp, pp = dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta, wy, minv=dmv)
    errs["dia_coded_spmv_pfold_minv[y]"] = _compare("K2 minv y", yk, yp)
    errs["dia_coded_spmv_pfold_minv[p]"] = _compare("K2 minv p", pk, pp)
    x, p, q = (_frame(rng, (P, wx), np.float32, dev) for _ in range(3))
    alpha = torch.tensor(0.0625, dtype=torch.float32, device=dev)
    for live in (1, 0):
        flag = torch.tensor(live, dtype=torch.int32, device=dev)
        outs = []
        for k in (sw.cg_sweep, sw.cg_sweep_plain):
            xc, rc = x.clone(), r.clone()
            part = torch.full((P, 2, sw.chunks(n)), 0.5, dtype=torch.float32, device=dev)
            rz, rs = k(rc, q, alpha, flag, part, dA.row_layout.o0, n, x=xc, p=p, minv=dmv)
            outs.append((xc, rc, part, rz, rs))
        for what, a, b in zip(("x", "r", "partials", "rz", "rs"), *outs):
            errs[f"cg_sweep_precond[live={live},{what}]"] = _compare(f"precond sweep live={live} {what}", a, b)
        if not live:
            require(torch.equal(outs[0][0], x) and torch.equal(outs[0][1], r), "precond sweep wrote with the flag 0")


def jacobi_kernel_times(jac, flush, rng):
    """K2 with minv and the precond sweep at Jacobi PCG's shapes (flushed
    ms), their plain versions, and the bounds: K2 with minv reads r,
    pprev, minv and a code byte and writes y and p; the precond sweep reads
    x, p, r, q, minv and writes x, r. No single PyTorch call computes
    either."""
    from partitionedarrays_jl_tpu_torch.ops import sweep as sw

    dA, dmv = jac["dA"], jac["dmv"]
    op, dev = dA.coded, dmv.device
    P, wx, wy, n, o0 = dA.col_layout.P, dA.col_layout.W, dA.row_layout.W, dA.row_layout.no_max, dA.row_layout.o0
    rows = int(dA.row_layout.noids.sum())
    nnz = dA.flops_per_spmv // 2
    r, pprev, x, p = (_frame(rng, (P, wx), np.float32, dev) for _ in range(4))
    q = _frame(rng, (P, wy), np.float32, dev)
    beta = torch.tensor(0.37, dtype=torch.float32, device=dev)
    alpha = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    live = torch.ones((), dtype=torch.int32, device=dev)
    part = sw.sweep_partials(r, n, 2)
    k2 = {"ms": time_ms(lambda: dia.dia_coded_spmv_pfold(op, r, pprev, beta, wy, minv=dmv), flush),
          "plain_ms": time_ms(lambda: dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta, wy, minv=dmv), flush),
          "library_ms": None}
    k2["bound_ms"], k2["bound_by"] = _bound_ms(rows * (5 * 4 + op.codes.shape[1]), 2 * nnz + 3 * rows)
    sweep = {"ms": time_ms(lambda: sw.cg_sweep(r, q, alpha, live, part, o0, n, x=x, p=p, minv=dmv), flush),
             "plain_ms": time_ms(lambda: sw.cg_sweep_plain(r, q, alpha, live, part, o0, n, x=x, p=p, minv=dmv), flush),
             "library_ms": None}
    sweep["bound_ms"], sweep["bound_by"] = _bound_ms(rows * 7 * 4, 6 * 2 * rows)
    for t in (k2, sweep):
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
    emit({"phase": "jacobi_kernel_times", "n": N_MAIN, "dtype": "float32", "reps": REPS,
          "dia_coded_spmv_pfold_minv": k2, "cg_sweep_precond": sweep})
    return {"dia_coded_spmv_pfold_minv": k2, "cg_sweep_precond": sweep}


def phase_jacobi(backend, run, rng):
    """Jacobi PCG at 192^3 f32 on phase 2b's decoupled operator through
    `pcg(Ah, bh)` (the default diagonal minv), fused and standard bodies:
    launch counts by formula, the plain path's iterations and error, graph
    against eager, K2 with minv and the precond sweep against their plain
    versions, and seconds per iteration from fixed trips."""
    Ah, bh = run["Ah"], run["bh"]
    dA = device_matrix(Ah, backend)
    require(dA.dia_mode == "coded", f"Jacobi PCG: the decoupled operator lowered as {dA.dia_mode}")
    mv = jacobi_preconditioner(Ah)
    dmv = _b_on_cols_layout(mv, dA)
    errs = {}
    _hold_jacobi_kernels(dA, dmv, rng, errs)
    b = _b_on_cols_layout(bh, dA)
    x0 = torch.zeros_like(b)
    maxiter = 4 * Ah.rows.ngids
    out = {"errs": errs, "launches": {}}
    for body, fused in (("fused", True), ("standard", False)):
        dia.reset_launches()
        t = time.perf_counter()
        x, info = pcg(Ah, bh, tol=TOL_MAIN, fused=fused)
        sync()
        solve_s = time.perf_counter() - t
        launches = dict(dia.LAUNCHES)
        dev_it = device_iterations(info)
        if fused:
            want = {"dia_coded_spmv": 1, "dia_coded_spmv_pfold_minv": dev_it, "cg_sweep_precond": dev_it}
        else:
            want = {"dia_coded_spmv": 1 + dev_it, "dia_coded_spmv_pfold_minv": 0, "cg_sweep_precond": dev_it}
        want.update(dia_coded_spmv_pfold=0, cg_sweep=0)
        err = _rel_err(x, run["xe"])
        xp, info_p = gpu_cg(Ah, bh, tol=TOL_MAIN, fused=fused, plain=True, minv=mv)
        err_p = _rel_err(xp, run["xe"])
        s_per_iter, fixed = fixed_trip_s_per_iter(
            lambda m: with_args(make_cg_fn(dA, 0.0, m, fused=fused, precond=True), dmv), b, x0, *CG_TRIPS)
        line = {
            "phase": "jacobi_pcg", "body": body, "n": N_MAIN, "dtype": "float32", "parts": 1, "tol": TOL_MAIN,
            "cg_body": info["cg_body"], "iterations": info["iterations"], "converged": info["converged"],
            "rel_err": err, "plain_iterations": info_p["iterations"], "plain_rel_err": err_p, "solve_s": solve_s,
            "kernels": launches, "expected_launches": want, "device_loop": info["device_loop"],
            "s_per_iter": s_per_iter, "fixed_trip_s": fixed, "fixed_trips": CG_TRIPS,
        }
        emit(line)
        require(info["cg_body"] == body and info["converged"] and np.isfinite(err),
                f"Jacobi PCG {body}: did not converge in the {body} body")
        require(info["iterations"] == info_p["iterations"], f"Jacobi PCG {body}: kernel and plain iterations differ")
        require(err <= 1.1 * err_p, f"Jacobi PCG {body}: kernel path error above 1.1x the plain path's")
        for k in want:
            require(launches[k] == want[k], f"Jacobi PCG {body}: {launches[k]} {k} launches, expected {want[k]}")
        g = graph_vs_eager(f"{N_MAIN}^3 f32 Jacobi PCG {body}",
                           lambda gr: make_cg_fn(dA, TOL_MAIN, maxiter, fused=fused, precond=True, graph=gr),
                           b, x0, dmv)
        require(g["iterations"] == info["iterations"], f"Jacobi PCG {body}: graph-vs-eager iterations differ")
        out[body] = line
        if fused:
            out["launches"] = {k: launches[k] for k in ("dia_coded_spmv_pfold_minv", "cg_sweep_precond")}
    out["dA"], out["dmv"] = dA, dmv
    return out


def assemble_varcoef_poisson(parts, ns, dtype=np.float32):
    """The variable-coefficient 7-point diffusion operator of the JAX
    package's multi-RHS benchmark (tools/bench_multirhs.py:53-107, its
    own copy here): harmonic-mean arm weights over a smooth k-field,
    Dirichlet identity rows, shifted by 1e-3 and scaled by 1/16. Every
    diagonal holds many values, so the lowering takes the streaming-DIA
    form. The column range is the rows' with the stencil's ghost layer
    (`add_gids`), so it assembles on any parts."""
    ns = tuple(int(n) for n in ns)
    dim = len(ns)
    rows = cartesian_partition(parts, ns, no_ghost)
    cis = p_cartesian_indices(parts, ns, no_ghost)

    def k_field(*cs):
        f = 1.0
        for d, c in enumerate(cs):
            f = f * (1.0 + 0.4 * np.sin(0.37 * (d + 1) * np.asarray(c)))
        return 1.0 + 0.8 * f

    def coo(ci):
        cs = [g.ravel() for g in ci.grid()]
        gid = np.ravel_multi_index(tuple(cs), ns)
        interior = np.ones(len(gid), dtype=bool)
        for d in range(dim):
            interior &= (cs[d] > 0) & (cs[d] < ns[d] - 1)
        I, J, V = [gid[~interior]], [gid[~interior]], [np.ones(int((~interior).sum()))]
        gi = gid[interior]
        ics = [c[interior] for c in cs]
        diag = np.zeros(len(gi))
        for d in range(dim):
            for s in (-1, 1):
                nb = list(ics)
                nb[d] = ics[d] + s
                kn = 2.0 / (1.0 / k_field(*ics) + 1.0 / k_field(*nb))
                I.append(gi)
                J.append(np.ravel_multi_index(tuple(nb), ns))
                V.append(-kn)
                diag += kn
        I.append(gi)
        J.append(gi)
        V.append(diag + 1e-3)
        return np.concatenate(I), np.concatenate(J), np.concatenate(V).astype(dtype) / 16.0

    trip = map_parts(coo, cis)
    I = map_parts(lambda t: t[0], trip)
    J = map_parts(lambda t: t[1], trip)
    V = map_parts(lambda t: t[2], trip)
    return PSparseMatrix.from_coo(I, J, V, rows, add_gids(rows, J), ids="global")


def dirichlet_start(A, xh):
    """A start over A.cols that holds x̂ on the identity (Dirichlet) rows
    and 0 elsewhere, as `assemble_poisson`'s x0 holds the boundary values:
    on the undecoupled operator the residual then starts 0 on those rows,
    and CG stays where the operator is symmetric (from x0 = 0 it diverges
    there)."""
    vals = []
    for M, xv in zip(A.values.part_values(), xh.values.part_values()):
        r = M.row_of_nz()
        lens = np.bincount(r, minlength=M.shape[0])
        ident = np.zeros(M.shape[0], dtype=bool)
        one = (lens[r] == 1) & (M.indices == r)
        ident[r[one]] = True
        v = np.zeros_like(np.asarray(xv))
        v[: M.shape[0]][ident] = np.asarray(xv)[: M.shape[0]][ident]
        vals.append(v)
    return PVector(A.cols.partition._like(vals), A.cols)


def block_rhs(A, backend, rng, b0=None, x00=None):
    """N_BLOCK right-hand sides over A.rows and their starts over A.cols:
    column 0 ``b0`` (start ``x00``) where given, the others b_k = A x̂_k
    for x̂_k from the seed (made by A's SpMV on the card), started from
    `dirichlet_start`. Returns (B, X0, x̂s), x̂ None for b0."""
    dA = device_matrix(A, backend)
    spmv = make_spmv_fn(dA)
    dt = np.dtype(A.dtype)
    B, X0, Xe = [], [], []
    for k in range(N_BLOCK):
        if k == 0 and b0 is not None:
            B.append(b0)
            X0.append(x00)
            Xe.append(None)
            continue
        xh = PVector(A.cols.partition._like([rng.standard_normal(i.num_lids).astype(dt)
                                             for i in A.cols.partition.part_values()]), A.cols)
        y = spmv(DeviceVector.from_pvector(xh, backend, dA.col_layout).data)
        B.append(DeviceVector(y, A.rows, dA.row_layout, backend).to_pvector())
        X0.append(dirichlet_start(A, xh))
        Xe.append(xh)
    return B, X0, Xe


def _stream_csr(vals, offsets, no, o0, w):
    """The CSR (on the card) of a streaming operand's nonzero entries over
    the stacked frame: row p*w + o0 + i, column p*w + o0 + i + off_d, rows in
    order, each in ascending offset; every part's A_oo block on the
    diagonal, as one launch of the kernel computes them."""
    P, D, n = vals.shape
    dev = vals.device
    i = torch.arange(n, device=dev)
    own = i[None, :] < no.to(dev)[:, None]
    C = i[None, :, None] + torch.tensor(offsets, device=dev)[None, None, :]
    V = vals.permute(0, 2, 1)
    keep = own[:, :, None] & (C >= 0) & (C < no.to(dev)[:, None, None]) & (V != 0)
    base = (torch.arange(P, device=dev) * w + o0)[:, None, None]
    counts = torch.zeros(P * w, dtype=torch.int64, device=dev)
    rows = (base[:, :, 0] + i[None, :]).reshape(-1)
    counts[rows] = keep.sum(2).reshape(-1)
    crow = torch.zeros(P * w + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(counts, 0)
    return torch.sparse_csr_tensor(crow, (C + base)[keep], V[keep], size=(P * w, P * w))


def _hold_block_kernels(tag, dA, dmv, rng, errs):
    """The block kernels of a path torch.equal to their plain versions on
    random slabs of its shapes (K = N_BLOCK): the SpMM (coded: plain and
    pfold forms, with minv where given; streaming), and the block sweep
    (minv where given) with every other column frozen, and the block
    dot's products."""
    from partitionedarrays_jl_tpu_torch.ops import sweep as sw

    dev = dA.stream_vals.device if dA.dia_mode == "stream" else dA.coded.cb.device
    P, wx, wy, n, o0 = dA.col_layout.P, dA.col_layout.W, dA.row_layout.W, dA.row_layout.no_max, dA.row_layout.o0
    K = N_BLOCK
    x, pprev = _frame(rng, (P, wx, K), np.float32, dev), _frame(rng, (P, wx, K), np.float32, dev)
    if dA.dia_mode == "stream":
        args = (dA.stream_vals, x, dA.dia_offsets, dA.stream_no, o0, wy)
        errs[f"dia_stream_spmm[{tag}]"] = _compare(f"stream SpMM {tag}", dia.dia_stream_spmm(*args),
                                                   dia.dia_stream_spmm_plain(*args))
    else:
        op = dA.coded
        errs[f"dia_coded_spmm[{tag}]"] = _compare(f"coded SpMM {tag}", dia.dia_coded_spmm(op, x, wy),
                                                  dia.dia_coded_spmm_plain(op, x, wy))
        beta = _frame(rng, (K,), np.float32, dev)
        for mv in (None, dmv) if dmv is not None else (None,):
            got = dia.dia_coded_spmm_pfold(op, x, pprev, beta, wy, minv=mv)
            want = dia.dia_coded_spmm_pfold_plain(op, x, pprev, beta, wy, minv=mv)
            for what, a, b in zip(("y", "p"), got, want):
                errs[f"dia_coded_spmm[{tag},pfold{'_minv' if mv is not None else ''},{what}]"] = _compare(
                    f"coded SpMM pfold {tag} {what}", a, b)
    r, p = _frame(rng, (P, wx, K), np.float32, dev), _frame(rng, (P, wx, K), np.float32, dev)
    q = _frame(rng, (P, wy, K), np.float32, dev)
    m = P * n  # each column's block; the padding to the column stride is not written
    errs[f"block_products[{tag}]"] = _compare(f"block products {tag}",
                                              sw.block_products(p, q, o0, n).view(K, -1)[:, :m],
                                              sw.block_products_plain(p, q, o0, n).view(K, -1)[:, :m])
    alpha = _frame(rng, (K,), np.float32, dev)
    act = torch.tensor([(k + 1) % 2 for k in range(K)], dtype=torch.int32, device=dev)
    for mv in (None, dmv) if dmv is not None else (None,):
        outs = []
        for k in (sw.cg_sweep_block, sw.cg_sweep_block_plain):
            xc, rc = x.clone(), r.clone()
            part = torch.full((P, 2 * K if mv is not None else K, sw.chunks(n)), 0.5, dtype=torch.float32,
                              device=dev)
            res = k(rc, q, alpha, act, part, o0, n, x=xc, p=p, minv=mv)
            outs.append((xc, rc, part) + (tuple(res) if mv is not None else (res,)))
        for j, (a, b) in enumerate(zip(*outs)):
            errs[f"cg_sweep_block[{tag},{'minv' if mv is not None else 'cg'},{j}]"] = _compare(
                f"block sweep {tag} output {j}", a, b)
        frozen = act == 0
        require(torch.equal(outs[0][0][..., frozen], x[..., frozen]), f"block sweep {tag}: a frozen column moved")


def block_kernel_times(tag, dA, dmv, flush, rng):
    """The block kernels of a path timed at K = N_BLOCK (flushed ms), their
    plain versions, torch.sparse.mm of the operator's CSR on the (rows, K)
    slab for the SpMMs, and the bounds: the SpMM reads the operator once
    (the coded one: a code byte a row; the streaming one: D values a row),
    x and writes y (K values a row each; the pfold form reads r, pprev and
    writes p too); the block sweep moves x, p, r, q read and x, r written,
    K values a row each (minv once)."""
    from partitionedarrays_jl_tpu_torch.ops import sweep as sw

    P, wx, wy, n, o0 = dA.col_layout.P, dA.col_layout.W, dA.row_layout.W, dA.row_layout.no_max, dA.row_layout.o0
    dev = dA.stream_vals.device if dA.dia_mode == "stream" else dA.coded.cb.device
    K, item = N_BLOCK, 4
    rows = int(dA.row_layout.noids.sum())
    x = _frame(rng, (P, wx, K), np.float32, dev)
    out = {}
    if dA.dia_mode == "stream":
        D = len(dA.dia_offsets)
        args = (dA.stream_vals, x, dA.dia_offsets, dA.stream_no, o0, wy)
        csr = _stream_csr(dA.stream_vals, dA.dia_offsets, dA.stream_no, o0, wx)
        xs = x.reshape(P * wx, K)
        t = {"ms": time_ms(lambda: dia.dia_stream_spmm(*args), flush),
             "plain_ms": time_ms(lambda: dia.dia_stream_spmm_plain(*args), flush),
             "library_ms": time_ms(lambda: torch.sparse.mm(csr, xs), flush)}
        t["bound_ms"], t["bound_by"] = _bound_ms(rows * (D * item + 2 * K * item), 2 * D * rows * K)
        out["dia_stream_spmm"] = t
        del csr
    else:
        op = dA.coded
        code_bytes = op.codes.shape[1]
        csr = _coded_csr(op, wx)
        xs = x[0]
        t = {"ms": time_ms(lambda: dia.dia_coded_spmm(op, x, wy), flush),
             "plain_ms": time_ms(lambda: dia.dia_coded_spmm_plain(op, x, wy), flush),
             "library_ms": time_ms(lambda: torch.sparse.mm(csr, xs), flush)}
        nnz = int(csr._nnz())
        t["bound_ms"], t["bound_by"] = _bound_ms(rows * (code_bytes + 2 * K * item), 2 * nnz * K)
        pprev = _frame(rng, (P, wx, K), np.float32, dev)
        beta = _frame(rng, (K,), np.float32, dev)
        t["pfold_ms"] = time_ms(lambda: dia.dia_coded_spmm_pfold(op, x, pprev, beta, wy), flush)
        t["pfold_bound_ms"], _ = _bound_ms(rows * (code_bytes + 4 * K * item), 2 * nnz * K + 2 * rows * K)
        out["dia_coded_spmm"] = t
        del csr
    r, p = _frame(rng, (P, wx, K), np.float32, dev), _frame(rng, (P, wx, K), np.float32, dev)
    q = _frame(rng, (P, wy, K), np.float32, dev)
    # the block dot's products: the plain version is the one transposing
    # torch.mul that computes them, so it is the library call too
    t = {"ms": time_ms(lambda: sw.block_products(p, q, o0, n), flush),
         "plain_ms": time_ms(lambda: sw.block_products_plain(p, q, o0, n), flush)}
    t["library_ms"] = t["plain_ms"]
    t["bound_ms"], t["bound_by"] = _bound_ms(rows * 3 * K * item, rows * K)
    out["block_products"] = t
    alpha = torch.full((K,), 1e-3, dtype=torch.float32, device=dev)
    act = torch.ones((K,), dtype=torch.int32, device=dev)
    for name, mv in (("cg_sweep_block", None),) + ((("cg_sweep_block_minv", dmv),) if dmv is not None else ()):
        part = sw.sweep_partials(r, n, 2 * K if mv is not None else K)
        t = {"ms": time_ms(lambda: sw.cg_sweep_block(r, q, alpha, act, part, o0, n, x=x, p=p, minv=mv), flush),
             "plain_ms": time_ms(lambda: sw.cg_sweep_block_plain(r, q, alpha, act, part, o0, n, x=x, p=p, minv=mv),
                                 flush),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = _bound_ms(rows * (6 * K * item + (item if mv is not None else 0)),
                                                 (6 if mv is not None else 3) * 2 * rows * K)
        out[name] = t
    for t in out.values():
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
    emit({"phase": "block_kernel_times", "path": tag, "K": K, "reps": REPS, **out})
    return out


def phase_block(backend, run, rng):
    """Block CG at 192^3 f32, K = N_BLOCK right-hand sides (column 0 the
    main path's b, the others A x̂_k from the seed), through `cg(A, B=...)`
    and `pcg(A, B=..., minv=jacobi)`: on phase 3's coded operator (fused
    block CG) and on the varcoef operator (streaming; fused block CG and
    block Jacobi PCG). For each: launch counts by formula, per-column
    iterations equal to each column's solo solve, errors against x̂_k,
    graph against eager, block and solo seconds per iteration; the block
    kernels against their plain versions; and the repaired solo fused CG
    on the varcoef operator."""
    t = time.perf_counter()
    Av = prun(lambda parts: decouple_dirichlet(assemble_varcoef_poisson(parts, (N_MAIN,) * 3)), backend, (1, 1, 1))
    asm_s = time.perf_counter() - t
    t = time.perf_counter()
    dAv = device_matrix(Av, backend)
    lower_s = time.perf_counter() - t
    require(dAv.dia_mode == "stream", f"varcoef operator lowered as {dAv.dia_mode}, expected stream")
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=backend.device)
    errs, launches, times, solves = {}, {}, {}, []
    paths = (("coded", run["A"], run["b"], run["x0"], (False,)), ("varcoef", Av, None, None, (False, True)))
    for tag, A, b0, x00, preconds in paths:
        dA = device_matrix(A, backend)
        B, X0, Xe = block_rhs(A, backend, rng, b0, x00)
        mv = jacobi_preconditioner(A) if True in preconds else None
        dmv = _b_on_cols_layout(mv, dA) if mv is not None else None
        _hold_block_kernels(tag, dA, dmv, rng, errs)
        db = _block_on_cols_layout(B, dA)
        dx0 = _block_on_cols_layout(X0, dA, with_ghosts=True)
        spmm = "dia_stream_spmm" if dA.dia_mode == "stream" else "dia_coded_spmm"
        maxiter = 4 * A.rows.ngids
        for precond in preconds:
            name = f"{tag} block {'Jacobi PCG' if precond else 'CG'}"
            dia.reset_launches()
            t = time.perf_counter()
            xs, info = (pcg(A, B=B, X0=X0, minv=mv, tol=TOL_MAIN) if precond
                        else cg(A, B=B, X0=X0, tol=TOL_MAIN))
            sync()
            solve_s = time.perf_counter() - t
            got = dict(dia.LAUNCHES)
            dev_it = info["device_loop"]["device_iterations"]
            # the products: p.q once per device iteration, r.r (and r.z) once
            want = {spmm: 1 + dev_it, "cg_sweep_block": dev_it, "block_products": dev_it + (2 if precond else 1)}
            its = info["iterations_per_column"]
            solo, x_vs_solo = [], []
            for k in range(N_BLOCK):
                xk, ik = gpu_cg(A, B[k], x0=X0[k], tol=TOL_MAIN, minv=mv if precond else None)
                solo.append(ik["iterations"])
                x_vs_solo.append(float(np.max(np.abs(gather_pvector(xs[k]) - gather_pvector(xk)))))
            rel = [None if Xe[k] is None else _rel_err(xs[k], Xe[k]) for k in range(N_BLOCK)]
            extra = (dmv,) if precond else ()
            block_s, block_fixed = fixed_trip_s_per_iter(
                lambda m: with_args(make_block_cg_fn(dA, 0.0, m, N_BLOCK, precond=precond), *extra), db, dx0,
                *CG_TRIPS)
            solo_s, _ = fixed_trip_s_per_iter(
                lambda m: with_args(make_cg_fn(dA, 0.0, m, precond=precond), *extra), db[..., 1].contiguous(),
                dx0[..., 1].contiguous(), *CG_TRIPS)
            line = {
                "phase": "block_cg", "path": name, "n": N_MAIN, "dtype": "float32", "K": N_BLOCK, "tol": TOL_MAIN,
                "dia_mode": dA.dia_mode, "cg_body": info["cg_body"], "iterations_per_column": its,
                "solo_iterations": solo, "converged": info["converged"], "column_health": info["column_health"],
                "rel_err_per_column": rel, "x_vs_solo_max_abs_diff": x_vs_solo, "solve_s": solve_s, "kernels": got, "expected_launches": want,
                "device_loop": info["device_loop"], "block_s_per_iter": block_s,
                "per_rhs_s_per_iter": block_s / N_BLOCK, "solo_s_per_iter": solo_s,
                "per_rhs_speedup": solo_s / (block_s / N_BLOCK), "block_fixed_trip_s": block_fixed,
                "fixed_trips": CG_TRIPS,
            }
            emit(line)
            require(info["converged"] and info["cg_body"] == "fused", f"{name}: did not converge in the fused body")
            require(its == solo, f"{name}: per-column iterations {its}, solo {solo}")
            require(all(e is None or e < 0.5 for e in rel), f"{name}: errors against x̂ {rel}")
            scale = max(1.0, float(np.max(np.abs(gather_pvector(xs[0])))))
            require(max(x_vs_solo) <= 1e-6 * scale, f"{name}: block columns differ from their solo solves by {x_vs_solo}")
            for k in want:
                require(got[k] == want[k], f"{name}: {got[k]} {k} launches, expected {want[k]}")
            graph_vs_eager(name, lambda g: make_block_cg_fn(dA, TOL_MAIN, maxiter, N_BLOCK, precond=precond, graph=g),
                           db, dx0, *extra)
            for k in (spmm, "cg_sweep_block", "block_products"):
                launches.setdefault(k, got[k])
            solves.append(line)
        times.update(block_kernel_times(tag, dA, dmv, flush, rng))
    # the repaired fault: the default (fused) solo CG on the streaming operator
    bv = _block_on_cols_layout(block_rhs(Av, backend, rng)[0][1:2], dAv)[..., 0].contiguous()
    b1 = DeviceVector(bv, Av.rows, dAv.col_layout, backend).to_pvector()
    dia.reset_launches()
    x, info = cg(Av, b1, tol=TOL_MAIN)
    got = dict(dia.LAUNCHES)
    dev_it = device_iterations(info)
    want = {"dia_stream_spmv": 1 + dev_it, "cg_sweep": dev_it}
    s_fused, _ = fixed_trip_s_per_iter(lambda m: make_cg_fn(dAv, 0.0, m), bv, torch.zeros_like(bv), *CG_TRIPS)
    s_std, _ = fixed_trip_s_per_iter(lambda m: make_cg_fn(dAv, 0.0, m, fused=False), bv, torch.zeros_like(bv),
                                     *CG_TRIPS)
    _, info_s = gpu_cg(Av, b1, tol=TOL_MAIN, fused=False)
    emit({"phase": "stream_fused_cg", "n": N_MAIN, "dtype": "float32", "cg_body": info["cg_body"],
          "iterations": info["iterations"], "standard_iterations": info_s["iterations"],
          "converged": info["converged"], "kernels": got, "expected_launches": want, "fused_s_per_iter": s_fused,
          "standard_s_per_iter": s_std, "assembly_s": asm_s, "lowering_s": lower_s})
    require(info["cg_body"] == "fused" and info["converged"], "varcoef: the default CG did not run the fused body")
    require(info["iterations"] == info_s["iterations"], "varcoef: fused and standard CG took other iterations")
    for k in want:
        require(got[k] == want[k], f"varcoef fused CG: {got[k]} {k} launches, expected {want[k]}")
    emit({"phase": "block_kernels_vs_plain", "equal": True, "max_abs_err": errs})
    return {"errs": errs, "launches": launches, "times": times, "solves": solves}


# ---------------------------------------------------------------------------
# phase 4f: the non-band lowerings, the elasticity model, strict bits
# ---------------------------------------------------------------------------


def elastic_system(backend, n, nparts):
    """The tet-elasticity system on (n, n, n) nodes over `nparts` parts
    (f64, `assemble_elasticity_tet`) and the host assembly's seconds.
    The model is imported here, so that tools/time_coded_kernels.py can
    load this file over a checkout from before it."""
    from partitionedarrays_jl_tpu_torch import assemble_elasticity_tet

    t = time.perf_counter()
    A, b, xh, x0 = prun(lambda parts: assemble_elasticity_tet(parts, (n, n, n)), backend, nparts)
    return {"A": A, "b": b, "xh": xh, "x0": x0, "assembly_s": time.perf_counter() - t}


def _irregular_launches(dA, spmvs):
    """The launches of `spmvs` SpMVs of a non-band lowering: its A_oo
    kernel (SD's product is torch.bmm: none) and its boundary kernel (one
    launch an SpMV, over every node-block bucket) where A_oh is not
    empty."""
    want = {"bsr_spmv": spmvs if dA.lowering == "bsr" else 0, "ell_spmv": spmvs if dA.lowering == "ell" else 0,
            "bsr_spmv_boundary": 0, "ell_spmv_boundary": 0}
    if dA.oh_nnz:
        want["bsr_spmv_boundary" if dA.ohb_bs is not None else "ell_spmv_boundary"] = spmvs
    return want


def _hold_irregular_kernels(tag, dA, dtype, rng, errs):
    """E1/E2 of a lowering (A_oo and boundary modes) torch.equal to their
    plain versions on a random frame of the lowering's column layout, in
    the operator's (numpy) dtype."""
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    cl, rl = dA.col_layout, dA.row_layout
    dev = dA.backend.device
    x = _frame(rng, (cl.P, cl.W), dtype, dev)
    x[:, cl.trash] = 0
    if dA.lowering == "bsr":
        errs[f"bsr_spmv[{tag}]"] = _compare(
            f"{tag} bsr_spmv", irr.bsr_spmv(dA.bsr_vals, dA.bsr_cols, dA.bsr_counts, x, cl.o0, rl.o0, rl.W),
            irr.bsr_spmv_plain(*bsr_plain_operands(dA), x, cl.o0, rl.o0, rl.W))
    if dA.lowering == "ell":
        errs[f"ell_spmv[{tag}]"] = _compare(f"{tag} ell_spmv", irr.ell_spmv(dA.oo_vals, dA.oo_cols, x, rl.o0, rl.W),
                                            irr.ell_spmv_plain(dA.oo_vals, dA.oo_cols, x, rl.o0, rl.W))
    if not dA.oh_nnz:
        return
    y0 = _frame(rng, (rl.P, rl.W), dtype, dev)
    if dA.ohb_bs is not None:
        args = (dA.ohb_rows, dA.ohb_vals, dA.ohb_cols, x, cl.g0, dA.ohb_nhn)
        errs[f"bsr_spmv_boundary[{tag}]"] = _compare(
            f"{tag} bsr_spmv_boundary", irr.bsr_spmv_boundary(*args, y0.clone(), rl.trash),
            irr.bsr_spmv_boundary_plain(*args, y0.clone(), rl.trash))
    else:
        errs[f"ell_spmv_boundary[{tag}]"] = _compare(
            f"{tag} ell_spmv_boundary", irr.ell_spmv_boundary(dA.oh_rows, dA.oh_vals, dA.oh_cols, x, y0.clone(), rl.trash),
            irr.ell_spmv_boundary_plain(dA.oh_rows, dA.oh_vals, dA.oh_cols, x, y0.clone(), rl.trash))


def phase_elastic(backend, rng):
    """The tet-elasticity model at N_ELASTIC^3 nodes, f64, one part, through
    `pcg(A, b, x0=x0)` (Jacobi, tol 1e-12 as the driver's): its lowering
    (the JAX package's order off a TPU), staging seconds, launches by
    formula, error against x̂ under the model's gate, the plain path's
    iterations, graph against eager, seconds per iteration from fixed
    trips; E2 (or E1) held against its plain version."""
    el = elastic_system(backend, N_ELASTIC, 1)
    A, b, xh, x0 = el["A"], el["b"], el["xh"], el["x0"]
    t = time.perf_counter()
    dA = device_matrix(A, backend)
    sync()
    staging_s = time.perf_counter() - t
    emit({"phase": "elasticity_lowering", "n": N_ELASTIC, "dtype": "float64", "lowering": dA.lowering,
          "bs": dA.sd_bs or dA.bsr_bs, "staging_s": staging_s, "assembly_s": el["assembly_s"]})
    errs = {}
    _hold_irregular_kernels(f"elasticity {N_ELASTIC}^3 f64", dA, A.dtype, rng, errs)
    dia.reset_launches()
    t = time.perf_counter()
    x, info = pcg(A, b, x0=x0, tol=TOL_ELASTIC, maxiter=ELASTIC_MAXITER)
    sync()
    solve_s = time.perf_counter() - t
    launches = dict(dia.LAUNCHES)
    dev_it = device_iterations(info)
    want = {**_irregular_launches(dA, 1 + dev_it), "cg_sweep_precond": dev_it, "pairwise_dot": 0}
    kernel = "bsr_oo_kernel" if dA.lowering == "bsr" else None
    err = float((x - xh).norm())
    mv = jacobi_preconditioner(A)
    t = time.perf_counter()
    xp, info_p = gpu_cg(A, b, x0=x0, tol=TOL_ELASTIC, maxiter=ELASTIC_MAXITER, minv=mv, plain=True)
    plain_s = time.perf_counter() - t
    err_p = float((xp - xh).norm())
    db = _b_on_cols_layout(b, dA)
    dx0 = DeviceVector.from_pvector(x0, backend, dA.col_layout).data
    dmv = _b_on_cols_layout(mv, dA)
    g = graph_vs_eager(f"elasticity {N_ELASTIC}^3 f64 Jacobi PCG",
                       lambda gr: make_cg_fn(dA, TOL_ELASTIC, ELASTIC_MAXITER, precond=True, graph=gr), db, dx0, dmv)
    s_per_iter, fixed = fixed_trip_s_per_iter(
        lambda m: with_args(make_cg_fn(dA, 0.0, m, precond=True), dmv), db, dx0, *CG_TRIPS)
    # the path's A_oo product alone at its own shape and dtype (flushed)
    spmv = make_spmv_fn(dA)
    spmv_ms = time_ms(lambda: spmv(dx0), torch.empty(64 * 2**20, dtype=torch.uint8, device=backend.device))
    prof = phase_profile("elasticity_pcg_profile", with_args(make_cg_fn(dA, 0.0, 48, precond=True), dmv), db, dx0,
                         48)
    if kernel is not None:
        # one A_oo kernel an SpMV: the start's and one an iteration
        calls = [c for k, _, c in prof["rows"] if kernel in k]
        require(len(calls) == 1 and round(calls[0] * prof["iters"]) == 1 + prof["iters"],
                f"elasticity profile: {kernel} launches {calls} an iteration, expected one an SpMV")
    line = {"phase": "elasticity_pcg", "n": N_ELASTIC, "dofs": A.rows.ngids, "nnz": dA.flops_per_spmv // 2,
            "dtype": "float64", "parts": 1, "tol": TOL_ELASTIC, "lowering": info["lowering"],
            "cg_body": info["cg_body"], "iterations": info["iterations"], "converged": info["converged"],
            "err": err, "plain_iterations": info_p["iterations"], "plain_err": err_p, "plain_solve_s": plain_s,
            "assembly_s": el["assembly_s"], "staging_s": staging_s, "solve_s": solve_s, "kernels": launches,
            "expected_launches": want, "device_loop": info["device_loop"], "s_per_iter": s_per_iter,
            "fixed_trip_s": fixed, "fixed_trips": CG_TRIPS, "spmv_ms": spmv_ms, "max_abs_err": errs}
    emit(line)
    require(info["converged"] and err < 1e-5, f"elasticity: error {err} against x̂ (gate 1e-5)")
    require(info["iterations"] == info_p["iterations"], "elasticity: kernel and plain iterations differ")
    require(g["iterations"] == info["iterations"], "elasticity: graph-vs-eager iterations differ")
    for k in want:
        require(launches[k] == want[k], f"elasticity: {launches[k]} {k} launches, expected {want[k]}")
    out = {"line": line, "errs": errs, "launches": launches, "A": A, "b": b, "xh": xh, "x0": x0,
           "iterations": info["iterations"]}
    if dA.lowering == "bsr":
        out["bsr_f64"] = bsr_f64_times(A, dA, dx0, errs)
    return out


def bsr_plain_operands(dA):
    """E2's A_oo operands in the row-major form its plain version takes."""
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    return irr.bsr_row_major(dA.bsr_vals), irr.bsr_row_major(dA.bsr_cols)


def bsr_bytes(dA, x, item):
    """E2's A_oo bytes: the real blocks' values and int32 node columns, the
    counts, the x frame read and the y frame written once (the kernel
    reads no pad block)."""
    rl = dA.row_layout
    real = int(dA.bsr_counts.sum())
    return (real * dA.bsr_bs**2 * item + real * 4 + dA.bsr_counts.numel() * 4 + x.numel() * item
            + rl.P * rl.W * item)


def bsr_f64_times(A, dA, x, errs):
    """E2's A_oo product in float64 at the elasticity path's shape (the
    dtype of its solve): torch.equal to its plain version, flushed µs of
    the kernel, the plain version and torch.sparse.mm on the same CSR, the
    bound of the bytes it moves and the CSR's need."""
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    cl, rl = dA.col_layout, dA.row_layout
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dA.backend.device)
    args = (*bsr_plain_operands(dA), x, cl.o0, rl.o0, rl.W)
    kargs = (dA.bsr_vals, dA.bsr_cols, dA.bsr_counts, x, cl.o0, rl.o0, rl.W)
    errs[f"bsr_spmv[elasticity {N_ELASTIC}^3 f64 timed]"] = _compare("elasticity f64 bsr_spmv", irr.bsr_spmv(*kargs),
                                                                    irr.bsr_spmv_plain(*args))
    M = A.values.part_values()[0]
    csr = _csr_on(M, dA.backend.device)
    xcol = x[0, cl.o0 : cl.o0 + csr.shape[1]].reshape(-1, 1).contiguous()
    item = 8
    nbytes = bsr_bytes(dA, x, item)
    t = {"ms": time_ms(lambda: irr.bsr_spmv(*kargs), flush),
         "plain_ms": time_ms(lambda: irr.bsr_spmv_plain(*args), flush),
         "library_ms": time_ms(lambda: torch.sparse.mm(csr, xcol), flush), "bytes": nbytes,
         "staged_bytes": dA.bsr_vals.numel() * item + dA.bsr_cols.numel() * 4,
         "shape": f"{N_ELASTIC}^3 f64, bs {dA.bsr_bs}, {int(dA.bsr_vals.shape[1])} blocks", **_csr_need(M, item)}
    del csr
    t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, 2 * M.nnz, F64_FLOPS_PER_S)
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    emit({"phase": "bsr_spmv_f64", "n": N_ELASTIC, "dtype": "float64", "reps": REPS, **t})
    return t


def _f32_operator(A):
    """A's values scaled by their largest magnitude and cast to f32, as
    tools/bench_irregular.py:125-135 scales them."""
    from partitionedarrays_jl_tpu_torch.ops.sparse import CSRMatrix

    vals = map_parts(lambda M: CSRMatrix(M.indptr, M.indices, (M.data / np.abs(M.data).max()).astype(np.float32),
                                         M.shape), A.values)
    return PSparseMatrix(vals, A.rows, A.cols)


def phase_lowering_times(backend, el, rng):
    """The three lowerings of the elasticity operator at N_ELASTIC^3 in f32
    (values scaled as the JAX bench scales them): each one's staging
    seconds, the SpMV's flushed µs and GFLOP/s (flops_per_spmv over the
    time, the JAX bench's metric), torch.sparse.mm on the CSR; E1 and E2
    torch.equal to their plain versions and timed (their kernel line
    times), SD's torch.bmm product timed; the three products agree with
    the f64 host product to rounding."""
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    A32 = _f32_operator(el["A"])
    xh = PVector(map_parts(lambda v: np.asarray(v, dtype=np.float32), el["xh"].values), el["xh"].rows)
    from partitionedarrays_jl_tpu_torch.ops.sparse import csr_spmv

    M = A32.values.part_values()[0]
    x64 = np.asarray(xh.values.part_values()[0], dtype=np.float64)
    y_host = torch.from_numpy(csr_spmv(CSRMatrix(M.indptr, M.indices, M.data.astype(np.float64), M.shape), x64))
    # the products' magnitude |A| |x|: A x̂ cancels to O(h^2) of its terms
    y_abs = csr_spmv(CSRMatrix(M.indptr, M.indices, np.abs(M.data.astype(np.float64)), M.shape), np.abs(x64))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=backend.device)
    csr = _csr_on(M, backend.device)
    xcol = torch.from_numpy(np.asarray(xh.values.part_values()[0])).to(backend.device).reshape(-1, 1)
    library_ms = time_ms(lambda: torch.sparse.mm(csr, xcol), flush)
    del csr
    rows, nnz = M.shape[0], M.nnz
    out, times, errs, ys = {"library_ms": library_ms, "library_gflops": 2 * nnz / library_ms / 1e6}, {}, {}, {}
    for low in ("sd", "bsr", "ell"):
        t = time.perf_counter()
        dA = device_matrix(A32, backend, lowering=low)
        sync()
        staging_s = time.perf_counter() - t
        cl, rl = dA.col_layout, dA.row_layout
        x = DeviceVector.from_pvector(xh, backend, cl).data
        spmv = make_spmv_fn(dA)
        ms = time_ms(lambda: spmv(x), flush)
        ys[low] = spmv(x)[0, : rows].double().cpu()
        rec = {"lowering": dA.lowering, "staging_s": staging_s, "spmv_ms": ms,
               "gflops": dA.flops_per_spmv / ms / 1e6}
        item = 4
        if dA.lowering == "sd":
            vb = sum(v.numel() for v in dA.sd_vals) * item + sum(i.numel() for i in dA.sd_idx) * 8
            rec["sd_widths"] = [int(v.shape[-1]) for v in dA.sd_vals]
            t_sd = {"ms": ms, "plain_ms": ms, "library_ms": library_ms, "bytes": vb + 2 * rows * item}
            t_sd["bound_ms"], t_sd["bound_by"] = _bound_ms(t_sd["bytes"], 2 * sum(v.numel() for v in dA.sd_vals))
            times["sd_bmm"] = t_sd
        elif dA.lowering == "bsr":
            args = (*bsr_plain_operands(dA), x, cl.o0, rl.o0, rl.W)
            kargs = (dA.bsr_vals, dA.bsr_cols, dA.bsr_counts, x, cl.o0, rl.o0, rl.W)
            errs["bsr_spmv[elasticity f32]"] = _compare("elasticity f32 bsr_spmv", irr.bsr_spmv(*kargs),
                                                        irr.bsr_spmv_plain(*args))
            nbytes = bsr_bytes(dA, x, item)
            t_k = {"ms": time_ms(lambda: irr.bsr_spmv(*kargs), flush),
                   "plain_ms": time_ms(lambda: irr.bsr_spmv_plain(*args), flush), "library_ms": library_ms,
                   "bytes": nbytes, "staged_bytes": dA.bsr_vals.numel() * item + dA.bsr_cols.numel() * 4}
            t_k["bound_ms"], t_k["bound_by"] = _bound_ms(nbytes, 2 * nnz)
            t_k.update(_csr_need(M, item))
            times["bsr_spmv"] = t_k
            rec["Lb"] = int(dA.bsr_vals.shape[1])
        else:
            args = (dA.oo_vals, dA.oo_cols, x, rl.o0, rl.W)
            errs["ell_spmv[elasticity f32]"] = _compare("elasticity f32 ell_spmv", irr.ell_spmv(*args),
                                                        irr.ell_spmv_plain(*args))
            nbytes = (dA.oo_vals.numel() * item + dA.oo_cols.numel() * dA.oo_cols.element_size()
                      + x.numel() * item + rl.P * rl.W * item)
            t_k = {"ms": time_ms(lambda: irr.ell_spmv(*args), flush),
                   "plain_ms": time_ms(lambda: irr.ell_spmv_plain(*args), flush), "library_ms": library_ms,
                   "bytes": nbytes, "shape": f"{N_ELASTIC}^3 f32, {int(dA.oo_vals.shape[1])} slots"}
            t_k["bound_ms"], t_k["bound_by"] = _bound_ms(nbytes, 2 * nnz)
            t_k.update(_csr_need(M, item))
            times["ell_spmv"] = t_k
            rec["L"] = int(dA.oo_vals.shape[1])
        out[low] = rec
        A32._device.clear()
        del dA, x, spmv
        torch.cuda.empty_cache()
    scale = float(y_abs.max())
    agree = {low: float((ys[low] - y_host).abs().max()) / scale for low in ys}
    for t in times.values():
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
    emit({"phase": "elasticity_lowering_times", "n": N_ELASTIC, "dtype": "float32", "rows": rows, "nnz": nnz,
          "reps": REPS, **out, "diff_to_f64_host_over_abs_product": agree, "kernels": times, "max_abs_err": errs})
    for low, d in agree.items():
        # f32 rounding of up to 57 terms a row, against max |A| |x|
        require(d <= 1e-5, f"elasticity f32 {low}: product differs from the f64 host product by {d} of max |A||x|")
    require(out["sd"]["lowering"] == "sd" and out["bsr"]["lowering"] == "bsr" and out["ell"]["lowering"] == "ell",
            f"elasticity f32: lowerings resolved as {[out[k]['lowering'] for k in ('sd', 'bsr', 'ell')]}")
    return {"times": times, "errs": errs}


def phase_elastic_multi(backend, rng):
    """Elasticity on 4 parts stacked on the card, N_ELASTIC_MULTI^3 nodes,
    f64: the default lowering (SD, its boundary in node blocks: E2's
    boundary mode), BSR and forced ELL (E1 in both modes) through `pcg`,
    each with the port's sequential iterations, launches by formula and
    graph against eager; E1/E2 held against their plain versions on each;
    the boundary kernels timed on their paths' shapes (their kernel line
    times)."""
    el = elastic_system(backend, N_ELASTIC_MULTI, 4)
    A, b, xh, x0 = el["A"], el["b"], el["xh"], el["x0"]

    from partitionedarrays_jl_tpu_torch import assemble_elasticity_tet

    def seq(parts):
        Ah, bh, xhh, x0h = assemble_elasticity_tet(parts, (N_ELASTIC_MULTI,) * 3)
        xs, info_s = pcg(Ah, bh, x0=x0h, tol=TOL_ELASTIC, maxiter=ELASTIC_MAXITER)
        return gather_pvector(xs), info_s

    xs, info_s = prun(seq, sequential, 4)
    mv = jacobi_preconditioner(A)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=backend.device)
    errs, times, launches_out, lines = {}, {}, {}, []
    for low in ("auto", "bsr", "ell"):
        dA = device_matrix(A, backend, lowering=low)
        _hold_irregular_kernels(f"elasticity {N_ELASTIC_MULTI}^3 f64 4 parts {low}", dA, A.dtype, rng, errs)
        dia.reset_launches()
        x, info = pcg(A, b, x0=x0, tol=TOL_ELASTIC, maxiter=ELASTIC_MAXITER, lowering=low)
        sync()
        launches = dict(dia.LAUNCHES)
        dev_it = device_iterations(info)
        want = {**_irregular_launches(dA, 1 + dev_it), "cg_sweep_precond": dev_it}
        db = _b_on_cols_layout(b, dA)
        dx0 = DeviceVector.from_pvector(x0, backend, dA.col_layout).data
        dmv = _b_on_cols_layout(mv, dA)
        graph_vs_eager(f"elasticity {N_ELASTIC_MULTI}^3 f64 (4 parts) {low}",
                       lambda gr: make_cg_fn(dA, TOL_ELASTIC, ELASTIC_MAXITER, precond=True, graph=gr), db, dx0, dmv)
        diff = float(np.max(np.abs(gather_pvector(x) - xs)))
        line = {"phase": "elasticity_stacked_parts", "n": N_ELASTIC_MULTI, "dtype": "float64", "parts": 4,
                "lowering": dA.lowering, "ohb_bs": dA.ohb_bs, "boundary_buckets": len(dA.ohb_rows or ()),
                "iterations": info["iterations"], "sequential_iterations": info_s["iterations"],
                "x_vs_sequential_max_abs_diff": diff, "kernels": launches, "expected_launches": want}
        emit(line)
        lines.append(line)
        require(info["converged"] and info["iterations"] == info_s["iterations"],
                f"elasticity 4 parts {low}: {info['iterations']} iterations, sequential {info_s['iterations']}")
        require(diff <= 1e-10, f"elasticity 4 parts {low}: solution differs from the sequential one by {diff}")
        for k in want:
            require(launches[k] == want[k], f"elasticity 4 parts {low}: {launches[k]} {k} launches, expected {want[k]}")
        if low == "auto":
            require(dA.lowering == "sd" and dA.ohb_bs is not None, "elasticity 4 parts: no node-block boundary on SD")
            launches_out["bsr_spmv_boundary"] = launches["bsr_spmv_boundary"]
        if low == "ell":
            launches_out["ell_spmv_boundary"] = launches["ell_spmv_boundary"]
        if low in ("auto", "ell"):
            times.update(_boundary_times(A, dA, rng, flush))
    emit({"phase": "boundary_kernel_times", "n": N_ELASTIC_MULTI, "dtype": "float64", "parts": 4, "reps": REPS,
          **times})
    return {"errs": errs, "times": times, "launches": launches_out, "lines": lines, "A": A, "b": b, "x0": x0,
            "sequential_iterations": info_s["iterations"]}


def _boundary_times(A, dA, rng, flush):
    """The boundary kernel of a multi-part lowering, timed over one SpMV's
    call (one launch over every node-block bucket, or the ELL call) against
    its plain version; library: torch.sparse.mm of the stacked parts'
    block-diagonal A_oh CSR on the ghost values (the products only, not the
    add into y). Bound (`_boundary_bytes`): the staged arrays and the
    ghost slots of the x frame (the only part of x the kernel reads) read
    once, the boundary rows of y read and written; beside it the CSR's
    need."""
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    cl, rl = dA.col_layout, dA.row_layout
    item = 8
    x = _frame(rng, (cl.P, cl.W), np.float64, dA.backend.device)
    y = _frame(rng, (rl.P, rl.W), np.float64, dA.backend.device)
    oh = A.owned_ghost_values.part_values()
    csr = _csr_on(_block_diagonal(oh), dA.backend.device)
    xg = torch.from_numpy(rng.standard_normal((csr.shape[1], 1))).to(dA.backend.device)
    library_ms = time_ms(lambda: torch.sparse.mm(csr, xg), flush)
    if dA.ohb_bs is not None:
        def run(k):
            k(dA.ohb_rows, dA.ohb_vals, dA.ohb_cols, x, cl.g0, dA.ohb_nhn, y, rl.trash)

        staged = sum(t.numel() * t.element_size() for t in (*dA.ohb_rows, *dA.ohb_cols, *dA.ohb_vals))
        touched = sum(int((r != rl.trash).sum()) for r in dA.ohb_rows)
        name, kern, plain = "bsr_spmv_boundary", irr.bsr_spmv_boundary, irr.bsr_spmv_boundary_plain
    else:
        def run(k):
            k(dA.oh_rows, dA.oh_vals, dA.oh_cols, x, y, rl.trash)

        staged = sum(t.numel() * t.element_size() for t in (dA.oh_rows, dA.oh_cols, dA.oh_vals))
        touched = int((dA.oh_rows != rl.trash).sum())
        name, kern, plain = "ell_spmv_boundary", irr.ell_spmv_boundary, irr.ell_spmv_boundary_plain
    nbytes, csr_bytes, nnz = _boundary_bytes(oh, staged, touched, 1, item)
    dia.reset_launches()
    run(kern)
    calls = dia.LAUNCHES[name]
    t = {"ms": time_ms(lambda: run(kern), flush), "plain_ms": time_ms(lambda: run(plain), flush),
         "library_ms": library_ms, "bytes": nbytes, "calls_per_spmv": calls,
         "buckets": len(dA.ohb_rows or ()), "shape": f"{N_ELASTIC_MULTI}^3 f64, 4 parts",
         "csr_bytes": csr_bytes, "csr_bound_ms": csr_bytes / HBM_BYTES_PER_S * 1e3}
    require(calls == 1, f"{name}: {calls} launches for one SpMV's boundary, expected 1")
    t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, 2 * nnz, F64_FLOPS_PER_S)
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    return {name: t}


def _boundary_bytes(oh, staged, touched, K, item):
    """The bytes one boundary product over K columns must move, the CSR's
    bytes for the same product, and A_oh's entries. Both read the ghost
    columns of x once (the kernels gather no owned slot) and read and write
    the touched rows of y; the staging adds its staged arrays, the CSR its
    values, int32 columns and row pointers."""
    nnz, ghosts = sum(m.nnz for m in oh), sum(m.shape[1] for m in oh)
    vectors = ghosts * K * item + 2 * touched * K * item
    return staged + vectors, nnz * (item + 4) + (touched + len(oh)) * 4 + vectors, nnz


def _block_diagonal(blocks):
    """The CSR of a block-diagonal matrix of per-part CSR blocks."""
    indptr, indices, data, r0, c0 = [np.zeros(1, dtype=np.int64)], [], [], 0, 0
    for m in blocks:
        indptr.append(m.indptr[1:].astype(np.int64) + indptr[-1][-1])
        indices.append(m.indices.astype(np.int64) + c0)
        data.append(m.data)
        r0, c0 = r0 + m.shape[0], c0 + m.shape[1]
    return CSRMatrix(np.concatenate(indptr), np.concatenate(indices), np.concatenate(data), (r0, c0))


def strict_pair(backend, ns, nparts, K=1, dtype=np.float64):
    """Strict CG on the Poisson operator over `nparts`, K columns (b = A x̂
    taken in strict mode, of the assembly's x̂ and, for K > 1, of seeded x̂_k
    started at their Dirichlet values), on the card (K = 1: a solo solve,
    else one block solve) against the port's sequential strict solo solve
    of each column: the card's info, its launches (zeroed just before its
    solve), per column whether iterations, residual history bits and
    solution bits agree (`_bitwise_columns`), the sequential iterations,
    and column 0's relative error against x̂."""

    def columns(parts):
        A, _, xe, x0 = assemble_poisson(parts, ns, dtype=dtype)
        Xe = [xe] + [_gid_vector(A.cols, SEED + 20 + k) for k in range(1, K)]
        B = [A.mul_into(PVector.full(0.0, A.rows, dtype=dtype), x, strict=True) for x in Xe]
        return A, B, [x0] + [dirichlet_start(A, x) for x in Xe[1:]], xe

    def solve(A, B, X0, many):
        if many:
            return cg(A, B=B, X0=X0, tol=1e-8, maxiter=2000, strict=True)
        x, info = cg(A, B[0], x0=X0[0], tol=1e-8, maxiter=2000, strict=True)
        return [x], info

    return _strict_columns(backend, nparts, K, columns, solve, _rel_err)


def strict_elastic_pair(backend, n, nparts, K=1):
    """Strict Jacobi PCG on the tet-elasticity system assembled in strict
    mode (`assemble_elasticity_tet(strict=True)`: b = A x̂ by the strict
    product, as the JAX package assembles it under PA_TPU_STRICT_BITS=1),
    K columns (its b and, for K > 1, strict A x̂_k of seeded x̂_k from
    their Dirichlet values), on the card against the port's sequential
    strict solo PCG of each column, as `strict_pair`; the error is column
    0's norm against x̂."""
    from partitionedarrays_jl_tpu_torch import assemble_elasticity_tet

    def columns(parts):
        A, b, xh, x0 = assemble_elasticity_tet(parts, (n, n, n), strict=True)
        Xe = [_gid_vector(A.cols, SEED + 30 + k) for k in range(1, K)]
        B = [b] + [A.mul_into(PVector.full(0.0, A.rows), x, strict=True) for x in Xe]
        return A, B, [x0] + [dirichlet_start(A, x) for x in Xe], xh

    def solve(A, B, X0, many):
        if many:
            return pcg(A, B=B, X0=X0, tol=TOL_ELASTIC, maxiter=ELASTIC_MAXITER, strict=True)
        x, info = pcg(A, B[0], x0=X0[0], tol=TOL_ELASTIC, maxiter=ELASTIC_MAXITER, strict=True)
        return [x], info

    return _strict_columns(backend, nparts, K, columns, solve, lambda x, xh: float((x - xh).norm()))


def _strict_columns(backend, nparts, K, columns, solve, err):
    """The comparison of `strict_pair` and `strict_elastic_pair`: each
    column of ``columns(parts) -> (A, B, X0, x̂)`` solved alone by
    ``solve(A, [b], [x0], False)`` on the sequential backend, then all of
    them by ``solve(A, B, X0, K > 1)`` on the card."""

    def seq(parts):
        A, B, X0, _ = columns(parts)
        out = [solve(A, [bk], [x0k], False) for bk, x0k in zip(B, X0)]
        return [(gather_pvector(xs[0]).tobytes(), i["iterations"], np.asarray(i["residuals"]).tobytes())
                for xs, i in out]

    def card(parts):
        A, B, X0, xh = columns(parts)
        dia.reset_launches()
        xs, info = solve(A, B, X0, K > 1)
        sync()
        return [gather_pvector(x).tobytes() for x in xs], info, dict(dia.LAUNCHES), err(xs[0], xh)

    solo = prun(seq, sequential, nparts)
    xs, info, launches, e = prun(card, backend, nparts)
    return info, launches, _bitwise_columns(info, xs, solo), [s[1] for s in solo], e


def phase_strict(backend, run, rng):
    """Strict CG (the ELL lowering on the generic plan, E1 in both modes,
    E3's dots, the standard body) on the card against the port's
    sequential strict loop, bit for bit: 6^3 on (2,2,2) parts (the JAX
    package's strict test) and the stacked N_MULTI^3 f64 (2,2,2) cell;
    launches by formula. Then at N_MAIN^3 f32, one part: strict CG's
    seconds per iteration against the default fused CG's, and E3 held bit
    for bit against its plain version and timed at that shape."""
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    out = {"errs": {}, "launches": {}}
    for n in (6, N_MULTI):
        info, launches, (equal,), _, err = strict_pair(backend, (n, n, n), (2, 2, 2))
        dev_it = device_iterations(info)
        want = {"ell_spmv": 1 + dev_it, "ell_spmv_boundary": 1 + dev_it, "pairwise_dot": 1 + 2 * dev_it,
                "cg_sweep": dev_it, "dia_coded_spmv": 0, "dia_coded_spmv_pfold": 0}
        emit({"phase": "strict_cg", "n": n, "dtype": "float64", "parts": [2, 2, 2], "lowering": info["lowering"],
              "cg_body": info["cg_body"], "iterations": info["iterations"], "rel_err": err,
              "bitwise_equal_to_sequential": equal, "kernels": launches, "expected_launches": want,
              "device_loop": info["device_loop"]})
        require(all(equal.values()), f"strict CG {n}^3: the card differs from the sequential oracle: {equal}")
        require(info["lowering"] == "ell" and info["cg_body"] == "standard", f"strict CG {n}^3: {info['lowering']}, "
                f"{info['cg_body']}")
        for k in want:
            require(launches[k] == want[k], f"strict CG {n}^3: {launches[k]} {k} launches, expected {want[k]}")
        if n == N_MULTI:
            out["launches"] = {k: launches[k] for k in ("ell_spmv", "pairwise_dot")}
            out["launches"]["ell_spmv_boundary_strict"] = launches["ell_spmv_boundary"]
    # strict Jacobi PCG on the elasticity system, b taken in strict mode
    info, launches, (equal,), _, err = strict_elastic_pair(backend, N_STRICT_ELASTIC, 4)
    emit({"phase": "strict_elasticity_pcg", "n": N_STRICT_ELASTIC, "dtype": "float64", "parts": 4,
          "lowering": info["lowering"], "iterations": info["iterations"], "err": err,
          "bitwise_equal_to_sequential": equal, "kernels": {k: launches[k] for k in ("ell_spmv", "ell_spmv_boundary",
                                                                                     "pairwise_dot")}})
    require(all(equal.values()) and info["lowering"] == "ell" and err < 1e-5,
            f"strict elasticity PCG {N_STRICT_ELASTIC}^3: {equal}, {info['lowering']}, error {err}")
    # strict mode's cost at the main cell
    A = run["A"]
    dS = device_matrix(A, backend, strict=True)
    dD = device_matrix(A, backend)
    bS, xS = _b_on_cols_layout(run["b"], dS), DeviceVector.from_pvector(run["x0"], backend, dS.col_layout).data
    bD, xD = run["b_dev"], run["x0_dev"]
    s_strict, fixed_strict = fixed_trip_s_per_iter(lambda m: make_cg_fn(dS, 0.0, m), bS, xS, *CG_TRIPS)
    s_fused, fixed_fused = fixed_trip_s_per_iter(lambda m: make_cg_fn(dD, 0.0, m), bD, xD, *CG_TRIPS)
    prof = phase_profile("strict_cg_profile", make_cg_fn(dS, 0.0, 48), bS, xS, 48)
    # E3 is one kernel a dot: p.q and r.r an iteration, and the start's r.r
    # unless the trace dropped the solve's first launches (phase_profile)
    calls = [c for k, _, c in prof["rows"] if "pairwise" in k]
    require(len(calls) == 1 and round(calls[0] * prof["iters"]) - 2 * prof["iters"] in (0, 1),
            f"strict profile: E3 kernels {calls} an iteration, expected one a dot (2 + 1/iterations)")
    o0, n = dS.row_layout.o0, dS.row_layout.no_max
    a = _frame(rng, (1, dS.row_layout.W), np.float32, backend.device)
    c = _frame(rng, (1, dS.row_layout.W), np.float32, backend.device)
    got, want = irr.pairwise_dot(a, c, o0, n), irr.pairwise_dot_plain(a, c, o0, n)
    sync()
    require(got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes(), "pairwise_dot: kernel differs from its plain version")
    out["errs"]["pairwise_dot[192^3 f32]"] = float((got - want).abs())
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=backend.device)
    av, cv = a[0, o0 : o0 + n], c[0, o0 : o0 + n]
    t = {"ms": time_ms(lambda: irr.pairwise_dot(a, c, o0, n), flush),
         "plain_ms": time_ms(lambda: irr.pairwise_dot_plain(a, c, o0, n), flush),
         "library_ms": time_ms(lambda: torch.dot(av, cv), flush), "bytes": 2 * n * 4}
    t["bound_ms"], t["bound_by"] = _bound_ms(t["bytes"], 2 * n)
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    # E1 on the strict lowering of the main cell (7 slots a row)
    args = (dS.oo_vals, dS.oo_cols, bS, dS.row_layout.o0, dS.row_layout.W)
    out["errs"]["ell_spmv[192^3 f32 strict]"] = _compare("192^3 strict ell_spmv", irr.ell_spmv(*args),
                                                          irr.ell_spmv_plain(*args))
    M = A.values.part_values()[0]
    ell192 = {"ms": time_ms(lambda: irr.ell_spmv(*args), flush),
              "plain_ms": time_ms(lambda: irr.ell_spmv_plain(*args), flush),
              "bytes": dS.oo_vals.numel() * 4 + dS.oo_cols.numel() * dS.oo_cols.element_size() + 2 * bS.numel() * 4,
              "shape": f"{N_MAIN}^3 f32 strict, {int(dS.oo_vals.shape[1])} slots", **_csr_need(M, 4)}
    csr = _csr_on(M, backend.device)
    xcol = bS[0, : csr.shape[1]].reshape(-1, 1).contiguous()
    ell192["library_ms"] = time_ms(lambda: torch.sparse.mm(csr, xcol), flush)
    del csr
    ell192["bound_ms"], ell192["bound_by"] = _bound_ms(ell192["bytes"], 2 * int(M.nnz))
    ell192["share_of_bound"] = ell192["bound_ms"] / ell192["ms"]
    emit({"phase": "strict_cost", "n": N_MAIN, "dtype": "float32", "parts": 1, "strict_s_per_iter": s_strict,
          "fused_s_per_iter": s_fused, "strict_over_fused": s_strict / s_fused, "strict_fixed_trip_s": fixed_strict,
          "fused_fixed_trip_s": fixed_fused, "fixed_trips": CG_TRIPS, "pairwise_dot": t,
          "ell_spmv_strict_lowering": ell192, "ell_slots": int(dS.oo_vals.shape[1])})
    out["times"] = {"pairwise_dot": t}
    out["strict_s_per_iter"] = s_strict
    return out


# ---------------------------------------------------------------------------
# phase 4g: block solves on the non-band lowerings, strict block solves
# ---------------------------------------------------------------------------


def _gid_vector(rows, seed):
    """A PVector over `rows` holding a seeded standard normal vector indexed
    by gid: the same values on every backend."""
    v = np.random.default_rng(seed).standard_normal(rows.ngids)
    return PVector(rows.partition._like([v[np.asarray(i.lid_to_gid)] for i in rows.partition.part_values()]), rows)


def _carried(rows, vecs):
    """Host PVectors over `rows` holding the part values of `vecs` (the
    same index sets, assembled on another backend)."""
    return [PVector(rows.partition._like([np.array(v) for v in w.values.part_values()]), rows) for w in vecs]


def _frames_of(fn, x, K):
    """The frame form on each column of a slab, stacked into a slab."""
    return torch.stack([fn(x[..., k].contiguous()) for k in range(K)], dim=-1)


#: SD's block columns against their solo solves: cuBLAS sums a K-column
#: product in another order than a one-column product, so a column agrees
#: to rounding and may stop an iteration sooner or later near tol 1e-12
SD_ITERATIONS_APART = 1
SD_X_REL_TOL = 1e-8


def _block_columns(name, A, B, X0, info, xs, solve_one, exact=True):
    """Each block column against its solo solve on the card: the same
    iterations and solution bytes, or with ``exact=False`` (SD) iterations
    at most SD_ITERATIONS_APART apart and solutions within SD_X_REL_TOL of
    the largest |x|. Returns the solo iterations and the max |diff| a
    column."""
    solo, diff = [], []
    for k in range(len(B)):
        xk, ik = solve_one(B[k], X0[k])
        solo.append(ik["iterations"])
        a, b = gather_pvector(xs[k]), gather_pvector(xk)
        diff.append(0.0 if a.tobytes() == b.tobytes() else float(np.max(np.abs(a - b))))
        if not exact:
            require(diff[-1] <= SD_X_REL_TOL * max(1.0, float(np.max(np.abs(b)))),
                    f"{name}: column {k} differs from its solo solve by {diff[-1]}")
    its = info["iterations_per_column"]
    if exact:
        require(its == solo, f"{name}: per-column iterations {its}, solo {solo}")
        require(not any(diff), f"{name}: block columns differ from their solo solves by {diff}")
    else:
        require(max(abs(a - b) for a, b in zip(its, solo)) <= SD_ITERATIONS_APART,
                f"{name}: per-column iterations {its}, solo {solo}")
    return solo, diff


def phase_block_elastic(backend, el, rng):
    """Block Jacobi PCG on phase 4f's N_ELASTIC^3 f64 elasticity system (the
    BSR lowering, E2's slab form), K = N_BLOCK right-hand sides through
    `pcg(A, B=..., X0=...)`, tol 1e-12: column 0 phase 4f's b from its x0,
    the others A x̂_k from the seed started at their Dirichlet values.
    Launches by formula (E2's slab form 1 + 1, the block sweep 1 a device
    iteration), every column's iterations and solution bit for bit its solo
    `pcg`, column 0's error against x̂ under the model's gate and every
    column's relative error under 1e-5, graph against eager, block
    seconds per iteration per RHS against the solo ones, a profile of the
    block iteration; E2's slab form torch.equal to its plain version and to
    K frame launches, timed beside torch.sparse.mm on the (rows, K) slab."""
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    A, K = el["A"], N_BLOCK
    dA = device_matrix(A, backend)
    require(dA.lowering == "bsr", f"elasticity {N_ELASTIC}^3 f64: lowering {dA.lowering}, expected bsr")
    B, X0, Xe = block_rhs(A, backend, rng, el["b"], el["x0"])
    Xe[0] = el["xh"]
    mv = jacobi_preconditioner(A)
    dmv = _b_on_cols_layout(mv, dA)
    db, dx0 = _block_on_cols_layout(B, dA), _block_on_cols_layout(X0, dA, with_ghosts=True)
    name = f"elasticity {N_ELASTIC}^3 f64 block Jacobi PCG"
    dia.reset_launches()
    t = time.perf_counter()
    xs, info = pcg(A, B=B, X0=X0, tol=TOL_ELASTIC, maxiter=ELASTIC_MAXITER)
    sync()
    solve_s = time.perf_counter() - t
    got = dict(dia.LAUNCHES)
    dev_it = device_iterations(info)
    want = {"bsr_spmm": 1 + dev_it, "bsr_spmv": 0, "cg_sweep_block": dev_it, "block_products": dev_it + 2}
    solo, _ = _block_columns(name, A, B, X0, info, xs,
                             lambda bk, x0k: pcg(A, bk, x0=x0k, tol=TOL_ELASTIC, maxiter=ELASTIC_MAXITER))
    err0 = float((xs[0] - Xe[0]).norm())
    rel = [_rel_err(xs[k], Xe[k]) for k in range(K)]
    g = graph_vs_eager(name, lambda gr: make_block_cg_fn(dA, TOL_ELASTIC, ELASTIC_MAXITER, K, precond=True, graph=gr),
                       db, dx0, dmv)
    block_s, block_fixed = fixed_trip_s_per_iter(
        lambda m: with_args(make_block_cg_fn(dA, 0.0, m, K, precond=True), dmv), db, dx0, *CG_TRIPS)
    solo_s, _ = fixed_trip_s_per_iter(lambda m: with_args(make_cg_fn(dA, 0.0, m, precond=True), dmv),
                                      db[..., 0].contiguous(), dx0[..., 0].contiguous(), *CG_TRIPS)
    prof = phase_profile("elasticity_block_pcg_profile",
                         with_args(make_block_cg_fn(dA, 0.0, 48, K, precond=True), dmv), db, dx0, 48)
    calls = [c for k, _, c in prof["rows"] if "bsr_oo_slab_kernel" in k]
    require(len(calls) == 1 and round(calls[0] * prof["iters"]) == 1 + prof["iters"],
            f"elasticity block profile: E2 slab kernels {calls} an iteration, expected one an SpMV")
    line = {"phase": "elasticity_block_pcg", "n": N_ELASTIC, "dtype": "float64", "parts": 1, "K": K,
            "tol": TOL_ELASTIC, "lowering": info["lowering"], "cg_body": info["cg_body"],
            "iterations_per_column": info["iterations_per_column"], "solo_iterations": solo,
            "solo_iterations_column0_phase_4f": el["iterations"], "converged": info["converged"],
            "err_column0": err0, "rel_err_per_column": rel, "solve_s": solve_s, "kernels": got,
            "expected_launches": want, "device_loop": info["device_loop"], "block_s_per_iter": block_s,
            "per_rhs_s_per_iter": block_s / K, "solo_s_per_iter": solo_s, "per_rhs_speedup": solo_s / (block_s / K),
            "block_fixed_trip_s": block_fixed, "fixed_trips": CG_TRIPS, "graph_iterations": g["iterations"]}
    emit(line)
    require(info["converged"] and info["lowering"] == "bsr", f"{name}: {info['lowering']}, converged "
            f"{info['converged']}")
    require(solo[0] == el["iterations"], f"{name}: column 0 took {solo[0]} solo iterations, phase 4f {el['iterations']}")
    require(err0 < 1e-5 and max(rel) < 1e-5, f"{name}: column 0 error {err0}, relative errors {rel}")
    for k in want:
        require(got[k] == want[k], f"{name}: {got[k]} {k} launches, expected {want[k]}")
    # E2's slab form at the path's shape (its bsr_spmm_times line is emitted
    # with the 4-part path's, `emit_bsr_spmm_times`)
    errs = {}
    frame_ms = K * el["bsr_f64"]["ms"] if "bsr_f64" in el else None
    t = _bsr_spmm_times(A, dA, K, rng, errs, f"elasticity {N_ELASTIC}^3 f64 K={K}",
                        f"{N_ELASTIC}^3 f64, bs {dA.bsr_bs}, K = {K}", frame_ms_times_K=frame_ms)
    return {"line": line, "errs": errs, "launches": got, "times": {"bsr_spmm": t}}


def _bsr_spmm_times(A, dA, K, rng, errs, tag, shape, **extra):
    """E2's slab form at a block path's shape, x (P, W_cols, K) f64:
    torch.equal to its plain version and to K frame launches, one launch;
    timed beside torch.sparse.mm of the stacked parts' block-diagonal A_oo
    CSR on a (columns, K) slab. Bound: the real blocks, their int32 node
    columns, the counts, the owned node rows of the x slab and the whole y
    slab once; beside it the same in the
    whole 32-byte sectors the staging's node order makes the card read
    (`bsr_sector_bytes`)."""
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    cl, rl, dev = dA.col_layout, dA.row_layout, dA.backend.device
    x = _frame(rng, (cl.P, cl.W, K), np.float64, dev)
    x[:, cl.trash] = 0
    kargs = (dA.bsr_vals, dA.bsr_cols, dA.bsr_counts, x, cl.o0, rl.o0, rl.W)
    pargs = (*bsr_plain_operands(dA), x, cl.o0, rl.o0, rl.W)
    dia.reset_launches()
    y = irr.bsr_spmm(*kargs)
    sync()
    require(dia.LAUNCHES["bsr_spmm"] == 1, f"{tag} bsr_spmm: not one launch")
    errs[f"bsr_spmm[{tag}]"] = _compare(f"{tag} bsr_spmm", y, irr.bsr_spmm_plain(*pargs))
    errs[f"bsr_spmm[{tag},frames]"] = _compare(f"{tag} bsr_spmm against {K} bsr_spmv", y, _frames_of(
        lambda xk: irr.bsr_spmv(dA.bsr_vals, dA.bsr_cols, dA.bsr_counts, xk, cl.o0, rl.o0, rl.W), x, K))
    oo = A.owned_owned_values.part_values()
    csr = _csr_on(_block_diagonal(oo), dev)
    xs_ = _frame(rng, (csr.shape[1], K), np.float64, dev)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    real = int(dA.bsr_counts.sum())
    # x: the owned node rows the kernel addresses (node columns and pad
    # terms), never the ghost layer or the trash slot; y: its whole width
    x_bytes = cl.P * dA.bsr_counts.shape[1] * dA.bsr_bs * K * 8
    nbytes = real * (dA.bsr_bs**2 * 8 + 4) + dA.bsr_counts.numel() * 4 + x_bytes + rl.P * rl.W * K * 8
    sector_bytes = bsr_sector_bytes(dA, 8) + x_bytes + rl.P * rl.W * K * 8
    t = {"ms": time_ms(lambda: irr.bsr_spmm(*kargs), flush), "plain_ms": time_ms(lambda: irr.bsr_spmm_plain(*pargs), flush),
         "library_ms": time_ms(lambda: torch.sparse.mm(csr, xs_), flush), "bytes": nbytes, "parts": cl.P,
         "sector_bytes": sector_bytes, "sector_bound_ms": sector_bytes / HBM_BYTES_PER_S * 1e3, **extra, "shape": shape}
    del csr
    t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, 2 * sum(m.nnz for m in oo) * K, F64_FLOPS_PER_S)
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    return t


def bsr_sector_bytes(dA, item):
    """The bytes E2's A_oo operands move in whole 32-byte sectors: at block
    slot l a sector of a slot-major value stream holds 32 / item
    neighbouring nodes (of a node column stream 8) and is read if any of
    them has more than l real blocks, so a node of few blocks beside one
    of many costs its pads' share of the sector; plus the counts. The
    frames' bytes are the caller's."""
    counts = dA.bsr_counts.long()
    P, nn = counts.shape

    def sectors(per):
        c = torch.nn.functional.pad(counts, (0, (-nn) % per)).view(P, -1, per)
        return int(c.amax(dim=2).sum())

    return (sectors(32 // item) * dA.bsr_bs**2 + sectors(8)) * 32 + counts.numel() * 4


def emit_bsr_spmm_times(bel, belm):
    """Phase 4g's `bsr_spmm_times` line: E2's slab form on the 64^3 block
    PCG's slabs (the kernels line's numbers) and, under ``four_parts``, on
    the 4-part BSR block PCG's."""
    errs = {k: v for k, v in {**bel["errs"], **belm["errs"]}.items() if k.startswith("bsr_spmm[")}
    emit({"phase": "bsr_spmm_times", "reps": REPS, **bel["times"]["bsr_spmm"], "four_parts": belm["bsr_spmm"],
          "max_abs_err": errs})


def phase_block_elastic_multi(backend, elm, rng):
    """Block Jacobi PCG on phase 4f's N_ELASTIC_MULTI^3 f64 system on 4
    stacked parts, K = N_BLOCK_MULTI (column 0 its b, the others A x̂_k
    from the seed), in each lowering (SD with the node-block boundary: E2's
    boundary mode on slabs; BSR: E2's slab forms; forced ELL: E1's slab and
    boundary forms): each column the sequential backend's iterations and
    its solo solve on the card (bit for bit on BSR and ELL; on SD, whose
    torch.bmm orders a K-column product its own way, to SD_X_REL_TOL and
    within SD_ITERATIONS_APART iterations of the solo and the sequential
    solves: the host's CSR product and cuBLAS's differ in rounding),
    launches by formula, graph against eager; E2's boundary mode on the
    SD path's (P, W, K) slabs torch.equal to its plain version and to K
    frame launches, timed."""
    from partitionedarrays_jl_tpu_torch import assemble_elasticity_tet
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    A, K = elm["A"], N_BLOCK_MULTI
    Xe = [None] + [_gid_vector(A.cols, SEED + 10 + k) for k in range(1, K)]
    B = [elm["b"]] + [A @ x for x in Xe[1:]]
    X0 = [elm["x0"]] + [dirichlet_start(A, x) for x in Xe[1:]]

    def seq(parts):
        Ah = assemble_elasticity_tet(parts, (N_ELASTIC_MULTI,) * 3)[0]
        _, info_s = pcg(Ah, B=_carried(Ah.rows, B), X0=_carried(Ah.cols, X0), tol=TOL_ELASTIC,
                        maxiter=ELASTIC_MAXITER)
        return info_s["iterations_per_column"]

    seq_its = prun(seq, sequential, 4)
    require(seq_its[0] == elm["sequential_iterations"], f"elasticity 4 parts: sequential column 0 {seq_its[0]}")
    mv = jacobi_preconditioner(A)
    errs, slab_errs, times, launches_out, lines, bsr4 = {}, {}, {}, {}, [], None
    for low in ("auto", "bsr", "ell"):
        dA = device_matrix(A, backend, lowering=low)
        name = f"elasticity {N_ELASTIC_MULTI}^3 f64 (4 parts) {low} block Jacobi PCG"
        dia.reset_launches()
        xs, info = pcg(A, B=B, X0=X0, tol=TOL_ELASTIC, maxiter=ELASTIC_MAXITER, lowering=low)
        sync()
        got = dict(dia.LAUNCHES)
        spmvs = 1 + device_iterations(info)
        want = {"bsr_spmm": spmvs if dA.lowering == "bsr" else 0, "ell_spmm": spmvs if dA.lowering == "ell" else 0,
                "bsr_spmv_boundary": spmvs if dA.ohb_bs is not None else 0,
                "ell_spmv_boundary": spmvs if dA.ohb_bs is None else 0, "cg_sweep_block": spmvs - 1}
        solo, diff = _block_columns(
            name, A, B, X0, info, xs,
            lambda bk, x0k: pcg(A, bk, x0=x0k, tol=TOL_ELASTIC, maxiter=ELASTIC_MAXITER, lowering=low),
            exact=dA.lowering != "sd")
        db, dx0 = _block_on_cols_layout(B, dA), _block_on_cols_layout(X0, dA, with_ghosts=True)
        graph_vs_eager(name, lambda gr: make_block_cg_fn(dA, TOL_ELASTIC, ELASTIC_MAXITER, K, precond=True, graph=gr),
                       db, dx0, _b_on_cols_layout(mv, dA))
        line = {"phase": "elasticity_block_stacked_parts", "n": N_ELASTIC_MULTI, "dtype": "float64", "parts": 4,
                "K": K, "lowering": dA.lowering, "ohb_bs": dA.ohb_bs, "iterations_per_column": info["iterations_per_column"],
                "sequential_iterations": seq_its, "solo_iterations": solo, "x_vs_solo_max_abs_diff": diff,
                "kernels": got, "expected_launches": want}
        emit(line)
        lines.append(line)
        apart = max(abs(a - b) for a, b in zip(info["iterations_per_column"], seq_its))
        require(info["converged"] and apart <= (SD_ITERATIONS_APART if dA.lowering == "sd" else 0),
                f"{name}: iterations {info['iterations_per_column']}, sequential {seq_its}")
        for k in want:
            require(got[k] == want[k], f"{name}: {got[k]} {k} launches, expected {want[k]}")
        if dA.lowering == "bsr":
            # E2's slab form at this path's shape, for the bsr_spmm_times line
            bsr4 = _bsr_spmm_times(A, dA, K, rng, slab_errs, f"elasticity {N_ELASTIC_MULTI}^3 f64 4 parts BSR K={K}",
                                   f"{N_ELASTIC_MULTI}^3 f64, 4 parts, bs {dA.bsr_bs}, K = {K}")
        if low == "auto":
            require(dA.lowering == "sd" and dA.ohb_bs is not None, "elasticity 4 parts: no node-block boundary on SD")
            # E2's boundary kernel on slabs: this run's launches of it
            launches_out["bsr_spmv_boundary_slab"] = got["bsr_spmv_boundary"]
            times.update(_boundary_slab_times(A, dA, rng, errs))
    emit({"phase": "boundary_slab_kernel_times", "n": N_ELASTIC_MULTI, "dtype": "float64", "parts": 4, "K": K,
          "reps": REPS, **times, "max_abs_err": errs})
    return {"errs": {**errs, **slab_errs}, "times": times, "launches": launches_out, "lines": lines, "bsr_spmm": bsr4}


def _boundary_slab_times(A, dA, rng, errs):
    """E2's boundary mode on the slabs the 4-part SD block PCG gives it, x
    (P, W_cols, N_BLOCK_MULTI) and y (P, W_rows, N_BLOCK_MULTI):
    torch.equal to its plain version and to K frame launches, one launch
    over every bucket; timed beside torch.sparse.mm of the stacked parts'
    block-diagonal A_oh CSR on the (ghosts, K) slab. Bound
    (`_boundary_bytes`): the staged arrays, the ghost columns of the x slab
    (the only part of x the kernel reads) once, the touched rows of y read
    and written; beside it the CSR's need."""
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    cl, rl, K, item = dA.col_layout, dA.row_layout, N_BLOCK_MULTI, 8
    dev = dA.backend.device
    x = _frame(rng, (cl.P, cl.W, K), np.float64, dev)
    y = _frame(rng, (rl.P, rl.W, K), np.float64, dev)
    args = (dA.ohb_rows, dA.ohb_vals, dA.ohb_cols)
    tag = f"elasticity {N_ELASTIC_MULTI}^3 f64 4 parts SD K={K}"
    dia.reset_launches()
    got = irr.bsr_spmv_boundary(*args, x, cl.g0, dA.ohb_nhn, y.clone(), rl.trash)
    sync()
    require(dia.LAUNCHES["bsr_spmv_boundary"] == 1, "bsr_spmv_boundary on slabs: not one launch")
    errs[f"bsr_spmv_boundary_slab[{tag}]"] = _compare(
        f"{tag} boundary slab", got, irr.bsr_spmv_boundary_plain(*args, x, cl.g0, dA.ohb_nhn, y.clone(), rl.trash))
    frames = torch.stack([irr.bsr_spmv_boundary(*args, x[..., k].contiguous(), cl.g0, dA.ohb_nhn,
                                                y[..., k].contiguous(), rl.trash) for k in range(K)], dim=-1)
    errs[f"bsr_spmv_boundary_slab[{tag},frames]"] = _compare(f"{tag} boundary slab against {K} frames", got, frames)
    oh = A.owned_ghost_values.part_values()
    csr = _csr_on(_block_diagonal(oh), dev)
    xg = torch.from_numpy(rng.standard_normal((csr.shape[1], K))).to(dev)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    staged = sum(t.numel() * t.element_size() for t in (*dA.ohb_rows, *dA.ohb_cols, *dA.ohb_vals))
    touched = sum(int((r != rl.trash).sum()) for r in dA.ohb_rows)
    nbytes, csr_bytes, nnz = _boundary_bytes(oh, staged, touched, K, item)

    def run(k):
        k(*args, x, cl.g0, dA.ohb_nhn, y, rl.trash)

    t = {"ms": time_ms(lambda: run(irr.bsr_spmv_boundary), flush),
         "plain_ms": time_ms(lambda: run(irr.bsr_spmv_boundary_plain), flush),
         "library_ms": time_ms(lambda: torch.sparse.mm(csr, xg), flush), "bytes": nbytes,
         "buckets": len(dA.ohb_rows), "shape": f"{N_ELASTIC_MULTI}^3 f64, 4 parts, K = {K}",
         "csr_bytes": csr_bytes, "csr_bound_ms": csr_bytes / HBM_BYTES_PER_S * 1e3}
    t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, 2 * nnz * K, F64_FLOPS_PER_S)
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    return {"bsr_spmv_boundary_slab": t}


def _bitwise_columns(info, xs, solo):
    """Per column of a solve on the card (the K columns of a block solve,
    or the one of a solo solve), whether its iterations, residual history
    bytes and solution bytes equal those of its solo solve ``(x bytes,
    iterations, history bytes)``."""
    cols = info["columns"] if "columns" in info else [info]
    return [{"iterations": c["iterations"] == it, "residuals": np.asarray(c["residuals"]).tobytes() == hist,
             "x": xk == x} for c, xk, (x, it, hist) in zip(cols, xs, solo)]


def phase_block_strict(backend, run, st, rng):
    """Strict block CG (the ELL lowering on the generic plan, E1's slab and
    boundary forms, E3's block form, the standard body): N_MULTI^3 f64 on
    (2,2,2) parts with STRICT_BLOCK_K ragged columns, every column bit for
    bit the sequential backend's strict solo solve, launches by formula (E1
    slab 1 + 1, E1 boundary 1 + 1, E3 block 1 + 2 a device iteration);
    strict block Jacobi PCG on the N_STRICT_ELASTIC^3 elasticity system on
    4 parts, bit for bit; at N_MAIN^3 f32, one part, K = N_BLOCK: strict
    block seconds per iteration per RHS against phase 4f's strict solo,
    and E1's slab form and E3's block form torch.equal to their plain
    versions and to K frame launches, timed (torch.sparse.mm on the (rows,
    K) slab, torch.linalg.vecdot over the slab)."""
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    out = {"errs": {}, "times": {}}
    info, launches, equal, seq_its, _ = strict_pair(backend, (N_MULTI,) * 3, (2, 2, 2), K=STRICT_BLOCK_K)
    dev_it = device_iterations(info)
    want = {"ell_spmm": 1 + dev_it, "ell_spmv_boundary": 1 + dev_it, "pairwise_dot_block": 1 + 2 * dev_it,
            "cg_sweep_block": dev_it, "ell_spmv": 0, "pairwise_dot": 0}
    its = info["iterations_per_column"]
    emit({"phase": "strict_block_cg", "n": N_MULTI, "dtype": "float64", "parts": [2, 2, 2], "K": STRICT_BLOCK_K,
          "lowering": info["lowering"], "cg_body": info["cg_body"], "iterations_per_column": its,
          "sequential_iterations": seq_its, "bitwise_equal_to_sequential": equal, "kernels": launches,
          "expected_launches": want, "device_loop": info["device_loop"]})
    require(all(all(e.values()) for e in equal), f"strict block CG {N_MULTI}^3: columns differ from the sequential "
            f"oracle: {equal}")
    require(len(set(its)) > 1, f"strict block CG {N_MULTI}^3: the block is not ragged: {its}")
    require(info["strict"] and info["lowering"] == "ell" and info["cg_body"] == "standard",
            f"strict block CG: {info['lowering']}, {info['cg_body']}")
    for k in want:
        require(launches[k] == want[k], f"strict block CG {N_MULTI}^3: {launches[k]} {k} launches, expected {want[k]}")
    out["launches"] = {k: launches[k] for k in ("ell_spmm", "pairwise_dot_block")}
    info_e, _, equal_e, _, _ = strict_elastic_pair(backend, N_STRICT_ELASTIC, 4, K=STRICT_BLOCK_K)
    emit({"phase": "strict_elasticity_block_pcg", "n": N_STRICT_ELASTIC, "dtype": "float64", "parts": 4,
          "K": STRICT_BLOCK_K, "lowering": info_e["lowering"], "iterations_per_column": info_e["iterations_per_column"],
          "bitwise_equal_to_sequential": equal_e})
    require(all(all(e.values()) for e in equal_e) and info_e["lowering"] == "ell",
            f"strict block elasticity PCG {N_STRICT_ELASTIC}^3: {equal_e}")
    # the main cell, one part, f32, K = N_BLOCK
    K = N_BLOCK
    dS = device_matrix(run["A"], backend, strict=True)
    o0, n, W = dS.row_layout.o0, dS.row_layout.no_max, dS.row_layout.W
    bS = _b_on_cols_layout(run["b"], dS)
    xS = DeviceVector.from_pvector(run["x0"], backend, dS.col_layout).data
    scale = torch.tensor([1.0 + 0.125 * k for k in range(K)], dtype=bS.dtype, device=bS.device)
    db, dx0 = (bS[..., None] * scale).contiguous(), (xS[..., None] * scale).contiguous()
    s_block, fixed = fixed_trip_s_per_iter(lambda m: make_block_cg_fn(dS, 0.0, m, K), db, dx0, *CG_TRIPS)
    prof = phase_profile("strict_block_cg_profile", make_block_cg_fn(dS, 0.0, 48, K), db, dx0, 48)
    # as in phase_strict: 2 an iteration and the start's one, if the trace kept it
    calls = [c for k, _, c in prof["rows"] if "pairwise_dot_block" in k]
    require(len(calls) == 1 and round(calls[0] * prof["iters"]) - 2 * prof["iters"] in (0, 1),
            f"strict block profile: E3 block kernels {calls} an iteration, expected one a dot")
    emit({"phase": "strict_block_cost", "n": N_MAIN, "dtype": "float32", "parts": 1, "K": K,
          "strict_block_s_per_iter": s_block, "per_rhs_s_per_iter": s_block / K,
          "strict_solo_s_per_iter": st["strict_s_per_iter"], "per_rhs_speedup": st["strict_s_per_iter"] / (s_block / K),
          "fixed_trip_s": fixed, "fixed_trips": CG_TRIPS})
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=backend.device)
    tag = f"{N_MAIN}^3 f32 strict K={K}"
    # E1's slab form on the strict lowering
    x = _frame(rng, (1, W, K), np.float32, backend.device)
    args = (dS.oo_vals, dS.oo_cols, x, o0, W)
    y = irr.ell_spmm(*args)
    out["errs"][f"ell_spmm[{tag}]"] = _compare(f"{tag} ell_spmm", y, irr.ell_spmm_plain(*args))
    out["errs"][f"ell_spmm[{tag},frames]"] = _compare(
        f"{tag} ell_spmm against {K} ell_spmv", y, _frames_of(lambda xk: irr.ell_spmv(dS.oo_vals, dS.oo_cols, xk, o0, W),
                                                               x, K))
    M = run["A"].values.part_values()[0]
    csr = _csr_on(M, backend.device)
    xs_ = x[0, : csr.shape[1]].contiguous()
    nbytes = dS.oo_vals.numel() * 4 + dS.oo_cols.numel() * 4 + x.numel() * 4 + W * K * 4
    t = {"ms": time_ms(lambda: irr.ell_spmm(*args), flush), "plain_ms": time_ms(lambda: irr.ell_spmm_plain(*args), flush),
         "library_ms": time_ms(lambda: torch.sparse.mm(csr, xs_), flush), "bytes": nbytes,
         "shape": f"{N_MAIN}^3 f32 strict, {int(dS.oo_vals.shape[1])} slots, K = {K}"}
    del csr
    t["bound_ms"], t["bound_by"] = _bound_ms(nbytes, 2 * int(M.nnz) * K)
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    out["times"]["ell_spmm"] = t
    # E3's block form
    a, c = _frame(rng, (1, W, K), np.float32, backend.device), _frame(rng, (1, W, K), np.float32, backend.device)
    got = irr.pairwise_dot_block(a, c, o0, n)
    want_b = irr.pairwise_dot_block_plain(a, c, o0, n)
    frames = torch.stack([irr.pairwise_dot(a[..., k].contiguous(), c[..., k].contiguous(), o0, n) for k in range(K)])
    sync()
    require(got.cpu().numpy().tobytes() == want_b.cpu().numpy().tobytes() == frames.cpu().numpy().tobytes(),
            "pairwise_dot_block: kernel differs from its plain version or from the frame kernel")
    out["errs"][f"pairwise_dot_block[{tag}]"] = float((got - want_b).abs().max())
    ab, cb = a[:, o0 : o0 + n], c[:, o0 : o0 + n]
    t = {"ms": time_ms(lambda: irr.pairwise_dot_block(a, c, o0, n), flush),
         "plain_ms": time_ms(lambda: irr.pairwise_dot_block_plain(a, c, o0, n), flush),
         "library_ms": time_ms(lambda: torch.linalg.vecdot(ab, cb, dim=1), flush), "bytes": 2 * n * K * 4,
         "shape": f"{N_MAIN}^3 f32, K = {K}"}
    t["bound_ms"], t["bound_by"] = _bound_ms(t["bytes"], 2 * n * K)
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    out["times"]["pairwise_dot_block"] = t
    emit({"phase": "strict_block_kernel_times", "reps": REPS, **out["times"], "max_abs_err": out["errs"]})
    return out


# ---------------------------------------------------------------------------
# phase 4h: strict GMG-PCG, the Q1 FE model, the transient heat march
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def timing_calls(module, name, secs):
    """Add the seconds of every call of ``module.name`` to ``secs[name]``
    while the context is open: one section of a model function timed from
    outside it."""
    fn = getattr(module, name)

    def timed_call(*args, **kw):
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            secs[name] = secs.get(name, 0.0) + time.perf_counter() - t

    setattr(module, name, timed_call)
    try:
        yield secs
    finally:
        setattr(module, name, fn)


def strict_gmg_launches(h, dh, dev_it):
    """The launches of a strict GMG-PCG solve of ``dev_it`` device
    iterations: every level's A and S on the ELL lowering (E1's A_oo form
    once an SpMV: the initial residual, and per iteration the outer A0
    product and per level 2 with A and 2 with S), E1's boundary form once
    an SpMV of an operator with an A_oh block, E3 once a dot (r.r at the
    start; r.z, p.q and r.r an iteration), the sweep, the epilogue; no
    band kernel and no stencil kernel."""
    levels = dh["levels"]
    oh_a = [1 if lv["dA"].oh_nnz else 0 for lv in levels]
    oh_s = [1 if lv["dS"].oh_nnz else 0 for lv in levels]
    epilogues = (h.pre + h.post + 1 if h.pre > 0 else h.post + 1) * len(levels)
    return {"ell_spmv": 1 + dev_it * (1 + 4 * len(levels)),
            "ell_spmv_boundary": oh_a[0] + dev_it * (oh_a[0] + 2 * sum(oh_a) + 2 * sum(oh_s)),
            "pairwise_dot": 1 + 3 * dev_it, "cg_sweep": dev_it, "vcycle_epilogue": dev_it * epilogues,
            "dia_coded_spmv": 0, "dia_stream_spmv": 0, "box_stencil_apply": 0}


def _hold_boundary(dM, x, tag, errs):
    """The boundary kernel of an operator with an A_oh block (E2's on a
    node-block staging, else E1's boundary mode) torch.equal to its plain
    version on the frame x, whose ghost slots the caller refreshed."""
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    if not dM.oh_nnz:
        return
    yk = torch.zeros((x.shape[0], dM.row_layout.W), dtype=x.dtype, device=x.device)
    yp, trash = yk.clone(), dM.row_layout.trash
    if dM.ohb_bs is not None:
        name, args = "bsr_spmv_boundary", (dM.ohb_rows, dM.ohb_vals, dM.ohb_cols, x, dM.col_layout.g0, dM.ohb_nhn)
        irr.bsr_spmv_boundary(*args, yk, trash)
        irr.bsr_spmv_boundary_plain(*args, yp, trash)
    else:
        name, args = "ell_spmv_boundary", (dM.oh_rows, dM.oh_vals, dM.oh_cols, x)
        irr.ell_spmv_boundary(*args, yk, trash)
        irr.ell_spmv_boundary_plain(*args, yp, trash)
    errs[f"{name}[{tag}]"] = _compare(f"{tag} {name}", yk, yp)


def _hold_level_products(dh, rng, tag, errs, ell=True):
    """On every level's A and S (where the level has one) of a staged
    hierarchy, on a random frame with its ghost slots refreshed by the
    operator's exchange: the boundary kernel (`_hold_boundary`) and, with
    ``ell`` (a strict hierarchy, every operator on ELL), E1's A_oo form,
    each torch.equal to its plain version."""
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    for li, lv in enumerate(dh["levels"]):
        for name in ("dA", "dS"):
            if name not in lv:
                continue
            dM = lv[name]
            L = dM.col_layout
            x = _frame(rng, (L.P, L.W), np.float64 if lv["dinv"].dtype == torch.float64 else np.float32,
                       lv["dinv"].device)
            exchange_(dM.col_plan, x)
            if ell:
                args = (dM.oo_vals, dM.oo_cols, x, L.o0, dM.row_layout.W)
                errs[f"ell_spmv[{tag} L{li} {name}]"] = _compare(f"{tag} L{li} {name} ell_spmv", irr.ell_spmv(*args),
                                                                 irr.ell_spmv_plain(*args))
            _hold_boundary(dM, x, f"{tag} L{li} {name}", errs)


def strict_gmg_system(parts, n, ct):
    """The decoupled Poisson system with b = A x̂ taken in strict mode, as
    the JAX package assembles it under PA_TPU_STRICT_BITS=1, and its
    hierarchy (tests/test_torch_strict.py's strict GMG-PCG cases)."""
    A, _, xe, _ = assemble_poisson(parts, (n, n, n))
    b = A.mul_into(PVector.full(0.0, A.rows), xe, strict=True)
    Ah, bh = decouple_dirichlet(A, b)
    return Ah, bh, xe, gmg_hierarchy(parts, Ah, (n, n, n), coarse_threshold=ct)


def phase_strict_gmg(backend, gmain, rng):
    """Strict GMG-PCG (`pcg(Ah, bh, minv=h, strict=True)`: every level's
    operator and S on the ELL lowering and the generic plan, E1 in both
    modes, E3's dots, the standard body) on (2,2,2) stacked parts, f64, at
    STRICT_GMG_CASES: the port's sequential strict solve's iterations, the
    solution and history to GMG_STRICT_RTOL (tests/test_torch_strict.py's
    tolerance), launches by formula per device iteration, the kernel path
    bit for bit the plain versions' path (so every E1 and E3 launch of it
    equals its plain version), E1 held on every level's A and S, graph
    against eager. Then the 192^3 f32 GMG cell's hierarchy staged strict:
    E1 in both modes held on every level's A and S of that staging, the
    staging seconds and fixed-trip seconds per iteration against the
    default GMG-PCG's, as `strict_cost` does for CG."""
    errs, out = {}, {"errs": {}}
    for n, ct in STRICT_GMG_CASES:
        def seq(parts):
            Ah, bh, xe, h = strict_gmg_system(parts, n, ct)
            x, info = pcg(Ah, bh, minv=h, tol=TOL_STRICT_GMG, strict=True)
            return gather_pvector(x), info["iterations"], np.asarray(info["residuals"])

        def card(parts):
            Ah, bh, xe, h = strict_gmg_system(parts, n, ct)
            dia.reset_launches()
            t = time.perf_counter()
            x, info = pcg(Ah, bh, minv=h, tol=TOL_STRICT_GMG, strict=True)
            sync()
            solve_s = time.perf_counter() - t
            launches = dict(dia.LAUNCHES)
            xp, info_p = gpu_gmg.gpu_gmg_pcg(h, bh, tol=TOL_STRICT_GMG, plain=True, strict=True)
            dh = gpu_gmg.device_hierarchy(h, backend, strict=True)
            return {"x": gather_pvector(x), "info": info, "launches": launches, "xp": gather_pvector(xp),
                    "info_p": info_p, "h": h, "dh": dh, "bh": bh, "Ah": Ah, "err": _rel_err(x, xe),
                    "solve_s": solve_s}

        xs, it_s, hist_s = prun(seq, sequential, (2, 2, 2))
        r = prun(card, backend, (2, 2, 2))
        info, dh = r["info"], r["dh"]
        dev_it = device_iterations(info)
        want = strict_gmg_launches(r["h"], dh, dev_it)
        hist = np.asarray(info["residuals"])
        x_rel = float(np.linalg.norm(r["x"] - xs) / np.linalg.norm(xs))
        hist_rel = float(np.abs(hist - hist_s).max() / hist_s[0]) if len(hist) == len(hist_s) else None
        tag = f"strict GMG {n}^3 ct={ct}"
        _hold_level_products(dh, rng, tag, errs)
        routes = [gpu_gmg.route(lv) for lv in dh["levels"]]
        emit({"phase": "strict_gmg_pcg", "n": n, "coarse_threshold": ct, "dtype": "float64", "parts": [2, 2, 2],
              "levels": len(dh["levels"]), "coarse_size": r["h"].coarse_A.rows.ngids, "routes": routes,
              "lowerings": [(lv["dA"].lowering, lv["dS"].lowering) for lv in dh["levels"]],
              "iterations": info["iterations"], "sequential_iterations": it_s,
              "plain_iterations": r["info_p"]["iterations"], "x_rel_to_sequential": x_rel,
              "history_rel_to_sequential": hist_rel, "tolerance": GMG_STRICT_RTOL, "rel_err": r["err"],
              "solve_s": r["solve_s"], "kernel_path_equals_plain_path": bool(np.array_equal(r["x"], r["xp"])),
              "kernels": r["launches"], "expected_launches": want, "device_loop": info["device_loop"]})
        require(info["strict"] and info["lowering"] == "ell" and "stencil" not in routes,
                f"{tag}: lowering {info['lowering']}, routes {routes}")
        require(all(lv["dA"].lowering == lv["dS"].lowering == "ell" for lv in dh["levels"]), f"{tag}: a level off ELL")
        require(info["converged"] and info["iterations"] == it_s == r["info_p"]["iterations"],
                f"{tag}: iterations {info['iterations']}, sequential {it_s}, plain {r['info_p']['iterations']}")
        require(x_rel <= GMG_STRICT_RTOL and hist_rel is not None and hist_rel <= GMG_STRICT_RTOL,
                f"{tag}: x {x_rel}, history {hist_rel} from the sequential solve (tolerance {GMG_STRICT_RTOL})")
        require(np.array_equal(r["x"], r["xp"]), f"{tag}: the kernel path differs from the plain versions' path")
        for k in want:
            require(r["launches"][k] == want[k], f"{tag}: {r['launches'][k]} {k} launches, expected {want[k]}")
        if (n, ct) == STRICT_GMG_CASES[-1]:
            b = _b_on_cols_layout(r["bh"], dh["levels"][0]["dA"])
            graph_vs_eager(f"{tag} f64 (2,2,2)", lambda g: gpu_gmg.make_gmg_pcg_fn(
                r["h"], backend, TOL_STRICT_GMG, 4 * r["Ah"].rows.ngids, graph=g, strict=True), b, torch.zeros_like(b))
            out["launches"] = {k: r["launches"][k] for k in ("ell_spmv", "ell_spmv_boundary", "pairwise_dot")}
    # the 192^3 f32 GMG cell's hierarchy staged strict, against its default staging
    h, Ah, bh = gmain["h"], gmain["Ah"], gmain["bh"]
    t = time.perf_counter()
    dhs = gpu_gmg.device_hierarchy(h, backend, strict=True)
    sync()
    staging_s = time.perf_counter() - t
    _hold_level_products(dhs, rng, f"strict GMG {N_MAIN}^3 f32", errs)
    bS = _b_on_cols_layout(bh, dhs["levels"][0]["dA"])
    bD = _b_on_cols_layout(bh, device_matrix(Ah, backend))
    s_strict, fixed_strict = fixed_trip_s_per_iter(
        lambda m: gpu_gmg.make_gmg_pcg_fn(h, backend, 0.0, m, strict=True), bS, torch.zeros_like(bS), *GMG_TRIPS)
    s_default, fixed_default = fixed_trip_s_per_iter(
        lambda m: gpu_gmg.make_gmg_pcg_fn(h, backend, 0.0, m), bD, torch.zeros_like(bD), *GMG_TRIPS)
    x, info = pcg(Ah, bh, minv=h, tol=TOL_MAIN, strict=True)
    emit({"phase": "strict_gmg_cost", "n": N_MAIN, "dtype": "float32", "parts": 1, "levels": len(dhs["levels"]),
          "routes": [gpu_gmg.route(lv) for lv in dhs["levels"]], "staging_s": staging_s,
          "ell_slots": [int(lv["dA"].oo_vals.shape[1]) for lv in dhs["levels"]],
          "strict_s_per_iter": s_strict, "default_s_per_iter": s_default, "strict_over_default": s_strict / s_default,
          "strict_fixed_trip_s": fixed_strict, "default_fixed_trip_s": fixed_default, "fixed_trips": GMG_TRIPS,
          "strict_iterations_to_tol": info["iterations"], "strict_rel_err": _rel_err(x, gmain["xe"]),
          "default_iterations_to_tol": GMG_ITERATIONS})
    require(info["converged"], "strict GMG-PCG at 192^3 f32 did not converge")
    out["errs"] = errs
    return out


def _coded_bytes(dA, reads, writes):
    """The bytes a coded SpMV variant must move on its staged operator: the
    code bytes and the codebook once, and ``reads`` + ``writes`` vectors of
    the owned rows."""
    op = dA.coded
    rows = int(dA.row_layout.noids.sum())
    item = op.cb.element_size()
    return op.codes.numel() * op.codes.element_size() + op.cb.numel() * item + (reads + writes) * rows * item


def q1_kernel_times(A, dA, rng, errs, flush):
    """K1 and K2 on the Q1 operator's staging (P parts, f64), its boundary
    kernel and the CG sweep at its frames: each torch.equal to its plain
    version on random frames; then K1 and K2 timed (flushed
    µs), beside the bound of the bytes each must move (the codes, the
    codebook, x read and y written; K2 also r and pprev read and p
    written) and of its operations, and torch.sparse.mm of the parts'
    block-diagonal A_oo CSR on the stacked owned x."""
    op, P, wx, wy = dA.coded, dA.col_layout.P, dA.col_layout.W, dA.row_layout.W
    x, r, pprev = (_frame(rng, (P, wx), np.float64, A.values.backend.device) for _ in range(3))
    beta = torch.tensor(0.37, dtype=torch.float64, device=x.device)
    errs["dia_coded_spmv[Q1]"] = _compare("Q1 dia_coded_spmv", dia.dia_coded_spmv(op, x, wy),
                                           dia.dia_coded_spmv_plain(op, x, wy))
    yk, pk = dia.dia_coded_spmv_pfold(op, r, pprev, beta, wy)
    yp, pp = dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta, wy)
    errs["dia_coded_spmv_pfold[Q1,y]"] = _compare("Q1 dia_coded_spmv_pfold y", yk, yp)
    errs["dia_coded_spmv_pfold[Q1,p]"] = _compare("Q1 dia_coded_spmv_pfold p", pk, pp)
    xb = x.clone()
    exchange_(dA.col_plan, xb)
    _hold_boundary(dA, xb, f"Q1 {N_Q1}^2", errs)
    _hold_sweep(f"Q1 {N_Q1}^2", x, r, pprev, xb, dA.row_layout.no_max, errs)
    del xb
    blocks = A.owned_owned_values.part_values()
    nnz = sum(int(m.nnz) for m in blocks)
    rows = int(dA.row_layout.noids.sum())
    csr = _csr_on(_block_diagonal(blocks), x.device)
    o0 = dA.col_layout.o0
    xcol = torch.cat([x[p, o0 : o0 + m.shape[1]] for p, m in enumerate(blocks)]).reshape(-1, 1).contiguous()
    lib = time_ms(lambda: torch.sparse.mm(csr, xcol), flush)
    del csr
    out = {}
    for name, fn, plain, reads, writes, ops in (
        ("dia_coded_spmv", lambda: dia.dia_coded_spmv(op, x, wy), lambda: dia.dia_coded_spmv_plain(op, x, wy),
         1, 1, 2 * nnz),
        ("dia_coded_spmv_pfold", lambda: dia.dia_coded_spmv_pfold(op, r, pprev, beta, wy),
         lambda: dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta, wy), 2, 2, 2 * nnz + 2 * rows),
    ):
        t = {"ms": time_ms(fn, flush), "plain_ms": time_ms(plain, flush), "library_ms": lib,
             "bytes": _coded_bytes(dA, reads, writes), "operations": ops}
        t["bound_ms"], t["bound_by"] = _bound_ms(t["bytes"], ops, F64_FLOPS_PER_S)
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        out[name] = t
    return out


def phase_fem_q1(backend, rng):
    """The 2-D Q1 FE model on the card: the reference's (8,8) and (9,7)
    on (2,2) through `fem_q1_driver` (err < 1e-5, test_fem_sa.jl:137);
    512^2 on (2,2): the plain path's iterations, error within 1.1x; then
    N_Q1^2 nodes f64 on (2,2) stacked parts through `assemble_fem_q1` and
    `cg`: host assembly seconds, the COO migration (`assemble_matrix_from_coo`)
    apart from the rest (element triplets, vectors), on the default and the generic plan
    (``box=False``) the staging seconds, the lowering and plan it resolves
    to, fixed-trip fused-CG seconds per iteration, one solve to TOL_Q1
    with Q1_MAXITER (iterations, relative error against x̂, launches by
    formula on the default plan); K1 and K2 held and timed on the
    operator (`q1_kernel_times`)."""
    from partitionedarrays_jl_tpu_torch import assemble_fem_q1, fem_q1_driver
    from partitionedarrays_jl_tpu_torch.models import fem_q1

    for ns in ((8, 8), (9, 7)):
        err, info = prun(fem_q1_driver, backend, (2, 2), ns)
        emit({"phase": "fem_q1_reference", "nodes": ns, "parts": [2, 2], "iterations": info["iterations"],
              "err": err, "lowering": info["lowering"]})
        require(info["converged"] and err < 1e-5, f"Q1 {ns}: error {err}")

    def check(parts):
        A, b, xe, x0 = assemble_fem_q1(parts, (N_Q1_CHECK, N_Q1_CHECK))
        x, info = cg(A, b, x0=x0, tol=TOL_Q1, maxiter=Q1_MAXITER)
        xp, info_p = gpu_cg(A, b, x0=x0, tol=TOL_Q1, maxiter=Q1_MAXITER, plain=True)
        return info, info_p, _rel_err(x, xe), _rel_err(xp, xe)

    info, info_p, err, err_p = prun(check, backend, (2, 2))
    emit({"phase": "fem_q1_vs_plain", "nodes": [N_Q1_CHECK] * 2, "parts": [2, 2], "iterations": info["iterations"],
          "plain_iterations": info_p["iterations"], "rel_err": err, "plain_rel_err": err_p})
    require(info["converged"] and info["iterations"] == info_p["iterations"] and err <= 1.1 * err_p,
            f"Q1 {N_Q1_CHECK}^2: {info['iterations']} vs plain {info_p['iterations']}, error {err} vs {err_p}")

    asm = {}
    t = time.perf_counter()
    with timing_calls(fem_q1, "assemble_matrix_from_coo", asm):
        A, b, xe, x0 = prun(assemble_fem_q1, backend, (2, 2), (N_Q1, N_Q1))
    asm["total"] = time.perf_counter() - t
    asm["rest"] = asm["total"] - asm["assemble_matrix_from_coo"]
    line = {"phase": "fem_q1", "nodes": [N_Q1] * 2, "dofs": N_Q1 ** 2, "dtype": "float64", "parts": [2, 2],
            "assembly_s": asm, "tol": TOL_Q1, "maxiter": Q1_MAXITER, "fixed_trips": CG_TRIPS}
    launches = None
    for plan, box in (("default", True), ("generic", False)):
        t = time.perf_counter()
        dA = device_matrix(A, backend, box)
        sync()
        staging_s = time.perf_counter() - t
        bb, xb = staged({"A": A, "b": b, "x0": x0}, backend, box)
        s_iter, fixed = fixed_trip_s_per_iter(lambda m: make_cg_fn(dA, 0.0, m), bb, xb, *CG_TRIPS)
        dia.reset_launches()
        t = time.perf_counter()
        x, info = cg(A, b, x0=x0, tol=TOL_Q1, maxiter=Q1_MAXITER, box=box)
        sync()
        solve_s = time.perf_counter() - t
        if box:
            launches = dict(dia.LAUNCHES)
            dev_it = device_iterations(info)
            boundary = "bsr_spmv_boundary" if dA.ohb_bs is not None else "ell_spmv_boundary"
            want = {"dia_coded_spmv": 1, "dia_coded_spmv_pfold": dev_it, "cg_sweep": dev_it,
                    boundary: (1 + dev_it) if dA.oh_nnz else 0}
        line[plan] = {
            "lowering": dA.lowering, "dia_mode": dA.dia_mode, "plan": type(dA.col_plan).__name__,
            "box_plan": dA.col_layout.box_info is not None, "staging_s": staging_s,
            "decode": "row_class" if dA.dia_cls_pattern is not None else "select_chain",
            "diagonals": len(dA.coded.offsets) if dA.coded is not None else None,
            "cg_s_per_iter": s_iter, "cg_fixed_trip_s": fixed, "iterations": info["iterations"],
            "converged": info["converged"], "cg_body": info["cg_body"], "rel_err": _rel_err(x, xe),
            "solve_s": solve_s, "device_loop": info["device_loop"],
        }
        require(info["converged"] and line[plan]["rel_err"] < 1e-5,
                f"Q1 {N_Q1}^2 on the {plan} plan: converged {info['converged']}, error {line[plan]['rel_err']}")
    line["kernels"], line["expected_launches"] = launches, want
    line["default_plan_note"] = ("the box plan resolved for the row-ghosted assembly" if line["default"]["box_plan"]
                                 else "the box plan did not resolve for the row-ghosted assembly: the generic plan")
    emit(line)
    require(line["default"]["iterations"] == line["generic"]["iterations"], "Q1: the plans took other iterations")
    require(line["default"]["dia_mode"] == "coded" and line["default"]["diagonals"] == 9,
            f"Q1: {line['default']['dia_mode']} with {line['default']['diagonals']} diagonals")
    for k in want:
        require(launches[k] == want[k], f"Q1: {launches[k]} {k} launches, expected {want[k]}")
    errs = {}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=backend.device)
    dA = device_matrix(A, backend)
    times = q1_kernel_times(A, dA, rng, errs, flush)
    op = dA.coded
    emit({"phase": "q1_kernel_times", "nodes": [N_Q1] * 2, "dtype": "float64", "parts": [2, 2],
          "decode": line["default"]["decode"], "offsets": [int(o) for o in op.offsets],
          "select_chain_instance": dia.select_chain_instance(op) if dA.dia_cls_pattern is None else None,
          "launches_per_solve": {k: launches[k] for k in ("dia_coded_spmv", "dia_coded_spmv_pfold")},
          "equal": True, "max_abs_err": errs, **times})
    return {"errs": errs, "times": times}


def heat_march(parts, ns, nsteps):
    """`heat_transient_driver`'s march step by step through the model's own
    functions (`assemble_heat`, `gmg_hierarchy`, `step_rhs`, `pcg`) at dt
    HEAT_DT, tol TOL_HEAT, coarse_threshold HEAT_CT, timed by section: the
    assembly, the hierarchy, and per step the host rhs and the `pcg` call
    (the card synchronized after it). Keeps the last step's start and
    right-hand side for the checks of `phase_heat`."""
    from partitionedarrays_jl_tpu_torch.models.heat_transient import assemble_heat, step_rhs

    t = time.perf_counter()
    B, bh, mask, u0, x_steady = assemble_heat(parts, ns, HEAT_DT)
    assembly_s = time.perf_counter() - t
    t = time.perf_counter()
    h = gmg_hierarchy(parts, B, ns, coarse_threshold=HEAT_CT)
    hierarchy_s = time.perf_counter() - t
    u = u0.copy()
    rhs = PVector.full(0.0, B.rows, dtype=bh.dtype)
    steps = []
    for _ in range(nsteps):
        t = time.perf_counter()
        step_rhs(rhs, u, bh, mask, HEAT_DT)
        t_rhs = time.perf_counter()
        u_prev = u
        u, info = pcg(B, rhs, x0=u, minv=h, tol=TOL_HEAT)
        sync()
        steps.append({"rhs_s": t_rhs - t, "pcg_s": time.perf_counter() - t_rhs, "iterations": info["iterations"],
                      "device_iterations": device_iterations(info) if "device_loop" in info else None})
    err = float(np.abs(gather_pvector(u) - gather_pvector(x_steady)).max())
    return {"B": B, "bh": bh, "mask": mask, "h": h, "rhs": rhs, "u_prev": u_prev, "u": u, "err": err,
            "steps": steps, "iterations": [st["iterations"] for st in steps], "assembly_s": assembly_s,
            "hierarchy_s": hierarchy_s}


def heat_step_split(m, backend):
    """Where a later step of the march goes, on its last step's start and
    right-hand side: the host sections of the step timed one by one (the
    rhs, b and x0 staged in the card's frames, the cached device loop with
    the card synchronized, x lifted back to a host PVector), and one replay
    of the whole step (`step_rhs` + `pcg`) under torch.profiler: device
    busy ms and the idle share (`phase_profile`)."""
    from partitionedarrays_jl_tpu_torch.models.heat_transient import step_rhs

    B, h, rhs, u = m["B"], m["h"], m["rhs"], m["u_prev"]
    solve = gpu_gmg.gmg_pcg_fn(h, backend, TOL_HEAT, 4 * int(B.rows.ngids))  # the march's cached entry
    dA0 = solve.staged["levels"][0]["dA"]
    marks = [time.perf_counter()]
    step_rhs(rhs, u, m["bh"], m["mask"], HEAT_DT)
    marks.append(time.perf_counter())
    db = _b_on_cols_layout(rhs, dA0)
    dx0 = DeviceVector.from_pvector(u, backend, dA0.col_layout).data
    sync()
    marks.append(time.perf_counter())
    xd, _, _, it, _ = solve(db, dx0)
    sync()
    marks.append(time.perf_counter())
    DeviceVector(xd, B.cols, dA0.col_layout, backend).to_pvector()
    marks.append(time.perf_counter())
    host = dict(zip(("rhs_ms", "stage_b_x0_ms", "device_loop_ms", "lift_x_ms"),
                    (1e3 * (b - a) for a, b in zip(marks, marks[1:]))))
    dev_it = solve.stats["device_iterations"]

    def one_step(_b, _x0):
        step_rhs(rhs, u, m["bh"], m["mask"], HEAT_DT)
        pcg(B, rhs, x0=u, minv=h, tol=TOL_HEAT)

    prof = phase_profile("heat_step_profile", one_step, None, None, dev_it)
    busy_ms = sum(r[1] for r in prof["rows"]) * dev_it
    return {"iterations": it, "device_iterations": dev_it, "host_sections": host, "profiled_step_ms": prof["wall_ms"],
            "device_busy_ms_per_step": busy_ms, "device_idle_share": 1.0 - busy_ms / prof["wall_ms"]}


def phase_heat(backend, rng):
    """The transient heat march on the card. 12^3 on (2,2,2), 10 steps:
    `heat_transient_driver` takes the port's sequential march's per-step
    iterations, its error within 1.1x, and `heat_march` the driver's
    iterations. Then N_HEAT^3 f64 on (2,2,2) stacked parts, dt HEAT_DT,
    HEAT_STEPS steps, tol TOL_HEAT, coarse_threshold HEAT_CT (`heat_march`):
    the seconds of assembly, hierarchy and each step (the first stages the
    hierarchy and captures the loop), the hierarchy stagings, solve
    functions and graph captures over the march (1 each), each step's
    iterations, host-included ms per later step and per PCG iteration,
    the error against the steady solution, the launches over the march by
    formula (`gmg_launches` summed over the steps' device iterations).
    Then on the march's own staged hierarchy: K1 on every coded operator,
    the stream kernel on every stream level, the stencil kernel on every
    stencil level, the boundary kernel on every level's A and S, the
    epilogue in every mode on every level and one V-cycle, the sweep on
    level 0's frames, each torch.equal to its plain version; the last
    step's solve through the plain versions (`gpu_gmg_pcg(plain=True)`)
    with the kernel path's iterations and x within GMG_STRICT_RTOL; graph
    against eager on that step; and where a later step's time goes
    (`heat_step_split`)."""
    from partitionedarrays_jl_tpu_torch import heat_transient_driver
    from partitionedarrays_jl_tpu_torch.parallel import gpu_loop

    kw = {"dt": HEAT_DT, "nsteps": 10, "tol": TOL_HEAT, "coarse_threshold": HEAT_CT}
    err_g, its_g = prun(heat_transient_driver, backend, (2, 2, 2), (12, 12, 12), **kw)
    err_s, its_s = prun(heat_transient_driver, sequential, (2, 2, 2), (12, 12, 12), **kw)
    small = prun(heat_march, backend, (2, 2, 2), (12, 12, 12), 10)
    emit({"phase": "heat_vs_sequential", "n": 12, "parts": [2, 2, 2], "steps": 10, "iterations": its_g,
          "sequential_iterations": its_s, "march_iterations": small["iterations"], "err": err_g,
          "sequential_err": err_s, "march_err": small["err"]})
    require(its_g == its_s == small["iterations"] and err_g <= 1.1 * err_s and small["err"] == err_g,
            f"heat 12^3: driver {its_g}, sequential {its_s}, march {small['iterations']}; error {err_g} vs {err_s}")

    before = {**gpu_gmg.STATS, **gpu_loop.STATS}
    dia.reset_launches()
    m = prun(heat_march, backend, (2, 2, 2), (N_HEAT,) * 3, HEAT_STEPS)
    launches = dict(dia.LAUNCHES)
    built = {k: v - before[k] for k, v in {**gpu_gmg.STATS, **gpu_loop.STATS}.items()}
    h, steps, its = m["h"], m["steps"], m["iterations"]
    dh = gpu_gmg.device_hierarchy(h, backend)  # the march's staging (cached on h)
    want = {}
    for st in steps:
        for k, v in gmg_launches(h, dh, st["device_iterations"]).items():
            want[k] = want.get(k, 0) + v
    # the first step stages the hierarchy and captures the loop; the others replay it
    later_ms = 1e3 * sum(st["rhs_s"] + st["pcg_s"] for st in steps[1:])
    line = {"phase": "heat_transient", "n": N_HEAT, "dofs": N_HEAT ** 3, "dtype": "float64", "parts": [2, 2, 2],
            "dt": HEAT_DT, "steps": HEAT_STEPS, "tol": TOL_HEAT, "coarse_threshold": HEAT_CT,
            "assembly_s": m["assembly_s"], "hierarchy_s": m["hierarchy_s"],
            "first_step_s": steps[0]["rhs_s"] + steps[0]["pcg_s"],
            "step_ms": [1e3 * (st["rhs_s"] + st["pcg_s"]) for st in steps],
            "rhs_ms": [1e3 * st["rhs_s"] for st in steps], "built_over_march": built, "iterations": its,
            "device_iterations": [st["device_iterations"] for st in steps],
            "host_included_ms_per_step": later_ms / (HEAT_STEPS - 1),
            "host_included_ms_per_pcg_iteration": later_ms / sum(its[1:]), "err_vs_steady": m["err"],
            "routes": [gpu_gmg.route(lv) for lv in dh["levels"]], "dia_modes": [lv["dA"].dia_mode for lv in dh["levels"]],
            "kernels": launches, "expected_launches": want}
    emit(line)
    require(built == {"stagings": 1, "pcg_fns": 1, "captures": 1},
            f"heat march: {built} stagings, solve functions and captures, expected 1 each")
    require(len(its) == HEAT_STEPS and all(0 < i < 4 * N_HEAT ** 3 for i in its) and np.isfinite(m["err"]),
            f"heat march: iterations {its}, error {m['err']}")
    for k in want:
        require(launches[k] == want[k] > 0, f"heat march: {launches[k]} {k} launches, expected {want[k]}")

    # every kernel of the march held against its plain version at the march's shapes
    tag = f"heat {N_HEAT}^3 f64 (2,2,2)"
    errs = {"coded": _k1_on_gmg_operators(dh, tag, rng)}
    require("A0" in errs["coded"], f"{tag}: coded operators {sorted(errs['coded'])}")
    errs["stream"], _ = _stream_checks(dh, rng, tag)
    errs["stencil"] = max([_stencil_check(lv, rng, f"{tag} level {li}") for li, lv in enumerate(dh["levels"])
                           if gpu_gmg.route(lv) == "stencil"], default=0.0)
    errs["epilogue"] = max(_epilogue_checks(h, dh, rng, tag))
    held = {}
    _hold_level_products(dh, rng, tag, held, ell=False)
    dA0 = dh["levels"][0]["dA"]
    L0 = dA0.col_layout
    fr = [_frame(rng, (L0.P, L0.W), np.float64, backend.device) for _ in range(4)]
    _hold_sweep(tag, *fr, L0.no_max, held)
    del fr

    # the last step through the plain versions, and graph against eager
    u_prev, rhs, last = m["u_prev"], m["rhs"], steps[-1]
    xp, info_p = gpu_gmg.gpu_gmg_pcg(h, rhs, x0=u_prev, tol=TOL_HEAT, plain=True)
    xk, xs = gather_pvector(m["u"]), gather_pvector(xp)
    x_rel = float(np.linalg.norm(xk - xs) / np.linalg.norm(xk))
    b0 = _b_on_cols_layout(rhs, dA0)
    x00 = DeviceVector.from_pvector(u_prev, backend, L0).data
    graph_vs_eager(f"{tag} GMG-PCG, the march's last step", lambda g: gpu_gmg.make_gmg_pcg_fn(
        h, backend, TOL_HEAT, 4 * int(m["B"].rows.ngids), graph=g), b0, x00)
    split = heat_step_split(m, backend)
    emit({"phase": "heat_transient_checks", "n": N_HEAT, "parts": [2, 2, 2],
          "last_step_iterations": last["iterations"], "plain_iterations": info_p["iterations"],
          "x_rel_to_plain": x_rel, "x_equal_plain": bool(np.array_equal(xk, xs)), "tolerance": GMG_STRICT_RTOL,
          "coded_vs_plain_max_abs_err": errs["coded"], "stream_vs_plain_max_abs_err": errs["stream"],
          "stencil_vs_plain_max_abs_err": errs["stencil"], "epilogue_and_vcycle_vs_plain_max_abs_err": errs["epilogue"],
          "max_abs_err": held, "coded_operators": {k: operator_info(dM.coded) for k, dM in gmg_coded_operators(dh)}})
    emit({"phase": "heat_step_split", "n": N_HEAT, "parts": [2, 2, 2], **split,
          "host_included_ms_per_step": line["host_included_ms_per_step"]})
    require(info_p["iterations"] == last["iterations"] and x_rel <= GMG_STRICT_RTOL,
            f"{tag}: the plain path took {info_p['iterations']} iterations (kernel path {last['iterations']}), "
            f"x {x_rel} apart")
    require(split["iterations"] == last["iterations"], f"{tag}: the step replay took {split['iterations']} iterations")
    return {"errs": held, "coded": max(errs["coded"].values()), "stream": errs["stream"],
            "stencil": errs["stencil"], "epilogue": errs["epilogue"], "launches": launches}


# ---------------------------------------------------------------------------
# phase 4i: the rest of the Krylov family, the advection model, the
# differentiable solve
# ---------------------------------------------------------------------------


def advection_system(parts, n):
    t = time.perf_counter()
    A, b, xe, x0 = assemble_advection_fv(parts, (n, n, n))
    return {"A": A, "b": b, "xe": xe, "x0": x0, "assembly_s": time.perf_counter() - t}


def _x_apart(x, y):
    """max |x - y| over the owned values, and whether they are equal."""
    gx, gy = gather_pvector(x), gather_pvector(y)
    return float(np.abs(gx - gy).max()), bool(np.array_equal(gx, gy))


def _k1_times(A, dA, flush, rng, tag):
    """K1 on an operator's own frames: flushed ms of the kernel, its plain
    version and torch.sparse.mm of the owned block's CSR (one part), and
    the bound: x read, the code bytes and y written a row, 2 nnz operations
    at the dtype's rate."""
    op, wy = dA.coded, dA.row_layout.W
    x = _random_frame(dA, rng)
    M = A.values.part_values()[0]
    csr = _csr_on(M, x.device)
    xcol = x[0, : M.shape[1]].reshape(-1, 1).contiguous()
    item = x.element_size()
    rows = int(dA.row_layout.noids.sum())
    nbytes = rows * (item + op.codes.shape[1] + item)
    out = {"operator": tag, "rows": rows, "bytes": nbytes, "code_bytes_per_row": int(op.codes.shape[1]),
           "decode": "row_class" if op.cls_pattern is not None else "select_chain",
           "ms": time_ms(lambda: dia.dia_coded_spmv(op, x, wy), flush),
           "plain_ms": time_ms(lambda: dia.dia_coded_spmv_plain(op, x, wy), flush),
           "library_ms": time_ms(lambda: torch.sparse.mm(csr, xcol), flush)}
    out["bound_ms"], out["bound_by"] = _bound_ms(nbytes, dA.flops_per_spmv,
                                                F64_FLOPS_PER_S if item == 8 else F32_FLOPS_PER_S)
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


def _eager_split(prof, kernel_names):
    """A profile's device time split between the named kernels and the rest
    (the eager ops and copies), per device iteration."""
    busy = sum(ms for _, ms, _ in prof["rows"])
    kern = sum(ms for k, ms, _ in prof["rows"] if any(n in k for n in kernel_names))
    return {"device_ms_per_iter": busy, "kernel_ms_per_iter": kern, "eager_ms_per_iter": busy - kern,
            "eager_share": (busy - kern) / busy if busy else None,
            "idle_share": 1.0 - busy * prof["iters"] / prof["wall_ms"]}


def phase_advection(backend, rng):
    """The nonsymmetric advection FV model at 192^3 f64 on one part: the
    driver's BiCGStab (`advection_fv_driver`'s solve on the assembled
    system: tol 1e-12, maxiter 4000, error < 1e-5), right-Jacobi BiCGStab and
    GMRES(30) at a fixed maxiter; for each the launches by formula, the
    plain path, graph against eager and seconds per iteration; a profile of
    a BiCGStab block; K1 on the operator against its plain version and
    timed."""
    from partitionedarrays_jl_tpu_torch.parallel import gpu_krylov as kr

    run = prun(advection_system, backend, (1, 1, 1), N_ADV)
    A, b, xe, x0 = run["A"], run["b"], run["xe"], run["x0"]
    t = time.perf_counter()
    dA = device_matrix(A, backend)
    sync()
    staging_s = time.perf_counter() - t
    require(dA.dia_mode == "coded", f"advection: the operator lowered as {dA.dia_mode}")
    errs = {}
    xr = _random_frame(dA, rng)
    errs[f"dia_coded_spmv[advection {N_ADV}^3 f64]"] = _compare(
        "advection dia_coded_spmv", dia.dia_coded_spmv(dA.coded, xr, dA.row_layout.W),
        dia.dia_coded_spmv_plain(dA.coded, xr, dA.row_layout.W))
    bd, x0d = staged(run, backend)
    mv = jacobi_preconditioner(A)
    dmv = _b_on_cols_layout(mv, dA)
    lines = {}
    for name, minv in (("bicgstab", None), ("bicgstab_jacobi", mv)):
        dia.reset_launches()
        t = time.perf_counter()
        x, info = bicgstab(A, b, x0=x0, tol=TOL_ADV, maxiter=ADV_MAXITER, minv=minv)
        sync()
        solve_s = time.perf_counter() - t
        launches = dict(dia.LAUNCHES)
        err = float((x - xe).norm())
        dev_it = device_iterations(info)
        want = {"dia_coded_spmv": 1 + 2 * dev_it}
        xp, info_p = gpu_bicgstab(A, b, x0=x0, tol=TOL_ADV, maxiter=ADV_MAXITER, minv=minv, plain=True)
        apart, bitwise = _x_apart(x, xp)
        extra = () if minv is None else (dmv,)
        pre = minv is not None
        s_per_iter, fixed = fixed_trip_s_per_iter(
            lambda m: with_args(kr.make_bicgstab_fn(dA, 0.0, m, precond=pre), *extra), bd, x0d, *BICG_TRIPS)
        line = {"phase": "advection_" + name, "n": N_ADV, "dofs": N_ADV ** 3, "dtype": "float64", "parts": 1,
                "tol": TOL_ADV, "maxiter": ADV_MAXITER, "iterations": info["iterations"],
                "converged": info["converged"], "err": err, "solve_s": solve_s, "kernels": launches,
                "expected_launches": want, "device_loop": info["device_loop"],
                "plain_iterations": info_p["iterations"], "plain_x_max_abs_diff": apart, "plain_x_bitwise": bitwise,
                "s_per_iter": s_per_iter, "fixed_trip_s": fixed, "fixed_trips": BICG_TRIPS}
        emit(line)
        require(info["converged"] and err < 1e-5, f"advection {name}: converged {info['converged']}, error {err}")
        require(info["iterations"] == info_p["iterations"] and apart <= 1e-12 * float(np.abs(gather_pvector(x)).max()),
                f"advection {name}: the plain path took {info_p['iterations']} iterations, x apart {apart}")
        for k in want:
            require(launches[k] == want[k], f"advection {name}: {launches[k]} {k} launches, expected {want[k]}")
        graph_vs_eager(f"{N_ADV}^3 f64 advection {name}",
                       lambda g: kr.make_bicgstab_fn(dA, TOL_ADV, ADV_MAXITER, precond=pre, graph=g), bd, x0d, *extra,
                       per_step=1)
        lines[name] = line

    # GMRES(30) at a fixed maxiter: the relative residual it reaches
    dia.reset_launches()
    t = time.perf_counter()
    x, info = gmres(A, b, x0=x0, restart=GMRES_RESTART, tol=TOL_ADV, maxiter=GMRES_MAXITER)
    sync()
    solve_s = time.perf_counter() - t
    launches = dict(dia.LAUNCHES)
    cycles = device_iterations(info)
    want = {"dia_coded_spmv": 1 + cycles * (GMRES_RESTART + 1)}
    xp, info_p = gpu_gmres(A, b, x0=x0, restart=GMRES_RESTART, tol=TOL_ADV, maxiter=GMRES_MAXITER, plain=True)
    apart, bitwise = _x_apart(x, xp)
    s_per_iter, fixed = fixed_trip_s_per_iter(
        lambda m: kr.make_gmres_fn(dA, GMRES_RESTART, 0.0, m), bd, x0d, *GMRES_TRIPS)
    res = np.asarray(info["residuals"])
    line = {"phase": "advection_gmres", "n": N_ADV, "dtype": "float64", "restart": GMRES_RESTART,
            "maxiter": GMRES_MAXITER, "iterations": info["iterations"], "cycles": cycles,
            "rel_residual": float(res[-1] / max(1.0, res[0])), "err": float((x - xe).norm()), "solve_s": solve_s,
            "kernels": launches, "expected_launches": want, "device_loop": info["device_loop"],
            "plain_iterations": info_p["iterations"], "plain_x_max_abs_diff": apart, "plain_x_bitwise": bitwise,
            "s_per_iter": s_per_iter, "fixed_trip_s": fixed, "fixed_trips": GMRES_TRIPS}
    emit(line)
    require(info["iterations"] == GMRES_MAXITER and np.isfinite(res[-1]) and res[-1] < res[0],
            f"advection GMRES: {info['iterations']} iterations, residual {res[-1]} from {res[0]}")
    require(info_p["iterations"] == info["iterations"] and apart <= 1e-12 * float(np.abs(gather_pvector(x)).max()),
            f"advection GMRES: the plain path took {info_p['iterations']} iterations, x apart {apart}")
    for k in want:
        require(launches[k] == want[k], f"advection GMRES: {launches[k]} {k} launches, expected {want[k]}")
    graph_vs_eager(f"{N_ADV}^3 f64 advection GMRES({GMRES_RESTART})",
                   lambda g: kr.make_gmres_fn(dA, GMRES_RESTART, TOL_ADV, GMRES_MAXITER, graph=g), bd, x0d,
                   per_step=GMRES_RESTART)
    lines["gmres"] = line

    prof = phase_profile("advection_bicgstab_profile", kr.make_bicgstab_fn(dA, 0.0, 48), bd, x0d, 48)
    emit({"phase": "advection_bicgstab_split", **_eager_split(prof, ("dia_coded",))})
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=backend.device)
    k1 = _k1_times(A, dA, flush, rng, f"advection {N_ADV}^3 f64")
    emit({"phase": "advection_kernel_times", "assembly_s": run["assembly_s"], "staging_s": staging_s,
          "dia_coded_spmv": k1, "reps": REPS})
    return {"errs": errs, "lines": lines, "k1": k1}


def phase_advection_multi(backend, rng):
    """The advection model at 48^3 f64 on (2,2,2) stacked parts through
    `advection_fv_driver`, on the box plan (launches by formula) and the
    generic plan, held against the port's sequential backend by the gates
    of the JAX package's tests/test_advection_fv.py:33-47; K1 and E1's
    boundary mode against their plain versions on its operator."""
    from partitionedarrays_jl_tpu_torch.parallel import gpu_krylov as kr
    from partitionedarrays_jl_tpu_torch.parallel.gpu_box import BoxExchangePlan

    n = N_ADV_MULTI
    dia.reset_launches()
    err_g, info_g = prun(advection_fv_driver, backend, (2, 2, 2), (n, n, n))
    launches = dict(dia.LAUNCHES)
    dev_it = device_iterations(info_g)
    want = {"dia_coded_spmv": 1 + 2 * dev_it, "ell_spmv_boundary": 1 + 2 * dev_it}
    t = time.perf_counter()
    err_s, info_s = prun(advection_fv_driver, sequential, (2, 2, 2), (n, n, n))
    seq_s = time.perf_counter() - t
    run = prun(advection_system, backend, (2, 2, 2), n)
    A, b, xe, x0 = run["A"], run["b"], run["xe"], run["x0"]
    xgen, info_gen = gpu_bicgstab(A, b, x0=x0, tol=TOL_ADV, maxiter=ADV_MAXITER, box=False)
    err_gen = float((xgen - xe).norm())
    dA = device_matrix(A, backend)
    require(isinstance(dA.col_plan, BoxExchangePlan), "advection (2,2,2): not on the box plan")
    errs = {}
    xr = _random_frame(dA, rng)
    errs[f"dia_coded_spmv[advection {n}^3 f64 (2,2,2)]"] = _compare(
        "advection (2,2,2) dia_coded_spmv", dia.dia_coded_spmv(dA.coded, xr, dA.row_layout.W),
        dia.dia_coded_spmv_plain(dA.coded, xr, dA.row_layout.W))
    exchange_(dA.col_plan, xr)
    _hold_boundary(dA, xr, f"advection {n}^3 f64 (2,2,2)", errs)
    bd, x0d = staged(run, backend)
    graph_vs_eager(f"{n}^3 f64 (2,2,2) advection bicgstab",
                   lambda g: kr.make_bicgstab_fn(dA, TOL_ADV, ADV_MAXITER, graph=g), bd, x0d, per_step=1)
    line = {"phase": "advection_stacked_parts", "n": n, "dtype": "float64", "parts": [2, 2, 2],
            "iterations": info_g["iterations"], "sequential_iterations": info_s["iterations"],
            "generic_plan_iterations": info_gen["iterations"], "err": err_g, "sequential_err": err_s,
            "generic_plan_err": err_gen, "converged": [info_g["converged"], info_s["converged"], info_gen["converged"]],
            "kernels": launches, "expected_launches": want, "device_loop": info_g["device_loop"],
            "sequential_s": seq_s, "max_abs_err": errs}
    emit(line)
    require(all(line["converged"]), f"advection (2,2,2): converged {line['converged']}")
    for name, it, err in (("box", info_g["iterations"], err_g), ("generic", info_gen["iterations"], err_gen)):
        require(abs(it - info_s["iterations"]) <= 2, f"advection (2,2,2) {name}: {it} iterations against the "
                f"sequential backend's {info_s['iterations']}")
        require(err < 1e-5 and err_s < 1e-5 and abs(err - err_s) < 1e-8,
                f"advection (2,2,2) {name}: errors {err} and {err_s} (sequential)")
    for k in want:
        require(launches[k] == want[k], f"advection (2,2,2): {launches[k]} {k} launches, expected {want[k]}")
    return {"errs": errs, "line": line}


def fgmres_gmg_launches(h, dh, steps, cycles):
    """The launches of a FGMRES-GMG solve: per Arnoldi step (every unrolled
    step of every cycle the device ran, ``steps``) a V-cycle and the outer
    A0 SpMV, as a GMG-PCG iteration has (`gmg_launches`) but no sweep; the
    initial residual; and the true residual at each cycle's end."""
    want = gmg_launches(h, dh, steps)
    dA0 = dh["levels"][0]["dA"]
    want["dia_coded_spmv" if dA0.dia_mode == "coded" else "dia_stream_spmv"] += cycles
    want["cg_sweep"] = 0
    if "ell_spmv_boundary" in want:
        want["ell_spmv_boundary"] += cycles
    return want


def phase_krylov_gmg(backend, gruns, gmg_iterations, rng):
    """MINRES, Chebyshev (bounds from `lanczos_bounds`) and FGMRES with the
    V-cycle inlined on phase 2b's decoupled 192^3 f32 operator and
    hierarchy; FGMRES-GMG against the host fgmres(minv=h) on the 48^3 f64
    (2,2,2) hierarchy. Launches by formula, the plain paths, graph against
    eager, seconds per iteration."""
    from partitionedarrays_jl_tpu_torch.parallel import gpu_krylov as kr

    g = gruns["main"]
    Ah, bh, h, dh = g["Ah"], g["bh"], g["h"], g["dh"]
    dA = device_matrix(Ah, backend)
    b = _b_on_cols_layout(bh, dA)
    x0 = torch.zeros_like(b)
    out = {}

    # MINRES beside CG
    dia.reset_launches()
    t = time.perf_counter()
    x, info = minres(Ah, bh, tol=TOL_MAIN)
    sync()
    solve_s = time.perf_counter() - t
    launches = dict(dia.LAUNCHES)
    dev_it = device_iterations(info)
    want = {"dia_coded_spmv": 1 + dev_it}
    _, info_cg = cg(Ah, bh, tol=TOL_MAIN)
    xp, info_p = gpu_minres(Ah, bh, tol=TOL_MAIN, plain=True)
    apart, bitwise = _x_apart(x, xp)
    s_per_iter, fixed = fixed_trip_s_per_iter(lambda m: kr.make_minres_fn(dA, 0.0, m), b, x0, *CG_TRIPS)
    line = {"phase": "minres", "n": N_MAIN, "dtype": "float32", "tol": TOL_MAIN, "iterations": info["iterations"],
            "cg_iterations": info_cg["iterations"], "converged": info["converged"], "rel_err": _rel_err(x, g["xe"]),
            "solve_s": solve_s, "kernels": launches, "expected_launches": want, "device_loop": info["device_loop"],
            "plain_iterations": info_p["iterations"], "plain_x_max_abs_diff": apart, "plain_x_bitwise": bitwise,
            "s_per_iter": s_per_iter, "fixed_trip_s": fixed, "fixed_trips": CG_TRIPS}
    emit(line)
    require(info["converged"], "MINRES 192^3: did not converge")
    require(info_p["iterations"] == info["iterations"] and bitwise, f"MINRES: plain path {info_p['iterations']}, "
            f"x apart {apart}")
    for k in want:
        require(launches[k] == want[k], f"MINRES: {launches[k]} {k} launches, expected {want[k]}")
    graph_vs_eager(f"{N_MAIN}^3 f32 MINRES", lambda gr: kr.make_minres_fn(dA, TOL_MAIN, 4 * Ah.rows.ngids, graph=gr),
                   b, x0, per_step=1)
    out["minres"] = line

    # Chebyshev with the Lanczos bounds
    t = time.perf_counter()
    lo, hi = lanczos_bounds(Ah)
    lanczos_s = time.perf_counter() - t
    dia.reset_launches()
    t = time.perf_counter()
    x, info = chebyshev_solve(Ah, bh, lo, hi, tol=TOL_MAIN, maxiter=CHEB_MAXITER)
    sync()
    solve_s = time.perf_counter() - t
    launches = dict(dia.LAUNCHES)
    legs = device_iterations(info)
    leg = info["residuals_every"]
    want = {"dia_coded_spmv": 1 + leg * legs}
    xp, info_p = gpu_chebyshev(Ah, bh, lo, hi, tol=TOL_MAIN, maxiter=CHEB_MAXITER, plain=True)
    apart, bitwise = _x_apart(x, xp)
    s_per_iter, fixed = fixed_trip_s_per_iter(lambda m: kr.make_chebyshev_fn(dA, lo, hi, 0.0, m), b, x0, *CHEB_TRIPS)
    res = np.asarray(info["residuals"])
    line = {"phase": "chebyshev", "n": N_MAIN, "dtype": "float32", "tol": TOL_MAIN, "maxiter": CHEB_MAXITER,
            "lanczos_bounds": [lo, hi], "lanczos_s": lanczos_s, "iterations": info["iterations"], "legs": legs,
            "converged": info["converged"], "rel_residual": float(res[-1] / max(1.0, res[0])),
            "rel_err": _rel_err(x, g["xe"]), "solve_s": solve_s, "kernels": launches, "expected_launches": want,
            "device_loop": info["device_loop"], "plain_iterations": info_p["iterations"],
            "plain_x_max_abs_diff": apart, "plain_x_bitwise": bitwise, "s_per_iter": s_per_iter,
            "fixed_trip_s": fixed, "fixed_trips": CHEB_TRIPS}
    emit(line)
    require(np.isfinite(res[-1]) and res[-1] < res[0], f"Chebyshev: residual {res[-1]} from {res[0]}")
    require(info_p["iterations"] == info["iterations"] and bitwise, f"Chebyshev: plain path {info_p['iterations']}, "
            f"x apart {apart}")
    for k in want:
        require(launches[k] == want[k], f"Chebyshev: {launches[k]} {k} launches, expected {want[k]}")
    graph_vs_eager(f"{N_MAIN}^3 f32 Chebyshev",
                   lambda gr: kr.make_chebyshev_fn(dA, lo, hi, TOL_MAIN, CHEB_MAXITER, graph=gr), b, x0, per_step=leg)
    out["chebyshev"] = line

    # FGMRES with the V-cycle inlined, beside GMG-PCG
    m = FGMRES_RESTART
    dia.reset_launches()
    t = time.perf_counter()
    x, info = gpu_gmg.gpu_fgmres_gmg(h, bh, tol=TOL_MAIN, restart=m)
    sync()
    solve_s = time.perf_counter() - t
    launches = dict(dia.LAUNCHES)
    cycles = device_iterations(info)
    want = fgmres_gmg_launches(h, dh, cycles * m, cycles)
    t = time.perf_counter()
    gpu_gmg.gpu_fgmres_gmg(h, bh, tol=TOL_MAIN, restart=m)
    sync()
    repeat_s = time.perf_counter() - t
    xp, info_p = gpu_gmg.gpu_fgmres_gmg(h, bh, tol=TOL_MAIN, restart=m, plain=True)
    apart, bitwise = _x_apart(x, xp)
    s_per_iter, fixed = fixed_trip_s_per_iter(
        lambda mi: gpu_gmg.make_fgmres_gmg_fn(h, backend, 0.0, mi, restart=m), b, x0, *FGMRES_TRIPS)
    pcg_s, pcg_fixed = fixed_trip_s_per_iter(lambda mi: gpu_gmg.make_gmg_pcg_fn(h, backend, 0.0, mi), b, x0,
                                             *GMG_TRIPS)
    line = {"phase": "fgmres_gmg", "n": N_MAIN, "dtype": "float32", "tol": TOL_MAIN, "restart": m,
            "iterations": info["iterations"], "gmg_pcg_iterations": gmg_iterations, "cycles": cycles,
            "converged": info["converged"], "rel_err": _rel_err(x, g["xe"]), "solve_s": solve_s,
            "repeat_solve_s": repeat_s, "kernels": launches, "expected_launches": want,
            "device_loop": info["device_loop"], "plain_iterations": info_p["iterations"],
            "plain_x_max_abs_diff": apart, "plain_x_bitwise": bitwise,
            "s_per_iter": s_per_iter, "fixed_trip_s": fixed, "fixed_trips": FGMRES_TRIPS,
            "gmg_pcg_s_per_iter": pcg_s, "gmg_pcg_fixed_trip_s": pcg_fixed, "gmg_pcg_fixed_trips": GMG_TRIPS}
    emit(line)
    require(info["converged"], "FGMRES-GMG 192^3: did not converge")
    require(info_p["iterations"] == info["iterations"] and bitwise, f"FGMRES-GMG: plain path {info_p['iterations']}, "
            f"x apart {apart}")
    for k in want:
        require(launches[k] == want[k], f"FGMRES-GMG: {launches[k]} {k} launches, expected {want[k]}")
    graph_vs_eager(f"{N_MAIN}^3 f32 FGMRES-GMG({m}), {3 * m} fixed steps",
                   lambda gr: gpu_gmg.make_fgmres_gmg_fn(h, backend, 0.0, 3 * m, restart=m, graph=gr), b, x0,
                   per_step=m)
    out["fgmres_gmg"] = line

    gm = gruns["multi"]
    dia.reset_launches()
    xd, info_d = gpu_gmg.gpu_fgmres_gmg(gm["h"], gm["bh"], tol=TOL_FGMRES_MULTI, restart=m)
    launches = dict(dia.LAUNCHES)
    cycles = device_iterations(info_d)
    want = fgmres_gmg_launches(gm["h"], gm["dh"], cycles * m, cycles)
    t = time.perf_counter()
    xh, info_h = fgmres(gm["Ah"], gm["bh"], minv=gm["h"], tol=TOL_FGMRES_MULTI, restart=m)
    host_s = time.perf_counter() - t
    line = {"phase": "fgmres_gmg_stacked_parts", "n": N_GMG_MULTI, "dtype": "float64", "parts": [2, 2, 2],
            "tol": TOL_FGMRES_MULTI, "restart": m, "iterations": info_d["iterations"],
            "host_iterations": info_h["iterations"], "converged": [info_d["converged"], info_h["converged"]],
            "rel_err": _rel_err(xd, gm["xe"]), "host_rel_err": _rel_err(xh, gm["xe"]), "host_s": host_s,
            "kernels": launches, "expected_launches": want, "device_loop": info_d["device_loop"]}
    emit(line)
    require(all(line["converged"]) and abs(info_d["iterations"] - info_h["iterations"]) <= 1,
            f"FGMRES-GMG (2,2,2): device {info_d['iterations']}, host {info_h['iterations']} iterations")
    for k in want:
        require(launches[k] == want[k], f"FGMRES-GMG (2,2,2): {launches[k]} {k} launches, expected {want[k]}")
    out["fgmres_gmg_multi"] = line
    return out


def diff_system(parts, n):
    A, b, _, _ = assemble_poisson(parts, (n, n, n))
    return decouple_dirichlet(A, b)


def phase_diff_solve(backend, rng):
    """The differentiable solve on the decoupled 48^3 f64 Poisson, (2,2,2):
    one forward and one backward on the one cached solve function (one
    capture), the vector-Jacobian product torch.equal to a forward solve of
    the cotangent, and one central finite difference along a seeded
    direction against the gradient (relative DIFF_FD_RTOL)."""
    from partitionedarrays_jl_tpu_torch.parallel import gpu_loop
    from partitionedarrays_jl_tpu_torch.parallel.gpu import STATS as gpu_stats

    Ah, bh = prun(diff_system, backend, (2, 2, 2), N_DIFF)
    dA = device_matrix(Ah, backend)
    b0 = _b_on_cols_layout(bh, dA)
    w = torch.from_numpy(rng.standard_normal(tuple(b0.shape))).to(b0.device)
    fns0, caps0 = gpu_stats["solve_fns"], gpu_loop.STATS["captures"]
    f = make_diff_solve_fn(dA, tol=TOL_DIFF)

    def loss(v):
        return torch.sum((f(v) * w) ** 2)

    cot = []
    dia.reset_launches()
    bv = b0.clone().requires_grad_(True)
    t = time.perf_counter()
    x = f(bv)
    sync()
    fwd_s = time.perf_counter() - t
    fwd_it = f.solve.stats["device_iterations"]
    x.register_hook(lambda gr: cot.append(gr.detach().clone()))
    t = time.perf_counter()
    (grad,) = torch.autograd.grad(torch.sum((x * w) ** 2), bv)
    sync()
    bwd_s = time.perf_counter() - t
    bwd_it = f.solve.stats["device_iterations"]
    launches = dict(dia.LAUNCHES)
    fns, caps = gpu_stats["solve_fns"] - fns0, gpu_loop.STATS["captures"] - caps0
    with torch.no_grad():
        again = f(cot[0])
        d = torch.from_numpy(rng.standard_normal(tuple(b0.shape))).to(b0.device)
        d *= b0.norm() / d.norm()
        fd = (float(loss(b0 + DIFF_EPS * d)) - float(loss(b0 - DIFF_EPS * d))) / (2 * DIFF_EPS)
    an = float(torch.sum(grad * d))
    want = {"dia_coded_spmv": 2, "dia_coded_spmv_pfold": fwd_it + bwd_it, "cg_sweep": fwd_it + bwd_it,
            "ell_spmv_boundary": 2 + fwd_it + bwd_it}
    line = {"phase": "diff_solve", "n": N_DIFF, "dtype": "float64", "parts": [2, 2, 2], "tol": TOL_DIFF,
            "forward_s": fwd_s, "backward_s": bwd_s, "device_iterations": [fwd_it, bwd_it],
            "solve_fns_built": fns, "captures": caps, "vjp_equal_forward_solve": bool(torch.equal(grad, again)),
            "fd": fd, "vjp_along_d": an, "fd_rel_err": abs(fd - an) / abs(an), "fd_eps": DIFF_EPS,
            "kernels": launches, "expected_launches": want}
    emit(line)
    require(fns == 1 and caps == 1, f"diff solve: {fns} solve functions built, {caps} captures (expected 1 and 1)")
    require(line["vjp_equal_forward_solve"], "diff solve: the vector-Jacobian product differs from a forward solve")
    require(line["fd_rel_err"] < DIFF_FD_RTOL, f"diff solve: finite difference {fd} against {an}")
    for k in want:
        require(launches[k] == want[k], f"diff solve: {launches[k]} {k} launches, expected {want[k]}")
    return line


# ---------------------------------------------------------------------------
# phase 4j: the rest of the solver family
# ---------------------------------------------------------------------------

SSTEP_DEPTHS = (2, 4)  # s-step depths at 192^3 f32 (s = 2 also on 48^3 f64 (2,2,2))
TOL_MULTI = 1e-9  # the 48^3 f64 (2,2,2) s-step and stationary GMG solves
SSTEP_X_ATOL = 1e-7  # tests/test_sstep.py:143: the s = 2 solution against the textbook body's, f64
AGG_THRESHOLD = 300  # 48^3 (2,2,2), coarse_threshold 500: the 12^3 level and the 6^3 coarse grid on one part
AGG_X_ATOL = 1e-10  # agglomerated against full-mesh solutions (the two placements' Galerkin products round apart)
LOBPCG_NEV = 4
# 192^3 f32, GMG-preconditioned: |r_i| <= tol*max(1, |lambda_i|), absolute
# here, where lambda_1 is about 5e-5: 1e-6 is about 2% of it, so a Ritz
# pair that has not converged fails the stop
TOL_LOBPCG = 1e-6
LOBPCG_MAXITER = 100
LOBPCG_TRIPS = (2, 6)  # fixed iterations of the 192^3 GMG LOBPCG seconds per iteration
# the eigenvalues against the closed form of the spectrum, relative: met to
# 6.9e-8 on the H100 at TOL_LOBPCG (9 iterations; PERF.md, PR 17)
LOBPCG_EIG_RTOL = 1e-5
# Jacobi LOBPCG on (2,2,2) f64, device against the host loop: 32^3, cut from
# 48^3, whose host loop (341 iterations, 79 s) put the whole run at 912 s
N_LOBPCG_MULTI = 32
TOL_LOBPCG_MULTI = 1e-7
LOBPCG_MULTI_MAXITER = 400
LOBPCG_MULTI_RTOL = 1e-8  # tests/test_solvers.py:566
TOL_RAS = 1e-10  # right-RAS BiCGStab on the 48^3 f64 (2,2,2) advection operator (tests/test_solvers.py:605)


def _hold_body(tag, dA, x, errs, names, **kw):
    """An SpMV body (`gpu._spmv_body`) through the kernels and through their
    plain versions on copies of the same operand, torch.equal; the error is
    kept under each kernel's name the body launches."""
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _spmv_body

    got = _spmv_body(dA, **kw)(x.clone())
    want = _spmv_body(dA, plain=True, **kw)(x.clone())
    err = _compare(tag, got, want)
    for name in names:
        errs[f"{name}[{tag}]"] = err
    return err


def _slab_kernels(dA):
    """The kernels a slab SpMV of dA launches."""
    names = ["dia_coded_spmm" if dA.dia_mode == "coded" else "dia_stream_spmm"]
    if dA.oh_nnz:
        names.append("bsr_spmv_boundary_slab" if dA.ohb_bs is not None else "ell_spmv_boundary")
    return names


def _random_slab(dA, K, rng):
    L = dA.col_layout
    dt = dA.coded.cb.dtype if dA.coded is not None else dA.stream_vals.dtype
    x = torch.from_numpy(rng.standard_normal((L.P, L.W, K))).to(dA.backend.device, dt)
    x[:, L.g0:] = 0
    return x


def slab_spmm_times(tag, dA, K, rng, errs=None):
    """`dia_coded_spmm` at a slab width K on a coded operator (its dtype,
    its stacked parts): the form the planner takes by shape and its flushed
    ms, the other form's (forced, held torch.equal to the plain version
    under `errs`; None where the staged form has no plan), its plain
    version, `torch.sparse.mm` of the operator's CSR (block-diagonal over
    the parts) on the (rows, K) slab, and the bound (the code bytes a row,
    x read and y written K values a row)."""
    op = dA.coded
    P, wx, wy = dA.col_layout.P, dA.col_layout.W, dA.row_layout.W
    rows = int(dA.row_layout.noids.sum())
    dt = op.cb.dtype
    item = op.cb.element_size()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=op.cb.device)
    x = _frame(rng, (P, wx, K), np.float32 if item == 4 else np.float64, op.cb.device)
    csr = _coded_csr_parts(op, wx)
    xs = x.reshape(P * wx, K)
    form = dia.spmm_form(op.offsets, item, K, "plain", op.codes.shape[1])
    other = dia.SPMM_ROW if form == dia.SPMM_STAGED else dia.SPMM_STAGED
    try:
        dia.plan_coded_block_windows(op.offsets, item, K, "plain", op.codes.shape[1])
        has_staged = True
    except ValueError:
        has_staged = False
    t = {"form": form, "nd_spec": dia.spmm_nd(op, K, "plain"),
         "ms": time_ms(lambda: dia.dia_coded_spmm(op, x, wy), flush),
         "plain_ms": time_ms(lambda: dia.dia_coded_spmm_plain(op, x, wy), flush),
         "library_ms": time_ms(lambda: torch.sparse.mm(csr, xs), flush), "other_form": other, "other_form_ms": None}
    if other == dia.SPMM_ROW or has_staged:
        err = _compare(f"coded SpMM {tag} K={K} {other} form", dia.dia_coded_spmm(op, x, wy, form=other),
                       dia.dia_coded_spmm_plain(op, x, wy))
        if errs is not None:
            errs[f"dia_coded_spmm[{tag},K={K},{other}]"] = err
        t["other_form_ms"] = time_ms(lambda: dia.dia_coded_spmm(op, x, wy, form=other), flush)
    t["bound_ms"], t["bound_by"] = _bound_ms(rows * (op.codes.shape[1] + 2 * K * item), 2 * int(csr._nnz()) * K,
                                             F32_FLOPS_PER_S if item == 4 else F64_FLOPS_PER_S)
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    emit({"phase": "slab_spmm_times", "path": tag, "K": K, "dtype": str(dt)[6:], "parts": P, "reps": REPS,
          "dia_coded_spmm": t})
    return t


def sstep_launches(dA, trips, s):
    """The launches of an s-step solve of ``trips`` device steps (outer
    trips): the initial residual's frame SpMV and s pair SpMVs a trip, each
    with its boundary product where A has an A_oh block; no sweep."""
    slab = "dia_coded_spmm" if dA.dia_mode == "coded" else "dia_stream_spmm"
    frame = "dia_coded_spmv" if dA.dia_mode == "coded" else "dia_stream_spmv"
    want = {frame: 1, slab: s * trips, "cg_sweep": 0}
    if dA.oh_nnz:
        want["ell_spmv_boundary"] = 1 + s * trips
    return want


def _true_rel(dA, b, x0, x):
    """||b - A x|| / ||b - A x0|| on the card, x a PVector over A.cols."""
    spmv = make_spmv_fn(dA)
    sl = slice(dA.row_layout.o0, dA.row_layout.o0 + dA.row_layout.no_max)
    xd = DeviceVector.from_pvector(x, dA.backend, dA.col_layout).data
    r1 = (b[:, sl] - spmv(xd)[:, sl]).double().norm()
    r0 = (b[:, sl] - spmv(x0.clone())[:, sl]).double().norm()
    return float(r1 / r0)


def phase_sstep(backend, run, gmulti, rng):
    """s-step CG (s = 2, 4) at 192^3 f32 on phase 3's operator against the
    standard body: iterations to TOL_MAIN and errors, the plain path's
    iterations, launches by formula a trip, the pair SpMV's kernel against
    its plain version, seconds per iteration from fixed trips; then s = 2 on
    the 48^3 f64 (2,2,2) decoupled system (phase 2b) on the box and the
    generic plans against the sequential backend's standard CG, and the
    overlap tail torch.equal to the standard tail on the fused, standard
    and s-step bodies (the coded fused body has no tail to overlap: there
    overlap=True builds the overlap=False function)."""
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _can_overlap
    from partitionedarrays_jl_tpu_torch.parallel.gpu_box import BoxExchangePlan

    A, b, x0, xe = run["A"], run["b"], run["x0"], run["xe"]
    errs, lines = {}, {}
    maxiter = 4 * A.rows.ngids
    bd, x0d = staged(run, backend)
    for s in (0,) + SSTEP_DEPTHS:
        kw = {"sstep": s} if s else {"fused": False}
        dA = device_matrix(A, backend)
        if s:
            _hold_body(f"s-step pair {N_MAIN}^3 f32 s={s}", dA, _random_slab(dA, 2, rng), errs, _slab_kernels(dA),
                       block=True)
        dia.reset_launches()
        t = time.perf_counter()
        x, info = cg(A, b, x0=x0, tol=TOL_MAIN, **kw)
        sync()
        solve_s = time.perf_counter() - t
        launches = dict(dia.LAUNCHES)
        trips = device_iterations(info)
        want = sstep_launches(dA, trips, s) if s else {"dia_coded_spmv": 1 + trips, "cg_sweep": trips}
        xp, info_p = gpu_cg(A, b, x0=x0, tol=TOL_MAIN, plain=True, **kw)
        true_rel = _true_rel(dA, bd, x0d, x)
        s_per_iter, fixed = fixed_trip_s_per_iter(lambda m: make_cg_fn(dA, 0.0, m, **kw), bd, x0d, *CG_TRIPS)
        line = {
            "phase": "sstep_cg", "n": N_MAIN, "dtype": "float32", "parts": 1, "s": s, "tol": TOL_MAIN,
            "cg_body": info["cg_body"], "iterations": info["iterations"], "converged": info["converged"],
            "rel_err": _rel_err(x, xe), "true_rel_residual": true_rel, "recursive_rel_residual":
            float(info["residuals"][-1] / info["residuals"][0]), "plain_iterations": info_p["iterations"],
            "plain_rel_err": _rel_err(xp, xe), "solve_s": solve_s, "kernels": launches, "expected_launches": want,
            "device_loop": info["device_loop"],
            "s_per_iter": s_per_iter, "fixed_trip_s": fixed, "fixed_trips": CG_TRIPS,
        }
        emit(line)
        lines[s] = line
        require(info["iterations"] == info_p["iterations"], f"s-step s={s}: kernel and plain iterations differ")
        for k in want:
            require(launches[k] == want[k], f"s-step s={s}: {launches[k]} {k} launches, expected {want[k]}")
    times = {"K=2": slab_spmm_times(f"s-step pair {N_MAIN}^3 f32", device_matrix(A, backend), 2, rng, errs)}
    std, s2 = lines[0], lines[2]
    require(std["converged"] and s2["converged"], "192^3 f32: the standard or the s = 2 body did not converge")
    # tests/test_sstep.py:143's iteration gate; its x gate is an f64 one
    # (the 48^3 arm below): in f32 the basis coordinates' residual drifts
    # from the true one, so the error is reported beside the true residual
    require(s2["iterations"] <= 2 * std["iterations"], f"s = 2: {s2['iterations']} iterations against the "
            f"standard body's {std['iterations']}")

    # 48^3 f64 (2,2,2): box and generic plans, the overlap tail
    Ah, bh, n = gmulti["Ah"], gmulti["bh"], N_GMG_MULTI

    def host(parts):
        A_, b_, _, _ = assemble_poisson(parts, (n, n, n))
        Ah_, bh_ = decouple_dirichlet(A_, b_)
        x_, info_ = cg(Ah_, bh_, tol=TOL_MULTI)
        return gather_pvector(x_), info_["iterations"]

    t = time.perf_counter()
    x_seq, it_seq = prun(host, sequential, (2, 2, 2))
    seq_s = time.perf_counter() - t
    multi = {"phase": "sstep_cg_stacked_parts", "n": n, "dtype": "float64", "parts": [2, 2, 2], "tol": TOL_MULTI,
             "sequential_iterations": it_seq, "sequential_s": seq_s}
    for plan, box in (("box", True), ("generic", False)):
        dA = device_matrix(Ah, backend, box)
        require(isinstance(dA.col_plan, BoxExchangePlan) == box, f"48^3 s-step {plan}: plan {type(dA.col_plan).__name__}")
        _hold_body(f"s-step pair {n}^3 f64 (2,2,2) {plan}", dA, _random_slab(dA, 2, rng), errs, _slab_kernels(dA),
                   block=True)
        if box and dA.dia_mode == "coded":
            times[f"K=2 {n}^3 f64 (2,2,2)"] = slab_spmm_times(f"s-step pair {n}^3 f64 (2,2,2)", dA, 2, rng, errs)
        db = _b_on_cols_layout(bh, dA)
        dx0 = torch.zeros_like(db)
        row = {}
        for body, kw in (("fused", {"fused": True}), ("standard", {"fused": False}), ("sstep2", {"sstep": 2})):
            fns = [make_cg_fn(dA, TOL_MULTI, 4 * Ah.rows.ngids, overlap=ov, **kw) for ov in (False, True)]
            outs = [f(db, dx0) for f in fns]
            sync()
            (xa, rsa, _, ita, ha), (xb, rsb, _, itb, hb) = outs
            equal = bool(torch.equal(xa, xb) and torch.equal(rsa, rsb) and ita == itb
                         and np.array_equal(ha, hb, equal_nan=True))
            xg = DeviceVector(xa, Ah.cols, dA.col_layout, backend).to_pvector()
            row[body] = {"iterations": ita, "overlap_equal": equal, "overlap_tail": fns[1].overlap,
                         "x_vs_sequential": float(np.abs(gather_pvector(xg) - x_seq).max())}
            require(fns[1].overlap == _can_overlap(dA, body == "fused"),
                    f"48^3 {plan} {body}: overlap tail {fns[1].overlap}")
            require(equal, f"48^3 {plan} {body}: the overlap tail differs from the standard tail")
            if body == "sstep2":
                s_ov = {}
                for ov in (False, True):
                    s_ov[f"overlap={ov}"], _ = fixed_trip_s_per_iter(
                        lambda m: make_cg_fn(dA, 0.0, m, sstep=2, overlap=ov), db, dx0, *CG_TRIPS)
                row[body]["s_per_iter"] = s_ov
        multi[plan] = row
        r = row["sstep2"]
        require(r["iterations"] <= 2 * it_seq and r["x_vs_sequential"] < SSTEP_X_ATOL,
                f"48^3 s = 2 on the {plan} plan: {r['iterations']} iterations (sequential {it_seq}), "
                f"|x - x_seq| {r['x_vs_sequential']}")
    emit(multi)
    return {"errs": errs, "lines": lines, "multi": multi, "times": times}


def cycle_launches(h, dh, dev_it, pcg_sweep=False):
    """The launches of ``dev_it`` device iterations of the stationary solve
    (``pcg_sweep``: of GMG-PCG) with the hierarchy's cycle, V or W: the
    initial residual, per iteration the outer A0 SpMV (and with
    ``pcg_sweep`` the sweep) and the cycle's visits of every level. A
    V-cycle visits each level once from x = 0 (a cold pass: pre - 1 + 1 +
    post A SpMVs and init + pre - 1 + 1 + post epilogues); the W-cycle
    visits level l >= 1 2^l times, half of them warm (pre + 1 + post A
    SpMVs and as many epilogues). Two transfers a visit: the stencil kernel
    or, on the structured routes, a coded or streaming SpMV with S; the
    coarse solve is a mat-vec."""
    want = {"dia_coded_spmv": 1, "dia_stream_spmv": 0, "box_stencil_apply": 0, "vcycle_epilogue": 0,
            "cg_sweep": dev_it if pcg_sweep else 0}
    a0 = dh["levels"][0]["dA"]
    want["dia_coded_spmv" if a0.dia_mode == "coded" else "dia_stream_spmv"] += dev_it
    for l, lv in enumerate(dh["levels"]):
        if h.cycle == "w" and l > 0:
            cold = warm = 2 ** (l - 1)
        else:
            cold, warm = 1, 0
        a_spmvs = cold * (max(h.pre - 1, 0) + 1 + h.post) + warm * (h.pre + 1 + h.post)
        epis = cold * ((1 if h.pre > 0 else 0) + max(h.pre - 1, 0) + 1 + h.post) + warm * (h.pre + 1 + h.post)
        want["dia_coded_spmv" if lv["dA"].dia_mode == "coded" else "dia_stream_spmv"] += dev_it * a_spmvs
        want["vcycle_epilogue"] += dev_it * epis
        if gpu_gmg.route(lv) == "stencil":
            want["box_stencil_apply"] += dev_it * 2 * (cold + warm)
        else:
            want["dia_coded_spmv" if lv["dS"].dia_mode == "coded" else "dia_stream_spmv"] += dev_it * 2 * (cold + warm)
    return want


def phase_gmg_family(backend, g, rng):
    """The stationary GMG solve at 192^3 f32 on phase 2b's hierarchy, V-
    and W-cycle (the W hierarchy built from the V hierarchy's levels,
    sharing its staging): iterations to TOL_MAIN, errors, the plain path's
    iterations, launches by formula, seconds per iteration, graph against
    eager, one W-cycle against its plain version; W-cycle GMG-PCG once."""
    h, Ah, bh, xe, dh = g["h"], g["Ah"], g["bh"], g["xe"], g["dh"]
    staged_before = gpu_gmg.STATS["stagings"]
    t = time.perf_counter()
    hw = h.with_cycle("w")
    w_setup_s = time.perf_counter() - t
    dA0 = device_matrix(Ah, backend)
    b = _b_on_cols_layout(bh, dA0)
    x0 = torch.zeros_like(b)
    errs, out = {}, {"phase": "gmg_stationary", "n": N_MAIN, "dtype": "float32", "parts": 1, "tol": TOL_MAIN,
                     "levels": len(h.levels), "w_setup_s": w_setup_s}
    for name, hh in (("v", h), ("w", hw)):
        dia.reset_launches()
        t = time.perf_counter()
        x, info = gmg_solve(hh, bh, tol=TOL_MAIN, maxiter=100)
        sync()
        solve_s = time.perf_counter() - t
        launches = dict(dia.LAUNCHES)
        dev_it = device_iterations(info)
        want = cycle_launches(hh, dh, dev_it)
        xp, info_p = gpu_gmg.gpu_gmg_solve(hh, bh, tol=TOL_MAIN, maxiter=100, plain=True)
        s_per_iter, fixed = fixed_trip_s_per_iter(lambda m: gpu_gmg.make_gmg_solve_fn(hh, backend, 0.0, m), b, x0,
                                                  *GMG_TRIPS)
        ge = graph_vs_eager(f"{N_MAIN}^3 f32 stationary GMG {name}-cycle",
                            lambda gr: gpu_gmg.make_gmg_solve_fn(hh, backend, TOL_MAIN, 100, graph=gr), b, x0)
        out[name] = {"iterations": info["iterations"], "converged": info["converged"], "rel_err": _rel_err(x, xe),
                     "plain_iterations": info_p["iterations"], "plain_rel_err": _rel_err(xp, xe), "solve_s": solve_s,
                     "kernels": {k: launches[k] for k in want}, "expected_launches": want,
                     "launches_a_cycle": {k: (want[k] - (1 if k == "dia_coded_spmv" else 0)) / max(dev_it, 1)
                                          for k in want},
                     "device_loop": info["device_loop"], "s_per_iter": s_per_iter, "fixed_trip_s": fixed,
                     "fixed_trips": GMG_TRIPS, "graph_vs_eager_iterations": ge["iterations"]}
        require(info["converged"], f"stationary GMG {name}-cycle did not converge")
        require(info["iterations"] == info_p["iterations"], f"stationary GMG {name}: kernel and plain iterations differ")
        for k in want:
            require(launches[k] == want[k], f"stationary GMG {name}: {launches[k]} {k} launches, expected {want[k]}")
    L0 = dh["levels"][0]["dA"].col_layout
    r = torch.zeros((L0.P, L0.W), dtype=b.dtype, device=b.device)
    r[:, L0.o0 : L0.o0 + L0.no_max] = torch.from_numpy(rng.standard_normal((L0.P, L0.no_max))).to(r)
    err_w = _compare("W-cycle (kernels against plain versions)", gpu_gmg.make_vcycle(hw, dh)(r.clone()),
                     gpu_gmg.make_vcycle(hw, dh, plain=True)(r.clone()))
    for name in ("dia_coded_spmv", "dia_stream_spmv", "box_stencil_apply", "vcycle_epilogue"):
        errs[f"{name}[W-cycle {N_MAIN}^3 f32]"] = err_w
    dia.reset_launches()
    xw, info_w = pcg(Ah, bh, minv=hw, tol=TOL_MAIN)
    sync()
    launches = dict(dia.LAUNCHES)
    want = cycle_launches(hw, dh, device_iterations(info_w), pcg_sweep=True)
    out["w_pcg"] = {"iterations": info_w["iterations"], "converged": info_w["converged"], "rel_err": _rel_err(xw, xe),
                    "kernels": {k: launches[k] for k in want}, "expected_launches": want}
    out["stagings_added"] = gpu_gmg.STATS["stagings"] - staged_before
    emit(out)
    require(out["stagings_added"] == 0, "the W hierarchy staged the V hierarchy's levels again")
    require(info_w["converged"], "W-cycle GMG-PCG did not converge")
    for k in want:
        require(launches[k] == want[k], f"W-cycle GMG-PCG: {launches[k]} {k} launches, expected {want[k]}")
    return {"errs": errs, "line": out}


def phase_agglomeration(backend, gmulti, rng):
    """Coarse agglomeration on the 48^3 f64 (2,2,2) system of phase 2b
    (AGG_THRESHOLD: the 12^3 level and the coarse grid on one part): the
    stationary solve and GMG-PCG take the full-mesh hierarchy's iterations
    and solutions, on the card and on the sequential backend's host loop
    (tests/test_gmg.py:405); the agglomerated levels' transfers (the
    assembled route: E1 on R and P) and one V-cycle against their plain
    versions; the staged S keep the box plan (tests/test_gmg.py:729)."""
    from partitionedarrays_jl_tpu_torch.parallel.gpu_box import BoxExchangePlan

    n, Ah, bh, xe, h = N_GMG_MULTI, gmulti["Ah"], gmulti["bh"], gmulti["xe"], gmulti["h"]
    t = time.perf_counter()
    ha = prun(lambda parts: gmg_hierarchy(parts, Ah, (n, n, n), coarse_threshold=500, agg_threshold=AGG_THRESHOLD),
              backend, (2, 2, 2))
    agg_hierarchy_s = time.perf_counter() - t
    empty = [lvl.A.rows.ngids for lvl in ha.levels[1:] if min(i.num_oids for i in lvl.A.rows.partition.part_values()) == 0]
    require(empty or min(i.num_oids for i in ha.coarse_A.rows.partition.part_values()) == 0,
            "agglomeration: no level was agglomerated")
    t = time.perf_counter()
    dha = gpu_gmg.device_hierarchy(ha, backend)
    sync()
    agg_staging_s = time.perf_counter() - t
    routes = [gpu_gmg.route(lv) for lv in dha["levels"]]
    errs = {}
    for li, lv in enumerate(dha["levels"]):
        if "dR" in lv:
            for name in ("dR", "dP"):
                dM = lv[name]
                x = torch.from_numpy(rng.standard_normal((dM.col_layout.P, dM.col_layout.W))).to(backend.device)
                x[:, dM.col_layout.g0:] = 0
                kern = ["ell_spmv"] + (["ell_spmv_boundary"] if dM.oh_nnz else [])
                _hold_body(f"agglomerated level {li} {name[1]} {n}^3 f64", dM, x, errs, kern)
    require(any(k.startswith("ell_spmv[") for k in errs), f"agglomeration: no assembled route ({routes})")
    _, err_vc = _epilogue_checks(ha, dha, rng, f"agglomerated {n}^3 f64")
    dhs = gpu_gmg.device_hierarchy(ha, backend, stencil=False)
    s_plans = [type(lv["dS"].col_plan).__name__ for lv in dhs["levels"] if "dS" in lv]
    require(all(isinstance(lv["dS"].col_plan, BoxExchangePlan) for lv in dhs["levels"] if "dS" in lv),
            f"agglomeration: a staged S left the box plan ({s_plans})")
    card = {}
    for name, hh in (("full", h), ("agg", ha)):
        xs, infos = gmg_solve(hh, bh, tol=TOL_MULTI)
        xp, infop = pcg(Ah, bh, minv=hh, tol=TOL_MULTI)
        card[name] = (infos["iterations"], infop["iterations"], gather_pvector(xs), gather_pvector(xp),
                      infos["converged"] and infop["converged"])

    def host(parts):
        A_, b_, _, _ = assemble_poisson(parts, (n, n, n))
        Ah_, bh_ = decouple_dirichlet(A_, b_)
        out = {}
        for name, agg in (("full", 0), ("agg", AGG_THRESHOLD)):
            hh = gmg_hierarchy(parts, Ah_, (n, n, n), coarse_threshold=500, agg_threshold=agg)
            xs, infos = gmg_solve(hh, bh_, tol=TOL_MULTI)
            out[name] = (infos["iterations"], gather_pvector(xs))
        return out

    t = time.perf_counter()
    seq = prun(host, sequential, (2, 2, 2))
    seq_s = time.perf_counter() - t
    xdiff = {"card_stationary": float(np.abs(card["agg"][2] - card["full"][2]).max()),
             "card_pcg": float(np.abs(card["agg"][3] - card["full"][3]).max()),
             "host_stationary": float(np.abs(seq["agg"][1] - seq["full"][1]).max())}
    line = {"phase": "gmg_agglomeration", "n": n, "dtype": "float64", "parts": [2, 2, 2],
            "agg_threshold": AGG_THRESHOLD, "agglomerated_level_sizes": empty, "routes": routes,
            "structured_s_plans": s_plans, "agg_hierarchy_s": agg_hierarchy_s, "agg_staging_s": agg_staging_s,
            "card_iterations": {k: v[:2] for k, v in card.items()},
            "host_iterations": {k: v[0] for k, v in seq.items()}, "x_apart": xdiff, "sequential_s": seq_s,
            "vcycle_vs_plain_max_abs_err": err_vc, "max_abs_err": errs}
    emit(line)
    require(card["full"][4] and card["agg"][4], "agglomeration: a card solve did not converge")
    require(card["full"][:2] == card["agg"][:2], f"agglomeration: card iterations {line['card_iterations']}")
    require(seq["full"][0] == seq["agg"][0] == card["agg"][0],
            f"agglomeration: host iterations {line['host_iterations']}, card {line['card_iterations']}")
    require(all(v < AGG_X_ATOL for v in xdiff.values()), f"agglomeration: solutions apart {xdiff}")
    return {"errs": errs, "line": line}


def laplacian_eigenvalues(n, scale, k):
    """The k smallest eigenvalues of the decoupled Dirichlet Poisson
    operator of `gmg_driver` (n^3 cells, the 7-point stencil scaled by
    ``scale``): the interior (n-2)^3 grid's Laplacian, sum over dimensions
    of 2 - 2cos(j pi / (n - 1)), below every boundary row's ``scale``."""
    m = n - 2
    one = 2.0 - 2.0 * np.cos(np.arange(1, 4) * np.pi / (m + 1))
    vals = sorted(scale * (one[a] + one[b_] + one[c]) for a in range(3) for b_ in range(3) for c in range(3))
    return np.array(vals[:k])


def lobpcg_s_per_iter(dA, h, rng):
    """Seconds per iteration of the GMG-preconditioned LOBPCG loop on dA:
    two solves of LOBPCG_TRIPS fixed iterations (tol 0) from one random
    start on the card, differenced, median of 3 each after a first call
    (the host's start staging and eigenvector lift are outside it)."""
    from partitionedarrays_jl_tpu_torch.parallel.gpu_lobpcg import make_lobpcg_fn

    L = dA.col_layout
    X0 = torch.from_numpy(rng.standard_normal((L.P, L.no_max, LOBPCG_NEV))).to(dA.backend.device,
                                                                                dA.coded.cb.dtype)
    per = {}
    for m in LOBPCG_TRIPS:
        fn = make_lobpcg_fn(dA, LOBPCG_NEV, 0.0, m, gmg_h=h)
        fn(X0, None)
        ts = []
        for _ in range(3):
            sync()
            t = time.perf_counter()
            out = fn(X0, None)
            sync()
            ts.append(time.perf_counter() - t)
            require(out[3] == m, f"fixed-trip LOBPCG stopped after {out[3]} of {m} iterations")
        per[m] = statistics.median(ts)
    m0, m1 = LOBPCG_TRIPS
    return (per[m1] - per[m0]) / (m1 - m0), per


def phase_lobpcg(backend, g, rng):
    """LOBPCG: nev = LOBPCG_NEV, GMG-preconditioned, at 192^3 f32 on phase
    2b's decoupled operator, its eigenvalues against the closed form of
    that operator's spectrum; Jacobi LOBPCG at N_LOBPCG_MULTI^3 f64 (2,2,2)
    (a depth cut of the 48^3 cell) against the host loop on the sequential
    backend (rtol LOBPCG_MULTI_RTOL, tests/test_solvers.py:566). Iterations, seconds per iteration, the block SpMV (nev
    columns) against its plain version on both operators, and the slab
    kernel's launches by formula (one a W block, the start's one)."""
    errs, out = {}, {"phase": "lobpcg", "nev": LOBPCG_NEV}
    Ah, h = g["Ah"], g["h"]
    dA = device_matrix(Ah, backend)
    _hold_body(f"lobpcg block {N_MAIN}^3 f32 K={LOBPCG_NEV}", dA, _random_slab(dA, LOBPCG_NEV, rng), errs,
               _slab_kernels(dA), block=True)
    times = {f"K={LOBPCG_NEV}": slab_spmm_times(f"lobpcg block {N_MAIN}^3 f32", dA, LOBPCG_NEV, rng, errs)}
    dia.reset_launches()
    t = time.perf_counter()
    lam, X, info = lobpcg(Ah, nev=LOBPCG_NEV, minv=h, tol=TOL_LOBPCG, maxiter=LOBPCG_MAXITER)
    sync()
    solve_s = time.perf_counter() - t
    launches = dict(dia.LAUNCHES)
    it = info["iterations"]
    exact = laplacian_eigenvalues(N_MAIN, 1.0 / 16.0, LOBPCG_NEV)
    rel = np.abs(lam - exact) / exact
    vc = cycle_launches(h, g["dh"], LOBPCG_NEV * it)
    want = {"dia_coded_spmm": 1 + it, "box_stencil_apply": vc["box_stencil_apply"],
            "vcycle_epilogue": vc["vcycle_epilogue"], "dia_stream_spmv": vc["dia_stream_spmv"],
            "dia_coded_spmv": vc["dia_coded_spmv"] - 1 - LOBPCG_NEV * it}
    s_per_iter, fixed = lobpcg_s_per_iter(dA, h, rng)
    out["gmg_192"] = {"n": N_MAIN, "dtype": "float32", "tol": TOL_LOBPCG, "iterations": it,
                      "converged": info["converged"], "eigenvalues": lam.tolist(), "closed_form": exact.tolist(),
                      "rel_err": rel.tolist(), "solve_s": solve_s, "s_per_iter": s_per_iter, "fixed_trip_s": fixed,
                      "fixed_trips": LOBPCG_TRIPS,
                      "kernels": {k: launches[k] for k in want}, "expected_launches": want,
                      "device_loop": info["device_loop"]}
    require(info["converged"], f"LOBPCG 192^3 GMG: not converged in {it} iterations")
    require(np.all(rel < LOBPCG_EIG_RTOL), f"LOBPCG 192^3: eigenvalues {lam} against the closed form {exact}")
    for k in want:
        require(launches[k] == want[k], f"LOBPCG 192^3: {launches[k]} {k} launches, expected {want[k]}")

    n = N_LOBPCG_MULTI

    def system(parts):
        A_, b_, _, _ = assemble_poisson(parts, (n, n, n))
        return decouple_dirichlet(A_, b_)[0]

    Am = prun(system, backend, (2, 2, 2))
    dAm = device_matrix(Am, backend)
    _hold_body(f"lobpcg block {n}^3 f64 (2,2,2) K={LOBPCG_NEV}", dAm, _random_slab(dAm, LOBPCG_NEV, rng), errs,
               _slab_kernels(dAm), block=True)
    kw = dict(nev=LOBPCG_NEV, tol=TOL_LOBPCG_MULTI, maxiter=LOBPCG_MULTI_MAXITER)
    t = time.perf_counter()
    lam_d, _, info_d = lobpcg(Am, minv=jacobi_preconditioner(Am), **kw)
    sync()
    dev_s = time.perf_counter() - t

    def host(parts):
        Ah_ = system(parts)
        lam_, _, info_ = lobpcg(Ah_, minv=jacobi_preconditioner(Ah_), **kw)
        return lam_, info_["iterations"], info_["converged"]

    t = time.perf_counter()
    lam_h, it_h, conv_h = prun(host, sequential, (2, 2, 2))
    host_s = time.perf_counter() - t
    out["jacobi_multi"] = {"n": n, "dtype": "float64", "parts": [2, 2, 2], "tol": TOL_LOBPCG_MULTI,
                        "iterations": info_d["iterations"], "host_iterations": it_h,
                        "converged": [info_d["converged"], conv_h], "eigenvalues": lam_d.tolist(),
                        "host_eigenvalues": lam_h.tolist(), "closed_form": laplacian_eigenvalues(n, 1.0, 4).tolist(),
                        "device_s": dev_s, "s_per_iter": dev_s / max(info_d["iterations"], 1), "host_s": host_s}
    out["max_abs_err"] = errs
    emit(out)
    require(info_d["converged"] and conv_h, f"LOBPCG {n}^3: device or host loop did not converge")
    require(np.allclose(lam_d, lam_h, rtol=LOBPCG_MULTI_RTOL, atol=0),
            f"LOBPCG {n}^3: device {lam_d} against host {lam_h}")
    return {"errs": errs, "line": out, "launches": launches, "times": times}


def phase_ras_bicgstab(backend):
    """Right-preconditioned BiCGStab with `additive_schwarz(mode="ras")` on
    the 48^3 f64 (2,2,2) advection system on the GPU backend (a callable
    preconditioner: the host loop) against the unpreconditioned device
    BiCGStab (tests/test_solvers.py:605)."""
    n = N_ADV_MULTI
    run = prun(advection_system, backend, (2, 2, 2), n)
    A, b, xe, x0 = run["A"], run["b"], run["xe"], run["x0"]
    t = time.perf_counter()
    ras = additive_schwarz(A, mode="ras")
    factor_s = time.perf_counter() - t
    t = time.perf_counter()
    xr, ir = bicgstab(A, b, x0=x0, minv=ras, tol=TOL_RAS)
    ras_s = time.perf_counter() - t
    xp, ip = bicgstab(A, b, x0=x0, tol=TOL_RAS)
    err_r = float(np.abs(gather_pvector(xr) - gather_pvector(xe)).max())
    line = {"phase": "ras_bicgstab", "n": n, "dtype": "float64", "parts": [2, 2, 2], "tol": TOL_RAS,
            "iterations": ir["iterations"], "converged": ir["converged"], "max_err": err_r,
            "plain_bicgstab_iterations": ip["iterations"], "factor_s": factor_s, "solve_s": ras_s,
            "s_per_iter": ras_s / max(ir["iterations"], 1)}
    emit(line)
    require(ir["converged"] and err_r < 1e-6, f"RAS BiCGStab: converged {ir['converged']}, error {err_r}")
    require(ir["iterations"] < ip["iterations"], f"RAS BiCGStab: {ir['iterations']} iterations against plain "
            f"BiCGStab's {ip['iterations']}")
    return line


def phase_solver_family(backend, run, gruns, rng):
    """Phase 4j: s-step CG and the overlap tail, the stationary GMG solve
    with the V- and W-cycle, coarse agglomeration, LOBPCG, right-RAS
    BiCGStab. Returns the held kernels' errors and the launch counts of
    each path for the launch_counts line."""
    t = time.perf_counter()
    ss = phase_sstep(backend, run, gruns["multi"], rng)
    t_ss = time.perf_counter() - t
    gf = phase_gmg_family(backend, gruns["main"], rng)
    t_gf = time.perf_counter() - t - t_ss
    ag = phase_agglomeration(backend, gruns["multi"], rng)
    t_ag = time.perf_counter() - t - t_ss - t_gf
    lb = phase_lobpcg(backend, gruns["main"], rng)
    t_lb = time.perf_counter() - t - t_ss - t_gf - t_ag
    ras = phase_ras_bicgstab(backend)
    seconds = {"sstep": t_ss, "gmg_family": t_gf, "agglomeration": t_ag, "lobpcg": t_lb,
               "ras_bicgstab": time.perf_counter() - t - t_ss - t_gf - t_ag - t_lb,
               "total": time.perf_counter() - t}
    emit({"phase": "solver_family_seconds", **seconds})
    launches = {f"sstep s={s}": line["kernels"] for s, line in ss["lines"].items()}
    launches.update({f"gmg stationary {c}": gf["line"][c]["kernels"] for c in ("v", "w")},
                    **{"gmg w pcg": gf["line"]["w_pcg"]["kernels"], "lobpcg 192^3 gmg": lb["launches"]})
    return {"errs": {**ss["errs"], **gf["errs"], **ag["errs"], **lb["errs"]}, "launches": launches,
            "ras": ras, "seconds": seconds, "times": {"s-step pair": ss["times"], "lobpcg block": lb["times"]}}


# ---------------------------------------------------------------------------
# phase 4k: the resilience layer
# ---------------------------------------------------------------------------

#: the defense of the 192^3 arm: ABFT checksums and an audit every 32
#: iterations (the JAX package's defaults under PA_TPU_ABFT=1)
SDC_EVERY = 32
SDC_FAULT_TRIP = 100  # the 192^3 arm's fault: a trip well inside the ~420-iteration solve
SDC_FAULT_FACTOR = 1e3
SDC_MULTI_FAULT = "spmv@trip=20,part=1,factor=1e3"  # the 48^3 (2,2,2) arm's fault, on part 1
SDC_BLOCK_K = 4
SDC_BLOCK_FAULT = "spmv@trip=7,part=1,factor=1e3"
SDC_SEQ_RTOL = 1e-12  # the clean 48^3 defended solve against the sequential host solve, of max |x|
TOL_RECOVERY = 1e-10
RECOVERY_EVERY = 50
RECOVERY_X_RTOL = 1e-7  # the chunked recovery solve against the one-shot device solve
RING_FULL = 512  # trace depth >= the 421 iterations of the 192^3 f32 solve: the whole trace
RING_ROLLED = 64  # a wrapped ring (trace_start > 0)
RING_PROFILE_TRIPS = 48
N_SERVE = 9  # the service's requests at 192^3 f32: a slab of 8 and a ragged slab of 1
SERVE_KMAX = 8
SERVE_POISON = 3  # the request with a NaN in b (retries=0)
SERVE_CHUNK = 100  # iterations a chunk of the deadline-carrying slab
SERVE_CHUNK_K = 4  # requests of the chunked slab


def _gathered_equal(x, y):
    return bool(torch.equal(torch.from_numpy(gather_pvector(x)), torch.from_numpy(gather_pvector(y))))


def _timed_solve(fn, b, x0, reps=3):
    """Median seconds of ``reps`` calls of a cached solve function, after a
    first call (the capture) outside the span; and its last output."""
    out = fn(b, x0)
    ts = []
    for _ in range(reps):
        sync()
        t = time.perf_counter()
        out = fn(b, x0)
        sync()
        ts.append(time.perf_counter() - t)
    return statistics.median(ts), out


def phase_resilience(backend, run, gmulti, rng):
    """Phase 4k: the resilience layer on the card (the SDC defense,
    `parallel/gpu_sdc.py`; the typed health errors; the recovery drivers).
    At 192^3 f32 on phase 3's operator, on its generic-plan lowering (ABFT
    pins the generic plan), the fused and standard bodies under
    SDCConfig(abft=True, audit_every=32): the clean solve torch.equal to
    the undefended one (iterations, history, x) with 0 detections; a
    device fault at trip SDC_FAULT_TRIP detected once, rolled back once,
    converged, x torch.equal to the clean solve; max_rollbacks=0
    escalating with SilentCorruptionError; launches by formula (K1 1 + 1
    a trip, no K2, the sweep 1 a trip, with audits on and off); the
    kernel path torch.equal to plain=True; seconds per iteration and per
    trip defended and undefended, and a profile of the defended trip. On
    phase 2b's 48^3 f64 (2,2,2) decoupled system, generic plan: fused CG
    with a fault on part 1 self-healing bit for bit, the clean defended
    solve against the sequential backend's host solve (iterations, x to
    SDC_SEQ_RTOL of max |x|), the exchange and K1 calls per trip equal with
    ABFT on and off (eager loops), block CG at K = SDC_BLOCK_K with a fault
    at trip 7, each column torch.equal to its clean solve; a NaN in b
    raising NonFiniteError within one iteration; `solve_with_recovery` in
    chunks of RECOVERY_EVERY into a temporary directory against the
    one-shot device solve, and `resume_solve` on the sequential backend
    from the card's checkpoint."""
    import tempfile

    from partitionedarrays_jl_tpu_torch import resume_solve, solve_with_recovery
    from partitionedarrays_jl_tpu_torch.parallel.gpu import EXCHANGES, _krylov_fn_for
    from partitionedarrays_jl_tpu_torch.utils.health import NonFiniteError, SDCConfig, SilentCorruptionError

    t_phase = time.perf_counter()
    A, b, x0 = run["A"], run["b"], run["x0"]
    maxiter = 4 * A.rows.ngids
    sdc = SDCConfig(abft=True, audit_every=SDC_EVERY)
    fault = SDCConfig(abft=True, audit_every=SDC_EVERY,
                      device_fault=f"spmv@trip={SDC_FAULT_TRIP},part=0,factor={SDC_FAULT_FACTOR}")
    t = time.perf_counter()
    dA = device_matrix(A, backend, box=False)
    bd = _b_on_cols_layout(b, dA)
    x0d = DeviceVector.from_pvector(x0, backend, dA.col_layout).data
    dA.abft_row()
    sync()
    staging_s = time.perf_counter() - t
    line = {"phase": "resilience", "n": N_MAIN, "dtype": "float32", "parts": 1, "tol": TOL_MAIN,
            "sdc": {"abft": True, "audit_every": SDC_EVERY}, "generic_staging_s": staging_s, "bodies": {}}
    for body, fused in (("fused", True), ("standard", False)):
        x_off, i_off = gpu_cg(A, b, x0=x0, tol=TOL_MAIN, fused=fused, box=False)
        dia.reset_launches()
        x_on, i_on = gpu_cg(A, b, x0=x0, tol=TOL_MAIN, fused=fused, sdc=sdc)
        launches = dict(dia.LAUNCHES)
        trips = device_iterations(i_on)
        want = {"dia_coded_spmv": 1 + trips, "dia_coded_spmv_pfold": 0, "cg_sweep": trips}
        x_f, i_f = gpu_cg(A, b, x0=x0, tol=TOL_MAIN, fused=fused, sdc=fault)
        clean_equal = (_gathered_equal(x_off, x_on) and i_off["iterations"] == i_on["iterations"]
                       and np.array_equal(i_off["residuals"], i_on["residuals"]))
        healed = _gathered_equal(x_on, x_f) and i_f["iterations"] == i_on["iterations"]
        f_on = _krylov_fn_for(dA, "cg", TOL_MAIN, maxiter, fused=fused, sdc=sdc)
        f_off = _krylov_fn_for(dA, "cg", TOL_MAIN, maxiter, fused=fused)
        s_on, out_on = _timed_solve(f_on, bd, x0d)
        s_off, out_off = _timed_solve(f_off, bd, x0d)
        row = {
            "cg_body": i_on["cg_body"], "exchange_plan": i_on["exchange_plan"], "iterations": i_on["iterations"],
            "undefended_iterations": i_off["iterations"], "converged": i_on["converged"], "clean_sdc": i_on["sdc"],
            "clean_equal_to_undefended": clean_equal, "fault": fault.device_fault, "fault_sdc": i_f["sdc"],
            "fault_converged": i_f["converged"], "fault_x_equal_to_clean": healed,
            "kernels": launches, "expected_launches": want, "device_loop": i_on["device_loop"],
            "s_per_iter": s_on / out_on[3], "s_per_trip": s_on / int(out_on[5][4]),
            "undefended_s_per_iter": s_off / out_off[3], "trips": int(out_on[5][4]),
            "defense_cost": s_on / s_off,
        }
        line["bodies"][body] = row
        require(clean_equal, f"192^3 {body}: the clean defended solve differs from the undefended one")
        require(i_on["sdc"]["detections"] == 0, f"192^3 {body}: {i_on['sdc']['detections']} detections on a clean solve")
        require(i_f["sdc"]["detections"] == 1 and i_f["sdc"]["rollbacks"] == 1 and i_f["converged"],
                f"192^3 {body}: the faulted solve's counters {i_f['sdc']}, converged {i_f['converged']}")
        require(healed, f"192^3 {body}: the healed x differs from the clean solve's")
        require(i_on["exchange_plan"] == "generic", f"192^3 {body}: ABFT ran the {i_on['exchange_plan']} plan")
        for k in want:
            require(launches[k] == want[k], f"192^3 {body} defended: {launches[k]} {k} launches, expected {want[k]}")
    # audits off (ABFT only): one K1 a trip as with audits on
    dia.reset_launches()
    _, i_na = gpu_cg(A, b, x0=x0, tol=TOL_MAIN, sdc=SDCConfig(abft=True, audit_every=0))
    na = dict(dia.LAUNCHES)
    tr_na = device_iterations(i_na)
    line["audits_off"] = {"kernels": na, "device_iterations": tr_na, "sdc": i_na["sdc"]}
    require(na["dia_coded_spmv"] == 1 + tr_na and na["cg_sweep"] == tr_na,
            f"192^3 audits off: launches {na} over {tr_na} trips")
    # escalation
    try:
        gpu_cg(A, b, x0=x0, tol=TOL_MAIN, sdc=SDCConfig(abft=True, audit_every=SDC_EVERY, max_rollbacks=0,
                                                          device_fault=fault.device_fault))
        esc = None
    except SilentCorruptionError as e:
        esc = e.diagnostics.get("sdc")
    line["escalation"] = esc
    require(esc is not None and esc["escalations"] == 1, f"192^3: max_rollbacks=0 did not escalate ({esc})")
    # the kernel path against the plain versions
    x_pl, i_pl = gpu_cg(A, b, x0=x0, tol=TOL_MAIN, sdc=sdc, plain=True)
    x_k, i_k = gpu_cg(A, b, x0=x0, tol=TOL_MAIN, sdc=sdc)
    line["plain_equal"] = _gathered_equal(x_pl, x_k) and i_pl["iterations"] == i_k["iterations"]
    require(line["plain_equal"], "192^3 defended: the kernel path differs from plain=True")
    prof = phase_profile("resilience_profile", make_cg_fn(dA, 0.0, 48, sdc=sdc), bd, x0d, 48)
    prof_off = phase_profile("resilience_profile_undefended", make_cg_fn(dA, 0.0, 48), bd, x0d, 48)
    line["device_ms_per_trip"] = sum(r[1] for r in prof["rows"])
    line["undefended_device_ms_per_iter"] = sum(r[1] for r in prof_off["rows"])
    line["profile_ms_per_trip"] = [{"name": k[:100], "ms": ms, "calls": c} for k, ms, c in prof["rows"]]

    # 48^3 f64 (2,2,2), generic plan
    Ah, bh, n = gmulti["Ah"], gmulti["bh"], N_GMG_MULTI
    dAg = device_matrix(Ah, backend, box=False)
    # the defended loop as a CUDA graph against the same loop run eagerly
    # (a faulted solve: a rollback inside the captured blocks)
    gf = SDCConfig(abft=True, audit_every=SDC_EVERY, device_fault=SDC_MULTI_FAULT)
    db_g = _b_on_cols_layout(bh, dAg)
    outs = {g: make_cg_fn(dAg, TOL_MULTI, 4 * Ah.rows.ngids, sdc=gf, graph=g) for g in (False, True)}
    res = {g: fn(db_g, torch.zeros_like(db_g)) for g, fn in outs.items()}
    sync()
    (xe_, rse_, _, ite_, he_, se_), (xg_, rsg_, _, itg_, hg_, sg_) = res[False], res[True]
    st = outs[True].stats
    gve = {"x": bool(torch.equal(xg_, xe_)), "rs": bool(torch.equal(rsg_, rse_)), "iterations": ite_ == itg_,
           "history": bool(np.array_equal(hg_, he_, equal_nan=True)), "sdc": bool(np.array_equal(sg_, se_))}
    emit({"phase": "loop_graph_vs_eager", "path": f"{n}^3 f64 (2,2,2) fused CG, SDC defended, faulted",
          "iterations": itg_, "sdc": [int(v) for v in sg_], "block": st["block"],
          "device_iterations": st["device_iterations"], "replays": st["replays"], "capture_s": st["capture_s"],
          "equal": gve})
    require(all(gve.values()) and st["loop"] == "graph" and st["replays"] > 0 and int(sg_[1]) == 1,
            f"48^3 defended: graph and eager loops differ ({gve}, {st}, sdc {sg_})")
    multi = {"n": n, "dtype": "float64", "parts": [2, 2, 2], "tol": TOL_MULTI}
    s5 = SDCConfig(abft=True, audit_every=SDC_EVERY)
    xc, ic = cg(Ah, bh, tol=TOL_MULTI, sdc=s5)
    xf, i_f = cg(Ah, bh, tol=TOL_MULTI, sdc=SDCConfig(abft=True, audit_every=SDC_EVERY, device_fault=SDC_MULTI_FAULT))
    multi.update(clean_sdc=ic["sdc"], fault_sdc=i_f["sdc"], healed=_gathered_equal(xc, xf), iterations=ic["iterations"])
    require(ic["sdc"]["detections"] == 0 and i_f["sdc"]["detections"] == 1 and i_f["sdc"]["rollbacks"] == 1,
            f"48^3: counters clean {ic['sdc']}, faulted {i_f['sdc']}")
    require(multi["healed"] and i_f["converged"], "48^3 (2,2,2): the faulted fused CG did not self-heal bit for bit")

    def host(parts):
        A_, b_, _, _ = assemble_poisson(parts, (n, n, n))
        Ah_, bh_ = decouple_dirichlet(A_, b_)
        x_, info_ = cg(Ah_, bh_, tol=TOL_MULTI)
        return Ah_, bh_, gather_pvector(x_), info_["iterations"]

    t = time.perf_counter()
    Ah_s, bh_s, x_seq, it_seq = prun(host, sequential, (2, 2, 2))
    multi["sequential_s"] = time.perf_counter() - t
    dx = float(np.abs(gather_pvector(xc) - x_seq).max() / np.abs(x_seq).max())
    multi.update(sequential_iterations=it_seq, x_vs_sequential=dx)
    require(ic["iterations"] == it_seq and dx <= SDC_SEQ_RTOL,
            f"48^3 defended: {ic['iterations']} iterations against the sequential {it_seq}, |dx|/max|x| {dx}")
    # exchange calls and K1 launches a trip, ABFT on and off (eager loops:
    # a graph replay calls no Python)
    db_ = _b_on_cols_layout(bh, dAg)
    per = {}
    for tag, cfg in (("abft", SDCConfig(abft=True, audit_every=SDC_EVERY)),
                     ("audit_only", SDCConfig(abft=False, audit_every=SDC_EVERY))):
        fn = make_cg_fn(dAg, TOL_MULTI, 4 * Ah.rows.ngids, graph=False, sdc=cfg)
        for k in EXCHANGES:
            EXCHANGES[k] = 0
        dia.reset_launches()
        out = fn(db_, torch.zeros_like(db_))
        sync()
        trips = fn.stats["device_iterations"]
        per[tag] = {"exchange_calls": EXCHANGES["calls"] - 1, "exchange_rounds": EXCHANGES["rounds"],
                    "dia_coded_spmv": dia.LAUNCHES["dia_coded_spmv"] - 1, "trips": trips}
        per[tag]["calls_per_trip"] = per[tag]["exchange_calls"] / trips
        per[tag]["k1_per_trip"] = per[tag]["dia_coded_spmv"] / trips
    multi["launch_parity"] = per
    require(per["abft"]["calls_per_trip"] == per["audit_only"]["calls_per_trip"] == 1.0
            and per["abft"]["k1_per_trip"] == per["audit_only"]["k1_per_trip"] == (1.0 if dAg.dia_mode == "coded" else 0.0),
            f"48^3: exchange / K1 launches a trip differ with ABFT on and off: {per}")

    # block CG, K = SDC_BLOCK_K
    def xk(k):
        return PVector(Ah.cols.partition._like([np.sin((k + 1.0) * np.asarray(i.lid_to_gid, dtype=np.float64))
                                               for i in Ah.cols.partition.part_values()]), Ah.cols)

    B = [bh] + [Ah @ xk(k) for k in range(SDC_BLOCK_K - 1)]
    xs_c, ibc = cg(Ah, B=B, tol=TOL_MULTI, sdc=s5)
    xs_f, ibf = cg(Ah, B=B, tol=TOL_MULTI, sdc=SDCConfig(abft=True, audit_every=SDC_EVERY, device_fault=SDC_BLOCK_FAULT))
    cols_equal = [_gathered_equal(a, c) for a, c in zip(xs_c, xs_f)]
    multi["block"] = {"K": SDC_BLOCK_K, "clean_sdc": ibc["sdc"], "fault_sdc": ibf["sdc"],
                      "iterations_per_column": ibc["iterations_per_column"], "columns_equal": cols_equal}
    require(all(cols_equal) and ibf["converged"] and ibf["sdc"]["rollbacks"] == 1 and ibc["sdc"]["detections"] == 0,
            f"48^3 block K={SDC_BLOCK_K}: {multi['block']}")

    # non-finite
    bn = bh.copy()
    vals = bn.values.part_values()[1]
    vals[int(np.asarray(bn.rows.partition.part_values()[1].oid_to_lid)[0])] = np.nan
    try:
        cg(Ah, bn, tol=TOL_MULTI)
        nf = None
    except NonFiniteError as e:
        nf = e.diagnostics.get("iteration")
    multi["nonfinite_iteration"] = nf
    require(nf is not None and nf <= 1, f"48^3: a NaN in b did not raise NonFiniteError within one iteration ({nf})")

    # recovery
    x1, i1 = cg(Ah, bh, tol=TOL_RECOVERY)
    with tempfile.TemporaryDirectory() as tmp:
        xr, ir = solve_with_recovery(Ah, bh, method="cg", checkpoint_dir=tmp, every=RECOVERY_EVERY, tol=TOL_RECOVERY)
        g1, gr = gather_pvector(x1), gather_pvector(xr)
        rel = float(np.linalg.norm(gr - g1) / np.linalg.norm(g1))
        xs_, is_ = resume_solve(tmp, Ah_s, bh_s)
    multi["recovery"] = {"converged": ir["converged"], "restarts": ir["restarts"], "iterations": ir["iterations"],
                         "ledger": ir["recovery"], "x_rel_vs_one_shot": rel, "one_shot_iterations": i1["iterations"],
                         "resumed_converged": is_["converged"], "resumed_from": is_["resumed_from_iteration"],
                         "resumed_iterations": is_["iterations"]}
    require(ir["converged"] and ir["restarts"] == 0 and rel <= RECOVERY_X_RTOL,
            f"48^3 solve_with_recovery: {multi['recovery']}")
    require(is_["converged"], "resume_solve on the sequential backend from the card's checkpoint did not converge")
    line["multi"] = multi
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)
    return line


# ---------------------------------------------------------------------------
# phase 4l: the serving path
# ---------------------------------------------------------------------------


def serving_rhs(A, backend, rng, k):
    """``k`` right-hand sides b_j = A x̂_j over A.rows (x̂_j from the seed,
    the product on the card) with their `dirichlet_start` starts: host
    PVectors, as a service's callers hold them."""
    dA = device_matrix(A, backend)
    spmv = make_spmv_fn(dA)
    dt = np.dtype(A.dtype)
    # `dirichlet_start`'s identity rows, found once for all requests
    ident = dirichlet_start(A, PVector(A.cols.partition._like([np.ones(i.num_lids, dt)
                                                               for i in A.cols.partition.part_values()]), A.cols))
    out = []
    for _ in range(k):
        xh = PVector(A.cols.partition._like([rng.standard_normal(i.num_lids).astype(dt)
                                             for i in A.cols.partition.part_values()]), A.cols)
        y = spmv(DeviceVector.from_pvector(xh, backend, dA.col_layout).data)
        x0 = PVector(A.cols.partition._like([np.where(np.asarray(m) != 0, np.asarray(v), np.zeros((), dt))
                                             for m, v in zip(ident.values.part_values(), xh.values.part_values())]),
                     A.cols)
        out.append((DeviceVector(y, A.rows, dA.row_layout, backend).to_pvector(), x0, xh))
    return out


def _ring_equal(a, b):
    return a is not None and b is not None and bool(np.array_equal(np.asarray(a), np.asarray(b)))


def phase_ring(backend, run, gmulti):
    """Phase 4l's trace-ring arms on phase 3's operator (fused and standard
    bodies) and the κ̂ reports; returns the ring's cost."""
    from partitionedarrays_jl_tpu_torch import telemetry
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _krylov_fn_for
    from partitionedarrays_jl_tpu_torch.parallel.gpu_loop import unroll_ring

    A = run["A"]
    dA = device_matrix(A, backend)
    bd, x0d = staged(run, backend)
    maxiter = 4 * A.rows.ngids
    line = {"phase": "trace_ring", "n": N_MAIN, "dtype": "float32", "tol": TOL_MAIN, "depths": [RING_FULL, RING_ROLLED],
            "bodies": {}}
    for body, fused in (("fused", True), ("standard", False)):
        row = {}
        dia.reset_launches()
        f0 = _krylov_fn_for(dA, "cg", TOL_MAIN, maxiter, fused=fused)
        o0 = f0(bd, x0d)
        sync()
        base_launches = dict(dia.LAUNCHES)
        dev_it = f0.stats["device_iterations"]
        want = ({"dia_coded_spmv": 1, "dia_coded_spmv_pfold": dev_it, "cg_sweep": dev_it} if fused
                else {"dia_coded_spmv": 1 + dev_it, "dia_coded_spmv_pfold": 0, "cg_sweep": dev_it})
        for k in want:
            require(base_launches[k] == want[k], f"ring {body} untraced: {base_launches[k]} {k} launches, want {want[k]}")
        for ht in (RING_FULL, RING_ROLLED):
            dia.reset_launches()
            ft = _krylov_fn_for(dA, "cg", TOL_MAIN, maxiter, fused=fused, trace_iters=ht)
            ot = ft(bd, x0d)
            sync()
            got = dict(dia.LAUNCHES)
            equal = {"x": bool(torch.equal(ot[0], o0[0])), "rs": bool(torch.equal(ot[1], o0[1])),
                     "iterations": ot[3] == o0[3], "history": bool(np.array_equal(ot[4], o0[4], equal_nan=True))}
            ring, it = ot[5], ot[3]
            rows, n_ab, start = unroll_ring(ring, it)
            h = np.asarray(ot[4][: it + 1], dtype=np.float64)
            # the CG recurrence: beta_k = rs_{k+1} / rs_k of the history, to f32 rounding
            j = np.arange(start, start + n_ab)
            beta_rel = float(np.max(np.abs(rows[:n_ab, 1] - (h[j + 1] / h[j]) ** 2) / ((h[j + 1] / h[j]) ** 2)))
            row[str(ht)] = {"ring_depth": ft.trace_iters, "trace_start": start, "entries": n_ab, "equal": equal,
                            "kernels": {k: got[k] for k in want}, "beta_vs_history_max_rel": beta_rel}
            require(all(equal.values()), f"ring {body} depth {ht}: the traced solve differs from the untraced one "
                    f"({equal})")
            for k in want:
                require(got[k] == base_launches[k], f"ring {body} depth {ht}: {got[k]} {k} launches, untraced "
                        f"{base_launches[k]}")
            require(start == max(0, it - ht) and n_ab == min(it, ht), f"ring {body} depth {ht}: start {start}, "
                    f"{n_ab} entries for {it} iterations")
            require(beta_rel < 1e-3, f"ring {body} depth {ht}: beta departs from the history by {beta_rel}")
        # the graph loop's ring against the eager loop's
        fe = make_cg_fn(dA, TOL_MAIN, maxiter, fused=fused, trace_iters=RING_FULL, graph=False)
        fg = make_cg_fn(dA, TOL_MAIN, maxiter, fused=fused, trace_iters=RING_FULL)
        oe, og = fe(bd, x0d), fg(bd, x0d)
        sync()
        gve = {"x": bool(torch.equal(og[0], oe[0])), "iterations": og[3] == oe[3], "ring": _ring_equal(og[5], oe[5]),
               "history": bool(np.array_equal(og[4], oe[4], equal_nan=True))}
        row["graph_vs_eager"] = {"equal": gve, "loop": fg.stats["loop"], "replays": fg.stats["replays"]}
        require(all(gve.values()) and fg.stats["loop"] == "graph" and fg.stats["replays"] > 0,
                f"ring {body}: the graph loop's ring differs from the eager loop's ({gve}, {fg.stats})")
        # seconds an iteration, traced and untraced (fixed trips)
        s_off, _ = fixed_trip_s_per_iter(lambda m: make_cg_fn(dA, 0.0, m, fused=fused), bd, x0d, *CG_TRIPS)
        s_on, _ = fixed_trip_s_per_iter(lambda m: make_cg_fn(dA, 0.0, m, fused=fused, trace_iters=RING_ROLLED),
                                        bd, x0d, *CG_TRIPS)
        p_off = phase_profile(f"ring_profile_{body}_untraced", make_cg_fn(dA, 0.0, RING_PROFILE_TRIPS, fused=fused),
                              bd, x0d, RING_PROFILE_TRIPS)
        p_on = phase_profile(f"ring_profile_{body}_traced",
                             make_cg_fn(dA, 0.0, RING_PROFILE_TRIPS, fused=fused, trace_iters=RING_ROLLED),
                             bd, x0d, RING_PROFILE_TRIPS)
        dev_off, dev_on = sum(r[1] for r in p_off["rows"]), sum(r[1] for r in p_on["rows"])
        row.update(s_per_iter_untraced=s_off, s_per_iter_traced=s_on, traced_over_untraced=s_on / s_off,
                   device_ms_per_iter_untraced=dev_off, device_ms_per_iter_traced=dev_on,
                   ring_device_ms_per_iter=dev_on - dev_off,
                   ring_share_of_iter=(dev_on - dev_off) / dev_on,
                   device_ops_per_iter_untraced=sum(r[2] for r in p_off["rows"]),
                   device_ops_per_iter_traced=sum(r[2] for r in p_on["rows"]))
        line["bodies"][body] = row
    # kappa against the analytic Dirichlet Laplacian: phase 3's operator,
    # whole trace, and phase 2b's 48^3 f64 (2,2,2) system, rolled ring
    _, info = cg(A, run["b"], x0=run["x0"], tol=TOL_MAIN, trace_iters=RING_FULL)
    est = telemetry.estimate_solve(info.record.alpha, info.record.beta, info["residuals"])
    lo, hi = telemetry.poisson_fdm_analytic_extremes((N_MAIN,) * 3)
    kap = {"192^3 f32": {"kappa": est["kappa"], "analytic": hi / lo, "ratio": est["kappa"] / (hi / lo),
                         "lam_min": est["lam_min"], "lam_max": est["lam_max"], "ritz_k": est["ritz_k"]}}
    _, im = cg(gmulti["Ah"], gmulti["bh"], tol=TOL_MULTI, trace_iters=RING_ROLLED)
    em = telemetry.estimate_solve(im.record.alpha, im.record.beta, im["residuals"], trace_start=im.record.trace_start)
    lo, hi = telemetry.poisson_fdm_analytic_extremes((N_GMG_MULTI,) * 3)
    kap["48^3 f64 (2,2,2), decoupled"] = {
        "kappa": em["kappa"], "analytic": hi / lo, "ratio": None if em["kappa"] is None else em["kappa"] / (hi / lo),
        "trace_start": im.record.trace_start, "iterations": im["iterations"], "ritz_k": em["ritz_k"]}
    line["kappa"] = kap
    emit(line)
    return line


def phase_serving(backend, run, gmulti, rng):
    """Phase 4l: the trace ring (`phase_ring`), the block ring, and
    `SolveService` at 192^3 f32 on phase 3's operator (see the module
    docstring)."""
    from partitionedarrays_jl_tpu_torch import telemetry
    from partitionedarrays_jl_tpu_torch.parallel import gpu_loop
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _krylov_fn_for
    from partitionedarrays_jl_tpu_torch.service import SolveService

    t_phase = time.perf_counter()
    arm_s = {}
    ring = phase_ring(backend, run, gmulti)
    arm_s["ring"] = time.perf_counter() - t_phase
    t = time.perf_counter()
    A = run["A"]
    dA = device_matrix(A, backend)
    maxiter = 4 * A.rows.ngids
    # request 0 is the main path's system (421 iterations: several chunks
    # of SERVE_CHUNK), the others b_k = A x̂_k (~73 iterations each)
    reqs = [(run["b"], run["x0"], run["xe"])] + serving_rhs(A, backend, rng, N_SERVE - 1)
    clean = [j for j in range(N_SERVE) if j != SERVE_POISON]
    arm_s["requests"] = time.perf_counter() - t
    # the solo solves (traced: the ring changes no bit) of the clean requests
    t = time.perf_counter()
    solo = {}
    for j in clean:
        b, x0, _ = reqs[j]
        x, info = cg(A, b, x0=x0, tol=TOL_MAIN, trace_iters=RING_FULL)
        solo[j] = (x, info)
    # ||b - A x0|| of each request, for the spectrum forecasts at submit
    # (the service's r0_norm: no host SpMV a submit)
    r0 = {j: float(solo[j][1]["residuals"][0]) for j in clean}
    arm_s["solo"] = time.perf_counter() - t
    t = time.perf_counter()
    # the block ring: K = 8 clean columns, traced, against the solo rings
    B = [reqs[j][0] for j in clean[:SERVE_KMAX]]
    X0 = [reqs[j][1] for j in clean[:SERVE_KMAX]]
    dia.reset_launches()
    xs, binfo = cg(A, B=B, X0=X0, tol=TOL_MAIN, trace_iters=RING_FULL)
    sync()
    brec = binfo.record
    block_ring = []
    for k, j in enumerate(clean[:SERVE_KMAX]):
        srec = solo[j][1].record
        n = len(srec.alpha)
        eq = (brec.trace_start == srec.trace_start == 0
              and [v is None for v in brec.alpha[k]] == [False] * n + [True] * (len(brec.alpha[k]) - n)
              and _ring_equal(brec.alpha[k][:n], srec.alpha) and _ring_equal(brec.beta[k][:n], srec.beta))
        block_ring.append(eq)
    require(all(block_ring), f"block ring K={SERVE_KMAX}: columns' alpha/beta differ from the solo rings: {block_ring}")
    arm_s["block_ring"] = time.perf_counter() - t

    # the service: a slab of 8 (request SERVE_POISON poisoned) and a ragged slab of 1
    telemetry.reset_state()
    observed = []
    model = telemetry.throughput_model()
    orig_observe = model.observe_slab

    def observe(fp, dt, K, s_per_it, iterations=1):
        observed.append({"K": int(K), "s_per_it": float(s_per_it), "iterations": int(iterations)})
        orig_observe(fp, dt, K, s_per_it, iterations)

    model.observe_slab = observe
    captures0 = gpu_loop.STATS["captures"]
    fns0 = set(dA._fn_cache)
    bad = reqs[SERVE_POISON][0].copy()
    vals = bad.values.part_values()[0]
    vals[int(np.asarray(bad.rows.partition.part_values()[0].oid_to_lid)[N_MAIN ** 2 + N_MAIN + 1])] = np.nan
    t = time.perf_counter()
    svc = SolveService(A, kmax=SERVE_KMAX, queue_depth=16)
    hs = []
    for j in range(N_SERVE):
        b = bad if j == SERVE_POISON else reqs[j][0]
        hs.append(svc.submit(b, x0=reqs[j][1], tol=TOL_MAIN, retries=0 if j == SERVE_POISON else None,
                             tag=f"req{j}"))
    slabs = []
    for K in (SERVE_KMAX, N_SERVE - SERVE_KMAX):
        dia.reset_launches()
        done = svc.step()
        sync()
        st = _krylov_fn_for(dA, "cg", TOL_MAIN, maxiter, rhs_batch=K).stats
        got = {k: dia.LAUNCHES[k] for k in ("dia_coded_spmm", "cg_sweep_block", "block_products", "dia_coded_spmv",
                                             "dia_coded_spmv_pfold", "cg_sweep")}
        dev_it = st["device_iterations"]
        want = {"dia_coded_spmm": 1 + dev_it, "cg_sweep_block": dev_it, "block_products": dev_it + 1}
        slabs.append({"K": K, "terminated": done, "device_iterations": dev_it, "kernels": got,
                      "expected": want, "loop": st["loop"]})
        for k in want:
            require(got[k] == want[k], f"service slab K={K}: {got[k]} {k} launches, expected {want[k]}")
    require(svc.step() == 0, "service: a third slab formed")
    drain_s = time.perf_counter() - t
    sync()
    hp = hs[SERVE_POISON]
    ejected = [e for e in hp.record.events if e.kind == "column_ejected"]
    stats = dict(svc.stats)
    require(hp.state == "failed" and type(hp.error).__name__ == "NonFiniteError" and len(ejected) == 1,
            f"service: the poisoned request ended {hp.state} ({hp.error!r}), {len(ejected)} column_ejected events")
    require(stats["ejected"] == 1 and stats["failed"] == 1 and stats["completed"] == N_SERVE - 1
            and stats["slabs"] == 2, f"service stats {stats}")
    bits, errs = [], []
    for j in clean:
        x, info = hs[j].result()
        bits.append(_gathered_equal(x, solo[j][0]) and info["iterations"] == solo[j][1]["iterations"])
        errs.append(_rel_err(x, reqs[j][2]))
    require(all(bits), f"service: completed requests differ from their solo solves: {bits}")
    # the same clean requests through the worker thread, submitted while it
    # runs; every slab must run on the worker (shutdown re-raises its error)
    svc2 = SolveService(A, kmax=SERVE_KMAX, queue_depth=16)
    ran_on = []
    run_slab = svc2._run_slab

    def on_thread(slab):
        ran_on.append((threading.current_thread().name, len(slab)))
        return run_slab(slab)

    svc2._run_slab = on_thread
    svc2.start()
    t = time.perf_counter()
    hw = [svc2.submit(reqs[j][0], x0=reqs[j][1], tol=TOL_MAIN, tag=f"w{j}", r0_norm=r0[j]) for j in clean]
    stats2 = svc2.shutdown(drain=True)
    worker_s = time.perf_counter() - t
    require(svc2._worker is not None and not svc2._worker.is_alive(), "service worker still alive after shutdown")
    require(ran_on and all(name == "pa-solve-service" for name, _ in ran_on),
            f"service worker: slabs ran on {ran_on}")
    wbits = [h.state == "done" and _gathered_equal(h.result()[0], solo[j][0]) for h, j in zip(hw, clean)]
    require(all(wbits) and stats2["completed"] == len(clean),
            f"service worker: {stats2}, bits {wbits}")
    # steady state: the 8 clean requests in one slab on the cached block
    # solve function (no capture; staging and the host lift included)
    t = time.perf_counter()
    svc4 = SolveService(A, kmax=SERVE_KMAX, queue_depth=16)
    for j in clean:
        svc4.submit(reqs[j][0], x0=reqs[j][1], tol=TOL_MAIN, tag=f"s{j}", r0_norm=r0[j])
    svc4.drain()
    arm_s["steady"] = time.perf_counter() - t
    require(svc4.stats["slabs"] == 1 and svc4.stats["completed"] == SERVE_KMAX, f"service steady slab: {svc4.stats}")
    # a chunked slab: deadlines on each request
    svc3 = SolveService(A, kmax=SERVE_CHUNK_K, chunk=SERVE_CHUNK)
    cj = clean[:SERVE_CHUNK_K]
    t = time.perf_counter()
    hc = [svc3.submit(reqs[j][0], x0=reqs[j][1], tol=TOL_MAIN, deadline=600.0, tag=f"c{j}", r0_norm=r0[j])
          for j in cj]
    svc3.drain()
    chunk_s = time.perf_counter() - t
    chunked = []
    for h, j in zip(hc, cj):
        x, info = h.result()
        target = TOL_MAIN * max(1.0, float(solo[j][1]["residuals"][0]))
        chunked.append({"iterations": h.iterations, "converged": bool(info["converged"]),
                        "final_residual": float(info["residuals"][-1]), "target": target,
                        "rel_err": _rel_err(x, reqs[j][2]), "solo_iterations": solo[j][1]["iterations"]})
        require(h.state == "done" and info["converged"] and float(info["residuals"][-1]) <= target,
                f"service chunked slab: request {j} {chunked[-1]}")
    model.observe_slab = orig_observe
    new_fns = [fn for key, fn in dA._fn_cache.items() if key not in fns0]
    reg = telemetry.registry()
    solo_s = [solo[j][1].record.wall_s / max(1, solo[j][1]["iterations"]) for j in clean]
    k8 = [o for o in observed if o["K"] == SERVE_KMAX]
    line = {
        "phase": "serving", "n": N_MAIN, "dtype": "float32", "tol": TOL_MAIN, "requests": N_SERVE, "kmax": SERVE_KMAX,
        "ring_s_per_iter": {body: [r["s_per_iter_untraced"], r["s_per_iter_traced"]]
                            for body, r in ring["bodies"].items()},
        "block_ring_equal": block_ring, "block_ring_kernels": {k: v for k, v in dia.LAUNCHES.items() if v},
        "stats": stats, "slabs": slabs, "drain_s": drain_s, "rel_err": errs,
        "poisoned": {"state": hp.state, "error": type(hp.error).__name__, "column_ejected": len(ejected)},
        "worker": {"stats": stats2, "s": worker_s, "slabs_on": ran_on},
        "chunked": {"requests": chunked, "s": chunk_s, "stats": dict(svc3.stats)},
        "arm_s": {**arm_s, "drain": drain_s, "worker": worker_s, "chunked": chunk_s},
        "captures": gpu_loop.STATS["captures"] - captures0,
        "capture_s": sum(fn.loop.capture_s or 0.0 for fn in new_fns if hasattr(fn, "loop")),
        "solve_fns_built": len(new_fns),
        "throughput_observations": observed,
        "per_rhs_s_per_iter_k8_model": telemetry.throughput_model().per_rhs(svc.fingerprint, "float32", SERVE_KMAX),
        "per_rhs_s_per_iter_k8_first": k8[0]["s_per_it"] / SERVE_KMAX if k8 else None,
        "per_rhs_s_per_iter_k8_steady": k8[-1]["s_per_it"] / SERVE_KMAX,
        "solo_s_per_iter_median": statistics.median(solo_s),
        "queue_wait_s_p50": reg.histogram("service.queue_wait_s").quantile(0.5),
        "solve_s_p50": reg.histogram("service.solve_s").quantile(0.5),
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(line)
    return line


# ---------------------------------------------------------------------------
# phase 4m: the front door
# ---------------------------------------------------------------------------

GATE_P192 = 8  # the 192^3 f32 tenant's requests: one slab of SERVE_KMAX (b_k = A x̂_k)
GATE_POISON = 3  # the one with a NaN in b (retries=0)
GATE_P48_KMAX = 4  # the 48^3 f64 (2,2,2) tenant's slab width
GATE_P48 = 4  # its interactive requests, deadlines GATE_DEADLINE_S + j (chunked slabs)
GATE_DEADLINE_S = 600.0
GATE_CAPTURE_K = 3  # the width both tenants capture at once (no earlier phase built it)
GATE_HTTP = 3  # requests over the HTTP surface
GATE_JOURNAL_CHUNK = 10  # chunk of the journaled tenant: its in-flight request checkpoints after one
GATE_LEASE_S = 0.2  # the fleet's lease: stale after 3 x, swept every 1 x


def _cuda_mem():
    """(allocated, reserved) bytes on the card."""
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def _p48_requests(Ah, k):
    """``k`` right-hand sides b_j = Ah x̂_j, x̂_j = sin((j + 2) gid) (the
    decoupled 48^3 f64 system converges from 0), with x̂_j: host PVectors."""
    out = []
    for j in range(k):
        xh = PVector(Ah.cols.partition._like([np.sin((j + 2.0) * np.asarray(i.lid_to_gid, dtype=np.float64))
                                             for i in Ah.cols.partition.part_values()]), Ah.cols)
        out.append((Ah @ xh, xh))
    return out


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and bool(np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def phase_frontdoor(backend, run, gmulti, rng):
    """Phase 4m: the front door on the card (see the module docstring).
    Returns the launches its paths counted."""
    import tempfile

    from partitionedarrays_jl_tpu_torch import frontdoor as fd
    from partitionedarrays_jl_tpu_torch import telemetry
    from partitionedarrays_jl_tpu_torch.parallel import gpu_loop
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _krylov_fn_for
    from partitionedarrays_jl_tpu_torch.service import AdmissionRejected, SolveService
    from partitionedarrays_jl_tpu_torch.utils.health import DeadlineInfeasible

    t_phase = time.perf_counter()
    arm_s = {}
    A, Ah = run["A"], gmulti["Ah"]
    maxiter = 4 * A.rows.ngids
    telemetry.reset_state()
    reg = telemetry.registry()
    line = {"phase": "frontdoor", "tenants": {"p192": {"n": N_MAIN, "dtype": "float32", "parts": [1, 1, 1],
                                                       "kmax": SERVE_KMAX},
                                              "p48": {"n": N_GMG_MULTI, "dtype": "float64", "parts": [2, 2, 2],
                                                      "kmax": GATE_P48_KMAX, "decoupled": True}}}
    launches = {k: 0 for k in ("dia_coded_spmv", "dia_coded_spmv_pfold", "dia_coded_spmm", "cg_sweep_block",
                               "block_products")}

    # the requests and their solo solves (deadline-free slabs are their solo solves bit for bit)
    t = time.perf_counter()
    reqs = serving_rhs(A, backend, rng, GATE_P192)
    clean = [j for j in range(GATE_P192) if j != GATE_POISON]
    solo = {j: cg(A, reqs[j][0], x0=reqs[j][1], tol=TOL_MAIN) for j in clean}
    # ||b - A x0|| of each request for the services' spectrum forecasts (once
    # the operator's spectrum is measured a submit without it pays a host
    # SpMV at 192^3); the poisoned request's is its clean twin's
    r0 = {j: float(solo[j if j in solo else clean[0]][1]["residuals"][0]) for j in range(GATE_P192)}
    q = _p48_requests(Ah, 8)
    qsolo = {j: cg(Ah, q[j][0], tol=TOL_MULTI) for j in (0, 1, 2, 6)}
    sync()
    arm_s["requests"] = time.perf_counter() - t

    # --- the paging gate: a budget that holds one tenant --------------------
    fp = {"p192": fd.operator_footprint_bytes(A, SERVE_KMAX), "p48": fd.operator_footprint_bytes(Ah, GATE_P48_KMAX)}
    budget = max(fp.values()) + 1
    require(sum(fp.values()) > budget, f"gate: a budget of {budget} B holds both tenants ({fp})")
    watermark = GATE_P192 + GATE_P48
    gate = fd.Gate(mem_budget_bytes=budget, shed_watermark=watermark)
    evictions, page_ins, slabs = [], [], []
    evict = gate.registry.evict

    def timed_evict(name):
        sync()
        m0 = _cuda_mem()
        t0 = time.perf_counter()
        out = evict(name)
        s = time.perf_counter() - t0
        m1 = _cuda_mem()
        evictions.append({"tenant": name, "s": s, "allocated_before": m0[0], "allocated_after": m1[0],
                          "reserved_before": m0[1], "reserved_after": m1[1]})
        return out

    def on_page_in(name, ten):
        rec = {"tenant": name, "after_eviction_allocated": _cuda_mem()[0]}
        page_ins.append(rec)
        run_slab = ten.svc._run_slab

        def counted(slab, _run=run_slab, _rec=rec, _name=name):
            c0, t0 = gpu_loop.STATS["captures"], time.perf_counter()
            dia.reset_launches()
            out = _run(slab)
            sync()
            s = time.perf_counter() - t0
            got = dict(dia.LAUNCHES)
            K = len(slab)
            row = {"tenant": _name, "K": K, "s": s, "captures": gpu_loop.STATS["captures"] - c0}
            if _name == "p192":
                st = _krylov_fn_for(device_matrix(A, backend), "cg", TOL_MAIN, maxiter, rhs_batch=K).stats
                dev_it = st["device_iterations"]
                want = {"dia_coded_spmm": 1 + dev_it, "cg_sweep_block": dev_it, "block_products": dev_it + 1}
                row.update(device_iterations=dev_it, kernels={k: got[k] for k in want}, expected=want)
                for k in want:
                    require(got[k] == want[k], f"gate p192 slab K={K}: {got[k]} {k} launches, expected {want[k]}")
                    launches[k] += got[k]
            slabs.append(row)
            if "first_slab_s" not in _rec:
                _rec.update(first_slab_s=s, captures=row["captures"], allocated=_cuda_mem()[0])
            return out

        ten.svc._run_slab = counted

    gate.registry.evict = timed_evict
    gate.registry.on_page_in = on_page_in
    observed = []
    model = telemetry.throughput_model()
    orig_observe = model.observe_slab

    def observe(fprint, dt, K, s_per_it, iterations=1):
        observed.append({"dtype": str(dt), "K": int(K), "s_per_it": float(s_per_it), "iterations": int(iterations)})
        orig_observe(fprint, dt, K, s_per_it, iterations)

    model.observe_slab = observe
    t = time.perf_counter()
    gate.register("p48", Ah, kmax=GATE_P48_KMAX)
    gate.register("p192", A, kmax=SERVE_KMAX)  # evicts p48
    adm0 = reg.counter("service.admitted").value
    gate.paused = True  # a deterministic backlog: shedding is a function of depth
    hq = [gate.submit("p48", q[j][0], tol=TOL_MULTI, deadline=GATE_DEADLINE_S + j, slo_class="interactive",
                      tag=f"q{j}") for j in range(GATE_P48)]
    bad = reqs[GATE_POISON][0].copy()
    vals = bad.values.part_values()[0]
    vals[int(np.asarray(bad.rows.partition.part_values()[0].oid_to_lid)[N_MAIN ** 2 + N_MAIN + 1])] = np.nan
    hr = [gate.submit("p192", bad if j == GATE_POISON else reqs[j][0], x0=reqs[j][1], tol=TOL_MAIN, r0_norm=r0[j],
                      retries=0 if j == GATE_POISON else None, slo_class="batch", tag=f"r{j}",
                      idempotency_key=f"r{j}") for j in range(GATE_P192)]
    replay = {}
    dup = gate.submit("p192", reqs[1][0], x0=reqs[1][1], tol=TOL_MAIN, slo_class="batch", idempotency_key="r1",
                      replay_out=replay)
    require(dup is hr[1] and replay == {"replayed": True}, "gate: a duplicate idempotency key admitted a new request")
    try:
        gate.submit("p192", reqs[0][0], x0=reqs[0][1], tol=TOL_MAIN, slo_class="besteffort", tag="burst")
        shed = None
    except fd.LoadShedded as e:
        shed = e
    require(shed is not None and not isinstance(shed, AdmissionRejected) and shed.retry_after_s > 0
            and shed.diagnostics["depth"] == watermark, f"gate: the burst past depth {watermark} was not shed "
            f"({shed!r})")
    gate.paused = False
    gate.drain()
    traffic_s = time.perf_counter() - t
    # EDF across tenants: the interactive tenant's deadline requests all
    # finish before the batch tenant's first (one K = 4 slab, so among
    # themselves they finish as they converge)
    fin_q = [h.request.finished_at for h in hq]
    fin_r = [h.request.finished_at for h in hr]
    require(max(fin_q) < min(fin_r), "gate: EDF order broken across tenants")
    hp = hr[GATE_POISON]
    require(hp.state == "failed" and type(hp.error).__name__ == "NonFiniteError",
            f"gate: the poisoned request ended {hp.state} ({hp.error!r})")
    bits = [hr[j].state == "done" and _gathered_equal(hr[j].result()[0], solo[j][0])
            and hr[j].result()[1]["iterations"] == solo[j][1]["iterations"] for j in clean]
    require(all(bits), f"gate: p192 requests differ from their solo solves: {bits}")
    qok = []
    for j, h in enumerate(hq):
        x, info = h.result()
        qok.append({"iterations": h.request.iterations, "converged": bool(info["converged"]),
                    "rel_err": _rel_err(x, q[j][1])})
        require(h.state == "done" and info["converged"], f"gate: interactive request q{j}: {qok[-1]}")
    require(reg.counter("service.admitted").value - adm0 == GATE_P192 + GATE_P48,
            "gate: the duplicate key or the shed request reached a service")
    require(len(evictions) == 3 and [e["tenant"] for e in evictions] == ["p48", "p192", "p48"],
            f"gate: evictions {[e['tenant'] for e in evictions]}")
    slo = {c: (reg.counter("gate.slo.hits", labels={"slo_class": c}).value,
               reg.counter("gate.slo.requests", labels={"slo_class": c}).value) for c in ("interactive", "batch")}
    require(slo["interactive"] == (GATE_P48, GATE_P48), f"gate: interactive attainment {slo}")
    # the steady K = 8 slab through the gate and through a bare service (the cached solve function)
    steady = [j for j in clean] + [clean[0]]
    n_obs = len(observed)
    t = time.perf_counter()
    hs = [gate.submit("p192", reqs[j][0], x0=reqs[j][1], tol=TOL_MAIN, r0_norm=r0[j], slo_class="batch", tag=f"s{k}")
          for k, j in enumerate(steady)]
    gate.drain()
    gate_steady_s = time.perf_counter() - t
    gate_obs = observed[n_obs:]
    require(all(h.state == "done" and _gathered_equal(h.result()[0], solo[j][0]) for h, j in zip(hs, steady)),
            "gate: the steady slab differs from the solo solves")
    svc = SolveService(A, kmax=SERVE_KMAX)
    for k, j in enumerate(steady):
        svc.submit(reqs[j][0], x0=reqs[j][1], tol=TOL_MAIN, r0_norm=r0[j], tag=f"bare{k}")
    n_obs = len(observed)
    svc.drain()
    bare_obs = observed[n_obs:]
    require(len(gate_obs) == 1 and gate_obs[0]["K"] == SERVE_KMAX and len(bare_obs) == 1
            and bare_obs[0]["K"] == SERVE_KMAX, f"gate steady: slabs {gate_obs}, bare {bare_obs}")
    model.observe_slab = orig_observe
    # spectrum admission: a traced solo fused CG measures the spectrum (K1
    # once, K2 each device iteration), then an infeasible deadline is refused
    dia.reset_launches()
    _, ti = cg(A, reqs[0][0], x0=reqs[0][1], tol=TOL_MAIN, trace_iters=RING_FULL)
    sync()
    got = dict(dia.LAUNCHES)
    dev_it = device_iterations(ti)
    want = {"dia_coded_spmv": 1, "dia_coded_spmv_pfold": dev_it}
    for k in want:
        require(got[k] == want[k], f"gate: the traced solve's {k} launched {got[k]}, expected {want[k]}")
        launches[k] += got[k]
    adm0, depth0 = reg.counter("service.admitted").value, gate.depth()
    dia.reset_launches()
    with telemetry.configure(spec_admit=True):
        try:
            gate.submit("p192", reqs[1][0], tol=TOL_MAIN, deadline=1e-6, slo_class="interactive", tag="infeasible")
            infeasible = None
        except DeadlineInfeasible as e:
            infeasible = e.diagnostics
    require(infeasible is not None and reg.counter("service.admitted").value == adm0 and gate.depth() == depth0
            and not any(dia.LAUNCHES.values()), f"gate: the infeasible deadline was not refused at the door "
            f"({infeasible})")
    gate.shutdown()
    line["paging"] = {
        "budget_bytes": budget, "footprint_bytes": fp, "evictions": evictions, "page_ins": page_ins, "slabs": slabs,
        "traffic_s": traffic_s, "shed": {"slo_class": shed.diagnostics["slo_class"], "depth": watermark,
                                        "retry_after_s": shed.retry_after_s},
        "duplicate_replayed": True, "poisoned": type(hp.error).__name__, "p192_solo_equal": bits,
        "interactive": qok, "slo": slo, "steady_s": gate_steady_s,
        "per_rhs_s_per_iter_k8_gate": gate_obs[0]["s_per_it"] / SERVE_KMAX,
        "per_rhs_s_per_iter_k8_bare": bare_obs[0]["s_per_it"] / SERVE_KMAX,
        "throughput_observations": observed,
        "infeasible": {k: infeasible.get(k) for k in ("predicted_s", "available_s", "predicted_iters")},
        "traced_solve": {"iterations": ti["iterations"], "device_iterations": dev_it, "kernels": want},
    }
    # measured resident bytes: what each tenant's first slab added over the
    # allocation left after the eviction that made room for it
    for rec in page_ins:
        if "allocated" in rec:
            rec["measured_resident_bytes"] = rec["allocated"] - rec["after_eviction_allocated"]
    arm_s["paging"] = time.perf_counter() - t_phase - arm_s["requests"]

    # --- two tenants capture at once: one card, two workers ------------------
    # both tenants resident (no budget), their requests dispatched before
    # the workers start, so each worker takes one slab of GATE_CAPTURE_K
    # and both try to capture its new solve function at once
    t = time.perf_counter()
    g2 = fd.Gate()
    g2.register("p192", A, kmax=GATE_CAPTURE_K)
    g2.register("p48", Ah, kmax=GATE_CAPTURE_K)
    spans = []
    for name in ("p192", "p48"):
        svc_ = g2.service(name)
        inner = svc_._run_slab

        def timed(slab, _inner=inner, _name=name):
            t0 = time.perf_counter()
            out = _inner(slab)
            spans.append((_name, t0, time.perf_counter(), len(slab), threading.current_thread().name))
            return out

        svc_._run_slab = timed
    c0 = gpu_loop.STATS["captures"]
    h192 = [g2.submit("p192", reqs[j][0], x0=reqs[j][1], tol=TOL_MAIN, r0_norm=r0[j], tag=f"c{j}")
            for j in clean[:GATE_CAPTURE_K]]
    h48 = [g2.submit("p48", q[j][0], tol=TOL_MULTI, tag=f"cq{j}") for j in range(GATE_CAPTURE_K)]
    g2.pump(dispatch_only=True)
    g2.pump(dispatch_only=True)
    for name in ("p192", "p48"):
        g2.service(name).start()
    g2.drain()
    g2.shutdown()
    captures = gpu_loop.STATS["captures"] - c0
    spans.sort(key=lambda s: s[1])
    overlap = any(a[2] > b[1] for a, b in zip(spans, spans[1:]))
    eq192 = [_gathered_equal(h.result()[0], solo[j][0]) for h, j in zip(h192, clean)]
    eq48 = [_gathered_equal(h.result()[0], qsolo[j][0]) for h, j in zip(h48, range(GATE_CAPTURE_K))]
    require(all(eq192) and all(eq48) and captures == 2 and not overlap and len(spans) == 2
            and all(s[3] == GATE_CAPTURE_K and s[4] == "pa-solve-service" for s in spans),
            f"gate: two tenants capturing at once: equal {eq192} {eq48}, captures {captures}, spans {spans}")
    line["concurrent_capture"] = {"K": GATE_CAPTURE_K, "captures": captures,
                                  "slabs": [{"tenant": s[0], "start_s": s[1] - t, "end_s": s[2] - t, "K": s[3]}
                                            for s in spans], "overlapped": overlap, "s": time.perf_counter() - t}
    arm_s["concurrent_capture"] = time.perf_counter() - t

    # --- the HTTP surface ----------------------------------------------------
    t = time.perf_counter()
    g3 = fd.Gate(start_workers=True)
    g3.register("p48", Ah, kmax=GATE_P48_KMAX)
    srv = fd.serve_gate(g3, port=0)
    try:
        inproc, http, walls = [], [], {"inproc": [], "http": []}
        for j in range(GATE_HTTP):
            t0 = time.perf_counter()
            h = g3.submit("p48", q[j][0], tol=TOL_MULTI, tag=f"in{j}")
            g3.drain()
            walls["inproc"].append(time.perf_counter() - t0)
            inproc.append(h.result())
        for j in range(GATE_HTTP):
            t0 = time.perf_counter()
            http.append(fd.http_solve(srv.url, "p48", gather_pvector(q[j][0]), tol=TOL_MULTI, tag=f"http{j}",
                                      poll_s=0.002))
            walls["http"].append(time.perf_counter() - t0)
    finally:
        srv.stop()
    http_eq = [o["state"] == "done" and _bits_equal(np.asarray(o["x"]), gather_pvector(x))
               and o["info"]["iterations"] == i["iterations"] for o, (x, i) in zip(http, inproc)]
    require(all(http_eq), f"gate: HTTP solves differ from in-process: {http_eq}")
    line["http"] = {"requests": GATE_HTTP, "equal": http_eq, "inproc_s": walls["inproc"], "http_s": walls["http"],
                    "overhead_ms_per_request": 1e3 * (sum(walls["http"]) - sum(walls["inproc"])) / GATE_HTTP,
                    "bytes_per_request_body": len(json.dumps([float(v) for v in gather_pvector(q[0][0])]))}
    arm_s["http"] = time.perf_counter() - t

    # --- the journal: a crash and a recovery -----------------------------------
    t = time.perf_counter()
    append_s = []
    orig_append = fd.RequestJournal.append

    def timed_append(self, kind, _sync=None, **payload):
        t0 = time.perf_counter()
        out = orig_append(self, kind, _sync=_sync, **payload)
        append_s.append(time.perf_counter() - t0)
        return out

    fd.RequestJournal.append = timed_append
    try:
        with tempfile.TemporaryDirectory() as tmp:
            jd = f"{tmp}/journal"
            with fd.configure(journal_fsync=True):
                j1 = fd.Gate(journal_dir=jd, checkpoint_dir=f"{tmp}/c1")
                j1.register("p48", Ah, kmax=GATE_P48_KMAX, chunk=GATE_JOURNAL_CHUNK)
                hc0 = j1.submit("p48", q[3][0], tol=TOL_MULTI, deadline=GATE_DEADLINE_S, tag="done")
                j1.drain()
                x_done = gather_pvector(hc0.result()[0])
                hc1 = j1.submit("p48", q[4][0], tol=TOL_MULTI, maxiter=4000, deadline=GATE_DEADLINE_S, tag="inflight")
                j1.pump(dispatch_only=True)
                sv = j1.service("p48")
                sv._stop = True  # one chunk, then the checkpoint path: the process dies here
                sv.step()
                it_done = hc1.request.iterations
                hc2 = j1.submit("p48", q[5][0], tol=TOL_MULTI, deadline=GATE_DEADLINE_S, tag="queued")
                kinds1 = [r["kind"] for r in fd.read_journal(jd)]
                # ---- the gate is dropped without shutdown ----
                j2 = fd.Gate(journal_dir=jd, checkpoint_dir=f"{tmp}/c2")
                j2.register("p48", Ah, kmax=GATE_P48_KMAX, chunk=GATE_JOURNAL_CHUNK)
                t0 = time.perf_counter()
                summary = j2.recover()
                recover_s = time.perf_counter() - t0
                xr, ir = j2.handle(hc0.rid).result()
                resumed = j2.handle(hc1.rid)
                resume_kw = {"maxiter": resumed.kwargs.get("maxiter"), "x0": resumed.kwargs.get("x0") is not None}
                j2.drain()
                out1, out2 = j2.handle(hc1.rid).result(), j2.handle(hc2.rid).result()
                j2.shutdown()
                completed = [r["rid"] for r in fd.read_journal(jd) if r["kind"] == "completed"]
    finally:
        fd.RequestJournal.append = orig_append
    require(summary["completed"] == 1 and summary["resumed"] == 1 and summary["requeued"] == 1
            and summary["failed"] == 0 and kinds1.count("chunk") >= 1, f"journal: recovery {summary}, {kinds1}")
    require(ir.get("recovered") and _bits_equal(xr, x_done), "journal: the recovered result is not the recorded one")
    require(resume_kw["x0"] and resume_kw["maxiter"] == 4000 - it_done,
            f"journal: the in-flight request did not resume from its checkpoint ({resume_kw}, {it_done} done)")
    require(out1[1]["converged"] and out2[1]["converged"], "journal: a recovered request did not converge")
    require(sorted(completed) == sorted({hc0.rid, hc1.rid, hc2.rid}), f"journal: completed records {completed}")
    line["journal"] = {"summary": summary, "recover_s": recover_s, "inflight_iterations_before": it_done,
                       "resumed_maxiter": resume_kw["maxiter"], "appends": len(append_s),
                       "append_ms_p50": 1e3 * statistics.median(append_s),
                       "append_ms_max": 1e3 * max(append_s),
                       "rel_err": [_rel_err(out1[0], q[4][1]), _rel_err(out2[0], q[5][1])],
                       "iterations": [out1[1]["iterations"], out2[1]["iterations"]]}
    arm_s["journal"] = time.perf_counter() - t

    # --- the fleet: two gates with leases, one dies ------------------------------
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        fleet = f"{tmp}/fleet"
        g0 = fd.Gate(journal_dir=f"{fleet}/g0", rid_namespace="g0")
        g1 = fd.Gate(journal_dir=f"{fleet}/g1", rid_namespace="g1")
        for g in (g0, g1):
            g.register("p48", Ah, kmax=GATE_P48_KMAX)
        m0 = fd.FleetMember(fleet, "g0", g0, lease_s=GATE_LEASE_S).start()
        m1 = fd.FleetMember(fleet, "g1", g1, lease_s=GATE_LEASE_S)
        adopt_s = []
        adopt = g1.adopt

        def timed_adopt(journal_dir, source="peer"):
            t0 = time.perf_counter()
            out = adopt(journal_dir, source=source)
            adopt_s.append(time.perf_counter() - t0)
            return out

        g1.adopt = timed_adopt
        m1.start()
        g0.paused = True
        lost = [g0.submit("p48", q[j][0], tol=TOL_MULTI, tag=f"f{j}", idempotency_key=f"f{j}") for j in (6, 0)]
        adm0 = reg.counter("service.admitted").value
        m0.stop()  # g0's heartbeat stops: its lease goes stale
        deadline = time.perf_counter() + 30 * GATE_LEASE_S
        while "g0" not in m1._missed and time.perf_counter() < deadline:
            time.sleep(GATE_LEASE_S / 4)
        m1.stop()
        require("g0" in m1._missed and len(adopt_s) == 1, "fleet: the survivor did not adopt the dead peer")
        g1.drain()
        served = [g1.handle(h.rid) for h in lost]
        fleet_eq = [s is not None and s.state == "done" and _gathered_equal(s.result()[0], qsolo[j][0])
                    for s, j in zip(served, (6, 0))]
        again = g1.adopt(f"{fleet}/g0")
        peer_adopted = [r["rid"] for r in fd.read_journal(f"{fleet}/g0") if r["kind"] == "adopted"]
        dup = reg.counter("service.admitted").value - adm0
        g1.shutdown()
    require(all(fleet_eq) and dup == len(lost) and sorted(peer_adopted) == sorted(h.rid for h in lost)
            and "skipped_dir" in again, f"fleet: served {fleet_eq}, admitted {dup}, markers {peer_adopted}, {again}")
    line["fleet"] = {"lease_s": GATE_LEASE_S, "adopted": len(lost), "lost": 0, "duplicated": dup - len(lost),
                     "adopt_s": adopt_s[0], "equal_to_solo": fleet_eq, "detect_and_adopt_s": time.perf_counter() - t}
    arm_s["fleet"] = time.perf_counter() - t
    sync()
    m = _cuda_mem()
    line.update(arm_s=arm_s, allocated_end=m[0], reserved_end=m[1], launches=launches,
                phase_s=time.perf_counter() - t_phase)
    emit(line)
    return line


#: phase 4n's comms cases on phase 2b's 48^3 f64 (2,2,2) system: (name, options of `gpu_cg` / `gpu_block_cg`,
#: the kernel each case's body launches once a device iteration)
OBS_CASES = (
    ("fused", {"fused": True}, "dia_coded_spmv_pfold"),
    ("standard", {"fused": False}, "dia_coded_spmv"),
    ("standard_nobox", {"fused": False, "box": False}, "dia_coded_spmv"),
    ("pipelined", {"pipelined": True}, "dia_coded_spmv_axpy"),
    ("sdc_abft", {"fused": False, "box": False, "sdc": {"abft": True}}, "dia_coded_spmv"),
    ("sstep2", {"sstep": 2}, "dia_coded_spmm"),
    ("block_k8_fused", {"fused": True, "rhs_batch": 8}, "dia_coded_spmm"),
)
TOL_OBS = 1e-9
OBS_TRIPS = (4, 28)  # the phase profile's fixed trips (equal residues modulo the loop's block of 8)


def _console(mod, argv):
    """A console's ``main(argv)`` in-process, its stdout captured: (rc, text)."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    return rc, out.getvalue()


def phase_observability(backend, run, gmulti):
    """Phase 4n: the comms accounting, the exchange cost matrix, the phase
    profile and the consoles on the card (see the module docstring). No new
    assembly: phase 3's 192^3 f32 operator and phase 2b's 48^3 f64 (2,2,2)
    system."""
    import tempfile

    from partitionedarrays_jl_tpu_torch import telemetry
    from partitionedarrays_jl_tpu_torch.telemetry import comms, commsmatrix
    from partitionedarrays_jl_tpu_torch.telemetry import profile as prof
    from partitionedarrays_jl_tpu_torch.tools import pamon, paprof, paspec, patrace

    t_phase = time.perf_counter()
    arm_s = {}
    Ah, bh = gmulti["Ah"], gmulti["bh"]
    x0h = PVector.full(0.0, Ah.cols, dtype=bh.dtype)
    line = {"phase": "observability", "tol": TOL_OBS, "cases": {}}
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        with telemetry.configure(metrics_dir=d):
            systems = [("fused_192", {"fused": True}, "dia_coded_spmv_pfold",
                        (run["A"], run["b"], run["x0"]), TOL_MAIN, 4 * run["A"].rows.ngids)]
            systems += [(name, opts, kern, (Ah, bh, x0h), TOL_OBS, 4 * Ah.rows.ngids) for name, opts, kern in OBS_CASES]
            for name, opts, kern, system, tol, maxiter in systems:
                dia.reset_launches()
                rec, info = comms.case_probe_solve(backend, {"name": name, "options": opts}, tol=tol,
                                                   maxiter=maxiter, system=system)
                dev_it = info["device_loop"]["device_iterations"]
                # both sides come off the record of the solve that ran
                mism = comms.reconcile(rec.comms_counted, rec.comms)
                per = rec.comms["per_iteration"]
                # a device iteration of the s-step loop is a trip of s iterations: s pair SpMMs
                want_launches = dev_it * (opts.get("sstep") or 1)
                line["cases"][name] = {
                    "cg_body": info["cg_body"], "iterations": rec.comms["iterations"], "device_iterations": dev_it,
                    "per_iteration": {k: per[k] for k in ("collective_permute", "all_gather")},
                    "observed": {k: rec.comms["observed"][k] for k in ("collective_permute", "all_gather")},
                    "mismatches": mism, "kernel": kern, "launches": dia.LAUNCHES[kern],
                }
                require(not mism, f"observability: {name}: the counted program disagrees with the model: {mism}")
                want_body = ("pipelined" if opts.get("pipelined") else f"sstep{opts['sstep']}" if opts.get("sstep")
                             else "fused" if opts.get("fused") else "standard")
                require(info["cg_body"] == want_body, f"observability: {name}: ran the {info['cg_body']} body")
                if name != "sdc_abft":  # a defended trip launches K1 once and audits stream through it
                    require(dia.LAUNCHES[kern] in (want_launches, want_launches + 1),
                            f"observability: {name}: {kern} launched {dia.LAUNCHES[kern]} times, "
                            f"{dev_it} device iterations")
        rc, text = _console(patrace, ["--last", "--dir", d])
        rc2, listing = _console(patrace, ["--list", "--dir", d])
        require(rc == rc2 == 0 and "comms (iterations=" in text and len(listing.splitlines()) == len(systems),
                f"observability: patrace over the phase's records: rc {rc}, {rc2}; {text[-400:]}")
        line["patrace_records"] = len(listing.splitlines())
    dia.reset_launches()
    arm_s["comms"] = time.perf_counter() - t
    t = time.perf_counter()
    line["matrix"] = {}
    for box in (True, False):
        m = commsmatrix.measure_comms_matrix(Ah, backend, box=box)
        require(not m["static_check"], f"observability: the {m['plan']} matrix: {m['static_check']}")
        require(all(v > 0 for v in m["round_s"]), f"observability: the {m['plan']} matrix: a round not timed")
        line["matrix"][m["plan"]] = {
            "rounds": m["rounds"], "edges": len(m["edges"]), "per_part_bytes": m["static"]["per_device_bytes"],
            "payload_bytes_a_round": sorted({e["payload_bytes"] for e in m["edges"]}),
            "round_us": [v * 1e6 for v in m["round_s"]], "rounds_summed_us": m["exchange_s"] * 1e6,
            "full_exchange_us": m["full_exchange_s"] * 1e6, "attribution": m["attribution"],
            "fabric": sorted(m["fabric_summary"]),
        }
    arm_s["matrix"] = time.perf_counter() - t
    t = time.perf_counter()
    line["profiles"] = []
    for tag, A, box in (("192^3 f32", run["A"], True), ("48^3 f64 (2,2,2) box", Ah, True),
                        ("48^3 f64 (2,2,2) generic", Ah, False)):
        for trace in (True, False):
            dia.reset_launches()
            with telemetry.configure(prof_trace=trace):
                p = prof.capture_phase_profile(A, backend, fused=True, box=box, k1=OBS_TRIPS[0], k2=OBS_TRIPS[1])
            bad = prof.reconcile_phases(p, dA=device_matrix(A, backend, box))
            line["profiles"].append({
                "cell": tag, "method": p["method"], "case": p["case"], "plan": p["lowering"]["plan"],
                "phases_us": {k: v["s_per_it"] * 1e6 for k, v in p["phases"].items()},
                "measured_us": p["measured_s_per_it"] * 1e6, "attributed_us": p["attributed_s_per_it"] * 1e6,
                "ratio": p["ratio_attributed_over_measured"], "band": p["band"], "attempts": p["attempts"],
                "halo_rounds": p["per_iteration_comms"]["collective_permute"]["ops"],
                "k1_launches": dia.LAUNCHES["dia_coded_spmv"], "k2_launches": dia.LAUNCHES["dia_coded_spmv_pfold"],
            })
            require(p["method"] == ("torch-trace" if trace else "split-timer"),
                    f"observability: {tag}: asked the {'trace' if trace else 'split-timer'}, got {p['method']}")
            require(p["in_band"] and not bad, f"observability: {tag} {p['method']}: ratio "
                    f"{p['ratio_attributed_over_measured']} of {p['band']}, {bad}")
            # the trace saw the fused body's K2; the split-timer's SpMV chain captured K1
            require(dia.LAUNCHES["dia_coded_spmv_pfold" if trace else "dia_coded_spmv"] > 0,
                    f"observability: {tag}: no K2 / K1 launch in the profile")
    dia.reset_launches()
    arm_s["profile"] = time.perf_counter() - t
    t = time.perf_counter()
    line["consoles"] = {}
    for name, mod, argv in (("paprof --profile", paprof, ["--profile", "--case", "fused", "--trace", "1"]),
                            ("pamon --check", pamon, ["--check"]), ("paspec --check", paspec, ["--check"])):
        t_c = time.perf_counter()
        rc, text = _console(mod, argv + ["--device", "cuda"])
        line["consoles"][name] = {"rc": rc, "s": time.perf_counter() - t_c, "tail": text.strip().splitlines()[-1]}
        require(rc == 0, f"observability: {name} exited {rc}: {text[-600:]}")
    arm_s["consoles"] = time.perf_counter() - t
    dia.reset_launches()
    line.update(arm_s=arm_s, phase_s=time.perf_counter() - t_phase)
    emit(line)
    return line


# ---------------------------------------------------------------------------
# phase 4o: the elastic tier (part loss, shrink, resume) and the drill consoles
# ---------------------------------------------------------------------------

#: the 192^3 f32 arm: the bench.py workload on (2,2,2) stacked parts; part 6
#: dies at the third chunk's host exchange (after the checkpoints at 100 and
#: 200 of the ~420 iterations) and the survivors form (1,2,2)
ELASTIC_PARTS = (2, 2, 2)
ELASTIC_DEAD = 6
ELASTIC_EVERY = 100
ELASTIC_FAULT = f"part_loss@part={ELASTIC_DEAD},after=2"
#: the 48^3 f64 arm (phase 2b's decoupled system) to TOL_RECOVERY: chunks of 40
ELASTIC_EVERY_MULTI = 40
#: the f32 arm's resumed x against the clean solve: no relative bound holds
#: in f32 at TOL_MAIN (two solutions of residual 1e-5 differ by up to the
#: condition number times it), so the resume's error against x̂ must stay
#: within this factor of the clean solve's, phase 3's gate
ELASTIC_ERR_FACTOR = 1.1
ELASTIC_CONSOLES = ("pagate", "padur", "pafleet", "paelastic")


class _CallLog:
    """Wraps ``module.name`` while open: every call's seconds, its part
    count (the first argument's partition, when it has one) and keyword
    ``context``; ``after`` runs after each call with its result."""

    def __init__(self, module, name, after=None):
        self.module, self.name, self.after, self.calls = module, name, after, []

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def logged(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            rows = getattr(args[0], "rows", None) if args else None
            self.calls.append({"s": time.perf_counter() - t, "context": kw.get("context"),
                               "parts": None if rows is None else int(rows.partition.num_parts)})
            if self.after is not None:
                self.after(out)
            return out

        setattr(self.module, self.name, logged)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False

    def seconds(self, **match):
        return sum(c["s"] for c in self.calls if all(c[k] == v for k, v in match.items()))


def _seeded_defects(gplan, bplan, ref):
    """One seeded defect of each check class on copies of a staged generic
    plan (and a flat box move written twice): the check each must trip
    -> whether it did. The staged plans themselves are left as they are."""
    import copy

    from partitionedarrays_jl_tpu_torch.analysis import plan_verifier as pv

    trash = gplan.layout.trash
    rcv = gplan.rcv_idx
    r, q = next((r, q) for r in range(gplan.R) for q in range(rcv.shape[1]) if int((rcv[r, q] != trash).sum()) >= 2)
    lanes = torch.nonzero(rcv[r, q] != trash).flatten().tolist()
    src = int(gplan.src_of[r, q])

    def mutated(**fields):
        bad = copy.copy(gplan)
        for k, v in fields.items():
            setattr(bad, k, v)
        return bad

    race = rcv.clone()
    race[r, q, lanes[1]] = race[r, q, lanes[0]]
    dropped_rcv, dropped_snd = rcv.clone(), gplan.snd_mask.clone()
    dropped_rcv[r, q, lanes[0]] = trash
    dropped_snd[r, src, lanes[0]] = False
    asym = gplan.snd_mask.clone()
    asym[r, src, lanes[0]] = False
    ref_dead = [m.copy() for m in ref]
    ref_dead[q][int(np.nonzero(ref_dead[q])[0][0])] = False
    selfsend = (tuple(gplan.perms[0]) + ((0, 0),),) + tuple(gplan.perms[1:])
    cases = {
        "ghost-race": (mutated(rcv_idx=race), ref),
        "coverage": (mutated(rcv_idx=dropped_rcv, snd_mask=dropped_snd), ref),
        "symmetry": (mutated(snd_mask=asym), ref),
        "dead-slot": (gplan, ref_dead),
        "rounds": (mutated(perms=selfsend), ref),
    }
    out = {k: k in {d.check for d in pv.verify_device_plan(p, referenced=m)} for k, (p, m) in cases.items()}
    bad = copy.copy(bplan)
    dst = bplan.dst.clone()
    dst[1] = dst[0]
    bad.dst = dst
    out["box ghost-race"] = "ghost-race" in {d.check for d in pv.verify_box_plan(bad, referenced=ref)}
    return out


def _survivor_kernels(A2, dA2, flush, rng, tag, errs):
    """K1, K2 and E1's boundary mode on the survivors' staging, each
    torch.equal to its plain version (the SpMV body with its generic
    exchange too); with a ``flush`` buffer their flushed ms, plain ms, the library
    call (torch.sparse.mm of the parts' block-diagonal A_oo, or A_oh on the
    ghost values) and the bound of the bytes each must move."""
    from partitionedarrays_jl_tpu_torch.ops import irregular as irr

    op, cl, rl = dA2.coded, dA2.col_layout, dA2.row_layout
    require(dA2.lowering == "coded" and op is not None and dA2.oh_nnz and dA2.ohb_bs is None,
            f"{tag}: the survivors staged {dA2.lowering} (boundary {'BSR' if dA2.ohb_bs else 'ELL'}), "
            "expected coded with E1's boundary mode")
    dt = op.cb.dtype
    item = torch.empty((), dtype=dt).element_size()
    x = _random_frame(dA2, rng)
    r, pprev = _random_frame(dA2, rng), _random_frame(dA2, rng)
    beta = torch.tensor(0.37, dtype=dt, device=x.device)
    y = torch.from_numpy(rng.standard_normal((rl.P, rl.W))).to(x.device, dt)
    errs[f"dia_coded_spmv[{tag}]"] = _compare(f"{tag} K1", dia.dia_coded_spmv(op, x, rl.W),
                                              dia.dia_coded_spmv_plain(op, x, rl.W))
    got, want = dia.dia_coded_spmv_pfold(op, r, pprev, beta, rl.W), dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta,
                                                                                                   rl.W)
    errs[f"dia_coded_spmv_pfold[{tag}]"] = max(_compare(f"{tag} K2 y", got[0], want[0]),
                                                _compare(f"{tag} K2 p", got[1], want[1]))

    def boundary(k):
        out = y.clone()
        k(dA2.oh_rows, dA2.oh_vals, dA2.oh_cols, x, out, rl.trash)
        return out

    errs[f"ell_spmv_boundary[{tag}]"] = _compare(f"{tag} E1 boundary", boundary(irr.ell_spmv_boundary),
                                                 boundary(irr.ell_spmv_boundary_plain))
    _hold_body(f"{tag} SpMV body (generic exchange)", dA2, x, errs, ["dia_coded_spmv", "ell_spmv_boundary"])
    if flush is None:
        return None
    rows = int(rl.noids.sum())
    nnz_oo = sum(m.nnz for m in A2.owned_owned_values.part_values())
    code = op.codes.shape[1]
    oo = _csr_on(_block_diagonal(list(A2.owned_owned_values.part_values())), x.device)
    xo = torch.from_numpy(rng.standard_normal((oo.shape[1], 1))).to(x.device, dt)
    oh = A2.owned_ghost_values.part_values()
    ohc = _csr_on(_block_diagonal(oh), x.device)
    xg = torch.from_numpy(rng.standard_normal((ohc.shape[1], 1))).to(x.device, dt)
    rate = F64_FLOPS_PER_S if item == 8 else F32_FLOPS_PER_S
    out = {}
    k1 = {"ms": time_ms(lambda: dia.dia_coded_spmv(op, x, rl.W), flush),
          "plain_ms": time_ms(lambda: dia.dia_coded_spmv_plain(op, x, rl.W), flush),
          "library_ms": time_ms(lambda: torch.sparse.mm(oo, xo), flush), "bytes": rows * (item + code + item)}
    k1["bound_ms"], k1["bound_by"] = _bound_ms(k1["bytes"], 2 * nnz_oo, rate)
    k2 = {"ms": time_ms(lambda: dia.dia_coded_spmv_pfold(op, r, pprev, beta, rl.W), flush),
          "plain_ms": time_ms(lambda: dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta, rl.W), flush),
          "library_ms": None, "bytes": rows * (4 * item + code)}
    k2["bound_ms"], k2["bound_by"] = _bound_ms(k2["bytes"], 2 * nnz_oo + 2 * rows, rate)
    staged = sum(t.numel() * t.element_size() for t in (dA2.oh_rows, dA2.oh_cols, dA2.oh_vals))
    touched = int((dA2.oh_rows != rl.trash).sum())
    nbytes, csr_bytes, nnz_oh = _boundary_bytes(oh, staged, touched, 1, item)
    yt = y.clone()  # accumulated into launch after launch: the time is the kernel's alone
    e1 = {"ms": time_ms(lambda: irr.ell_spmv_boundary(dA2.oh_rows, dA2.oh_vals, dA2.oh_cols, x, yt, rl.trash), flush),
          "plain_ms": time_ms(lambda: irr.ell_spmv_boundary_plain(dA2.oh_rows, dA2.oh_vals, dA2.oh_cols, x, yt,
                                                                  rl.trash), flush),
          "library_ms": time_ms(lambda: torch.sparse.mm(ohc, xg), flush), "bytes": nbytes, "csr_bytes": csr_bytes}
    e1["bound_ms"], e1["bound_by"] = _bound_ms(nbytes, 2 * nnz_oh, rate)
    for name, t in (("dia_coded_spmv", k1), ("dia_coded_spmv_pfold", k2), ("ell_spmv_boundary", e1)):
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        out[name] = t
    return out


def _elastic_ladder(tag, backend, A, b, x0, xe, tol, every, rng, flush=None):
    """The elastic ladder on one system of (2,2,2) stacked parts (see
    `phase_elastic_shrink`). Returns its line, the resume's launches and the
    kernels' errors (and with ``flush`` their times on the survivors)."""
    import importlib
    import tempfile

    from partitionedarrays_jl_tpu_torch import inject_faults, load_solver_state, solve_with_recovery, telemetry
    from partitionedarrays_jl_tpu_torch.analysis import plan_verifier as pv
    from partitionedarrays_jl_tpu_torch.parallel import elastic, repartition
    from partitionedarrays_jl_tpu_torch.parallel.gpu import DeviceExchangePlan

    gpu_mod = importlib.import_module("partitionedarrays_jl_tpu_torch.parallel.gpu")  # the module, not `parallel.gpu`
    from partitionedarrays_jl_tpu_torch.utils.health import PartLossError

    line, errs = {"cell": tag, "tol": tol, "every": every, "fault": ELASTIC_FAULT}, {}
    t = time.perf_counter()
    x_clean, info_clean = cg(A, b, x0=x0, tol=tol)
    sync()
    line["clean"] = {"iterations": info_clean["iterations"], "s": time.perf_counter() - t,
                     "err": _rel_err(x_clean, xe), "lowering": info_clean.get("lowering"),
                     "plan": info_clean.get("exchange_plan")}
    shrunk = {}

    def keep(out):  # the survivors' system; the resume's launches start now
        shrunk["A2"], shrunk["b2"] = out[0], out[1]
        dia.reset_launches()

    tmp = tempfile.mkdtemp(prefix="pa-elastic-")
    with _CallLog(repartition, "repartition_psparse") as rp, _CallLog(repartition, "repartition_pvector") as rv, \
            _CallLog(pv, "check_plan") as chk, _CallLog(gpu_mod, "device_matrix") as stg, \
            _CallLog(elastic, "shrink_system", after=keep), \
            elastic.configure(enabled=True), pv.configure(enabled=True), inject_faults(ELASTIC_FAULT, seed=1):
        t = time.perf_counter()
        x, info = solve_with_recovery(A, b, method="cg", x0=x0, checkpoint_dir=tmp, every=every, tol=tol)
        sync()
        wall = time.perf_counter() - t
    launches = dict(dia.LAUNCHES)
    rec = telemetry.last_record("solve_with_recovery")
    kinds = [(e.kind, e.label) for e in rec.events]
    A2, b2 = shrunk["A2"], shrunk["b2"]
    dA2 = device_matrix(A2, backend)
    el, dl = info["elastic"], info["device_loop"]
    dev_it = dl["device_iterations"]
    plan = dA2.col_plan
    line["shrink"] = {
        "elastic": el, "converged": info["converged"], "restarts": info["restarts"],
        "iterations": info["iterations"], "device_iterations": dev_it, "recovery": info["recovery"],
        "wall_s": wall, "events": sorted({k for k, _ in kinds}),
        "survivors": {"lowering": dA2.lowering, "dia_mode": dA2.dia_mode,
                      "decode": "row_class" if dA2.coded.cls_pattern is not None else "select_chain",
                      "plan": type(plan).__name__, "rounds": plan.R, "slots_a_round": plan.L,
                      "perms": [list(map(list, p)) for p in plan.perms], "ghosts": [int(n) for n in plan.layout.nhids],
                      "W": plan.layout.W, "rows": [int(n) for n in plan.layout.noids]},
        "seconds": {"host_repartition": rp.seconds() + rv.seconds(), "repartition_psparse": rp.seconds(),
                    "plan_verification": chk.seconds(), "staging": stg.seconds(parts=4),
                    "capture": dl.get("capture_s")},
        "plan_checks": {str(c["context"]): sum(1 for d in chk.calls if d["context"] == c["context"])
                        for c in chk.calls},
        "launches": {k: launches[k] for k in ("dia_coded_spmv", "dia_coded_spmv_pfold", "ell_spmv_boundary",
                                              "cg_sweep")},
    }
    require(el["from_parts"] == 8 and el["to_parts"] == 4 and el["dead_part"] == ELASTIC_DEAD
            and (el["checkpoint_iteration"] or 0) > 0, f"{tag}: elastic ledger {el}")
    require(info["converged"] and info["restarts"] == 0, f"{tag}: the resume did not converge cleanly: {line['shrink']}")
    require([s["from"] for s in info["recovery"]["restart_sources"]] == ["elastic_shrink_checkpoint"],
            f"{tag}: restart sources {info['recovery']['restart_sources']}")
    for want in (("fault_injected", "part_loss"), ("health_error", "PartLossError"), ("elastic_shrink", "part_loss"),
                 ("restart", "PartLossError")):
        require(want in kinds, f"{tag}: the trail lacks {want}: {kinds}")
    require(isinstance(plan, DeviceExchangePlan) and line["shrink"]["plan_checks"].get("device_exchange_plan", 0) >= 1
            and line["shrink"]["plan_checks"].get("elastic.shrink", 0) == 1,
            f"{tag}: the survivors' plan was not verified at its build: {line['shrink']['plan_checks']}")
    # the fused body: K1 once (the initial residual), K2 and the sweep once a
    # device iteration, E1's boundary mode with every SpMV of either
    require(launches["dia_coded_spmv_pfold"] == dev_it and launches["cg_sweep"] == dev_it
            and launches["dia_coded_spmv"] == 1 and launches["ell_spmv_boundary"] == dev_it + 1,
            f"{tag}: resume launches {line['shrink']['launches']}, {dev_it} device iterations")
    # the resumed x (on the survivors) against the clean solve, gathered
    g, gc, ge = gather_pvector(x), gather_pvector(x_clean), gather_pvector(xe)
    err, err_clean = float(np.linalg.norm(g - ge) / np.linalg.norm(ge)), line["clean"]["err"]
    line["shrink"]["err"] = err
    line["shrink"]["x_rel_vs_clean"] = float(np.linalg.norm(g - gc) / np.linalg.norm(gc))
    if np.dtype(b.dtype) == np.float64:
        require(line["shrink"]["x_rel_vs_clean"] <= RECOVERY_X_RTOL, f"{tag}: resumed x against clean {line['shrink']}")
    else:
        require(err <= ELASTIC_ERR_FACTOR * err_clean, f"{tag}: resumed error {err} against the clean {err_clean}")
    # bit for bit the cold solve on the survivors from the same x_k: a fresh
    # solve function (the default maxiter) on a fresh staging at 48^3, on
    # the resume's staging at 192^3 (a second host repartition there costs
    # its ~10 s again)
    with elastic.configure(enabled=True):
        if flush is None:
            A2, b2 = elastic.shrink_system(A, b, shape=tuple(el["shape"]))[:2]
        st = load_solver_state(tmp, {"x": A2.cols, "r": b2.rows, "p": A2.cols})
    require(int(st["meta"]["it"]) == el["checkpoint_iteration"], f"{tag}: the checkpoint moved: {st['meta']}")
    x_cold, info_cold = cg(A2, b2, x0=st["x"], tol=tol)
    line["cold"] = {"iterations": info_cold["iterations"], "fresh_staging": flush is None,
                    "equal": _gathered_equal(x, x_cold)}
    require(line["cold"]["equal"] and info_cold["iterations"] == info["iterations"],
            f"{tag}: the resume is not the cold solve from x_k: {line['cold']}")
    # grow back: the next full-capacity solve
    solve_with_recovery(A, b, method="cg", x0=x0, tol=tol)
    rec2 = telemetry.last_record("solve_with_recovery")
    line["grow_back"] = any(e.kind == "elastic_restore" and e.label == "grow_back" for e in rec2.events)
    require(line["grow_back"] and not elastic.degraded_state(), f"{tag}: no grow-back on the 8-part solve")
    # with the config off: typed, no restart
    with tempfile.TemporaryDirectory() as tmp2, inject_faults(ELASTIC_FAULT, seed=1):
        try:
            solve_with_recovery(A, b, method="cg", x0=x0, checkpoint_dir=tmp2, every=every, tol=tol)
            raised = None
        except PartLossError as e:
            raised = e.diagnostics
    rec3 = telemetry.last_record("solve_with_recovery")
    line["config_off"] = {"raised": raised, "restart_events": sum(1 for e in rec3.events if e.kind == "restart")}
    require(raised is not None and raised.get("part") == ELASTIC_DEAD and line["config_off"]["restart_events"] == 0,
            f"{tag}: with the config off: {line['config_off']}")
    # the resume's s/iteration against the 8-part solve's (fixed trips)
    dA8 = device_matrix(A, backend)
    s_it = {}
    for name, dM, bv, xv in (("parts_8", dA8, b, x0), ("survivors_4", dA2, b2, st["x"])):
        bb = _b_on_cols_layout(bv, dM)
        x0v = DeviceVector.from_pvector(xv, backend, dM.col_layout).data
        s_it[name], _ = fixed_trip_s_per_iter(lambda m: make_cg_fn(dM, 0.0, m), bb, x0v, *CG_TRIPS)
    line["s_per_iter"] = s_it
    line["kernels"] = _survivor_kernels(A2, dA2, flush, rng, f"{tag} survivors", errs)
    dia.reset_launches()
    return line, launches, errs


def _console_checks():
    """Each drill console's ``--check --device cuda`` in-process: (rc, s,
    the last line)."""
    import importlib

    out = {}
    for name in ELASTIC_CONSOLES:
        t = time.perf_counter()
        rc, text = _console(importlib.import_module(f"partitionedarrays_jl_tpu_torch.tools.{name}"),
                            ["--check", "--device", "cuda"])
        out[name] = {"rc": rc, "s": time.perf_counter() - t, "tail": text.strip().splitlines()[-1]}
        require(rc == 0, f"{name} --check --device cuda exited {rc}: {text[-800:]}")
    return out


def phase_elastic_shrink(backend, gmulti, rng):
    """Phase 4o: the elastic tier on the card (`parallel/elastic.py`,
    `parallel/repartition.py`, `analysis/plan_verifier.py`) and the front
    door's drill consoles. At 192^3 f32 on (2,2,2) stacked parts (the
    bench.py workload, assembled here): a clean solve, then
    `solve_with_recovery` in chunks of ELASTIC_EVERY under ELASTIC_FAULT
    with the elastic config and the plan verifier's build-site gate on: the
    shrink 8 -> 4 (part 6 excluded) from the last checkpoint, converged
    with no restart, its error within ELASTIC_ERR_FACTOR of the clean
    solve's, bit for bit a cold `cg` on the survivors from the same x_k,
    the survivors' generic plan verified at its build, K2 and the sweep
    once per device iteration of the resume, the trail of events, the
    grow-back event on the next 8-part solve, and with the config off a
    typed `PartLossError` and no restart; the survivors' lowering and
    plan, the seconds of the host repartition, the plan verification, the
    staging and the capture, the resume's s/iteration against the 8-part
    solve's, and K1, K2 and E1's boundary mode on the survivors torch.equal
    to plain and timed. The same ladder on phase 2b's 48^3 f64 (2,2,2)
    system (x within RECOVERY_X_RTOL of the clean solve, the cold solve on
    a fresh repartition), the static verification of that system's box and
    generic plans as staged, with one seeded defect of each check class
    caught, and `pagate`, `padur`, `pafleet` and `paelastic --check
    --device cuda` in-process. `tools/run_phase_4o.py` runs this phase
    alone, and the three drills after it."""
    from partitionedarrays_jl_tpu_torch.analysis import plan_verifier as pv

    t_phase = time.perf_counter()
    arm_s = {}
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=backend.device)
    t = time.perf_counter()

    def assemble(parts):
        return assemble_poisson(parts, (N_MAIN,) * 3, dtype=np.float32)

    A, b, xe, x0 = prun(assemble, backend, ELASTIC_PARTS)
    assembly_s = time.perf_counter() - t
    t = time.perf_counter()
    device_matrix(A, backend)
    sync()
    staging_8 = time.perf_counter() - t
    line, launches, errs = _elastic_ladder(f"{N_MAIN}^3 f32 (2,2,2)", backend, A, b, x0, xe, TOL_MAIN,
                                           ELASTIC_EVERY, rng, flush)
    line.update(assembly_s=assembly_s, staging_8_parts_s=staging_8)
    arm_s["192"] = time.perf_counter() - t_phase
    emit({**line, "phase": "elastic_shrink_arm"})
    del A, b, xe, x0
    t = time.perf_counter()
    Ah, bh, xh = gmulti["Ah"], gmulti["bh"], gmulti["xe"]
    x0h = PVector.full(0.0, Ah.cols, dtype=bh.dtype)
    multi, _, errs_m = _elastic_ladder(f"{N_GMG_MULTI}^3 f64 (2,2,2)", backend, Ah, bh, x0h, xh, TOL_RECOVERY,
                                       ELASTIC_EVERY_MULTI, rng)
    errs.update(errs_m)
    ref = pv.referenced_ghosts(Ah)
    plans = {"box": device_exchange_plan(Ah.cols, backend), "generic": device_exchange_plan(Ah.cols, backend, box=False)}
    multi["static"] = {k: [str(d) for d in pv.verify_plan(p, referenced=ref)] for k, p in plans.items()}
    multi["seeded"] = _seeded_defects(plans["generic"], plans["box"], ref)
    require(not any(multi["static"].values()), f"48^3 staged plans: {multi['static']}")
    require(all(multi["seeded"].values()), f"48^3 seeded defects not caught: {multi['seeded']}")
    arm_s["48"] = time.perf_counter() - t
    emit({**multi, "phase": "elastic_shrink_arm"})
    t = time.perf_counter()
    consoles = _console_checks()
    arm_s["consoles"] = time.perf_counter() - t
    emit({"phase": "elastic_shrink", "arms": [line["cell"], multi["cell"]], "consoles": consoles, "arm_s": arm_s,
          "phase_s": time.perf_counter() - t_phase})
    return {"line": line, "multi": multi, "consoles": consoles, "launches": launches, "errs": errs}



# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------


def time_ms(fn, flush):
    """Median over REPS launches of fn, each timed by CUDA events after an
    L2 flush outside the timed span. A spin queued after the flush keeps
    the card busy while the host queues the start event, fn's launches and
    the stop event, so the span holds no host launch latency."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    sync()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def _bound_ms(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _csr_need(M, item):
    """The bytes and the bound of the same product on M's own CSR, whatever
    implements it: values and int32 columns of the stored entries, int32
    row pointers, x read and y written once (a yardstick that does not
    depend on a staging's padding)."""
    rows, cols = M.shape
    nbytes = M.nnz * (item + 4) + (rows + 1) * 4 + (rows + cols) * item
    return {"csr_bytes": nbytes, "csr_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def _csr_on(M, dev):
    return torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr.astype(np.int64)), torch.from_numpy(M.indices.astype(np.int64)),
        torch.from_numpy(M.data), size=M.shape,
    ).to(dev)


def with_args(fn, *args):
    """A solve function ``fn(b, x0, *args)`` as one of (b, x0), keeping
    its stats (for the timers and the profile)."""

    def run(b, x0):
        return fn(b, x0, *args)

    run.stats = fn.stats
    return run


def fixed_trip_s_per_iter(make_fn, b, x0, m0, m1):
    """Seconds per iteration from two fixed-trip (tol=0) solves of m0 and
    m1 iterations, differenced (median of 3 each). Each function's first
    call runs before the timed span: the capture of a graph loop, and the
    kernels' first launches. A graph loop runs whole blocks of k: m
    iterations take k * (m // k + 1) on the device, the last block holding
    the stop and frozen iterations; m0 and m1 with equal residues mod k
    make the difference m1 - m0 device iterations."""
    per = {}
    for m in (m0, m1):
        fn = make_fn(m)
        fn(b, x0)
        ts = []
        for _ in range(3):
            sync()
            t = time.perf_counter()
            out = fn(b, x0)
            sync()
            ts.append(time.perf_counter() - t)
            require(np.all(np.asarray(out[3]) == m), f"fixed-trip solve stopped after {out[3]} of {m} iterations")
        per[m] = statistics.median(ts)
    return (per[m1] - per[m0]) / (m1 - m0), per


def phase_times(backend, k, run, n):
    dev = backend.device
    dA, op = k["dA"], k["dA"].coded
    wy = dA.row_layout.W
    rows = int(dA.row_layout.noids.sum())
    nnz = dA.flops_per_spmv // 2
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    M = k["A"].values.part_values()[0]
    csr = _csr_on(M, dev)
    xcol = k["x"][0, : M.shape[1]].reshape(-1, 1).contiguous()
    x, r, pprev, beta = k["x"], k["r"], k["pprev"], k["beta"]
    xacc, alpha = k["xacc"].clone(), k["alpha"]
    code_bytes = op.codes.shape[1]
    library_ms = time_ms(lambda: torch.sparse.mm(csr, xcol), flush)
    spmv = {
        "ms": time_ms(lambda: dia.dia_coded_spmv(op, x, wy), flush),
        "plain_ms": time_ms(lambda: dia.dia_coded_spmv_plain(op, x, wy), flush),
        "library_ms": library_ms,
    }
    spmv["bound_ms"], spmv["bound_by"] = _bound_ms(rows * (4 + code_bytes + 4), 2 * nnz)
    pfold = {
        "ms": time_ms(lambda: dia.dia_coded_spmv_pfold(op, r, pprev, beta, wy), flush),
        "plain_ms": time_ms(lambda: dia.dia_coded_spmv_pfold_plain(op, r, pprev, beta, wy), flush),
        "library_ms": None,  # no single PyTorch call folds p and multiplies
    }
    pfold["bound_ms"], pfold["bound_by"] = _bound_ms(rows * (4 + 4 + code_bytes + 4 + 4), 2 * nnz + 2 * rows)
    axpy = {
        "ms": time_ms(lambda: dia.dia_coded_spmv_axpy(op, x, xacc, pprev, alpha, wy), flush),
        "plain_ms": time_ms(lambda: dia.dia_coded_spmv_axpy_plain(op, x, xacc, pprev, alpha, wy), flush),
        "library_ms": None,  # no single PyTorch call multiplies and updates x
    }
    # x, the code bytes, y, pprev, xacc read and written
    axpy["bound_ms"], axpy["bound_by"] = _bound_ms(rows * (4 + code_bytes + 4 + 4 + 8), 2 * nnz + 2 * rows)
    sweep = sweep_times(dA, x, r, pprev, k["xacc"], alpha, flush)

    # CG seconds per iteration from fixed-trip solves, each body in the
    # graph loop and in the eager loop
    A = run["A"]
    dA_main = device_matrix(A, backend)
    b = _b_on_cols_layout(run["b"], dA_main)
    x0 = DeviceVector.from_pvector(run["x0"], backend, dA_main.col_layout).data
    s_per_iter, fixed = {}, {}
    for body, kw in (("cg", {}), ("pipelined_cg", {"pipelined": True}), ("standard_cg", {"fused": False})):
        for loop, graph in (("", True), ("_eager", False)):
            s_per_iter[body + loop], fixed[body + loop] = fixed_trip_s_per_iter(
                lambda m: make_cg_fn(dA_main, 0.0, m, graph=graph, **kw), b, x0, 20, 220)
    for t in (spmv, pfold, axpy):
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
    emit({
        "phase": "times", "n": n, "dtype": "float32", "reps": REPS,
        "dia_coded_spmv": spmv, "dia_coded_spmv_pfold": pfold, "dia_coded_spmv_axpy": axpy, "cg_sweep": sweep,
        "library_spmv_ms_for_pfold_and_axpy": library_ms,
        "cg_s_per_iter": s_per_iter["cg"], "cg_fixed_trip_s": fixed["cg"],
        "pipelined_cg_s_per_iter": s_per_iter["pipelined_cg"], "pipelined_cg_fixed_trip_s": fixed["pipelined_cg"],
        "s_per_iter": s_per_iter, "fixed_trip_s": fixed,
    })
    phase_profile("cg_profile", make_cg_fn(dA_main, 0.0, 48), b, x0, 48)
    phase_profile("cg_profile_eager", make_cg_fn(dA_main, 0.0, 48, graph=False), b, x0, 48)
    return {"dia_coded_spmv": spmv, "dia_coded_spmv_pfold": pfold, "dia_coded_spmv_axpy": axpy,
            "cg_sweep": sweep}


def sweep_times(dA, x, r, p, q, alpha, flush):
    """The CG update sweep at the main path's shapes (mode 0, the flag set,
    on copies of the frames): the kernel's flushed ms, its plain
    version's, the eager ops it replaces in the loop (the x and r updates
    and the part-order r.r, as the loop ran them before), and the bound:
    x, p, r, q read and x, r written, bytes over 3.35 TB/s. No single
    PyTorch call computes it."""
    from partitionedarrays_jl_tpu_torch.ops import sweep as sw
    from partitionedarrays_jl_tpu_torch.parallel.gpu import _pdot_factory

    o0, n = dA.row_layout.o0, dA.row_layout.no_max
    sl = slice(o0, o0 + n)
    x, r = x.clone(), r.clone()
    live = torch.ones((), dtype=torch.int32, device=x.device)
    part = sw.sweep_partials(r, n)
    pdot = _pdot_factory(o0, n)

    def eager():
        x[:, sl] = x[:, sl] + alpha * p[:, sl]
        r[:, sl] = r[:, sl] + (-alpha) * q[:, sl]
        return pdot(r, r)

    rows = int(dA.row_layout.noids.sum())
    item = x.element_size()
    out = {
        "ms": time_ms(lambda: sw.cg_sweep(r, q, alpha, live, part, o0, n, x=x, p=p), flush),
        "plain_ms": time_ms(lambda: sw.cg_sweep_plain(r, q, alpha, live, part, o0, n, x=x, p=p), flush),
        "eager_ops_ms": time_ms(eager, flush), "library_ms": None, "rows": rows,
    }
    out["bound_ms"], out["bound_by"] = _bound_ms(rows * 6 * item, 3 * 2 * rows)
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


def operator_info(op):
    """A coded operator's shape: rows, diagonals, coded diagonals, code
    bytes a row, its codebook sizes, its decode and (select chain) the
    band-sum instance the launcher picks for it."""
    pick = getattr(dia, "select_chain_instance", None)  # absent before the specialised sums
    return {
        "rows": int(op.no.sum()), "parts": int(op.cb.shape[0]), "diagonals": len(op.offsets),
        "coded_diagonals": sum(1 for k in op.kk if k > 1), "code_bytes_per_row": int(op.codes.shape[1]),
        "kk_set": sorted(set(op.kk)), "decode": "select_chain" if op.cls_pattern is None else "row_class",
        "instance": pick(op) if pick else None,
    }


def _coded_csr(op, wx):
    """The CSR (one part) of a coded operator's nonzero entries, built on
    the card from its codebook and codes: row i, column o0 + i + off_d of
    the operand frame, rows in order and each in ascending offset."""
    require(op.cb.shape[0] == 1, "the library CSR is built for one part")
    dev, no = op.cb.device, int(op.no[0])
    i = torch.arange(no, device=dev)
    vals = []
    for d in range(len(op.offsets)):
        if op.kk[d] == 1:
            vals.append(op.cb[0, d, 0].expand(no))
        else:
            ci = op.code_row[d]
            c = (op.codes[0, ci // 2, :no].to(torch.int64) >> (4 * (ci % 2))) & 15
            vals.append(op.cb[0, d][torch.where(c < op.kk[d], c, 0)])
    V = torch.stack(vals, 1)
    C = i[:, None] + torch.tensor(op.offsets, device=dev)[None, :]
    keep = (C >= 0) & (C < no) & (V != 0)
    crow = torch.zeros(no + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    csr = torch.sparse_csr_tensor(crow, (C + op.o0)[keep], V[keep], size=(no, wx))
    del V, C, keep
    return csr


def _coded_csr_parts(op, wx):
    """`_coded_csr` of each part of a stacked coded operator, block-diagonal:
    part p's rows after those of the parts before it, its columns at p * wx
    (the stacked (P * wx, K) operand)."""
    if op.cb.shape[0] == 1:
        return _coded_csr(op, wx)
    crows, cols, vals, at = [], [], [], 0
    for p in range(op.cb.shape[0]):
        one = dia.CodedOperator(op.cb[p : p + 1], op.no[p : p + 1], op.codes[p : p + 1], op.offsets, op.kk,
                                op.code_row, op.cls_pattern, op.o0)
        c = _coded_csr(one, wx)
        crows.append(c.crow_indices()[(1 if p else 0):] + at)
        cols.append(c.col_indices() + p * wx)
        vals.append(c.values())
        at += int(c._nnz())
    rows = int(op.no.sum())
    return torch.sparse_csr_tensor(torch.cat(crows), torch.cat(cols), torch.cat(vals),
                                   size=(rows, op.cb.shape[0] * wx))


def null_launch_us(flush, op=None, x=None, width=None):
    """The launch floor on the kernels' timer: the flushed µs of an empty
    kernel (one warp, no parameters), or with op that of an empty kernel
    launched as K1 launches op (its grid, threads, shared memory and
    parameters). None where the checkout has no empty kernel."""
    null = getattr(dia, "dia_null_launch", None)
    return None if null is None else time_ms(lambda: null(op, x, width), flush) * 1e3


def coded_operator_times(dh, iterations, flush, rng):
    """One line per coded operator of a device hierarchy: its shape, its
    launches per GMG-PCG solve of `iterations` device iterations (the fine
    A 1 + 3 per iteration, every S 2), K1 flushed, warm-L2 and back-to-back µs (back
    to back, a launch shorter than its host cost reads the host), the plain
    version's and torch.sparse.mm's µs, the empty kernel launched as K1 is,
    and the bound: rows x (2 x itemsize + code bytes) over 3.35 TB/s."""
    out = []
    for name, dM in gmg_coded_operators(dh):
        op, wx, wy = dM.coded, dM.col_layout.W, dM.row_layout.W
        x = _random_frame(dM, rng)
        info = operator_info(op)
        k1 = lambda: dia.dia_coded_spmv(op, x, wy)  # noqa: E731
        flushed = time_ms(k1, flush)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            k1()
        b.record()
        sync()
        line = {
            "phase": "gmg_coded_operator", "name": name, **info,
            "launches_per_solve": None if iterations is None else (1 + 3 * iterations if name == "A0" else 2 * iterations),
            "us": flushed * 1e3, "loop_us": a.elapsed_time(b) * 1e3 / 20,
            # the same timer with the L2 left warm (a one-byte "flush")
            "warm_us": time_ms(k1, flush[:1]) * 1e3,
            "plain_us": time_ms(lambda: dia.dia_coded_spmv_plain(op, x, wy), flush) * 1e3,
        }
        if info["parts"] == 1:
            csr = _coded_csr(op, wx)
            xcol = x[0].reshape(-1, 1).contiguous()
            line["library_us"] = time_ms(lambda: torch.sparse.mm(csr, xcol), flush) * 1e3
            line["csr_nnz"] = int(csr.values().numel())
            del csr
        line["null_as_launched_us"] = null_launch_us(flush, op, x, wy)
        itemsize = op.cb.element_size()
        line["bound_us"] = info["rows"] * (2 * itemsize + info["code_bytes_per_row"]) / HBM_BYTES_PER_S * 1e6
        line["share_of_bound"] = line["bound_us"] / line["us"]
        emit(line)
        out.append(line)
    return out


def _ext_boxes(op, x):
    """The parts' zero-padded extended boxes (P, 1, fb + 2) of a 3-D level
    whose parts share one box: the owned boxes and the ghost segments
    embedded as the plain version embeds them."""
    from partitionedarrays_jl_tpu_torch.ops import stencil as stn

    fb, P = op.groups[0].fb, x.shape[0]
    ext = x.new_zeros((P, 1) + tuple(f + 2 for f in fb))
    ext[(slice(None), 0) + tuple(slice(1, 1 + f) for f in fb)] = x[:, op.o0 : op.o0 + int(np.prod(fb))].reshape(
        (P,) + fb)
    for e, off in op.dirs:
        shape = tuple(1 if c != 0 else f for c, f in zip(e, fb))
        seg = x[:, op.g0 + off : op.g0 + off + int(np.prod(shape))].reshape((P,) + shape)
        if op.mask is not None:
            seg = seg * op.mask[:, stn.dir_index(e)].reshape((P,) + (1,) * len(fb))
        sl = tuple(slice(0, 1) if c == -1 else slice(1 + f, 2 + f) if c == 1 else slice(1, 1 + f)
                   for c, f in zip(e, fb))
        ext[(slice(None), 0) + sl] = seg
    return ext


def _stencil_launch(op, dtype):
    """The form, grid, threads, planes a CTA and rows a CTA of an operand's
    launch, and that form's registers, shared memory, local memory and CTAs
    an SM (the CUDA runtime's attributes); {} for a checkout without them."""
    from partitionedarrays_jl_tpu_torch.ops import stencil as stn

    if not hasattr(stn, "kernel_attributes"):
        return {}
    plan = op.launch[dtype][2]
    return {"form": plan.form, "launch_grid": list(plan.grid), "threads": plan.threads, "planes_per_cta": plan.tz,
            "rows_per_cta": plan.rows, **stn.kernel_attributes(dtype, plan)}


def stencil_level_times(dh, iterations, flush, rng, tag="192^3 f32"):
    """One line per stencil level of a device hierarchy: the box stencil
    kernel's form and launch, its flushed and back-to-back µs, the other
    form's flushed µs, its plain version's, conv3d of the parts' extended
    boxes with the fixed 3x3x3 weight (cuDNN with TF32 off, so it computes
    the same function in f32; the boxes built before the timing), launches
    per solve, and the bound: the owned boxes and ghost segments read and
    the result written, bytes over 3.35 TB/s, 2 x 3^d - 2 operations a
    point over 67 TFLOP/s. Returns the lines."""
    from partitionedarrays_jl_tpu_torch.ops import stencil as stn

    out = []
    for li, lv in enumerate(dh["levels"]):
        if gpu_gmg.route(lv) != "stencil":
            continue
        op = lv["stencil"]
        P = op.table.shape[0]
        dt = lv["dinv"].dtype
        x = torch.from_numpy(rng.standard_normal((P, op.W))).to(op.table.device, dt)
        exchange_(lv["dA"].col_plan, x)
        k = lambda: stn.box_stencil_apply(op, x)  # noqa: E731
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            k()
        b.record()
        sync()
        rows = int(op.table[:, 3].sum())
        item = x.element_size()
        nh = dh["levels"][li]["dA"].col_layout.box_info.nh_total
        line = {
            "phase": "box_stencil_level", "hierarchy": tag, "level": li,
            "grid": [int(v) for v in op.table[0, :3]], "parts": P,
            "rows": rows, "dtype": str(dt), "launches_per_solve": None if iterations is None else 2 * iterations,
            **_stencil_launch(op, dt),
            "us": time_ms(k, flush) * 1e3, "loop_us": a.elapsed_time(b) * 1e3 / 20,
            "plain_us": time_ms(lambda: stn.box_stencil_apply_plain(op, x), flush) * 1e3,
        }
        other = _other_form(op, dt)
        if other is not None:
            line["other_form"] = _stencil_launch(other, dt)
            line["other_form"]["us"] = time_ms(lambda: stn.box_stencil_apply(other, x), flush) * 1e3
        bound_ms, line["bound_by"] = _bound_ms(item * (rows + P * nh + P * op.n), (2 * 3 ** op.dim - 2) * rows)
        line["bound_us"] = bound_ms * 1e3
        line["share_of_bound"] = line["bound_us"] / line["us"]
        if len(op.groups) == 1 and op.dim == 3:
            ext = _ext_boxes(op, x)
            w = torch.tensor([0.5 ** sum(1 for c in d if c != 1) for d in np.ndindex(3, 3, 3)], dtype=dt,
                             device=x.device).view(1, 1, 3, 3, 3)
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                line["library_us"] = time_ms(lambda: torch.nn.functional.conv3d(ext, w), flush) * 1e3
                conv = torch.nn.functional.conv3d(ext, w).reshape(P, -1)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            line["library_max_abs_diff"] = float((conv - k()[:, : conv.shape[1]]).abs().max())
            del ext, conv
        emit(line)
        out.append(line)
    return out


def stream_level_times(h, dh, iterations, flush, rng, tag="192^3 f32"):
    """One ``dia_stream_level`` line per streaming level of a device
    hierarchy: the form its shape takes and its launch (vector loads, the
    unrolled sum), the flushed µs of each form (``form_us``) and of the one
    the level takes (``us``), its back-to-back µs, its plain version's,
    torch.sparse.mm's on the level's CSR (one part only), launches per
    solve, and the bound: the dense values (every diagonal, every row), x
    and y, bytes over 3.35 TB/s. Returns the lines."""
    out = []
    for li, lv in enumerate(dh["levels"]):
        dA = lv["dA"]
        if dA.dia_mode != "stream":
            continue
        x = torch.from_numpy(rng.standard_normal((dA.col_layout.P, dA.col_layout.W))).to(
            dA.stream_vals.device, dA.stream_vals.dtype)
        args = _stream_args(dA, x)
        P, D, n = dA.stream_vals.shape
        item = x.element_size()
        rows = int(dA.row_layout.noids.sum())
        form, vec, nd = dia.stream_launch(dA.stream_vals, dA.stream_form)
        k = lambda: dia.dia_stream_spmv(*args, form=form)  # noqa: E731
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            k()
        b.record()
        sync()
        line = {
            "phase": "dia_stream_level", "hierarchy": tag, "level": li, "parts": P, "rows": rows, "diagonals": D,
            "dtype": str(x.dtype), "form": form, "vector_loads": vec, "unrolled_diagonals": nd,
            "launches_per_solve": None if iterations is None else 2 * iterations,
            "form_us": {f: time_ms(lambda: dia.dia_stream_spmv(*args, form=f), flush) * 1e3 for f in dia.STREAM_FORMS},
            "loop_us": a.elapsed_time(b) * 1e3 / 20,
            "plain_us": time_ms(lambda: dia.dia_stream_spmv_plain(*args), flush) * 1e3,
            "library_us": None,
        }
        line["us"] = line["form_us"][form]
        if P == 1:
            M = h.levels[li].A.values.part_values()[0]
            csr = _csr_on(M, x.device)
            xcol = x[0, : M.shape[1]].reshape(-1, 1).contiguous()
            line["library_us"] = time_ms(lambda: torch.sparse.mm(csr, xcol), flush) * 1e3
            line["csr_nnz"] = int(M.nnz)
        else:
            # stacked parts: the block-diagonal CSR of every part's A_oo over
            # the stacked frame, as one launch of the kernel computes them
            csr = _stream_csr(dA.stream_vals, dA.dia_offsets, dA.stream_no, dA.row_layout.o0, x.shape[1])
            xcol = x.reshape(-1, 1)
            line["library_us"] = time_ms(lambda: torch.sparse.mm(csr, xcol), flush) * 1e3
            line["csr_nnz"] = int(csr._nnz())
        del csr
        bound_ms, line["bound_by"] = _bound_ms(rows * (item * D + 2 * item), 2 * D * rows)
        line["bound_us"] = bound_ms * 1e3
        line["share_of_bound"] = line["bound_us"] / line["us"]
        emit(line)
        out.append(line)
    return out


def epilogue_level_times(h, dh, iterations, flush, rng, tag="192^3 f32"):
    """One ``vcycle_epilogue_level`` line per level of a device hierarchy
    and mode, on the frames `make_vcycle` gives it (`_epilogue_calls`): the
    kernel's flushed µs, its plain version's, launches per solve (one of
    each mode a level per device iteration), and the bound: init reads dinv
    and b over the band and writes the output frame, residual reads b and
    y and writes it, smooth reads x, dinv, b and y and writes x, bytes
    over 3.35 TB/s (2, 1 and 4 operations an element). Returns the lines."""
    from partitionedarrays_jl_tpu_torch.ops import epilogue as ep

    out = []
    for li in range(len(dh["levels"])):
        for mode, kw in _epilogue_calls(dh, li, h.omega, rng).items():
            b = kw["b"]
            P, item, band = b.shape[0], b.element_size(), b.shape[0] * kw["n"]
            frame = P * kw.get("width", b.shape[1])
            nbytes, ops = {"init": (item * (2 * band + frame), 2 * band),
                           "residual": (item * (2 * band + frame), band),
                           "smooth": (item * 5 * band, 4 * band)}[mode]
            line = {
                "phase": "vcycle_epilogue_level", "hierarchy": tag, "level": li, "mode": mode,
                "route": gpu_gmg.route(dh["levels"][li]), "parts": P, "band": kw["n"], "dtype": str(b.dtype),
                "launches_per_solve": None if iterations is None else iterations,
                "us": time_ms(lambda: ep.vcycle_epilogue(**kw), flush) * 1e3,
                "plain_us": time_ms(lambda: ep.vcycle_epilogue_plain(**kw), flush) * 1e3,
                "library_us": None,  # no single PyTorch call computes it
            }
            bound_ms, line["bound_by"] = _bound_ms(nbytes, ops)
            line["bound_us"] = bound_ms * 1e3
            line["share_of_bound"] = line["bound_us"] / line["us"]
            emit(line)
            out.append(line)
    return out


def phase_gmg_times(backend, g, gs, multi):
    """A `dia_stream_level` line (both forms) for each stream level and a
    `vcycle_epilogue_level` line for each level and mode of both GMG
    hierarchies (``multi``: the stacked f64 one's hierarchy, device
    hierarchy and iterations); GMG-PCG seconds per iteration, solve seconds
    and a profile of one iteration on both routes (stencil, structured);
    the empty kernel's µs; one line per coded operator of the structured
    route and per stencil level of both hierarchies. Returns the stream
    kernel's (192^3 level 1), the stencil kernel's (192^3 level 0) and the
    epilogue's (192^3 level 0, smooth) numbers."""
    dev = backend.device
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    h = g["run"]["h"]
    streams = stream_level_times(h, g["dh"], g["device_iterations"], flush, np.random.default_rng(SEED))
    stream_level_times(multi["h"], multi["dh"], multi["iterations"], flush, np.random.default_rng(SEED),
                       f"{N_GMG_MULTI}^3 f64 (2,2,2)")
    epis = epilogue_level_times(h, g["dh"], g["device_iterations"], flush, np.random.default_rng(SEED))
    epilogue_level_times(multi["h"], multi["dh"], multi["iterations"], flush, np.random.default_rng(SEED),
                         f"{N_GMG_MULTI}^3 f64 (2,2,2)")
    s1 = next(ln for ln in streams if ln["level"] == 1)
    stream = {"ms": s1["us"] / 1e3, "plain_ms": s1["plain_us"] / 1e3, "bound_ms": s1["bound_us"] / 1e3,
              "bound_by": s1["bound_by"], "library_ms": s1["library_us"] / 1e3}
    e0 = next(ln for ln in epis if ln["level"] == 0 and ln["mode"] == "smooth")
    epilogue = {"ms": e0["us"] / 1e3, "plain_ms": e0["plain_us"] / 1e3, "bound_ms": e0["bound_us"] / 1e3,
                "bound_by": e0["bound_by"], "library_ms": None}

    Ah, bh = g["run"]["Ah"], g["run"]["bh"]
    b = _b_on_cols_layout(bh, device_matrix(Ah, backend))
    x0 = torch.zeros_like(b)
    line = {"phase": "gmg_times", "n": N_MAIN, "dtype": "float32", "reps": REPS, "fixed_trips": GMG_TRIPS,
            "dia_stream_spmv_level1": stream, "vcycle_epilogue_level0_smooth": epilogue}
    for route, kw in (("stencil", {}), ("structured", {"stencil": False}), ("stencil_eager", {"graph": False}),
                      ("structured_eager", {"stencil": False, "graph": False})):
        s_per_iter, per = fixed_trip_s_per_iter(
            lambda m: gpu_gmg.make_gmg_pcg_fn(h, backend, 0.0, m, **kw), b, x0, *GMG_TRIPS)
        fn = gpu_gmg.make_gmg_pcg_fn(h, backend, TOL_MAIN, 4 * Ah.rows.ngids, **kw)
        fn(b, x0)
        sync()
        t = time.perf_counter()
        out = fn(b, x0)
        sync()
        line[route] = {"s_per_iter": s_per_iter, "fixed_trip_s": per, "solve_s": time.perf_counter() - t,
                       "iterations": out[3], "device_loop": fn.stats}
    emit(line)
    for route, kw in (("stencil", {}), ("structured", {"stencil": False}), ("stencil_eager", {"graph": False})):
        phase_profile(f"gmg_pcg_profile_{route}", gpu_gmg.make_gmg_pcg_fn(h, backend, 0.0, 5, **kw), b, x0, 5)
    emit({"phase": "null_launch", "us": null_launch_us(flush)})
    coded_operator_times(gs["dh"], gs["device_iterations"], flush, np.random.default_rng(SEED))
    levels = stencil_level_times(g["dh"], g["device_iterations"], flush, np.random.default_rng(SEED))
    stencil_level_times(multi["dh"], multi["iterations"], flush, np.random.default_rng(SEED),
                        f"{N_GMG_MULTI}^3 f64 (2,2,2)")
    s0 = levels[0]
    stencil = {"ms": s0["us"] / 1e3, "plain_ms": s0["plain_us"] / 1e3, "bound_ms": s0["bound_us"] / 1e3,
               "bound_by": s0["bound_by"], "library_ms": s0["library_us"] / 1e3}
    return stream, stencil, epilogue


def phase_profile(name, fn, b, x0, iters):
    """Where a fixed-trip solve's iteration goes: device time per
    iteration by kernel name (torch.profiler), and the device's idle share
    of the wall time. The first call (a graph loop's capture) and a
    warm-up call of the profiler's schedule run before the profiled one.
    Per iteration means per iteration the device ran: a device-resident
    loop runs whole blocks, frozen iterations included (``fn.stats``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn(b, x0)
    sync()
    # one warm-up solve with the trace's collection on and its events
    # discarded, then the recorded one: a trace started right before a
    # solve has dropped its first launches (the start's SpMV and dot), and
    # once in a while still did after the warm-up step, so a spin on the
    # card opens the recorded step and its row is dropped
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn(b, x0)
        sync()
        prof.step()
        torch.cuda._sleep(SPIN_CYCLES)
        sync()
        t = time.perf_counter()
        fn(b, x0)
        sync()
        wall = time.perf_counter() - t
    loop = getattr(fn, "stats", None) or {}
    iters = loop.get("device_iterations", iters)
    # device-side events only (kernels, memcpys): the CPU-side aten ops
    # carry their kernels' device time too and would count it twice, and
    # the schedule's step annotation spans the whole step
    rows = [
        (e.key, e.self_device_time_total / 1e3 / iters, e.count / iters)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0 and not e.key.startswith("ProfilerStep")
        and "spin_kernel" not in e.key
    ]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    out = {"rows": rows, "iters": iters, "wall_ms": wall * 1e3}
    emit({
        "phase": name, "device_iterations": iters, "loop": loop.get("loop"), "block": loop.get("block"),
        "wall_ms_per_iter": wall * 1e3 / iters,
        "device_ms_per_iter": busy_ms, "idle_share": 1.0 - busy_ms * iters / (wall * 1e3),
        "by_kernel_ms_per_iter": [
            {"name": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:12]
        ],
    })
    return out


# ---------------------------------------------------------------------------


def _owned_values(v):
    from partitionedarrays_jl_tpu_torch.parallel.pvector import _owned

    return np.concatenate([np.asarray(_owned(i, x)) for i, x in zip(v.rows.partition.part_values(),
                                                                   v.values.part_values())])


def _global_triplets(A):
    from partitionedarrays_jl_tpu_torch import psparse_global_triplets

    out = []
    for i, j, v in psparse_global_triplets(A).part_values():
        o = np.lexsort((j, i))
        out.append((np.asarray(i)[o].astype(np.int64), np.asarray(j)[o].astype(np.int64), np.asarray(v)[o]))
    return out


def phase_planner(backend, run, gruns):
    """Phase 4p: the native host planner. Phase 2b's 48^3 f64 (2,2,2) system
    on the COO-free route and on the COO route: global triplets bit for bit
    (tests/test_fdm.py:86), b, x̂ and x0 to 1e-12, the COO-free system's
    fused CG within phase 2b's error gate with its launch formula, both
    routes' iterations; the main cell's planning seconds."""
    from partitionedarrays_jl_tpu_torch import native

    t_phase = time.perf_counter()
    n = N_MULTI
    systems, seconds = {}, {}
    for route, fast in (("coo_free", True), ("coo", False)):
        native.STENCIL_FAST = fast
        try:
            t = time.perf_counter()
            systems[route] = prun(lambda parts: assemble_poisson(parts, (n, n, n)), backend, (2, 2, 2))
            seconds[route] = time.perf_counter() - t
        finally:
            native.STENCIL_FAST = True
    (A, b, xe, x0), (Ac, bc, xec, x0c) = systems["coo_free"], systems["coo"]
    same = all(all(np.array_equal(p, q) for p, q in zip(u, w)) and u[2].tobytes() == w[2].tobytes()
               for u, w in zip(_global_triplets(A), _global_triplets(Ac)))
    vec_err = {k: float(np.max(np.abs(_owned_values(u) - _owned_values(w))))
               for k, u, w in (("b", b, bc), ("xe", xe, xec), ("x0", x0, x0c))}
    ghosts_sorted = all(bool(np.all(np.diff(np.asarray(i.lid_to_gid[i.num_oids:])) > 0))
                        for i in A.cols.partition.part_values())
    dia.reset_launches()
    x, info = cg(A, b, x0=x0, tol=1e-8)
    sync()
    launches = dict(dia.LAUNCHES)
    xc, info_c = cg(Ac, bc, x0=x0c, tol=1e-8)
    err, err_c = _rel_err(x, xe), _rel_err(xc, xec)
    dev_it = device_iterations(info)
    want = {"dia_coded_spmv": 1, "dia_coded_spmv_pfold": dev_it, "cg_sweep": dev_it, "ell_spmv_boundary": 1 + dev_it}
    g = gruns["main"]
    emit({
        "phase": "planner", "planner": "native", "library": str(native.LIBRARY),
        "cell_48": {"n": n, "dtype": "float64", "parts": [2, 2, 2], "assembly_s": seconds,
                    "triplets_equal": same, "max_abs_diff": vec_err, "ghosts_sorted": ghosts_sorted,
                    "iterations": info["iterations"], "coo_iterations": info_c["iterations"], "err": err,
                    "coo_err": err_c, "lowering": info.get("lowering"), "plan": info.get("exchange_plan"),
                    "kernels": {k: launches.get(k, 0) for k in want}, "expected_launches": want},
        "main_cell": {"n": N_MAIN, "dtype": "float32", "parts": 1, "assembly_s": run["assembly_s"],
                      "staging_s": run["lowering_s"], "gmg_assembly_s": g["assembly_s"],
                      "hierarchy_s": g["hierarchy_s"], "gmg_staging_s": g.get("staging_s")},
        "phase_s": time.perf_counter() - t_phase,
    })
    require(same, "planner: the COO-free and the COO route's global triplets differ")
    require(all(v <= 1e-12 for v in vec_err.values()), f"planner: b, x̂ or x0 differ across routes: {vec_err}")
    require(ghosts_sorted, "planner: the COO-free route's ghost columns are not sorted by gid")
    require(info["converged"] and err < 1e-5, f"planner: the COO-free system's CG error {err} >= 1e-5")
    require(info_c["converged"] and err_c < 1e-5, f"planner: the COO system's CG error {err_c} >= 1e-5")
    for k in want:
        require(launches.get(k, 0) == want[k], f"planner: {launches.get(k, 0)} {k} launches, expected {want[k]}")


def main() -> int:
    smi = phase_device()
    backend = GPUBackend()
    rng = np.random.default_rng(SEED)
    kern = phase_kernels(backend, N_MAIN, rng)
    gruns, err_stencil = phase_stencil_kernels(backend, rng)
    run, launches = phase_main(backend, N_MAIN)
    launches["dia_coded_spmv_axpy"] = phase_pipelined(backend, run)["dia_coded_spmv_axpy"]
    err_sweep_multi = phase_multi(backend, N_MULTI, rng)
    gmg = phase_gmg(backend, gruns["main"], rng)
    gmg_s = phase_gmg_structured(backend, gmg, rng)
    launches["dia_stream_spmv"] = gmg["launches"]["dia_stream_spmv"]
    launches["box_stencil_apply"] = gmg["launches"]["box_stencil_apply"]
    launches["vcycle_epilogue"] = gmg["launches"]["vcycle_epilogue"]
    err_multi = phase_gmg_multi(backend, gruns["multi"], rng)
    jac = phase_jacobi(backend, gruns["main"], rng)
    launches.update(jac["launches"])
    blk = phase_block(backend, run, rng)
    launches.update(blk["launches"])
    el = phase_elastic(backend, rng)
    low = phase_lowering_times(backend, el, rng)
    elm = phase_elastic_multi(backend, rng)
    st = phase_strict(backend, run, rng)
    bel = phase_block_elastic(backend, el, rng)
    belm = phase_block_elastic_multi(backend, elm, rng)
    emit_bsr_spmm_times(bel, belm)
    bst = phase_block_strict(backend, run, st, rng)
    sg = phase_strict_gmg(backend, gruns["main"], rng)
    q1 = phase_fem_q1(backend, rng)
    heat = phase_heat(backend, rng)
    adv = phase_advection(backend, rng)
    advm = phase_advection_multi(backend, rng)
    phase_krylov_gmg(backend, gruns, gmg["iterations"], rng)
    phase_diff_solve(backend, rng)
    fam = phase_solver_family(backend, run, gruns, rng)
    phase_resilience(backend, run, gruns["multi"], rng)
    phase_serving(backend, run, gruns["multi"], rng)
    gate = phase_frontdoor(backend, run, gruns["multi"], rng)
    phase_observability(backend, run, gruns["multi"])
    shrink = phase_elastic_shrink(backend, gruns["multi"], rng)
    phase_planner(backend, run, gruns)
    emit({"phase": "device_memory", "after": "phase 4j", "max_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "max_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
          "allocated_gib": torch.cuda.memory_allocated() / 2**30})
    # each kernel's launches from the path it runs on: E2 on the elasticity
    # path's BSR lowering (its stacked BSR run where 64^3 resolved to SD),
    # E2's boundary on the stacked SD path, E1 and E3 on the strict
    # (2,2,2) path
    bsr_runs = [el["launches"]["bsr_spmv"]] + [ln["kernels"]["bsr_spmv"] for ln in elm["lines"]]
    launches.update(bsr_spmv=next(v for v in bsr_runs if v > 0), bsr_spmv_boundary=elm["launches"]["bsr_spmv_boundary"],
                    ell_spmv=st["launches"]["ell_spmv"], ell_spmv_boundary=st["launches"]["ell_spmv_boundary_strict"],
                    pairwise_dot=st["launches"]["pairwise_dot"])
    # the slab forms from phase 4g's paths: E2's on the 64^3 block PCG, its
    # boundary kernel's launches in the 4-part SD block PCG, E1's and E3's on
    # the strict (2,2,2) block CG
    launches.update(bsr_spmm=bel["launches"]["bsr_spmm"],
                    bsr_spmv_boundary_slab=belm["launches"]["bsr_spmv_boundary_slab"],
                    ell_spmm=bst["launches"]["ell_spmm"], pairwise_dot_block=bst["launches"]["pairwise_dot_block"])
    times = phase_times(backend, kern, run, N_MAIN)
    times["dia_stream_spmv"], times["box_stencil_apply"], times["vcycle_epilogue"] = phase_gmg_times(
        backend, gmg, gmg_s, {"h": gruns["multi"]["h"], "dh": gruns["multi"]["dh"],
                              "iterations": err_multi["device_iterations"]})
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=backend.device)
    times.update(jacobi_kernel_times(jac, flush, np.random.default_rng(SEED)))
    times.update({k: v for k, v in blk["times"].items() if k in KERNELS})
    times.update({k: v for k, v in {**low["times"], **elm["times"], **st["times"], **bel["times"], **belm["times"],
                                    **bst["times"]}.items() if k in KERNELS})
    # the front door's paths launch the block kernels, K1 and K2 again
    # (phase 4m: its p192 slabs and its traced solo solve, by formula)
    for k, v in gate["launches"].items():
        launches[k] += v
    # and the elastic resume on the 192^3 survivors (phase 4o) K1, K2, the
    # sweep and E1's boundary mode
    phase_4o = {k: shrink["launches"][k] for k in ("dia_coded_spmv", "dia_coded_spmv_pfold", "cg_sweep",
                                                   "ell_spmv_boundary")}
    for k, v in phase_4o.items():
        launches[k] += v
    emit({"phase": "launch_counts", "kernels": launches, "phase_4j": fam["launches"], "phase_4m": gate["launches"],
          "phase_4o": phase_4o})
    errs = {**kern["errs"], **q1["errs"], **heat["errs"], **adv["errs"], **advm["errs"], **shrink["errs"]}
    max_err = {
        name: max(v for key, v in errs.items() if key.startswith(name + "["))
        for name in ("dia_coded_spmv", "dia_coded_spmv_pfold", "dia_coded_spmv_axpy")
    }
    max_err["dia_coded_spmv"] = max(max_err["dia_coded_spmv"], *gmg_s["err_k1"].values(), err_multi["coded"],
                                    heat["coded"])
    max_err["dia_stream_spmv"] = max(gmg["err_k4"], err_multi["stream"], heat["stream"])
    max_err["box_stencil_apply"] = max(err_stencil, heat["stencil"])
    max_err["vcycle_epilogue"] = max(gmg["err_epi"], gmg_s["err_epi"], err_multi["epilogue"], heat["epilogue"])
    max_err["cg_sweep"] = max(max(v for key, v in errs.items() if key.startswith("cg_sweep[")), err_sweep_multi)
    for name in ("dia_coded_spmv", "dia_stream_spmv", "box_stencil_apply", "vcycle_epilogue"):
        on_4j = [v for key, v in fam["errs"].items() if key.startswith(name + "[")]
        max_err[name] = max([max_err[name]] + on_4j)
    held = {**jac["errs"], **blk["errs"], **el["errs"], **low["errs"], **elm["errs"], **st["errs"], **bel["errs"],
            **belm["errs"], **bst["errs"], **sg["errs"], **q1["errs"], **heat["errs"], **advm["errs"], **fam["errs"],
            **shrink["errs"]}
    for name in ("dia_coded_spmv_pfold_minv", "cg_sweep_precond", "cg_sweep_block", "dia_coded_spmm", "dia_stream_spmm",
                 "block_products", "ell_spmv", "ell_spmv_boundary", "bsr_spmv", "bsr_spmv_boundary", "pairwise_dot",
                 "ell_spmm", "bsr_spmm", "bsr_spmv_boundary_slab", "pairwise_dot_block"):
        max_err[name] = max(v for key, v in held.items() if key.startswith(name + "["))
    for name in KERNELS:
        require(launches[name] > 0, f"{name}: no launch on its path")
    emit({"kernels": [
        {
            "name": name, "route": "cuda", "source": SRC[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
            "library_ms": times[name]["library_ms"],
        }
        for name in KERNELS
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
