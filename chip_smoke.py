"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py [--old OLD_SOURCE] [--old-scan OLD_SOURCE]

Phases (any failure raises and the script exits non-zero, printing no result):
  1. the card's name and power limit (nvidia-smi);
  2. build the two kernels, the CR kernel from ctdirect_tpu_torch/csrc/cr_solve.cu
     and the scan kernel (the structured block solve) from csrc/scan_solve.cu,
     the latter one library per block width up to 16 and one for the wider
     ones, one nvcc each, all started together (ptxas report);
  3. the CR kernel vs its plain PyTorch version at the MPC tick shape
     (P=128, bs=5, wb=7, B=512) in float32 and float64, plus a dense-residual
     check on 3 lanes; times of both (CUDA events, median of 20 calls for the
     kernel, of 3-20 within a 2 s budget for the plain version);
  4. the front door: ct.solve(double integrator, N=100, trapeze) on the card
     against its analytic oracles, its structured block solves (warm-ups
     included) equal to the scan kernel's launches;
  5. the main path: cold start (a compiled structured solve, as in phase 10;
     scan kernel launches = its block solves) + 512
     warm-started MPC controllers at N=100,
     3 Newton steps per tick, with the f32 and then the f64 block solve, run
     twice from the same warm state over the same x0 sequence: the eager
     tick (`MPCController.eager`) and the tick as the controller runs it on
     the card, a replayed CUDA graph (captured by one call before the
     counted run; its capture time and pool printed). In each run the
     kernel's launch count must grow by exactly ticks x 3 and max KKT stay
     below 1e-10; the replay's u0 and KKT (every tick) and final states must
     equal the eager tick's within GRAPH_TOL; p50 / p90 and solves/s of both;
  6. the device split of 5 more ticks of each, eager and replayed
     (torch.profiler): device busy and idle share, the CR kernel's share,
     kernel launches per tick, and the CR kernel's CUDA launches per tick as
     the profiler sees them, which must be the plan (3 x (3 + 3 log2 128) =
     72): the witness that the graph runs the kernel apart from the
     wrapper's counts; then the eager tick's device ms by stage (the KKT
     operator's prepare, assemble, block solve and the CR kernel, the rest);
  7. the front door with the default scheme (midpoint): ct.solve(double
     integrator, N=100) with no scheme= against the same analytic oracles,
     scan kernel launches = structured block solves;
  8. the cart-pole MPC tick (BASELINE config 3): cold start (scan kernel
     launches = its block solves) + 1024 warm-started
     controllers at N=60 trapeze, 3 Newton steps, f64 block solve; 2 warm-up
     + 10 timed ticks, eager and replayed as in phase 5 (launches = ticks x
     3, the replay held to the eager tick), then phase 6's split over 3
     ticks (63 CR launches per tick);
  9. batched cart-pole scenario solves: BatchSolver (kkt_mode="cr", tol 1e-6,
     30 iterations at most) over 1024 instances with per-instance x0, from the
     cold-start solution, three times: the eager solve (`BatchSolver.eager`),
     the first call as the solver runs it on the card (its ten segments
     captured as CUDA graphs at their first use, after a warm-up run of
     each) and a second call (replay only). Each prints its wall, solves/s,
     host syncs per iteration and kernel launches, which must be the batched
     KKT solves (plus, in the first call, those of the segment warm-ups); the
     graphed calls also their capture s, segment graphs and pool MiB, and
     must equal the eager solve within GRAPH_TOL over every field and
     instance (bitwise expected) with the same solves, syncs and segment
     runs. Then one more graphed solve under torch.profiler: device busy and
     idle share, the CR kernel's share, and its CUDA launches, which must be
     the solve's KKT solves x (3 + 3 log2 64) = 21. Three instances re-solved
     unbatched must match, converged share >= CP_MIN_CONVERGED.
 10. BASELINE config 2: goddard, Gauss-Legendre 2-stage constant control,
     N=200, tol 1e-8, adaptive mu, kkt_mode="cr", with the f64 block solve
     and with the f32 block solve + 2 refinement sweeps + Ruiz, each on one
     transcribed DOCP three times: the eager solve (`run.eager`, ipm_solve),
     the first compiled solve_docp (the batched IPM at B=1, its segments
     captured as CUDA graphs after a warm-up each; wall, capture s, segment
     graphs, pool MiB) and a replayed one; iterations, host syncs per
     iteration and kernel launches of each, launches = block solves (+ the
     warm-ups' in the first call). Every compiled solve successful, the
     objective within 1e-2 of 1.01257; the f32 and f64 runs agreeing to 1e-7
     in objective and 1e-4 in controls; the replay within GRAPH_TOL of the
     same B=1 program run op by op over every field (bitwise expected), with
     the same KKT solves, syncs and segment runs; against the eager solve the
     same status and the objective within 1e-8 (iterations side by side);
     then a replayed solve under torch.profiler: device busy and idle share,
     and the CR kernel's CUDA launches, which must be the block solves x
     (3 + 3 log2 256) = 27.
     Each of these profiled checks (phases 6, 9, 10 and 14f) goes through
     utils/profiling.py's kernel_events: it reports the activity records
     CUPTI dropped (kineto's warnings, printed with KINETO_LOG_LEVEL=2,
     which this script sets) and takes a profile that dropped records again,
     3 profiles at most; a count that differs with nothing dropped fails
     (each profile keeps PROFILE_MARGIN_S of idle after the call, so that
     the call's last kernels end inside it); phases 9 and 10 hold every
     profiled solve's result to the unprofiled replay's within GRAPH_TOL;
 11. the 10-problem suite (benchmarks/sweep.py's EASY_SET) at N=250 trapeze
     through ctdirect_tpu_torch.sweep's run_sweep and checks, unprofiled:
     the sweep's options (f32 block solve, refinement, Ruiz, its
     per-problem overrides), each a
     compiled solve as ct.solve runs it (first call: captures), then a
     replay on the same DOCP (the first call's overhead is the difference):
     every problem ok by the sweep's rule, the replay bitwise the first
     call, launches = block solves (+ the warm-ups'), and its objective
     within the sweep's SUITE_JAX_RTOL of the JAX package's on the CPU;
 12. grid_continuation(goddard, grids (50, 100), GL2 constant control) with
     phase 10's f32 options, compiled: the final stage successful and within
     1e-6 of the JAX package's final objective with the same grids on the CPU;
 13. the fixture CI on the card (compiled solves; the segment graphs and
     capture seconds of each printed): every registered problem but `pattern` and
     the suite (22 fixtures) under its recipe from the JAX CI
     (tests/test_all_ocp.py, copied as CI_CONFIG: grid, scheme, coarse-to-fine
     stages, warm mu, tol 1e-6, max_iter, mu_init), f64, kkt_mode="cr" but
     for CI_CARD_OVERRIDES (the JAX CI's structured solve: the scan kernel),
     each fixture's block solves on its mode's kernel and none on the other,
     each recipe from its fixture's guess; in CI_WORKERS processes sharing the card, held
     to that CI's oracle (successful; objective within rtol of the stored
     one, truck_trailer's better-optimum band, orbit_transfer's fuel bounds;
     success only where none is stored); walls by utils.profiling.timed, one
     utils.profiling.trace around bolza_freetf whose Chrome trace must hold
     CUDA events of the CR kernel, and utils.structure.verify_structure on a
     CUDA DOCP (N=4) of each fixture this slice ported.
 14. the sharded paths, in one gloo world of SHARD_WORLD processes on the one
     card (ctdirect_tpu_torch.parallel.spmd.launch; NCCL refuses two ranks
     on one card, so every message is staged through the host, counted):
     a. the distributed CR (make_sharded_tridiag_solver) at D=2 and D=4 on
        the tick's chain (P=128, bs=5, wb=7, B=512) and Goddard's (P=256,
        bs=19, wb=8, B=1), f64, against the plain CR and the kernel on the
        card (max abs diff <= 1e-10 x scale, lane residuals), ms per solve
        beside phase 3's kernel ms at the same shape;
     b. the batch-sharded RTI tick at full width: phase 5's configuration
        (N=100, B=512 over batch=4, kkt_algorithm="cr", f32 block solve, 3
        Newton steps) from phase 5's warm state and x0 sequence, each rank
        replaying its own CUDA graph (captured by one call before the
        counted run), 2 warm-up + 8 timed ticks: max KKT < 1e-10, each
        rank's CR kernel launches = 3 x ticks, u0 equal to an unsharded tick
        of the same rows to 1e-12;
     c. the 2-D tick, batch=2 x time=2, f64, through InsideTimeShardKKT,
        eager (its halos are staged through the host; it must capture
        nothing): max KKT < 1e-10, u0 within 1e-10 of the unsharded f64
        tick, the ranks of each time group in agreement;
     d. BASELINE config 2 (Goddard GL2 N=200, f64, phase 10's options)
        through ipm_solve(kkt=TimeShardedKKT) over time=2: status 0 and the
        objective within 1e-8 of phase 10's f64 objective;
     e. ctdirect_tpu_torch.entry.dryrun_multichip(4, cuda, gloo): all five
        legs; on every rank the batch-sharded solves of legs 1 and 4 run as
        the rank's own segment graphs (the all_gather outside them);
     f. the compiled time-sharded paths in a one-rank NCCL world (NCCL puts
        one rank on each card; ctdirect_tpu_torch.shard_timing's run and
        checks at time=1): (i) the distributed CR on the tick's chain
        (P=128, bs=5, wb=7, B=512, f64) replayed as a CUDA graph, bitwise
        its eager form and within 1e-10 x scale of the kernel; (ii) the 2-D
        tick over batch=1 x time=1, phase 5's f64 configuration from its
        warm state over its x0s: one capture, the replay within GRAPH_TOL
        of the eager tick at every tick, max KKT < 1e-10, u0 within 1e-10
        of phase 5's unsharded tick; (iii) Goddard config 2 through
        DOCPSolver(kkt=TimeShardedKKT) over time=1, compiled (segment
        graphs) against the eager ipm_solve(kkt=TimeShardedKKT): status 0
        both, objective within 1e-8, and within 1e-8 of phase 10's. Each
        prints its replayed and eager times and the NCCL messages per
        replay, which must be nonzero (none staged); each path's kernel
        launches (the root solve, P=1) are counted around its replays, and
        one more replay of (i) and (ii) runs under torch.profiler, which
        must see those launches x the plan (3 CUDA launches each; (iii)'s
        segment graphs are phase 10's kind, whose launches it profiles).
 15. BASELINE config 4, the orbit-transfer scenario batch, through
     ctdirect_tpu_torch.orbit_scenarios' run and checks at full width
     (midpoint N=500: a KKT chain of P=512, bs=11, wb=13) with ORBIT_CFG's
     batch size and nominal KKT solve (the structured solve, on the scan
     kernel: launches = its block solves): the compiled nominal solve held
     to the JAX package's structured objective 0.17222008 at 1e-3; the scenario BatchSolver (kkt_mode="cr")
     eager, first graphed call and replay, held to each other bitwise, each
     with its kernel launches = its KKT solves (+ the warm-ups'); a profiled
     graphed solve whose CR launches must be the KKT solves x 30; the
     batch with its rows moved at random within their alignment classes
     held to it bit for bit; three scenarios solved alone printed beside
     their rows;
 16. a cut of the suite ladder through ctdirect_tpu_torch.sweep's
     run_sweep and checks (LADDER_CUT: the 10 problems at N=1000 and
     goddard_all at N=5000 with its per-cell refine 3, a chain of P=8,192
     blocks), with phase 11's checks and, once per rung, a profiled replay
     of goddard_all that must see every planned CUDA launch of the CR
     kernel (its busy, idle and CR shares and its idle by segment printed);
     the ladder table against Ipopt's totals;
 17. BASELINE config 5 through ctdirect_tpu_torch.multihost's run and
     checks in a one-rank NCCL world (MULTIHOST_SIZES): the batch-sharded
     MPC tick (MPCController(mesh=, batch_axis="batch"), a replayed CUDA
     graph) of the double integrator (N=100, 512 a card, 10 timed ticks)
     and of cart-pole (N=60, 1,024 a card, 5 timed ticks) from the warm
     states of phases 5 and 8 (the same cold starts as the script's own)
     over the (seed, tick) x0 draws: the replay
     bitwise its eager tick (u0 and KKT at every tick, the states), max KKT
     < 1e-10 (the double integrator), no message in the timed loop and one
     all_reduce a tick in the isolation loop, ticks x 3 CR launches and a
     profiled replay that sees their CUDA launches (72 / 63) and no NCCL
     kernel; cart-pole's BatchSolver(mesh=) over 1,024 scenarios, a first
     graphed call and a replay, bitwise its eager solve, converged share
     >= CP_MIN_CONVERGED;
 18. the single-solve latency lab (ctdirect_tpu_torch.latency_lab's run_lab,
     report and checks; benchmarks/latency_lab.py's port) at LAB_N: beam and
     goddard (trapeze) under structured:f64, cr:f64, cr:f32 and
     structured:f32, each a compiled first call and LAB_REPS replays
     (bitwise the first), its block solves on its mode's kernel (the scan
     kernel in f64 and f32, the CR kernel) and none on the other, status and
     objective against the JAX package's on the CPU where recorded.
Each phase's wall is printed after it.
Phase 3 also holds the kernel against its plain version at the cart-pole
chain (P=64, bs=9, wb=13, B=1024 and BASELINE config 5's CP5_B a card,
f64), at the Goddard GL2 chain of phase 10
(P=256, bs=19, wb=8, B=1, f32 and f64) and at the width-41 goddard_all GL3
chain (P=256, bs=30, wb=11, B=1 and B=256, f64), and at phase 13's widest
and longest chains (quadrotor P=256 bs=21 wb=28, orbit_transfer P=512 bs=11
wb=15, B=1, f64), at these shapes with the dense residual checked on every
lane, at phase 15's (P=512, bs=11, wb=13, B=2048, f64; 3 lanes), and at
the suite ladder's longest chains (goddard_all trapeze, bs=10, wb=12, B=1:
N=5000 gives P=8,192 and N=10,000 P=16,384; f32 and f64). Then it holds the
scan kernel against its plain version (the structured solve's _scan_solve)
at SCAN_SHAPES (quadrotor N=150 bs=21 wb=28, orbit_transfer N=500 bs=11
wb=13 and goddard_all trapeze N=5000 bs=10 wb=12 at B=1, cart-pole N=60
bs=9 wb=13 at B=1024; f64 and f32): max abs difference / (1 + max |x|)
within SCAN_TOL, the block-matvec residual of every instance, one launch a
call; with the kernel's, the plain version's and the library call's times,
the bound and the latency floor (one chain's operations on one SM), the
kernel's µs per step (ms / N), its share of the floor and the chains that
can be resident on one SM (the occupancy calculator's CTAs x the chains a
CTA holds at that batch). At each
CR shape it prints the kernel's,
the plain version's and a library call's time (torch.linalg.solve of the
same system as one dense matrix per instance, at most LIBRARY_MAX_B of
them; where they would pass LIBRARY_MAX_BYTES, of the chain's first
blocks, the most of a power of two that keeps them within), the bound
(bytes or operations), the kernel's share of it, the form
that ran, the CUDA launches of one solve and the device memory free across
the first launch; then the launch floor of one solve at P=256. Phase 2
prints ptxas's registers, stack frame and spills per kernel and fails on a
spill or a stack frame of 1 KB or more. Each path's launches are counted
from zero just before it runs and read just after: one `launches` per block
solve, and `grid_launches` must equal the planned CUDA launches of those
solves (3 + 3 log2 P each, P = the path's chain padded to a power of two).
Scan kernel paths count one launch per structured block solve (one CUDA
launch each).
The card's name and power limit are printed first and again just before the
JSON lines; the line before the last is a JSON object describing the kernels
(one entry per kernel and dtype: its launches (and the CR kernel's CUDA
launches) per path, the times, bounds and library times at every shape);
the last line is
{"ok": true, "device": {...}}.

--old OLD_SOURCE adds the earlier one-thread-per-instance kernel, built from
an earlier cr_solve.cu with its C interface, to phase 3: at each shape it is
held against the plain version with the same tolerance and timed in turns
with the current kernel (old, new, new, old; CUDA events, median of up to 20
calls each, fewer where one call takes seconds). Its calls count nowhere.

--old-scan OLD_SOURCE does the same for the scan kernel with an earlier
scan_solve.cu (the C interface scan_solve_f32 / scan_solve_f64(A, Bc, E, F,
r, rb, X, xb, work, N, bs, wb, B, stream) and scan_workspace_elems(N, bs,
wb, B)): at each SCAN_SHAPES row the current kernel must equal it bit for bit
(max |dX| = max |dxb| = 0, f32 and f64), and both are timed in turns (old,
new, new, old). Its calls count nowhere.
"""

import argparse
import concurrent.futures
import contextlib
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

# kineto (torch.profiler) prints its warnings, among them CUPTI's dropped
# activity records that the profiled checks report, only at this level or
# below; read when its profiler first starts
os.environ.setdefault("KINETO_LOG_LEVEL", "2")

import numpy as np
import torch

from ctdirect_tpu_torch.multihost import PROBLEMS as MULTIHOST_PROBLEMS
from ctdirect_tpu_torch.sweep import SUITE, chain_blocks

B, N, ITERS = 512, 100, 3
P_TICK, BS_TICK, WB_TICK = 128, 5, 7
WARMUP_TICKS, TIMED_TICKS = 2, 30
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# the replayed tick against the eager tick (f64 outputs; the same kernels in
# the same order, so bitwise is expected: the bound leaves room for a library
# that picks another algorithm on the capture stream)
GRAPH_TOL = 1e-13
RESID_TOL = {torch.float32: 2e-4, torch.float64: 1e-12}
# cart-pole (benchmarks/mpc_cartpole.py: N=60, B=1024, 3 Newton steps)
CP_N, CP_B, CP_WARMUP, CP_TICKS = 60, 1024, 2, 10
P_CP, BS_CP, WB_CP = 64, 9, 13  # its trapeze KKT chain (padded to a power of two)
CP_UMAX = 12.0
# BASELINE config 5's cart-pole tick a card (multihost.py's full run)
CP5_B = MULTIHOST_PROBLEMS["cartpole"]["batch_per_chip"]
CP_BATCH, CP_CHECK = 1024, (0, 511, 1023)
# min(0.95, the share that the JAX package converges on the CPU for the first
# 16 of the same draws with the same options: 7 of 16, PERF.md)
CP_MIN_CONVERGED = 0.4375
# BASELINE config 2 (BASELINE.json:8): Goddard, free tf, GL2 constant control,
# N=200, with the options of tests/test_accuracy.py:78-84
GD_N, GD_SCHEME, GD_OBJ = 200, "gauss_legendre_2_constant_control", 1.01257
GD_OPTS = dict(tol=1e-8, mu_strategy="adaptive", kkt_mode="cr")
P_GD, BS_GD, WB_GD = 256, 19, 8  # its KKT chain (bs + wb = 27), padded to a power of two
P_W, BS_W, WB_W, B_W = 256, 30, 11, 256  # goddard_all GL3 at N=200 (width 41)
# the widest chain (quadrotor N=150) and the longest (orbit_transfer N=300)
# that phase 13 gives the kernel
P_QR, BS_QR, WB_QR = 256, 21, 28
P_OT, BS_OT, WB_OT = 512, 11, 15
# BASELINE config 4 (phase 15): orbit_transfer midpoint N=500, the scenario batch
P_O4, BS_O4, WB_O4, B_O4 = 512, 11, 13, 2048
# the suite ladder's widest chain (goddard_all trapeze) at its longest: N=5000
# (phase 16) and N=10,000 (the sweep's --large)
BS_L, WB_L = 10, 12
P_L5, P_L10 = 8192, 16384
# phase 3's shapes: (dtype, P, bs, wb, B)
PHASE3_SHAPES = [(torch.float32, P_TICK, BS_TICK, WB_TICK, B), (torch.float64, P_TICK, BS_TICK, WB_TICK, B),
                 (torch.float64, P_CP, BS_CP, WB_CP, CP_B), (torch.float64, P_CP, BS_CP, WB_CP, CP5_B),
                 (torch.float32, P_GD, BS_GD, WB_GD, 1), (torch.float64, P_GD, BS_GD, WB_GD, 1),
                 (torch.float64, P_W, BS_W, WB_W, 1), (torch.float64, P_W, BS_W, WB_W, B_W),
                 (torch.float64, P_QR, BS_QR, WB_QR, 1), (torch.float64, P_OT, BS_OT, WB_OT, 1),
                 (torch.float64, P_O4, BS_O4, WB_O4, B_O4),
                 *((dt, p, BS_L, WB_L, 1) for p in (P_L5, P_L10) for dt in (torch.float32, torch.float64))]
# the plain version's timing stops at 3 calls where 20 would take longer than
# this (at the long B=1 chains): the script's time limit
PLAIN_BUDGET_MS = 2000
# the library yardstick solves at most this many dense systems (goddard_all at
# B=256 would be 121 GB of f64 matrices)
LIBRARY_MAX_B = 16
# and dense matrices of at most this many bytes in all (a ladder chain of
# P=8,192 blocks is a 54 GB f64 matrix, and its LU works on a copy): beyond
# it, the chain's first P' blocks, P' the largest power of two within it
LIBRARY_MAX_BYTES = 16e9
# NVIDIA's H100 SXM data sheet: the HBM3 rate; 67 TFLOP/s is its f32 rate outside
# the tensor cores and its f64 rate on them (DMMA, which the small matrix
# products of the reduction could use)
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.float32: 67e12, torch.float64: 67e12}
SM_COUNT = 132  # its SMs: the scan kernel walks a chain on one of them
MAX_STACK_BYTES = 1024
# phase 3's chains of the scan kernel (the structured block solve), (dtype, N,
# bs, wb, B): quadrotor's (phase 13's widest structured recipe, N=150),
# config 4's nominal (orbit_transfer midpoint N=500) and the ladder's longest
# (goddard_all trapeze N=5000), each at B=1, and the cart-pole tick's chain
# (N=60) at B=1024; the plain version is the structured solve's own
# _scan_solve. Their random chains take the diagonal shift 4 + bs (with the
# helper's 4, the orbit-width chain has max |x| 396 and two f32 solves of it
# differ by 1.1e-3 relative: torch_helpers.random_chain_lanes)
SCAN_SHAPES = [(dt, *shape) for shape in ((150, BS_QR, WB_QR, 1), (500, BS_O4, WB_O4, 1), (5000, BS_L, WB_L, 1),
                                          (60, BS_CP, WB_CP, CP_B))
               for dt in (torch.float64, torch.float32)]
# the scan kernel against its plain version: max abs difference / (1 + max |x|)
SCAN_TOL = {torch.float32: 1e-3, torch.float64: 1e-10}
# phase 12, cut from grids (50, 200) to (50, 100) to keep the script near half
# its time limit (PERF.md). Its final stage is held against the JAX
# package's grid_continuation with the same grids and options on the CPU
# (both stages status 0, 63 + 56 iterations)
GC_GRIDS = (50, 100)
GC_JAX_CPU = 1.0125757548902092
# the 10-problem suite (phase 11) and its cut of the ladder (phase 16):
# ctdirect_tpu_torch/sweep.py keeps the data (benchmarks/sweep.py's suite,
# options and overrides, the JAX package's objectives on the CPU and the
# bounds on them)
SUITE_N = 250
LADDER_CUT = [*((name, 1000) for name in SUITE), ("goddard_all", 5000)]


# phase 13, the fixture CI on the card: a copy of the JAX package's CI recipe
# table (tests/test_all_ocp.py:19-110; that file imports JAX, so it cannot be
# imported here). tests/test_torch_ci_recipes.py keeps the copy equal to it.
class Cfg:
    def __init__(self, grid=100, scheme="trapeze", rtol=1e-2, pre_grids=(),
                 warm_mu=None, **opts):
        self.grid = grid
        self.scheme = scheme
        self.rtol = rtol
        self.pre_grids = list(pre_grids)  # coarse-to-fine stages before the final grid
        self.warm_mu = warm_mu  # mu_init of the warm stages
        self.opts = dict(tol=1e-6, max_iter=600)
        self.opts.update(opts)


CI_CONFIG = {
    "algal_bacterial": Cfg(grid=200, pre_grids=[50, 100], max_iter=2000),
    "action": Cfg(grid=200, pre_grids=[50], max_iter=1200),
    "bioreactor_Ndays": Cfg(grid=200),
    "electric_vehicle": Cfg(grid=200),
    "fuller": Cfg(grid=250),
    "glider": Cfg(grid=150),
    "insurance": Cfg(grid=150),
    "moonlander": Cfg(grid=250, pre_grids=[60]),
    "robbins": Cfg(grid=250),
    "quadrotor": Cfg(grid=150, pre_grids=[50]),
    "space_shuttle": Cfg(grid=150, pre_grids=[30, 75], warm_mu=1e-3, max_iter=3000),
    "goddard_all": Cfg(grid=150),
    "orbit_transfer": Cfg(grid=300, pre_grids=[75, 150], max_iter=2000),
    "cartpole": Cfg(grid=150),
    "truck_trailer": Cfg(grid=50, max_iter=2000),
    "swimmer": Cfg(grid=120, pre_grids=[60], mu_init=1e-2, warm_mu=1e-4, max_iter=1500),
    "swimmer2": Cfg(grid=120, pre_grids=[60], mu_init=1e-2, warm_mu=1e-4, max_iter=1500),
}
CI_SKIP = {"pattern"}
CI_BETTER_OK = {"truck_trailer"}
CI_BETTER_BAND = 0.10
# the fixtures that this slice ported (utils.structure.verify_structure runs on each)
CI_NEW = ("algal_bacterial", "glider", "insurance", "moonlander", "bioreactor_1day", "bioreactor_Ndays",
          "bolza_freetf", "parametric", "schlogl", "electric_vehicle", "quadrotor", "space_shuttle",
          "truck_trailer", "swimmer", "swimmer2")
CI_TRACED = "bolza_freetf"  # solved under utils.profiling.trace
# Phase 13 runs the solves in this many processes that share the one card,
# the longest first (by their iterations and walls on the card, PERF.md).
# Compiled, 3 processes took 104.6 and 110.4 s, 6 took 106.6 and 108.6 s
# (two runs each, PERF.md): a tie, so the fewer processes
CI_WORKERS = 3
CI_LONGEST_FIRST = ("orbit_transfer", "algal_bacterial", "quadrotor", "space_shuttle", "swimmer", "swimmer2",
                    "bioreactor_Ndays", "action", "moonlander", "truck_trailer")
# Card overrides of kkt_mode="cr": these run the JAX CI's own structured
# solve, the scan kernel on the card. quadrotor's recipe fails under "cr" in
# both packages on the CPU; space_shuttle's passes or fails with a few-ulp
# change of its tf guess in the JAX package under either KKT solve;
# algal_bacterial's and orbit_transfer's pass in the JAX package from the
# fixture's own guess and fail there under "cr" with every entry of that
# guess moved by one or two ulps (tools/ci_override_witness.py; PERF.md,
# ROADMAP.md queue 3). Under the structured solve too these outcomes rest
# on rounding: over the fixture's guess and five moved draws, the JAX
# package fails quadrotor's at 1 of 5 moved draws and algal_bacterial's at
# 2 of 6, and on the card the kernel and its plain version fail some draws
# of each (PERF.md). Every recipe runs from its fixture's guess.
CI_CARD_OVERRIDES = {name: dict(kkt_mode="structured")
                     for name in ("quadrotor", "space_shuttle", "orbit_transfer", "algal_bacterial")}


# phase 14: one gloo world of this many processes on the one card
SHARD_WORLD = 4
SHARD_WARMUP, SHARD_TICKS = 2, 8
SHARD_TIMED_SOLVES = 5
# 14a's chains: the tick's and Goddard's, f64 (in phase 3's shapes)
SHARD_CHAINS = {"tick": (P_TICK, BS_TICK, WB_TICK, B), "goddard": (P_GD, BS_GD, WB_GD, 1)}
SHARD_TIMEOUT = 600.0
# phase 15: BASELINE config 4 at full width (N=500: P=512, bs=11, wb=13) and
# batch (B=2048); the nominal on the structured solve, the script's own (the
# scan kernel; on PyTorch's plain scan it took ~210 s, PERF.md), and no
# diagnostics (the stage split's ~125 s of profiling and attribution, the
# alignment witness's ~120 s; the script's own run takes them)
ORBIT_CFG = dict(N=500, B=2048, nominal_mode="structured", diagnostics=False)
# phase 17: BASELINE config 5 through multihost.run in a one-rank NCCL world,
# (per-card batch, timed ticks) a problem; the script's own run (`python -m
# ctdirect_tpu_torch.multihost --nproc 4`) takes cart-pole at its full
# per-card batch on 1, 2 and 4 cards
MULTIHOST_SIZES = {"double_integrator_minenergy": (512, 10), "cartpole": (1024, 5)}
# phase 18: the single-solve latency lab (ctdirect_tpu_torch.latency_lab, its
# problems and four configs) at this N, each config a first call and this
# many replays
LAB_N, LAB_REPS = 1000, 1


def ci_fixtures(names):
    """Phase 13's fixtures: every registered problem but CI_SKIP and the
    suite of phase 11."""
    return [n for n in names if n not in CI_SKIP and n not in SUITE]


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(out)
    return out


def random_chain(P, bs, wb, B, dtype, seed=0, shift=None):
    """The tests' random well-conditioned symmetric chain (the CR recurrences
    assume symmetric A and F), lane-minor, on the card."""
    from torch_helpers import random_chain_lanes

    host = random_chain_lanes(P, bs, wb, B, seed=seed, shift=shift)
    return tuple(torch.tensor(x, dtype=dtype, device="cuda") for x in host)


def event_ms(fn):
    """CUDA-event ms of one call of fn."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, calls=20, budget_ms=None):
    """Median CUDA-event ms of `calls` calls after a warm-up call; with
    `budget_ms`, fewer calls (at least 3) where the warm-up says they would
    take longer."""
    first = event_ms(fn)
    if budget_ms is not None:
        calls = max(3, min(calls, int(budget_ms / max(first, 1e-3))))
    return float(np.median([event_ms(fn) for _ in range(calls)]))


def grid_per_solve(P):
    """The CUDA launches of one solve of a chain padded to P blocks (the
    library's plan)."""
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched

    return len(cr_solve_batched.plan(P, 1, 0, 1, 8))


def old_kernel(source):
    """solve(*chain) of the one-thread-per-instance kernel built from an
    earlier cr_solve.cu (C interface: cr_solve_f32 / cr_solve_f64(A, Bp, E, F, r, rb, X, xb, work,
    P, bs, wb, B, stream) and cr_workspace_elems(P, bs, wb, B))."""
    from ctdirect_tpu_torch.solver import cr_kernel

    lib = cr_kernel.BUILD_DIR / f"libcr_solve_old-{hashlib.sha256(source.read_bytes()).hexdigest()[:16]}.so"
    if not lib.exists():
        cr_kernel.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cr_kernel._nvcc(), *cr_kernel.NVCC_FLAGS, "-o", str(lib), str(source)], check=True)
    dll = ctypes.CDLL(str(lib))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("cr_solve_f32", "cr_solve_f64"):
        getattr(dll, name).argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
        getattr(dll, name).restype = i32
    dll.cr_workspace_elems.argtypes = [i32] * 4
    dll.cr_workspace_elems.restype = ctypes.c_size_t

    def solve(A, Bp, E, F, r, rb):
        P, bs, _, nb = A.shape
        wb = E.shape[-2]
        X = torch.empty((P, bs, nb), dtype=A.dtype, device=A.device)
        xb = torch.empty((wb, nb), dtype=A.dtype, device=A.device)
        work = torch.empty(dll.cr_workspace_elems(P, bs, wb, nb), dtype=A.dtype, device=A.device)
        fn = dll.cr_solve_f32 if A.dtype == torch.float32 else dll.cr_solve_f64
        rc = fn(A.data_ptr(), Bp.data_ptr(), E.data_ptr(), F.data_ptr(), r.data_ptr(), rb.data_ptr(), X.data_ptr(),
                xb.data_ptr(), work.data_ptr(), P, bs, wb, nb, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old CR kernel launch failed: cudaError {rc}")
        return X, xb

    return solve


def old_scan_kernel(source):
    """solve(A, Bc, E, F, r, rb) of the scan kernel built from an earlier
    scan_solve.cu (batch leading; the C interface of the module docstring)."""
    from ctdirect_tpu_torch.solver import cr_kernel

    lib = cr_kernel.BUILD_DIR / f"libscan_solve_old-{hashlib.sha256(source.read_bytes()).hexdigest()[:16]}.so"
    if not lib.exists():
        cr_kernel.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cr_kernel._nvcc(), *cr_kernel.NVCC_FLAGS, "-o", str(lib), str(source)], check=True)
    dll = ctypes.CDLL(str(lib))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("scan_solve_f32", "scan_solve_f64"):
        getattr(dll, name).argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
        getattr(dll, name).restype = i32
    dll.scan_workspace_elems.argtypes = [i32] * 4
    dll.scan_workspace_elems.restype = ctypes.c_size_t

    def solve(A, Bc, E, F, r, rb):
        nb, N, bs, _ = A.shape
        wb = E.shape[-1]
        X = torch.empty((nb, N, bs), dtype=A.dtype, device=A.device)
        xb = torch.empty((nb, wb), dtype=A.dtype, device=A.device)
        work = torch.empty(dll.scan_workspace_elems(N, bs, wb, nb), dtype=A.dtype, device=A.device)
        fn = dll.scan_solve_f32 if A.dtype == torch.float32 else dll.scan_solve_f64
        rc = fn(A.data_ptr(), Bc.data_ptr(), E.data_ptr(), F.data_ptr(), r.data_ptr(), rb.data_ptr(), X.data_ptr(),
                xb.data_ptr(), work.data_ptr(), N, bs, wb, nb, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old scan kernel launch failed: cudaError {rc}")
        return X, xb

    return solve


def bound(dtype, P, bs, wb, nb):
    """(bound ms, what sets it, bytes, flops) of one solve: each input read
    once and each output written once, over the HBM rate; the operations the
    reduction needs, over PEAK_FLOP_S. Per odd block: the inverse of A_o
    (2 bs^3), the five bs x bs products of the couplings and Schur updates
    (10 bs^3), the three products with E_o (6 bs^2 wb), the border term
    (2 bs wb^2), the right-hand sides and the down-sweep step (12 bs^2 +
    4 bs wb); then one dense LU solve of the root, n = bs + wb (2n^3/3 + 2n^2)."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * nb * (P * (2 * bs * bs + bs * wb + 2 * bs) + wb * wb + 2 * wb)
    per_odd = 12 * bs**3 + 6 * bs * bs * wb + 2 * bs * wb * wb + 12 * bs * bs + 4 * bs * wb
    n = bs + wb
    flops = nb * ((P - 1) * per_odd + 2 * n**3 / 3 + 2 * n * n)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOP_S[dtype] * 1e3
    return (t_bytes, "bytes", nbytes, flops) if t_bytes >= t_ops else (t_ops, "operations", nbytes, flops)


def dense_system(chain, lanes):
    """The first `lanes` instances of a lane-minor chain as dense (n x n)
    matrices and right-hand sides on the card, n = P bs + wb."""
    A, Bp, E, F, r, rb = (x[..., :lanes].movedim(-1, 0) for x in chain)
    P, bs, wb = A.shape[1], A.shape[2], E.shape[-1]
    m = P * bs
    K = A.new_zeros((lanes, m + wb, m + wb))
    for p in range(P):
        sl = slice(p * bs, (p + 1) * bs)
        K[:, sl, sl] = A[:, p]
        if p + 1 < P:
            sl1 = slice((p + 1) * bs, (p + 2) * bs)
            K[:, sl, sl1] = Bp[:, p]
            K[:, sl1, sl] = Bp[:, p].transpose(-1, -2)
    Ec = E.reshape(lanes, m, wb)
    K[:, :m, m:] = Ec
    K[:, m:, :m] = Ec.transpose(-1, -2)
    K[:, m:, m:] = F
    return K, torch.cat([r.reshape(lanes, m), rb], dim=1)[..., None]


def launch_split(kernel, chain, calls=5):
    """Device ms of one solve by CUDA kernel (torch.profiler over `calls` solves)."""
    from torch.profiler import ProfilerActivity, profile

    from ctdirect_tpu_torch.utils.profiling import CR_KERNELS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kernel(*chain)
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        m = CR_KERNELS.search(e.key)
        if m and e.device_type.name == "CUDA":
            split[m.group(1)] = split.get(m.group(1), 0.0) + e.self_device_time_total / calls / 1e3
    return split


def phase_kernel_vs_plain(kernel, old=None):
    """The kernel against its plain version at every shape the paths give it:
    agreement, a dense-residual check (3 lanes at the tick and cart-pole shapes, every
    lane at the others), the times of the kernel, the plain version and the
    library call, the bound, the form, the launches of one solve and the
    device memory across the first launch; with `old` (old_kernel), the
    earlier kernel's agreement and both kernels' times in turns. Returns one
    record per shape."""
    from torch_helpers import lane_residuals, relative_residual

    from ctdirect_tpu_torch.solver.lanes import cr_solve_lanes

    results = []
    for dtype, P, bs, wb, nb in PHASE3_SHAPES:
        itemsize = torch.finfo(dtype).bits // 8
        chain = random_chain(P, bs, wb, nb, dtype)
        torch.cuda.synchronize()
        free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
        grid0 = kernel.grid_launches
        X, xb = kernel(*chain)
        torch.cuda.synchronize()
        grid = kernel.grid_launches - grid0
        free1, total = torch.cuda.mem_get_info()
        # what the first launch took outside PyTorch's allocator (its outputs and workspace)
        outside = (free0 - free1) - (torch.cuda.memory_reserved() - reserved0)
        if not outside < 2**30:
            raise AssertionError(f"kernel at P={P} bs={bs} wb={wb} B={nb}: the first launch took "
                                 f"{outside / 2**30:.2f} GiB of device memory outside PyTorch's allocator")
        plan = kernel.plan(P, bs, wb, nb, itemsize)
        if grid != len(plan):
            raise AssertionError(f"kernel at P={P}: {grid} CUDA launches in one solve, planned {len(plan)}")
        Xp, xbp = cr_solve_lanes(*chain)
        torch.cuda.synchronize()
        for name, t in (("X", X), ("xb", xb)):
            if t.shape != (Xp if name == "X" else xbp).shape or not torch.isfinite(t).all():
                raise AssertionError(f"kernel {dtype}: {name} not finite or wrong shape")
        err = max((X - Xp).abs().max().item(), (xb - xbp).abs().max().item())
        scale = max(1.0, Xp.abs().max().item(), xbp.abs().max().item())
        if not err <= TOL[dtype] * scale:
            raise AssertionError(f"kernel vs plain {dtype}: max abs err {err:.3e} > {TOL[dtype]:.0e} x {scale:.3g}")
        if nb >= B:  # the tick, cart-pole and config-4 batches
            # each lane sliced on the card first (the oracle copies what it is given to the host)
            lanes, resid = "3 lanes", max(relative_residual(tuple(x[..., [lane]] for x in chain), X[..., [lane]],
                                                            xb[..., [lane]], 0) for lane in (0, 7, nb - 1))
        else:
            lanes, resid = f"all {nb} lanes", lane_residuals(chain, X, xb).max().item()
        if not resid < RESID_TOL[dtype]:
            raise AssertionError(f"kernel {dtype} at P={P} bs={bs} wb={wb} B={nb}: dense residual {resid:.3e}")
        ms = median_ms(lambda: kernel(*chain))
        split = launch_split(kernel, chain)
        plain_ms = median_ms(lambda: cr_solve_lanes(*chain), budget_ms=PLAIN_BUDGET_MS)
        library_ms, lib_b, lib_p, lib_n, lib_note = library_yardstick(chain, Xp, nb)
        bound_ms, bound_by, nbytes, flops = bound(dtype, P, bs, wb, nb)
        wpb = plan[1][2] // 32
        form = f"level-parallel, {wpb} warp(s) per block at the first level"
        log(f"CR kernel {dtype} at P={P} bs={bs} wb={wb} B={nb}: max abs err {err:.3e} vs plain, dense "
            f"residual {resid:.3e} ({lanes}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library "
            f"torch.linalg.solve {library_ms:.3f} ms at B={lib_b} (n={lib_n}, {lib_note}) (CUDA events, median of "
            f"20 / 3-20 / 5 or 3); bound {1e3 * bound_ms:.3f} us "
            f"set by {bound_by} ({nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP), kernel at "
            f"{100 * bound_ms / ms:.3f}% of it; form: {form}; {grid} CUDA launches per solve; device memory "
            f"free {free0 / 2**30:.2f} -> {free1 / 2**30:.2f} GiB of {total / 2**30:.2f} across the first "
            f"launch, {outside / 2**20:.1f} MiB of it outside PyTorch's allocator; device ms per solve by kernel "
            f"(torch.profiler, 5 solves): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f" (sum {sum(split.values()):.4f})")
        results.append(dict(dtype=str(dtype).replace("torch.", ""), P=P, bs=bs, wb=wb, B=nb, form=form,
                            grid_launches_per_solve=grid, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, library_B=lib_b, library_P=lib_p, bound_us=1e3 * bound_ms, bound_by=bound_by,
                            mem_outside_allocator_mib=outside / 2**20, device_ms_by_kernel=split))
        if old is not None:
            Xo, xbo = old(*chain)
            torch.cuda.synchronize()
            old_err = max((Xo - Xp).abs().max().item(), (xbo - xbp).abs().max().item())
            if not old_err <= TOL[dtype] * scale:
                raise AssertionError(f"old kernel vs plain {dtype}: max abs err {old_err:.3e} > {TOL[dtype]:.0e} x "
                                     f"{scale:.3g}")
            turns = {"old": [], "new": []}
            for tag in ("old", "new", "new", "old"):
                fn = (lambda: old(*chain)) if tag == "old" else (lambda: kernel(*chain))
                turns[tag].append(median_ms(fn, budget_ms=2000))
            results[-1].update(old_ms=turns["old"], new_ms=turns["new"], old_max_abs_err=old_err)
            log(f"  old kernel at the same shape: max abs err {old_err:.3e} vs plain; old {turns['old']} "
                f"ms, new {turns['new']} ms (in turns old, new, new, old; CUDA events, median of up to 20)")
        del chain, X, xb, Xp, xbp
    tiny = random_chain(P_GD, 1, 0, 1, torch.float64)
    floor = median_ms(lambda: kernel(*tiny))
    log(f"launch floor: one solve at P={P_GD} bs=1 wb=0 B=1 ({grid_per_solve(P_GD)} CUDA launches) takes "
        f"{floor:.4f} ms (CUDA events, median of 20), {1e3 * floor / grid_per_solve(P_GD):.2f} us per launch")
    return results


def shape_ms(kres, dtype, P, bs, wb, nb):
    """The kernel's per-launch ms measured in phase 3 at one shape."""
    tag = str(dtype).replace("torch.", "")
    return next(r["ms"] for r in kres if (r["dtype"], r["P"], r["bs"], r["wb"], r["B"]) == (tag, P, bs, wb, nb))


def scan_bound(dtype, N, bs, wb, nb):
    """(bound ms, what sets it, bytes, flops, latency floor ms) of one scan
    solve of nb chains: each input read once and each output written once,
    over the HBM rate; the operations of the block elimination over
    PEAK_FLOP_S. Per block: the inverse (2 bs^3), Ainv E and Ainv r (2 bs^2
    wb + 2 bs^2), the border terms (2 bs wb^2 + 2 bs wb), the back sweep
    (4 bs^2 + 2 bs wb); per block after the first, C and the Schur updates
    of A, E and r (4 bs^3 + 2 bs^2 wb + 2 bs^2); then the border solve (2
    wb^3/3 + 2 wb^2). The latency floor: one chain's operations at one SM's
    share of the peak (its N steps run in order on one SM)."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * nb * (N * (bs * bs + bs * wb + 2 * bs) + (N - 1) * bs * bs + wb * wb + 2 * wb)
    chain = (N * (2 * bs**3 + 2 * bs * bs * wb + 2 * bs * wb * wb + 6 * bs * bs + 4 * bs * wb)
             + (N - 1) * (4 * bs**3 + 2 * bs * bs * wb + 2 * bs * bs) + 2 * wb**3 / 3 + 2 * wb * wb)
    flops = nb * chain
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOP_S[dtype] * 1e3
    floor = chain / (PEAK_FLOP_S[dtype] / SM_COUNT) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, flops, floor
    return t_ops, "operations", nbytes, flops, floor


def library_yardstick(chain, X, lanes):
    """torch.linalg.solve of a lane-minor chain's first `lanes` instances as
    dense matrices (at most LIBRARY_MAX_B where all would pass 8 GB; where
    they would pass LIBRARY_MAX_BYTES, of the chain's first P' blocks, P'
    the largest power of two within it): (ms, instances, blocks, n, note);
    with all the blocks, the note holds the max difference to X, the plain
    solution (lane-minor)."""
    P, bs, _, nb = chain[0].shape
    wb = chain[2].shape[2]
    itemsize = chain[0].element_size()
    n = P * bs + wb
    lib_b = nb if nb * n * n * itemsize <= 8e9 else min(nb, LIBRARY_MAX_B)
    lib_p = P
    if lib_b * n * n * itemsize > LIBRARY_MAX_BYTES:
        lib_p = 1 << (P.bit_length() - 1)
        while lib_b * (lib_p * bs + wb) ** 2 * itemsize > LIBRARY_MAX_BYTES:
            lib_p //= 2
    lib_n = lib_p * bs + wb
    # the chain's first lib_p blocks (F and rb, chain[3] and chain[5], have no block axis)
    K, rhs = dense_system(tuple(x if i in (3, 5) else x[:lib_p] for i, x in enumerate(chain)), lib_b)
    if lib_p == P:
        err = (torch.linalg.solve(K, rhs)[:, : P * bs, 0]
               - X[..., :lib_b].movedim(-1, 0).reshape(lib_b, -1)).abs().max().item()
        note = f"max diff to plain {err:.2e}"
    else:
        note = f"the chain's first {lib_p} blocks: {n}^2 would pass {LIBRARY_MAX_BYTES / 1e9:g} GB"
    ms = median_ms(lambda: torch.linalg.solve(K, rhs), calls=5 if lib_p == P else 3)
    del K, rhs
    return ms, lib_b, lib_p, lib_n, note


def phase_scan_vs_plain(scan, old=None):
    """The scan kernel against its plain version (`scan_solve_plain`, the
    structured solve's _scan_solve) at SCAN_SHAPES: one launch per call,
    agreement (max abs difference / (1 + max |x|) <= SCAN_TOL), the
    block-matvec residual of every instance, the device memory across the
    first launch, and the times of the kernel, the plain version and the
    library call (library_yardstick), beside the bound and the latency
    floor (scan_bound), µs per step and the resident chains per SM; with
    `old` (old_scan_kernel), the earlier kernel held to the current one bit
    for bit and both timed in turns. Returns one record per shape."""
    from torch_helpers import lane_residuals

    from ctdirect_tpu_torch.solver.scan_kernel import scan_solve_plain

    results = []
    for dtype, N, bs, wb, nb in SCAN_SHAPES:
        lane_chain = random_chain(N, bs, wb, nb, dtype, shift=4.0 + bs)  # lane-minor, N blocks
        A, Bp, E, F, r, rb = (x.movedim(-1, 0).contiguous() for x in lane_chain)
        chain = (A, Bp[:, : N - 1].contiguous(), E, F, r, rb)
        torch.cuda.synchronize()
        free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
        n0 = scan.launches
        X, xb = scan(*chain)
        torch.cuda.synchronize()
        if scan.launches != n0 + 1:
            raise AssertionError(f"scan kernel at N={N}: {scan.launches - n0} launches counted for one call")
        free1, total = torch.cuda.mem_get_info()
        outside = (free0 - free1) - (torch.cuda.memory_reserved() - reserved0)
        if not outside < 2**30:
            raise AssertionError(f"scan kernel at N={N} bs={bs} wb={wb} B={nb}: the first launch took "
                                 f"{outside / 2**30:.2f} GiB of device memory outside PyTorch's allocator")
        Xp, xbp = scan_solve_plain(*chain)
        torch.cuda.synchronize()
        for name, got, want in (("X", X, Xp), ("xb", xb, xbp)):
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"scan kernel {dtype} at N={N}: {name} not finite or of shape "
                                     f"{tuple(got.shape)}")
        err = max((X - Xp).abs().max().item(), (xb - xbp).abs().max().item())
        scale = 1.0 + max(Xp.abs().max().item(), xbp.abs().max().item())
        if not err <= SCAN_TOL[dtype] * scale:
            raise AssertionError(f"scan kernel vs plain {dtype} at N={N} bs={bs} wb={wb} B={nb}: max abs err "
                                 f"{err:.3e} > {SCAN_TOL[dtype]:.0e} x {scale:.3g}")
        resid = lane_residuals(lane_chain, X.permute(1, 2, 0), xb.T).max().item()
        if not resid < RESID_TOL[dtype]:
            raise AssertionError(f"scan kernel {dtype} at N={N} bs={bs} wb={wb} B={nb}: residual {resid:.3e}")
        ms = median_ms(lambda: scan(*chain))
        old_rec = {}
        if old is not None:
            Xo, xbo = old(*chain)
            old_dx = (X - Xo).abs().max().item()
            old_dxb = (xb - xbo).abs().max().item() if xb.numel() else 0.0
            if not (old_dx == 0.0 and old_dxb == 0.0):
                raise AssertionError(f"scan kernel {dtype} at N={N} bs={bs} wb={wb} B={nb}: not the earlier "
                                     f"kernel's bit for bit (max |dX| {old_dx:.3e}, max |dxb| {old_dxb:.3e})")
            turns = {"old": [], "new": []}
            for tag in ("old", "new", "new", "old"):
                fn = (lambda: old(*chain)) if tag == "old" else (lambda: scan(*chain))
                turns[tag].append(median_ms(fn, budget_ms=PLAIN_BUDGET_MS))
            old_rec = dict(old_ms=turns["old"], new_ms=turns["new"], old_max_abs_diff=max(old_dx, old_dxb))
            del Xo, xbo
        # the plain version's calls take seconds at the long chains: the comparison call
        # above is their warm-up, then 1-20 calls within PLAIN_BUDGET_MS
        plain = [event_ms(lambda: scan_solve_plain(*chain))]
        plain += [event_ms(lambda: scan_solve_plain(*chain))
                  for _ in range(min(20, int(PLAIN_BUDGET_MS / max(plain[0], 1e-3))) - 1)]
        plain_ms = float(np.median(plain))
        library_ms, lib_b, lib_n_blocks, lib_n, lib_note = library_yardstick(lane_chain, Xp.permute(1, 2, 0), nb)
        bound_ms, bound_by, nbytes, flops, floor_ms = scan_bound(dtype, N, bs, wb, nb)
        smem = scan.smem_bytes(bs, wb, torch.finfo(dtype).bits // 8)
        per_cta, resident = scan.launch_shape(bs, wb, nb, torch.finfo(dtype).bits // 8)
        if old_rec:
            log(f"  earlier scan kernel at N={N} bs={bs} wb={wb} B={nb} {dtype}: bitwise the current one (max "
                f"|dX| = max |dxb| = 0); old {old_rec['old_ms']} ms, new {old_rec['new_ms']} ms (in turns old, "
                f"new, new, old; CUDA events, median of up to 20)")
        log(f"scan kernel {dtype} at N={N} bs={bs} wb={wb} B={nb}: max abs err {err:.3e} vs plain (scale "
            f"{scale:.3g}), residual {resid:.3e} (every instance); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"library torch.linalg.solve {library_ms:.3f} ms at B={lib_b} (n={lib_n}, {lib_note}) (CUDA events, "
            f"median of 20 / 1-20 / 5 or 3); bound {1e3 * bound_ms:.3f} us set by {bound_by} ({nbytes / 1e6:.3f} "
            f"MB, {flops / 1e9:.4f} GFLOP), kernel at {100 * bound_ms / ms:.3f}% of it; latency floor (one "
            f"chain's operations on one SM) {1e3 * floor_ms:.3f} us, kernel at {100 * floor_ms / ms:.2f}% of "
            f"it; {1e3 * ms / N:.3f} us per step; one launch of {-(-nb // per_cta)} CTAs x {64 * per_cta} threads "
            f"({per_cta} chains a CTA, two warps and {smem} B of shared memory a chain), {resident} chains "
            f"resident per SM ({resident * SM_COUNT} on the card); device memory free "
            f"{free0 / 2**30:.2f} -> {free1 / 2**30:.2f} GiB of {total / 2**30:.2f}, {outside / 2**20:.1f} MiB "
            f"outside PyTorch's allocator")
        results.append(dict(dtype=str(dtype).replace("torch.", ""), N=N, bs=bs, wb=wb, B=nb, max_abs_err=err,
                            scale=scale, residual=resid, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            library_B=lib_b, library_N=lib_n_blocks, bound_us=1e3 * bound_ms, bound_by=bound_by,
                            floor_us=1e3 * floor_ms, us_per_step=1e3 * ms / N, floor_share=floor_ms / ms,
                            chains_per_cta=per_cta, resident_chains_per_sm=resident, smem_bytes=smem,
                            mem_outside_allocator_mib=outside / 2**20, **old_rec))
        del chain, lane_chain, A, Bp, E, F, r, rb, X, xb, Xp, xbp
    return results


def scan_record(path, dtype, launches, solves):
    """One path's scan kernel launches, which must be its structured block
    solves (warm-ups included), one CUDA launch each."""
    if not launches or launches != solves:
        raise AssertionError(f"{path}: {launches} scan kernel launches for {solves} structured block solves")
    return dict(path=path, dtype=str(dtype).replace("torch.", ""), launches=launches)


def solve_record(path, scan, sol):
    """scan_record of a compiled solve_docp / ct.solve on a new DOCP, from its
    infos (block solves + those of the segment warm-ups)."""
    return scan_record(path, torch.float64, scan.launches,
                       sol.infos["kkt_block_solves"] + sol.infos["kkt_warmup_block_solves"])


def phase_front_door(ct, get_problem, scan):
    """ct.solve(double integrator, N=100, trapeze) against its analytic
    oracles; its structured block solves on the scan kernel."""
    t0 = time.perf_counter()
    p = get_problem("double_integrator_minenergy")
    scan.reset_counts()
    sol = ct.solve(p.ocp, grid_size=N, scheme="trapeze", tol=1e-8, device="cuda")
    secs = time.perf_counter() - t0
    rec = solve_record("front_door_trapeze", scan, sol)
    if not sol.successful:
        raise AssertionError(f"front door: {sol.message}")
    t = sol.time_grid
    u = sol.control_values[:, 0]
    if not np.max(np.abs(u[2:-2] - (6 - 12 * t[2:-2]))) < 5e-3:
        raise AssertionError("front door: interior control error")
    np.testing.assert_allclose(sol.objective, 12.0, rtol=1e-2)
    Pc = sol.costate_values
    np.testing.assert_allclose(Pc[:-1, 0], 24.0, rtol=1e-2)
    tm = 0.5 * (t[:-1] + t[1:])
    np.testing.assert_allclose(Pc[:-1, 1], 12 - 24 * tm, rtol=1e-2, atol=0.05)
    log(f"front door: solve N={N} trapeze on cuda: status {sol.status}, {sol.iterations} "
        f"iterations, objective {sol.objective:.10g}, p(0) = {Pc[0]}, {secs:.2f} s wall; scan kernel launches "
        f"{rec['launches']} = structured block solves (warm-ups included)")
    return rec


def tick_run(tick, states, xs, warmup):
    """xs through `tick` from `states`, each tick timed by CUDA events and on
    the host clock (the first `warmup` untimed); returns the per-tick u0 and
    KKT, the final states, the times and the max KKT."""
    tick_ms, host_ms, u0s, kkts = [], [], [], []
    for k, x0 in enumerate(xs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        states, u0, kkt, viol = tick(states, x0)
        end.record()
        end.synchronize()
        if k >= warmup:
            tick_ms.append(start.elapsed_time(end))
            host_ms.append((time.perf_counter() - h0) * 1e3)
        u0s.append(u0)
        kkts.append(kkt)
    return dict(states=states, u0s=u0s, kkts=kkts, tick_ms=tick_ms, host_ms=host_ms,
                kkt_max=max(k.max().item() for k in kkts), viol=viol)


def eager_and_replayed(name, kernel, ctrl, states0, xs, warmup, batch):
    """Phase 5's (and 8's) comparison: the eager tick and the replayed CUDA
    graph from the same warm state over the same x0 sequence, the kernel's
    counts set to 0 just before each run and read just after; the graph is
    captured by one call before its counted run. Holds u0, KKT (every tick)
    and the final states of the replay to the eager tick (<= GRAPH_TOL abs).
    Returns both runs with their launches."""
    kernel.reset_counts()
    eager = tick_run(ctrl.eager, states0, xs, warmup)
    eager.update(launches=kernel.launches, grid=kernel.grid_launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctrl(states0, xs[0])  # the first call of this signature: warm-up, capture, replay
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    graph = next(iter(ctrl.graphs.values()))
    kernel.reset_counts()
    replay = tick_run(ctrl, states0, xs, warmup)
    replay.update(launches=kernel.launches, grid=kernel.grid_launches)
    for tag, run in (("eager", eager), ("replayed", replay)):
        if run["launches"] != len(xs) * ITERS:
            raise AssertionError(f"{name} {tag} tick: kernel launched {run['launches']} times, want "
                                 f"{len(xs) * ITERS}")
    if ctrl.captures != 1 or len(ctrl.graphs) != 1:
        raise AssertionError(f"{name}: {ctrl.captures} captures, {len(ctrl.graphs)} graphs, want 1")
    diffs = dict(
        u0=max((a - b).abs().max().item() for a, b in zip(replay["u0s"], eager["u0s"])),
        kkt=max((a - b).abs().max().item() for a, b in zip(replay["kkts"], eager["kkts"])),
        states=max((a - b).abs().max().item() for a, b in zip(replay["states"], eager["states"])))
    bitwise = all(torch.equal(a, b) for a, b in zip((*replay["u0s"], *replay["kkts"], *replay["states"]),
                                                      (*eager["u0s"], *eager["kkts"], *eager["states"])))
    if not max(diffs.values()) <= GRAPH_TOL:
        raise AssertionError(f"{name}: the replayed tick differs from the eager tick by {diffs} > {GRAPH_TOL:g}")
    for tag, run in (("eager", eager), ("replayed", replay)):
        p50, p90 = np.percentile(run["tick_ms"], 50), np.percentile(run["tick_ms"], 90)
        run.update(p50=p50, p90=p90)
        log(f"  {name} {tag} tick: {p50:.3f} ms p50 / {p90:.3f} ms p90 (CUDA events, {len(run['tick_ms'])} "
            f"timed), host {np.percentile(run['host_ms'], 50):.3f} ms p50 -> {batch / (p50 / 1e3):.1f} solves/s; "
            f"max KKT {run['kkt_max']:.3e}; kernel launches {run['launches']} ({run['grid']} CUDA launches)")
    log(f"  {name} replayed vs eager: max abs diff u0 {diffs['u0']:.3e}, KKT {diffs['kkt']:.3e}, states "
        f"{diffs['states']:.3e} ({'bitwise equal' if bitwise else 'not bitwise'}; bound {GRAPH_TOL:g}); "
        f"speed-up {eager['p50'] / replay['p50']:.2f}x at p50; first call {first_s:.3f} s (warm-up tick + "
        f"capture {graph.capture_s:.3f} s + replay), graph pool {graph.pool_bytes / 2**20:.1f} MiB")
    return dict(eager=eager, replay=replay, diffs=diffs, bitwise=bitwise, first_s=first_s,
                capture_s=graph.capture_s, pool_mib=graph.pool_bytes / 2**20)


def cold_start_graphs(docp, options):
    """How a controller's cold start ran: the compiled solve's segment
    graphs, capture seconds and iterations, from the DOCP's cached solver."""
    from ctdirect_tpu_torch.solver.interface import _get_solver

    run = _get_solver(docp, options)
    if not run.graphed or run.graph is None:
        raise AssertionError("cold start: not a compiled solve")
    return (f"compiled: {run.captures} segment graphs, capture {run.graph.capture_s:.3f} s, {run.stats.iterations} "
            f"iterations, {run.stats.host_syncs} host syncs")


def cold_start(ctrl, docp, scan, path, **kw):
    """A controller's cold start (the compiled structured solve), its scan
    kernel launches held to its block solves; returns (warm state, s, the
    path's record)."""
    from ctdirect_tpu_torch.solver.interface import _get_solver

    scan.reset_counts()
    t0 = time.perf_counter()
    warm = ctrl.cold_start(**kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return warm, secs, scan_record(path, torch.float64, scan.launches,
                                   _get_solver(docp, kw["options"]).kkt.block_solves)


def phase_main_path(ct, get_problem, kernel, scan, solve_dtype, xs):
    from ctdirect_tpu_torch.parallel.mpc import MPCController, broadcast_state

    p = get_problem("double_integrator_minenergy")
    docp = ct.transcribe(p.ocp, grid_size=N, scheme="trapeze", device="cuda")

    def make_ctrl():
        return MPCController(docp, x0_boundary_rows=[0, 1], resolve_iters=ITERS, kkt_algorithm="cr",
                             kkt_solve_dtype=solve_dtype, device="cuda")

    ctrl = make_ctrl()
    cold_opts = ct.IPMOptions(tol=1e-8, max_iter=60)
    name = "f32" if solve_dtype == torch.float32 else "f64"
    warm, cold_s, cold = cold_start(ctrl, docp, scan, f"mpc_cold_start_double_integrator_{name}_run",
                                    options=cold_opts)
    log(f"main path, {name} block solve: cold start {cold_s:.2f} s ({cold_start_graphs(docp, cold_opts)}; scan "
        f"kernel launches {cold['launches']} = structured block solves); {len(xs)} ticks x B={B} N={N} x {ITERS} "
        f"Newton steps, eager and replayed")
    both = eager_and_replayed(f"{name} block solve", kernel, ctrl, broadcast_state(warm, B), xs, WARMUP_TICKS, B)
    replay = both["replay"]
    u0 = replay["u0s"][-1]
    if u0.shape != (B, 1) or not torch.isfinite(u0).all():
        raise AssertionError(f"{name} tick: u0 not finite or wrong shape {tuple(u0.shape)}")
    for tag in ("eager", "replay"):
        if not both[tag]["kkt_max"] < 1e-10:
            raise AssertionError(f"{name} {tag} tick: max KKT {both[tag]['kkt_max']:.3e} >= 1e-10")
    per = grid_per_solve(chain_blocks(N))
    return dict(paths=[path_record("mpc_tick_double_integrator", solve_dtype, replay["launches"], replay["grid"],
                                   replay["launches"] * per),
                       path_record("mpc_tick_double_integrator_eager", solve_dtype, both["eager"]["launches"],
                                   both["eager"]["grid"], both["eager"]["launches"] * per)],
                scan_paths=[cold], u0=u0, ctrl=ctrl, make_ctrl=make_ctrl, states=replay["states"], warm=warm, both=both)


def ticking(tick, states, xs, ticks, want=None):
    """A call that runs `ticks` ticks of `tick` from `states` over xs and
    returns `want` (profiling.kernel_events' planned count)."""
    def run():
        s = states
        for x0 in xs[:ticks]:
            s, *_ = tick(s, x0)
        return want
    return run


def seen_note(rec):
    """What the profiler lost on the way (profiling.kernel_events)."""
    return f"; CUPTI dropped {rec['dropped']} activity records over {rec['tries']} profiles"


def stage_split(make_ctrl, states, xs, ticks):
    """Device ms per tick by stage of the eager tick (utils/profiling.py's
    stage_split), for a controller built by make_ctrl() while these run in
    profiler ranges (for this run only): `mpc.shift_state` (shift), the
    resolve's gradients and vector-Jacobian products (derivatives: grad f,
    J^T lam), and the KKT operator's prepare, _assemble, _block_solve and
    the rest of its solve (kkt_ranges). A kernel launched outside every
    range goes to "update" (x0 rows, barrier terms, residuals, the step to
    the boundary, the state update, the exit norms). The replay runs the
    same kernels in the same order."""
    from ctdirect_tpu_torch.parallel import mpc
    from ctdirect_tpu_torch.solver import resolve
    from ctdirect_tpu_torch.utils import profiling
    from ctdirect_tpu_torch.utils.profiling import device_profile, kkt_ranges, ranged

    grad, vjp, shift = resolve.grad, resolve.vjp, mpc.shift_state

    def vjp_ranged(fn, *primals):
        out, back = ranged("derivatives", vjp)(fn, *primals)
        return out, ranged("derivatives", back)

    resolve.grad, resolve.vjp = (lambda fn: ranged("derivatives", grad(fn))), vjp_ranged
    mpc.shift_state = ranged("shift", shift)
    try:
        ctrl = make_ctrl()
        with kkt_ranges(ctrl.kkt):
            _, prof, _, _ = device_profile(ticking(ctrl.eager, states, xs, ticks))
    finally:
        resolve.grad, resolve.vjp, mpc.shift_state = grad, vjp, shift
    return profiling.stage_split(prof, ticks, outside="update")


def phase_device_split(name, ctrl, make_ctrl, states, xs, ticks=5, P=None):
    """Device busy/idle share of a few eager and replayed ticks, the CR
    kernel's part, and its CUDA launches per replayed tick seen by the
    profiler (the witness that the graph runs the kernel, apart from the
    wrapper's counts): ITERS x the plan's launches of one solve
    (profiling.kernel_events, which raises otherwise). Then the stage split
    of the eager tick (stage_split)."""
    from ctdirect_tpu_torch.utils.profiling import kernel_events

    P = P or chain_blocks(N)
    want = ITERS * grid_per_solve(P)
    out = {}
    for tag, tick in (("eager", ctrl.eager), ("replayed", ctrl)):
        try:
            rec = kernel_events(ticking(tick, states, xs, ticks, want * ticks))
        except AssertionError as e:
            raise AssertionError(f"{name} {tag}, CR kernel over {ticks} ticks: {e}") from None
        prof, wall, totals = rec["prof"], rec["wall"] / ticks * 1e3, rec["totals"]
        busy, cr = totals["busy"] / ticks * 1e3, totals["cr"] / ticks * 1e3
        cr_launches = rec["seen"] / ticks
        launches = totals["events"] / ticks
        if not busy > 0:
            seen = sorted({e.key for e in prof.key_averages()})[:40]
            raise AssertionError(f"{name} {tag}: the profiler saw no device time; it saw {seen}")
        out[tag] = dict(wall=wall, busy=busy, cr=cr, cr_launches=cr_launches, launches=launches,
                        dropped=rec["dropped"])
        log(f"device split, {name} {tag} ({ticks} ticks under torch.profiler): wall {wall:.3f} ms/tick, "
            f"device busy {busy:.3f} ms/tick ({100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%), "
            f"CR kernel {cr:.3f} ms/tick ({100 * cr / busy:.1f}% of busy, {cr_launches:.0f} CUDA launches of it "
            f"seen per tick, planned {want}), other kernels {busy - cr:.3f} ms/tick, {launches:.0f} kernel "
            f"launches/tick{seen_note(rec)}")
    split = stage_split(make_ctrl, states, xs, ticks)
    total = sum(split.values())
    log(f"  stage split, {name} (eager tick, device ms per tick, {ticks} ticks): "
        + ", ".join(f"{k} {v:.3f} ({100 * v / total:.1f}%)" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
        + f"; sum {total:.3f}")
    out["stages"] = split
    return out


def path_record(path, dtype, launches, grid, want_grid):
    """One path's block solves (`launches`) and CUDA launches, which must be
    the planned launches of those solves."""
    if not launches or grid != want_grid:
        raise AssertionError(f"{path}: {launches} solves, {grid} CUDA launches, planned {want_grid}")
    return dict(path=path, dtype=str(dtype).replace("torch.", ""), launches=launches, grid_launches=grid)


def phase_front_door_default(ct, get_problem, scan, device="cuda"):
    """ct.solve with no scheme= (midpoint, the default) against the oracles;
    its structured block solves on the scan kernel."""
    t0 = time.perf_counter()
    scan.reset_counts()
    sol = ct.solve(get_problem("double_integrator_minenergy").ocp, grid_size=N, tol=1e-8, device=device)
    secs = time.perf_counter() - t0
    rec = solve_record("front_door_midpoint", scan, sol)
    if not sol.successful:
        raise AssertionError(f"default-scheme front door: {sol.message}")
    t = sol.time_grid
    tm = 0.5 * (t[:-1] + t[1:])  # midpoint controls live at the step midpoints
    u = sol.control_values[:-1, 0]
    if not np.max(np.abs(u - (6 - 12 * tm))) < 5e-3:
        raise AssertionError("default-scheme front door: control error")
    np.testing.assert_allclose(sol.objective, 12.0, rtol=1e-2)
    Pc = sol.costate_values
    np.testing.assert_allclose(Pc[:-1, 0], 24.0, rtol=1e-2)
    np.testing.assert_allclose(Pc[:-1, 1], 12 - 24 * tm, rtol=1e-2, atol=0.05)
    log(f"front door, default scheme (midpoint): solve N={N} on {device}: status "
        f"{sol.status}, {sol.iterations} iterations, objective {sol.objective:.10g}, p(0) = {Pc[0]}, "
        f"{secs:.2f} s wall; scan kernel launches {rec['launches']} = structured block solves (warm-ups included)")
    return rec


def cartpole_x0(rng, batch):
    """Measured initial states around the hanging rest position
    (benchmarks/mpc_cartpole.py)."""
    return 0.02 * rng.standard_normal((batch, 4)) * np.array([1.0, 1.0, 0.5, 0.5])


def phase_cartpole_tick(ct, get_problem, kernel, scan, device="cuda"):
    from ctdirect_tpu_torch.parallel.mpc import MPCController, broadcast_state

    prob = get_problem("cartpole")
    docp = ct.transcribe(prob.ocp, grid_size=CP_N, scheme="trapeze", device=device)

    def make_ctrl():
        return MPCController(docp, x0_boundary_rows=[0, 1, 2, 3], resolve_iters=ITERS, kkt_algorithm="cr",
                             device=device)

    ctrl = make_ctrl()
    cold_opts = ct.IPMOptions(tol=1e-8, max_iter=200)
    warm, cold_s, cold = cold_start(ctrl, docp, scan, "mpc_cold_start_cartpole", options=cold_opts, init=prob.init)
    states0 = broadcast_state(warm, CP_B)
    rng = np.random.default_rng(0)
    xs = [torch.tensor(cartpole_x0(rng, CP_B), dtype=torch.float64, device=device)
          for _ in range(CP_WARMUP + CP_TICKS)]

    log(f"cart-pole tick, f64 block solve: cold start {cold_s:.2f} s ({cold_start_graphs(docp, cold_opts)}; scan "
        f"kernel launches {cold['launches']} = structured block solves); {len(xs)} ticks x B={CP_B} N={CP_N} x {ITERS} Newton steps, eager and replayed")
    both = eager_and_replayed("cart-pole", kernel, ctrl, states0, xs, CP_WARMUP, CP_B)
    replay = both["replay"]
    u0, states = replay["u0s"][-1], replay["states"]
    if u0.shape != (CP_B, 1) or not torch.isfinite(u0).all():
        raise AssertionError(f"cart-pole tick: u0 not finite or wrong shape {tuple(u0.shape)}")
    if not u0.abs().max().item() <= CP_UMAX * (1 + 1e-6):
        raise AssertionError(f"cart-pole tick: |u0| {u0.abs().max().item():.6g} beyond the force box")
    u_all = states.z[:, docp.control_col_indices()]
    sat = (torch.abs(u_all.abs() - CP_UMAX) < 1e-6).double().mean().item()
    log(f"cart-pole tick: max KKT {replay['kkt_max']:.3e}, max violation {replay['viol'].max().item():.3e} "
        f"(last tick), saturated force nodes {100 * sat:.2f}%")
    split = phase_device_split("cart-pole", ctrl, make_ctrl, states0, xs, ticks=3, P=chain_blocks(CP_N))
    per = grid_per_solve(chain_blocks(CP_N))
    return dict(paths=[path_record("mpc_tick_cartpole", torch.float64, replay["launches"], replay["grid"],
                                   replay["launches"] * per),
                       path_record("mpc_tick_cartpole_eager", torch.float64, both["eager"]["launches"],
                                   both["eager"]["grid"], both["eager"]["launches"] * per)],
                scan_paths=[cold], docp=docp, warm=warm, both=both, split=split)


def phase_cartpole_batch(ct, kernel, docp, warm, device="cuda"):
    """BatchSolver over per-instance x0 scenarios from the cold-start
    solution, three times: eager, the first graphed call (captures) and a
    second one (replay only); the graphed results held to the eager ones,
    then one more graphed call under torch.profiler."""
    from ctdirect_tpu_torch.parallel import BatchSolver
    from ctdirect_tpu_torch.solver.graph import result_diff
    from ctdirect_tpu_torch.solver.interface import _get_solver
    from ctdirect_tpu_torch.solver.ipm import BatchStats
    from ctdirect_tpu_torch.utils.profiling import profiled_solve

    opts = ct.IPMOptions(tol=1e-6, max_iter=30, lsq_lambda_init=False, kkt_mode="cr")
    solver = BatchSolver(docp, opts, device=device)
    rows = docp.boundary_row_indices()[:4]
    x0 = cartpole_x0(np.random.default_rng(0), CP_BATCH)
    cl, cu = np.tile(docp._c_lb, (CP_BATCH, 1)), np.tile(docp._c_ub, (CP_BATCH, 1))
    cl[:, rows] += x0
    cu[:, rows] += x0
    z0 = warm.z.expand(CP_BATCH, -1)
    per = grid_per_solve(chain_blocks(CP_N))
    log(f"cart-pole batch solve, f64 cr: B={CP_BATCH} N={CP_N} tol {opts.tol:g}, <= {opts.max_iter} iterations; "
        f"eager, first graphed call, graphed replay")

    runs = {}
    for tag, fn in (("eager", solver.eager), ("first graphed call", solver), ("graphed replay", solver)):
        solver.stats = BatchStats()
        graph = solver.graphs.get(CP_BATCH)
        capture_s0 = graph.capture_s if graph else 0.0
        warm0 = graph.warmup_added[kernel, "launches"] if graph else 0
        kernel.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(z0, cl, cu)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, grid = kernel.launches, kernel.grid_launches
        st, graph = solver.stats, solver.graphs.get(CP_BATCH)
        warmups = graph.warmup_added[kernel, "launches"] - warm0 if fn is solver else 0
        if launches != st.kkt_solves + warmups:
            raise AssertionError(f"batch solve, {tag}: kernel launched {launches} times, {st.kkt_solves} batched KKT "
                                 f"solves + {warmups} in segment warm-ups")
        if res.z.shape != (CP_BATCH, docp.nz) or not torch.isfinite(res.z).all():
            raise AssertionError(f"batch solve, {tag}: z not finite or wrong shape")
        runs[tag] = dict(res=res, stats=st, wall=wall, launches=launches, grid=grid)
        line = (f"  {tag}: {wall:.3f} s wall -> {CP_BATCH / wall:.1f} solves/s; {st.iterations} batch iterations, "
                f"{st.kkt_solves} batched KKT solves, {st.host_syncs} host syncs "
                f"({st.host_syncs / max(st.iterations, 1):.2f} per iteration); kernel launches {launches} "
                f"({grid} CUDA launches)")
        if fn is solver:
            diff = result_diff(res, runs["eager"]["res"])
            bitwise = all(torch.equal(a, b) for a, b in zip(res, runs["eager"]["res"]))
            if not (diff <= GRAPH_TOL and st == runs["eager"]["stats"]):
                raise AssertionError(f"batch solve, {tag}: differs from the eager solve by {diff:.3e} "
                                     f"(bound {GRAPH_TOL:g}), stats {st} vs {runs['eager']['stats']}")
            line += (f"; {warmups} warm-up launches; capture {graph.capture_s - capture_s0:.3f} s, "
                     f"{solver.captures} segment graphs, pool {graph.pool_bytes / 2**20:.1f} MiB; vs eager: max abs "
                     f"diff {diff:.3e} over every field and instance ({'bitwise equal' if bitwise else 'not bitwise'}; "
                     f"bound {GRAPH_TOL:g}), same solves, syncs and segment runs")
        log(line)
    log(f"  segment runs per solve: {runs['eager']['stats'].segments}; speed-up of the replay over the eager solve "
        f"{runs['eager']['wall'] / runs['graphed replay']['wall']:.2f}x")

    res = runs["graphed replay"]["res"]
    ok = res.successful.double().mean().item()
    its = res.iterations.cpu().numpy()
    if not ok >= CP_MIN_CONVERGED:
        raise AssertionError(f"batch solve: converged share {ok:.4f} < {CP_MIN_CONVERGED}")
    log(f"  converged {100 * ok:.2f}%, median iterations {np.median(its):.0f} (max {its.max()})")

    # the device split of one more graphed solve (each profile taken runs it), held to the replay
    solver.stats = BatchStats()
    profiled = []
    try:
        split = profiled_solve(lambda: profiled.append(solver(z0, cl, cu)), lambda: solver.stats.kkt_solves, per)
    except AssertionError as e:
        raise AssertionError(f"batch solve, CR kernel: {e}") from None
    diff = max(result_diff(r, res) for r in profiled)
    if not diff <= GRAPH_TOL:
        raise AssertionError(f"batch solve under torch.profiler: differs from the graphed replay by {diff:.3e} "
                             f"(bound {GRAPH_TOL:g}) in one of its {len(profiled)} profiles")
    wall, busy, cr, cr_launches = split["wall"], split["busy"], split["cr"], split["cr_launches"]
    replay = runs["graphed replay"]["wall"]
    log(f"  device split, graphed solve under torch.profiler: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%; idle {100 * (1 - busy / replay):.1f}% of "
        f"the unprofiled replay's {replay:.3f} s), CR kernel {cr:.3f} s ({100 * cr / busy:.1f}% of busy, "
        f"{cr_launches} CUDA launches of it seen = {cr_launches // per} solves x {per}), {split['launches']} "
        f"kernel launches{seen_note(split)}; max abs diff from the replay {diff:.3e}")

    run = _get_solver(docp, opts)
    for b in CP_CHECK:
        r, _ = run(warm.z, docp._z_lb, docp._z_ub, cl[b], cu[b])
        same = int(r.status) == int(res.status[b]) and int(r.iterations) == int(res.iterations[b])
        rel = abs(float(r.objective) - float(res.objective[b])) / max(1.0, abs(float(r.objective)))
        if not (same and rel <= 1e-8):
            raise AssertionError(
                f"batch solve: instance {b} batched (status {int(res.status[b])}, {int(res.iterations[b])} it, "
                f"objective {float(res.objective[b])!r}) vs unbatched (status {int(r.status)}, "
                f"{int(r.iterations)} it, objective {float(r.objective)!r})")
        log(f"  instance {b}: status {int(r.status)}, {int(r.iterations)} iterations, objective "
            f"{float(r.objective):.12g} batched and unbatched (rel diff {rel:.1e})")
    names = {"graphed replay": "batch_solve_cartpole", "first graphed call": "batch_solve_cartpole_first_call",
             "eager": "batch_solve_cartpole_eager"}
    return dict(paths=[path_record(names[tag], torch.float64, r["launches"], r["grid"], r["launches"] * per)
                       for tag, r in runs.items()], split=split)


def timed_solve(kernel, fn):
    """fn() with the kernel counts reset just before; returns (its result,
    wall s, launches, CUDA launches)."""
    kernel.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, kernel.launches, kernel.grid_launches


def solve_diff(a, b):
    """Max abs difference of two (IPMResult, postprocess) pairs over every
    field (inf where their NaNs or non-float fields differ)."""
    from ctdirect_tpu_torch.solver.graph import result_diff

    worst = 0.0
    for x, y in zip((*a[0], *a[1]), (*b[0], *b[1])):
        if not isinstance(x, torch.Tensor):
            worst = max(worst, 0.0 if x == y else float("inf"))
            continue
        worst = max(worst, result_diff([x], [y]))
    return worst


def phase_goddard(ct, get_problem, kernel, kres):
    """BASELINE config 2 on one transcribed DOCP per block solve (f64, and
    f32 + refinement + Ruiz), three times: the eager solve (`run.eager`),
    the first compiled solve_docp (its segment graphs captured) and a
    replayed one; the replay held to the same B=1 program run op by op and
    to the eager solve, then one more replay under torch.profiler."""
    from ctdirect_tpu_torch.solver.graph import BatchGraph, graph_counters
    from ctdirect_tpu_torch.solver.interface import _get_solver
    from ctdirect_tpu_torch.solver.ipm import BatchStats
    from ctdirect_tpu_torch.utils.profiling import profiled_solve

    p = get_problem("goddard")
    per = grid_per_solve(chain_blocks(GD_N))
    sols, paths, rows = {}, [], {}
    for tag, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        opts = ct.IPMOptions(kkt_solve_dtype=None if tag == "f64" else "f32", **GD_OPTS)
        docp = ct.transcribe(p.ocp, grid_size=GD_N, scheme=GD_SCHEME, device="cuda")
        run = _get_solver(docp, opts)
        args = (docp.initial_guess(p.init), docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
        log(f"goddard GL2 N={GD_N} cr, {tag} block solve{' + 2 refinement sweeps + Ruiz' * (tag == 'f32')}: "
            f"eager, first compiled call, replayed call (one DOCP)")
        blocks0 = run.kkt.block_solves
        (eager, _), wall, launches, grid = timed_solve(kernel, lambda: run.eager(*args))
        if launches != run.kkt.block_solves - blocks0:
            raise AssertionError(f"goddard {tag} eager: kernel launched {launches} times, "
                                 f"{run.kkt.block_solves - blocks0} block solves")
        paths.append(path_record(f"goddard_gl2_N{GD_N}_{tag}_eager", dtype, launches, grid, launches * per))
        share = launches * shape_ms(kres, dtype, P_GD, BS_GD, WB_GD, 1) / 1e3 / wall
        log(f"  eager: status {eager.status}, {eager.iterations} iterations, objective {float(eager.objective)!r}, "
            f"{wall:.3f} s wall; kernel launches {launches} = block solves ({grid} CUDA launches); kernel share "
            f"{100 * share:.1f}% (launches x phase-3 ms / wall)")
        row = dict(eager_s=wall, eager_iterations=eager.iterations)
        for call, suffix in (("first compiled call", "_first_call"), ("replayed call", "")):
            run.stats = BatchStats()
            capture0 = run.graph.capture_s if run.graph else 0.0
            sol, wall, launches, grid = timed_solve(kernel, lambda: ct.solve_docp(docp, init=p.init, options=opts))
            blocks, warm = sol.infos["kkt_block_solves"], sol.infos["kkt_warmup_block_solves"]
            if launches != blocks + warm or (warm != 0) != (suffix == "_first_call"):
                raise AssertionError(f"goddard {tag} {call}: kernel launched {launches} times, {blocks} block "
                                     f"solves + {warm} in segment warm-ups")
            if not sol.successful:
                raise AssertionError(f"goddard {tag} {call}: {sol.message}")
            if not abs(sol.objective - GD_OBJ) <= 1e-2 * GD_OBJ:
                raise AssertionError(f"goddard {tag} {call}: objective {sol.objective!r} vs {GD_OBJ}")
            if not np.isfinite(sol.control_values).all() or sol.control_values.shape != (GD_N + 1, 1):
                raise AssertionError(f"goddard {tag} {call}: controls not finite or of shape "
                                     f"{sol.control_values.shape}")
            st = run.stats
            paths.append(path_record(f"goddard_gl2_N{GD_N}_{tag}{suffix}", dtype, launches, grid, launches * per))
            log(f"  {call}: status {sol.status}, {sol.iterations} iterations, objective {sol.objective!r}, tf "
                f"{sol.variable[0]:.6f}, {wall:.3f} s wall; {st.host_syncs} host syncs "
                f"({st.host_syncs / max(st.iterations, 1):.2f} per iteration), {st.kkt_solves} KKT solves; kernel "
                f"launches {launches} = {blocks} block solves + {warm} in segment warm-ups ({grid} CUDA launches); "
                f"capture {run.graph.capture_s - capture0:.3f} s, {run.captures} segment graphs, pool "
                f"{run.graph.pool_bytes / 2**20:.1f} MiB")
            row[call] = dict(wall=wall, syncs=st.host_syncs / max(st.iterations, 1), launches=launches)
        row.update(capture_s=run.graph.capture_s, captures=run.captures, pool_mib=run.graph.pool_bytes / 2**20)

        # the replay against the same B=1 program op by op, and against the eager solve
        run.stats = BatchStats()
        got = run(*args)
        counts, run.stats = run.stats, BatchStats()
        ref = run.batched(BatchGraph(run.program.segments, graph_counters(run.kkt), "cuda", capture=False), *args)
        diff = solve_diff(got, ref)
        if not (diff <= GRAPH_TOL and counts == run.stats):
            raise AssertionError(f"goddard {tag}: the replay differs from the B=1 program op by op by {diff:.3e} "
                                 f"(bound {GRAPH_TOL:g}), stats {counts} vs {run.stats}")
        res = got[0]
        rel = abs(float(res.objective) - float(eager.objective)) / abs(float(eager.objective))
        if not (res.status == eager.status and rel <= 1e-8):
            raise AssertionError(f"goddard {tag}: compiled status {res.status}, objective {float(res.objective)!r} "
                                 f"vs eager status {eager.status}, {float(eager.objective)!r}")
        log(f"  replay vs the B=1 program op by op: max abs diff {diff:.3e} over every field "
            f"({'bitwise equal' if diff == 0 else 'not bitwise'}; bound {GRAPH_TOL:g}), same KKT solves, syncs and "
            f"segment runs; vs eager: status {res.status} both, iterations {res.iterations} compiled vs "
            f"{eager.iterations} eager, objective rel diff {rel:.2e} (bound 1e-8); speed-up of the replay over the "
            f"eager solve {row['eager_s'] / row['replayed call']['wall']:.2f}x")

        profiled = []
        try:
            split = profiled_solve(lambda: profiled.append(run(*args)), lambda: run.kkt.block_solves, per)
        except AssertionError as e:
            raise AssertionError(f"goddard {tag}, a replayed solve's CR kernel (block solves x {per}): {e}") from None
        pdiff = max(solve_diff(r, got) for r in profiled)
        if not pdiff <= GRAPH_TOL:
            raise AssertionError(f"goddard {tag}: a replay under torch.profiler differs from the replay by "
                                 f"{pdiff:.3e} (bound {GRAPH_TOL:g}) in one of its {len(profiled)} profiles")
        want = split["cr_launches"]
        log(f"  device split, replayed solve under torch.profiler: wall {split['wall']:.3f} s, device busy "
            f"{split['busy']:.3f} s ({100 * split['busy'] / split['wall']:.1f}%, idle "
            f"{100 * (1 - split['busy'] / split['wall']):.1f}%), CR kernel {split['cr']:.3f} s "
            f"({100 * split['cr'] / split['busy']:.1f}% of busy, {split['cr_launches']} CUDA launches of it seen = "
            f"{want // per} block solves x {per}), {split['launches']} kernel launches{seen_note(split)}; max abs "
            f"diff from the replay {pdiff:.3e}")
        row["split"] = split
        sols[tag], rows[tag] = sol, row
    dobj = abs(sols["f32"].objective - sols["f64"].objective) / abs(sols["f64"].objective)
    du = np.max(np.abs(sols["f32"].control_values - sols["f64"].control_values))
    if not (dobj <= 1e-7 and du <= 1e-4):
        raise AssertionError(f"goddard f32 vs f64: objective rel diff {dobj:.3e}, controls {du:.3e}")
    log(f"goddard f32 vs f64: objective rel diff {dobj:.3e}, controls L-inf {du:.3e}")
    return dict(sols=sols, paths=paths, rows=rows)


def phase_sweep(tag, cells, kernel, profile):
    """`cells` through ctdirect_tpu_torch.sweep's run_sweep and checks on the
    card (phase 11: the suite at N=250, unprofiled; phase 16: LADDER_CUT,
    goddard_all profiled once per rung), with the kernel's counts set to 0
    just before and read just after, then its ladder table. Returns the
    path's kernel record."""
    from ctdirect_tpu_torch import sweep

    log(f"{tag}: ctdirect_tpu_torch.sweep.run_sweep over {len(cells)} cells (trapeze, the sweep's options"
        f"{', goddard_all profiled once per rung' if profile else ''})")
    kernel.reset_counts()
    rows = sweep.run_sweep(cells, device="cuda", profile=profile, log=log)
    launches, grid = kernel.launches, kernel.grid_launches
    summary = sweep.report(rows, log=log)
    if not summary["ok"]:
        raise AssertionError(f"{tag}: cells not green or failing a check: {summary['bad']}")
    # each cell's block solves (warm-ups, and every profile taken, included) and their planned CUDA launches
    counted, planned = 0, 0
    for r in rows:
        solves = sum(r[c]["block_solves"] + r[c]["warmup_block_solves"] for c in ("first", "replay"))
        solves += r["profile"]["block_solves"] if "profile" in r else 0
        counted += solves
        planned += solves * grid_per_solve(r["P"])
    if launches != counted:
        raise AssertionError(f"{tag}: the kernel counted {launches} launches, its cells {counted} block solves")
    return path_record(tag, torch.float32, launches, grid, planned)


def phase_grid_continuation(ct, get_problem, kernel, cold):
    """Goddard GL2 coarse to fine with phase 10's f32 options."""
    from ctdirect_tpu_torch.solver import grid_continuation

    p = get_problem("goddard")
    opts = ct.IPMOptions(kkt_solve_dtype="f32", **GD_OPTS)
    sols, wall, launches, grid = timed_solve(kernel, lambda: grid_continuation(
        p.ocp, GC_GRIDS, scheme=GD_SCHEME, options=opts, init=p.init, device="cuda"))
    per_stage = [s.infos["kkt_block_solves"] + s.infos["kkt_warmup_block_solves"] for s in sols]
    if launches != sum(per_stage):
        raise AssertionError(f"grid continuation: kernel launched {launches} times, {per_stage} block solves "
                             f"(warm-ups included) per stage")
    final = sols[-1]
    rel = abs(final.objective - GC_JAX_CPU) / abs(GC_JAX_CPU)
    if not (final.successful and rel <= 1e-6):
        raise AssertionError(f"grid continuation: {final.message}, objective {final.objective!r}, rel diff "
                             f"{rel:.3e} to the JAX package's {GC_JAX_CPU!r}")
    # the warm start resampled from the coarse solution lands on the card
    docp = ct.transcribe(p.ocp, grid_size=GC_GRIDS[-1], scheme=GD_SCHEME, device="cuda")
    z0 = docp.tensor(docp.initial_guess(ct.InitialGuess.from_solution(sols[0])))
    if z0.device.type != docp.device.type or z0.shape != (docp.nz,) or not torch.isfinite(z0).all():
        raise AssertionError(f"grid continuation: warm start on {z0.device}, shape {tuple(z0.shape)}")
    its = " + ".join(f"{s.iterations} (N={n_})" for s, n_ in zip(sols, GC_GRIDS))
    log(f"grid continuation goddard GL2 {GC_GRIDS}, f32 cr: final status {final.status}, objective "
        f"{final.objective!r} (rel diff {rel:.2e} to the JAX package's at N={GC_GRIDS[-1]} on the CPU, "
        f"{abs(final.objective - cold.objective) / abs(cold.objective):.2e} to phase 10's at N={GD_N}), "
        f"iterations {its} vs {cold.iterations} cold at N={GD_N}; {wall:.2f} s wall (compiled, "
        f"{sum(s.infos['captures'] for s in sols)} segment graphs captured); kernel launches {launches} = block "
        f"solves + their warm-ups ({grid} CUDA launches)")
    want = sum(k * grid_per_solve(chain_blocks(n_)) for k, n_ in zip(per_stage, GC_GRIDS))
    return path_record(f"grid_continuation_goddard_{'_'.join(map(str, GC_GRIDS))}", torch.float32, launches,
                       grid, want)


def fuel_integral(sol):
    """Unsmoothed trapezoid of |u(t)| of the returned control
    (tests/test_all_ocp.py:115-122)."""
    mag = np.sqrt((np.asarray(sol.control_values) ** 2).sum(axis=1))
    trapz = getattr(np, "trapezoid", None) or np.trapz
    return float(trapz(mag, np.asarray(sol.control_grid)))


def ci_verdict(name, prob, cfg, sol):
    """The JAX CI's oracle (tests/test_all_ocp.py:147-168): '' when it holds,
    else what failed."""
    if name == "orbit_transfer":
        fuel = fuel_integral(sol)
        if not 0.1816 <= fuel <= prob.obj + 1e-3 * 11.0 + 0.005:
            return f"fuel integral {fuel!r} outside [0.1816, {prob.obj + 1e-3 * 11.0 + 0.005!r}]"
    if not sol.successful:
        return f"not successful: {sol.message}"
    if prob.obj is None:
        return ""
    if name in CI_BETTER_OK:
        sense = -1.0 if prob.ocp.maximize else 1.0
        if sense * (prob.obj - sol.objective) < -cfg.rtol * abs(prob.obj):
            return f"objective {sol.objective!r} worse than the stored {prob.obj!r} beyond rtol {cfg.rtol:g}"
        if abs(sol.objective - prob.obj) > CI_BETTER_BAND * abs(prob.obj):
            return f"objective {sol.objective!r} outside the {CI_BETTER_BAND:g} band around {prob.obj!r}"
        return ""
    if abs(sol.objective - prob.obj) > cfg.rtol * abs(prob.obj):
        return f"objective {sol.objective!r} vs stored {prob.obj!r} beyond rtol {cfg.rtol:g}"
    return ""


def ci_solve(ct, prob, cfg, opts, device="cuda"):
    """One fixture under its CI recipe: (Solution per stage, grid per stage)."""
    from ctdirect_tpu_torch.solver import grid_continuation

    if cfg.pre_grids:
        grids = cfg.pre_grids + [cfg.grid]
        warm = opts if cfg.warm_mu is None else opts.replace(mu_init=cfg.warm_mu)
        sols = grid_continuation(prob.ocp, grids, scheme=cfg.scheme, options=opts, warm_options=warm,
                                 init=prob.init, device=device)
        return sols, grids
    docp = ct.transcribe(prob.ocp, grid_size=cfg.grid, scheme=cfg.scheme, device=device)
    sol = ct.solve_docp(docp, init=prob.init, options=opts)
    docp.release_solvers()  # as ct.solve does: the graphs go with the DOCP
    return [sol], [cfg.grid]


def trace_cr_events(path):
    """CUDA kernel events of the CR kernel in a Chrome trace."""
    from ctdirect_tpu_torch.utils.profiling import CR_KERNELS

    events = json.loads(Path(path).read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel" and CR_KERNELS.search(e.get("name", ""))]


def ci_fixture(name):
    """Phase 13's solve of one fixture, in a worker process of its pool:
    its recipe on the card with the kernel counts reset just before and read
    just after (its block solves on the CR kernel under "cr", on the scan
    kernel under "structured", and none on the other), the oracle's verdict,
    and for CI_TRACED the CR kernel's CUDA events in its Chrome trace."""
    from torch.profiler import ProfilerActivity

    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.cr_kernel import BUILD_DIR
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel
    from ctdirect_tpu_torch.solver.scan_kernel import scan_solve_batched as scan
    from ctdirect_tpu_torch.utils.profiling import TRACE_FILE, Timings, timed, trace

    torch.set_num_threads(1)
    prob, cfg = get_problem(name), CI_CONFIG.get(name, Cfg())
    opts = ct.IPMOptions(**{**cfg.opts, "kkt_mode": "cr", **CI_CARD_OVERRIDES.get(name, {})})
    trace_dir = BUILD_DIR / f"trace_{name}"
    timings = Timings()
    kernel.reset_counts()
    scan.reset_counts()
    with contextlib.ExitStack() as stack:
        if name == CI_TRACED:
            stack.enter_context(trace(str(trace_dir), [ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        with timed(name, timings, sync=torch.device("cuda")):
            sols, grids = ci_solve(ct, prob, cfg, opts)
    launches, grid, scan_launches = kernel.launches, kernel.grid_launches, scan.launches
    # each stage's DOCP is new, so each solve captures its graphs (warm-ups
    # included); the dense solve has no block solves
    solves = [s.infos.get("kkt_block_solves", 0) + s.infos.get("kkt_warmup_block_solves", 0) for s in sols]
    cr = opts.kkt_mode == "cr"
    want = (sum(solves), sum(k * grid_per_solve(chain_blocks(g)) for k, g in zip(solves, grids))) if cr else (0, 0)
    want_scan = sum(solves) if opts.kkt_mode == "structured" else 0
    if (launches, grid, scan_launches) != (*want, want_scan):
        raise AssertionError(f"fixture CI {name}: CR kernel launched {launches} times ({grid} CUDA launches), scan "
                             f"kernel {scan_launches} times; want {want[0]} ({want[1]}) and {want_scan} for "
                             f"{sum(solves)} block solves with kkt_mode {opts.kkt_mode}")
    d = ct.transcribe(prob.ocp, grid_size=4, scheme=cfg.scheme, device="cpu")
    sol = sols[-1]
    return dict(name=name, why=ci_verdict(name, prob, cfg, sol), status=sol.status, objective=sol.objective,
                stored=prob.obj, maximize=prob.ocp.maximize, iterations=[s.iterations for s in sols], grids=grids,
                block_solves=solves, wall_s=timings.records[name][-1], launches=launches, grid_launches=grid,
                scan_launches=scan_launches,
                captures=[s.infos["captures"] for s in sols], capture_s=sum(s.infos["capture_s"] for s in sols),
                kkt_mode=opts.kkt_mode, bs=d.bw + d.cw,
                wb=d.tail_w + d.q + d.n_path + d.n_boundary,
                fuel=fuel_integral(sol) if name == "orbit_transfer" else None,
                cr_events=len(trace_cr_events(trace_dir / TRACE_FILE)) if name == CI_TRACED else None)


def check_gj_on_card(widths=(14, 18, 21, 28, 49), seeds=3, mats=4):
    """The structured solve's Gauss-Jordan (solver/kkt.py::_gj_eliminate) on
    the card, unbatched and under vmap, equals a plain numpy loop bit for
    bit at the widths of phase 13's structured fixtures (space_shuttle's
    blocks 14 and border 18, quadrotor's 21 and 28, and 49), pivot ties
    included (entries drawn from five values)."""
    from ctdirect_tpu_torch.solver.kkt import _gj_eliminate
    from torch_helpers import gj_loop

    for n in widths:
        for seed in range(seeds):
            rng = np.random.default_rng(seed)
            ms = []
            while len(ms) < mats:
                M = rng.choice([-0.3, -0.1, 0.1, 0.3, 0.7], size=(n, n + 3))
                if np.linalg.cond(M[:, :n]) < 1e6:
                    ms.append(M)
            want = np.stack([gj_loop(M, n) for M in ms])
            dev = torch.tensor(np.stack(ms), dtype=torch.float64, device="cuda")
            one = np.stack([_gj_eliminate(M, n).cpu().numpy() for M in dev])
            vm = torch.func.vmap(lambda M: _gj_eliminate(M, n))(dev).cpu().numpy()
            if not (np.array_equal(one, want) and np.array_equal(vm, want)):
                raise AssertionError(f"structured Gauss-Jordan on the card differs from the plain loop at n={n} "
                                     f"seed {seed}: max diff {np.abs(one - want).max()!r} unbatched, "
                                     f"{np.abs(vm - want).max()!r} under vmap")
    log(f"fixture CI: the structured solve's Gauss-Jordan equals a plain loop bit for bit on the card "
        f"(n = {', '.join(map(str, widths))}; {seeds} x {mats} matrices with pivot ties; unbatched and under vmap)")


def phase_fixture_ci(ct, get_problem, problem_names):
    """Every registered problem but CI_SKIP and the suite, under
    the JAX CI's recipe and oracle, f64, kkt_mode="cr" (the CR kernel at B=1)
    but for CI_CARD_OVERRIDES, compiled (each stage's DOCP captures its
    segment graphs); CI_WORKERS processes share the card, the longest
    fixtures first. Before them, the
    structure check of every new fixture on a CUDA DOCP at N=4 and the
    bit-for-bit check of the structured solve's Gauss-Jordan."""
    import multiprocessing

    from ctdirect_tpu_torch.utils.structure import verify_structure

    check_gj_on_card()
    bad = [nm for nm in CI_NEW
           if not verify_structure(ct.transcribe(get_problem(nm).ocp, grid_size=4, scheme="trapeze", device="cuda"))]
    if bad:
        raise AssertionError(f"fixture CI: Jacobian outside the predicted envelope on the card: {bad}")
    log(f"fixture CI: verify_structure true for all {len(CI_NEW)} new fixtures (trapeze N=4, cuda DOCP)")

    names = ci_fixtures(problem_names())
    order = [n for n in CI_LONGEST_FIRST if n in names] + [n for n in names if n not in CI_LONGEST_FIRST]
    rows = []
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(CI_WORKERS) as pool:
        for r in pool.imap_unordered(ci_fixture, order):
            stored = "none" if r["stored"] is None else repr(r["stored"])
            its = " + ".join(f"{i} (N={g})" for i, g in zip(r["iterations"], r["grids"]))
            log(f"  fixture CI {r['name']}: {'ok' if not r['why'] else 'FAIL (' + r['why'] + ')'}, status "
                f"{r['status']}, objective {r['objective']!r} (stored {stored})"
                f"{'' if r['fuel'] is None else ', fuel %.6f' % r['fuel']}, iterations {its}, {r['wall_s']:.2f} s "
                f"wall{' under torch.profiler' if r['name'] == CI_TRACED else ''}, kkt_mode {r['kkt_mode']}, "
                f"segment graphs {' + '.join(map(str, r['captures']))} (capture {r['capture_s']:.2f} s), block "
                f"solves {sum(r['block_solves'])} (warm-ups included), CR kernel launches {r['launches']} "
                f"({r['grid_launches']} CUDA launches), scan kernel launches {r['scan_launches']}, bs {r['bs']} "
                f"wb {r['wb']}")
            rows.append(r)
    elapsed = time.perf_counter() - t0
    rows.sort(key=lambda r: r["name"])
    traced = [r for r in rows if r["cr_events"] is not None]
    for r in traced:
        log(f"fixture CI trace of {r['name']}: {r['cr_events']} CUDA events of the CR kernel in its Chrome trace "
            f"({r['grid_launches']} CUDA launches counted by the wrapper)")
        if not r["cr_events"]:
            raise AssertionError(f"fixture CI: no CUDA event of the CR kernel in the trace of {r['name']}")
    failed = [(r["name"], r["why"]) for r in rows if r["why"]]
    if failed:
        raise AssertionError(f"fixture CI: the JAX CI's oracle fails on the card for {failed}")
    total, grid_total = sum(r["launches"] for r in rows), sum(r["grid_launches"] for r in rows)
    structured = [r for r in rows if r["kkt_mode"] == "structured"]
    scan_total = sum(r["scan_launches"] for r in structured)
    log(f"fixture CI: {len(rows)}/{len(names)} ok under the JAX CI's oracle, f64; {elapsed:.1f} s in "
        f"{CI_WORKERS} processes on the card ({sum(r['wall_s'] for r in rows):.1f} s of solve walls, "
        f"{sum(r['capture_s'] for r in rows):.1f} s of it capturing {sum(sum(r['captures']) for r in rows)} "
        f"segment graphs); "
        f"{sum(sum(r['iterations']) for r in rows)} iterations; {total} CR kernel launches ({grid_total} CUDA "
        f"launches), {scan_total} scan kernel launches ({', '.join(r['name'] for r in structured)}: structured)")
    want = sum(sum(k * grid_per_solve(chain_blocks(g)) for k, g in zip(r["block_solves"], r["grids"]))
               for r in rows if r["kkt_mode"] == "cr")
    return dict(path=path_record("fixture_ci", torch.float64, total, grid_total, want),
                scan_path=scan_record("fixture_ci_structured", torch.float64, scan_total,
                                      sum(sum(r["block_solves"]) for r in structured)),
                rows=rows, elapsed_s=elapsed)


def _host_ms(fn):
    """fn() timed on the host clock to a synchronised end; returns (its
    result, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def shard_rank(world, payload):
    """Phase 14 on one rank of the gloo world (all ranks on the one card):
    14a-14d; returns this rank's numbers and outputs (numpy)."""
    import ctdirect_tpu_torch as ct
    from torch_helpers import lane_residuals

    from ctdirect_tpu_torch.parallel import MPCController, TimeShardedKKT, broadcast_state
    from ctdirect_tpu_torch.parallel import make_sharded_tridiag_solver
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel
    from ctdirect_tpu_torch.solver.ipm import ipm_solve, make_spec
    from ctdirect_tpu_torch.solver.lanes import cr_solve_lanes
    from ctdirect_tpu_torch.solver.resolve import warm_state_from_numpy

    kernel.library(verbose=True)  # the parent's build, from the cache
    dev = world.device
    mesh_t = world.mesh((world.size,), ("time",))
    mesh_b = world.mesh((world.size,), ("batch",))
    mesh_2d = world.mesh((2, world.size // 2), ("batch", "time"))
    out = dict(rank=world.rank, dcr=[])

    # 14a: the distributed CR against the plain CR and the kernel
    for D, mesh in ((2, mesh_2d), (4, mesh_t)):
        for tag, (P, bs, wb, nb) in SHARD_CHAINS.items():
            chain = random_chain(P, bs, wb, nb, torch.float64, seed=1)
            A, Bp, E, F, r, rb = chain
            solve = make_sharded_tridiag_solver(mesh, "time", P, bs, wb)
            (X, xb), _ = _host_ms(lambda: solve(A, Bp[:-1], E, F, r, rb))
            ms = float(np.median([_host_ms(lambda: solve(A, Bp[:-1], E, F, r, rb))[1]
                                  for _ in range(SHARD_TIMED_SOLVES)]))
            rec = dict(D=D, chain=tag, ms=ms, messages=solve.axis.messages, staged=solve.axis.staged_messages,
                       time_rank=solve.axis.rank)
            if world.rank == 0:
                Xp, xbp = cr_solve_lanes(*chain)
                Xk, xbk = kernel(*chain)
                scale = max(1.0, Xp.abs().max().item(), xbp.abs().max().item())
                rec.update(err_plain=max((X - Xp).abs().max().item(), (xb - xbp).abs().max().item()),
                           err_kernel=max((X - Xk).abs().max().item(), (xb - xbk).abs().max().item()),
                           scale=scale, resid=lane_residuals(chain, X, xb).max().item(),
                           finite=bool(torch.isfinite(X).all() and torch.isfinite(xb).all()))
            out["dcr"].append(rec)
            del chain, A, Bp, E, F, r, rb, X, xb

    p = get_problem("double_integrator_minenergy")
    docp = ct.transcribe(p.ocp, grid_size=N, scheme="trapeze", device=dev)
    xs = [torch.tensor(x, dtype=torch.float64, device=dev) for x in payload["xs"]]

    def ticks(ctrl, warm):
        rows = B // ctrl.axis.size
        mine = slice(ctrl.axis.rank * rows, (ctrl.axis.rank + 1) * rows)
        states = broadcast_state(warm_state_from_numpy(warm, dev), rows)
        first_s = None
        if ctrl.graphed:  # the signature's first call captures this rank's graph (not counted)
            first_s = _host_ms(lambda: ctrl(states, xs[0][mine]))[1] / 1e3
        tick_ms, kkt_max = [], 0.0
        kernel.reset_counts()
        for k, x0 in enumerate(xs):
            (states, u0, kkt, viol), ms = _host_ms(lambda: ctrl(states, x0[mine]))
            if k >= SHARD_WARMUP:
                tick_ms.append(ms)
            kkt_max = max(kkt_max, kkt.max().item())
        return dict(rows=(mine.start, mine.stop), u0=u0.cpu().numpy(), kkt_max=kkt_max,
                    finite=bool(torch.isfinite(u0).all()), tick_ms_p50=float(np.median(tick_ms)),
                    launches=kernel.launches, grid_launches=kernel.grid_launches, graphed=ctrl.graphed,
                    captures=ctrl.captures, first_s=first_s)

    # 14b: the batch-sharded RTI tick, f32 block solve through the kernel
    ctrl = MPCController(docp, x0_boundary_rows=[0, 1], resolve_iters=ITERS, kkt_algorithm="cr",
                         kkt_solve_dtype=torch.float32, mesh=mesh_b, device=dev)
    out["tick"] = ticks(ctrl, payload["warm32"])

    # 14c: the 2-D tick, f64, the KKT solve distributed over the time axis
    ctrl = MPCController(docp, x0_boundary_rows=[0, 1], resolve_iters=ITERS, mesh=mesh_2d, time_axis="time",
                         device=dev)
    out["tick_2d"] = ticks(ctrl, payload["warm64"])
    out["tick_2d"].update(messages=ctrl.kkt.axis.messages, staged=ctrl.kkt.axis.staged_messages,
                          block_solves=ctrl.kkt.block_solves)

    # 14d: BASELINE config 2 through the full IPM over the time axis
    gp = get_problem("goddard")
    gd = ct.transcribe(gp.ocp, grid_size=GD_N, scheme=GD_SCHEME, device=dev)
    kkt = TimeShardedKKT(gd, mesh_2d, axis="time")
    res, ms = _host_ms(lambda: ipm_solve(
        gd.nlp_objective, gd.constraints, make_spec(gd._z_lb, gd._z_ub, gd._c_lb, gd._c_ub),
        gd.initial_guess(gp.init), gd._z_lb, gd._z_ub, gd._c_lb, gd._c_ub, options=ct.IPMOptions(**GD_OPTS),
        kkt=kkt, device=dev, dtype=gd.dtype))
    # the IPM minimizes; the user-sense objective of a max problem is its negative
    objective = -float(res.objective) if gp.ocp.maximize else float(res.objective)
    out["goddard"] = dict(status=int(res.status), objective=objective, iterations=int(res.iterations),
                          wall_s=ms / 1e3, block_solves=kkt.block_solves, messages=kkt.axis.messages,
                          staged=kkt.axis.staged_messages, finite=bool(torch.isfinite(res.z).all()))
    return out


def phase_sharded(kernel, kres, main, gd_f64_objective, xs):
    """Phase 14: the sharded paths in one gloo world of SHARD_WORLD ranks on
    the card (14a-14d, shard_rank), then the entry's dry run (14e), then the
    compiled paths over NCCL (14f). Returns the kernel path records of the
    batch-sharded tick and of 14f."""
    from ctdirect_tpu_torch.entry import dryrun_multichip
    from ctdirect_tpu_torch.parallel import broadcast_state
    from ctdirect_tpu_torch.parallel.spmd import launch

    n_ticks = SHARD_WARMUP + SHARD_TICKS
    # the unsharded ticks of the same rows from the same state: phase 5's controllers
    refs = {}
    for dt, m in main.items():
        states = broadcast_state(m["warm"], B)
        for x0 in xs[:n_ticks]:
            states, u0, _, _ = m["ctrl"](states, x0)
        refs[dt] = u0.cpu().numpy()
    payload = dict(xs=[x.cpu().numpy() for x in xs[:n_ticks]],
                   **{f"warm{32 if dt == torch.float32 else 64}": {f: getattr(m["warm"], f).cpu().numpy()
                                                                    for f in m["warm"]._fields}
                      for dt, m in main.items()})
    t0 = time.perf_counter()
    ranks = launch(shard_rank, SHARD_WORLD, device="cuda", backend="gloo", args=(payload,), timeout=SHARD_TIMEOUT)
    log(f"sharded paths: a gloo world of {SHARD_WORLD} ranks on one card (every message staged through the "
        f"host), {time.perf_counter() - t0:.1f} s")

    # 14a
    k3 = {tag: shape_ms(kres, torch.float64, *shape) for tag, shape in SHARD_CHAINS.items()}
    for i, rec in enumerate(ranks[0]["dcr"]):
        tol = TOL[torch.float64] * rec["scale"]
        if not (rec["finite"] and rec["err_plain"] <= tol and rec["err_kernel"] <= tol
                and rec["resid"] < RESID_TOL[torch.float64]):
            raise AssertionError(f"distributed CR D={rec['D']} on the {rec['chain']} chain: {rec}")
        msgs = sum(r["dcr"][i]["messages"] for r in ranks)
        staged = sum(r["dcr"][i]["staged"] for r in ranks)
        P, bs, wb, nb = SHARD_CHAINS[rec["chain"]]
        log(f"distributed CR D={rec['D']}, {rec['chain']} chain (P={P} bs={bs} wb={wb} B={nb}, f64): max abs diff "
            f"{rec['err_plain']:.3e} to the plain CR, {rec['err_kernel']:.3e} to the kernel (scale "
            f"{rec['scale']:.3g}); lane residual {rec['resid']:.3e}; "
            f"{', '.join('%.3f' % r['dcr'][i]['ms'] for r in ranks)} ms per solve on ranks 0-{SHARD_WORLD - 1} "
            f"(host clock, median of {SHARD_TIMED_SOLVES}; phase 3's kernel {k3[rec['chain']]:.4f} ms); "
            f"world messages {msgs}, staged {staged}")

    # 14b
    ref = refs[torch.float32]
    launches = grid = 0
    for r in ranks:
        t = r["tick"]
        lo, hi = t["rows"]
        du = float(np.abs(t["u0"] - ref[lo:hi]).max())
        if t["launches"] != n_ticks * ITERS:
            raise AssertionError(f"sharded tick rank {r['rank']}: kernel launched {t['launches']} times, "
                                 f"want {n_ticks * ITERS}")
        if not (t["finite"] and t["kkt_max"] < 1e-10 and du <= 1e-12):
            raise AssertionError(f"sharded tick rank {r['rank']}: max KKT {t['kkt_max']:.3e}, u0 diff {du:.3e}")
        if not (t["graphed"] and t["captures"] == 1):
            raise AssertionError(f"sharded tick rank {r['rank']}: graphed {t['graphed']}, {t['captures']} captures")
        launches, grid = launches + t["launches"], grid + t["grid_launches"]
        log(f"batch-sharded tick rank {r['rank']} (rows {lo}-{hi}, f32 block solve), the rank's own CUDA graph "
            f"replayed (captured once, first call {t['first_s']:.3f} s): {n_ticks} ticks, tick "
            f"{t['tick_ms_p50']:.3f} ms p50 (host clock, {SHARD_TICKS} timed, 4 ranks sharing the card); max KKT "
            f"{t['kkt_max']:.3e}; u0 vs the unsharded tick {du:.3e}; kernel launches {t['launches']}")
    path = path_record("mpc_tick_batch_sharded", torch.float32, launches, grid,
                       launches * grid_per_solve(chain_blocks(N)))

    # 14c
    ref = refs[torch.float64]
    for r in ranks:
        t = r["tick_2d"]
        lo, hi = t["rows"]
        du = float(np.abs(t["u0"] - ref[lo:hi]).max())
        mates = [q["tick_2d"] for q in ranks if q["tick_2d"]["rows"] == t["rows"]]
        dmate = max(float(np.abs(q["u0"] - t["u0"]).max()) for q in mates)
        if not (len(mates) == 2 and t["finite"] and t["kkt_max"] < 1e-10 and du <= 1e-10 and dmate <= 1e-13):
            raise AssertionError(f"2-D tick rank {r['rank']}: max KKT {t['kkt_max']:.3e}, u0 diff {du:.3e}, "
                                 f"time group diff {dmate:.3e}, {len(mates)} ranks on rows {lo}-{hi}")
        if t["graphed"] or t["captures"]:
            raise AssertionError(f"2-D tick rank {r['rank']}: graphed {t['graphed']}, {t['captures']} captures")
        log(f"2-D tick rank {r['rank']} (batch shard rows {lo}-{hi}, time=2, f64 distributed CR), eager (its "
            f"halos are staged through the host, which a CUDA graph cannot capture): tick "
            f"{t['tick_ms_p50']:.3f} ms p50; max KKT {t['kkt_max']:.3e}; u0 vs the unsharded f64 tick {du:.3e}, "
            f"vs its time-group mate {dmate:.3e}; {t['block_solves']} distributed solves, {t['messages']} "
            f"messages ({t['staged']} staged)")

    # 14d
    for r in ranks:
        g = r["goddard"]
        rel = abs(g["objective"] - gd_f64_objective) / abs(gd_f64_objective)
        if not (g["finite"] and g["status"] == 0 and rel <= 1e-8):
            raise AssertionError(f"goddard over time=2 rank {r['rank']}: {g}, rel diff {rel:.3e} to phase 10")
    g = ranks[0]["goddard"]
    log(f"goddard GL2 N={GD_N} f64, ipm_solve(kkt=TimeShardedKKT) over time=2: status {g['status']}, "
        f"{g['iterations']} iterations, objective {g['objective']!r} (phase 10 f64: {gd_f64_objective!r}), "
        f"walls {', '.join('%.2f' % r['goddard']['wall_s'] for r in ranks)} s; {g['block_solves']} block solves, "
        f"{g['messages']} messages on rank 0 ({g['staged']} staged)")
    msgs = sum(r["dcr"][-1]["messages"] + r["tick_2d"]["messages"] + r["goddard"]["messages"] for r in ranks)
    staged = sum(r["dcr"][-1]["staged"] + r["tick_2d"]["staged"] + r["goddard"]["staged"] for r in ranks)
    log(f"sharded paths: world messages {msgs}, staged_messages {staged} (all axes, all ranks)")

    # 14e
    t0 = time.perf_counter()
    legs = dryrun_multichip(SHARD_WORLD, device="cuda", backend="gloo", timeout=SHARD_TIMEOUT)
    if len(legs) != SHARD_WORLD or any(set(r) != {"batch", "time", "tick", "boxes", "tick_2d"} for r in legs):
        raise AssertionError("dryrun_multichip: a leg is missing")
    captures = [(r["batch"]["captures"], r["boxes"]["captures"]) for r in legs]
    if not all(r["batch"]["graphed"] for r in legs) or min(min(c) for c in captures) < 1:
        raise AssertionError(f"dryrun_multichip: legs 1 and 4 not graphed on every rank: {captures}")
    log(f"dryrun_multichip({SHARD_WORLD}, cuda, gloo): all five legs, {time.perf_counter() - t0:.1f} s; segment "
        f"graphs per rank after legs 1 and 4: {captures}")
    return [path, *phase_nccl_graphs(main[torch.float64]["warm"], xs[:n_ticks], refs[torch.float64],
                                     gd_f64_objective)]


def phase_nccl_graphs(warm, xs, ref_u0, gd_f64_objective):
    """Phase 14f: the compiled time-sharded paths in a one-rank NCCL world
    (shard_timing's run and checks, a profiled replay of the tick and of
    the distributed CR among them, then this phase's own). Returns the paths' kernel records."""
    from ctdirect_tpu_torch import shard_timing

    cfg = dict(tick=dict(shard_timing.TICK, B=B, N=N, iters=ITERS, warmup=SHARD_WARMUP, timed=len(xs) - SHARD_WARMUP,
                         time=1, x0s=[x.cpu().numpy() for x in xs],
                         warm={f: getattr(warm, f).cpu().numpy() for f in warm._fields}),
               chains={"tick": SHARD_CHAINS["tick"]}, chain_sizes=[1], goddard_sizes=[1])
    t0 = time.perf_counter()
    (r,) = shard_timing.run(1, cfg, timeout=SHARD_TIMEOUT)
    log(f"compiled sharded paths: a one-rank NCCL world, {time.perf_counter() - t0:.1f} s")
    shard_timing.report([r], cfg, log=lambda m: log("  " + m))
    t, c, g = r["tick"], r["chains"][0], r["goddard"][0]
    du = float(np.abs(t["u0"] - ref_u0).max())
    rel = abs(g["objective"][1] - gd_f64_objective) / abs(gd_f64_objective)
    checks = {
        "(i) the distributed CR replay bitwise its eager form": c["bitwise"],
        "(ii) u0 within 1e-10 of phase 5's unsharded f64 tick": du <= 1e-10,
        "(iii) the compiled Goddard within 1e-8 of phase 10's f64 objective": rel <= 1e-8,
        "NCCL messages inside every graph": min(t["replay"]["messages"], c["messages"], g["messages"]) > 0,
    }
    failed = [what for what, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 14f: {failed}; u0 diff {du:.3e}, objective rel diff {rel:.3e}")
    log(f"compiled sharded paths: the 2-D tick's u0 within {du:.3e} of phase 5's unsharded tick; Goddard within "
        f"{rel:.3e} of phase 10's objective; NCCL messages per replay: tick run {t['replay']['messages']}, "
        f"distributed CR {c['messages']}, Goddard {g['messages']}")
    root = grid_per_solve(1)
    return [path_record(name, torch.float64, rec["launches"], rec["grid_launches"], rec["launches"] * root)
            for name, rec in (("mpc_tick_2d_nccl_graph", t["replay"]), ("dcr_nccl_graph", c),
                              ("goddard_time_sharded_nccl_graph", g))]


def phase_orbit_scenarios(kernel):
    """Phase 15: BASELINE config 4 through ctdirect_tpu_torch.orbit_scenarios'
    run and checks at full width (ORBIT_CFG). Returns the batch's CR kernel
    records and the nominal's (its kernel's: the scan kernel's under
    "structured")."""
    from ctdirect_tpu_torch import orbit_scenarios

    cfg = dict(orbit_scenarios.DEFAULT_CFG, **ORBIT_CFG)
    log(f"BASELINE config 4: orbit_scenarios.run at N={cfg['N']}, B={cfg['B']}, the nominal on the "
        f"{cfg['nominal_mode']} KKT solve, no diagnostics (the script's own run adds the stage split and the "
        f"alignment witness; PERF.md)")
    result = orbit_scenarios.report(orbit_scenarios.run(cfg), cfg, log=log)
    per = result["grid_per_solve"]
    names = {"eager": "batch_solve_orbit_eager", "first graphed call": "batch_solve_orbit_first_call",
             "graphed replay": "batch_solve_orbit"}
    paths = [path_record(names[tag], torch.float64, c["launches"], c["grid_launches"], c["launches"] * per)
             for tag, c in result["calls"].items()]
    nom = result["nominal"]
    solves = nom["block_solves"] + nom["warmup_block_solves"]
    if nom["mode"] == "cr":
        paths.append(path_record("orbit_nominal", torch.float64, nom["launches"], nom["grid_launches"],
                                 nom["launches"] * per))
        return dict(paths=paths, scan_paths=[])
    return dict(paths=paths, scan_paths=[scan_record("orbit_nominal_structured", torch.float64,
                                                     nom["scan_launches"], solves)])


def phase_lab(kernel, scan):
    """Phase 18: the single-solve latency lab (ctdirect_tpu_torch.latency_lab's
    run_lab, report and checks) at LAB_N, its problems and four configs,
    LAB_REPS replays each, with both kernels' counts set to 0 just before
    and read just after: the structured configs' block solves on the scan
    kernel, the cr configs' on the CR kernel (3 + 3 log2 P CUDA launches
    each). Returns the CR and the scan kernel's records."""
    from ctdirect_tpu_torch import latency_lab

    log(f"latency lab: {', '.join(latency_lab.PROBLEMS)} at N={LAB_N} (trapeze), configs "
        f"{', '.join(latency_lab.CONFIGS)}, tol {latency_lab.TOL:g}, <= {latency_lab.MAX_ITER} iterations; a first "
        f"call and {LAB_REPS} replay(s) each")
    kernel.reset_counts()
    scan.reset_counts()
    rows = latency_lab.run_lab(latency_lab.PROBLEMS, [LAB_N], latency_lab.CONFIGS, device="cuda", reps=LAB_REPS,
                               log=log)
    launches, grid, scan_launches = kernel.launches, kernel.grid_launches, scan.launches
    summary = latency_lab.report(rows, log=log)
    if not summary["ok"]:
        raise AssertionError(f"latency lab: rows failing a check: {summary['bad']}")
    per = grid_per_solve(chain_blocks(LAB_N))
    cr_paths, scan_paths = [], []
    for r in rows:
        calls = r["launches_first"] + LAB_REPS * r["launches"]
        path = f"lab_{r['problem']}_N{LAB_N}_{r['mode']}_{r['dtype']}"
        dtype = torch.float32 if r["dtype"] == "f32" else torch.float64
        if r["mode"] == "cr":
            cr_paths.append(path_record(path, dtype, calls, calls * per, calls * per))
        else:
            scan_paths.append(scan_record(path, dtype, calls, calls))
    want = (sum(p["launches"] for p in cr_paths), sum(p["launches"] for p in cr_paths) * per,
            sum(p["launches"] for p in scan_paths))
    if (launches, grid, scan_launches) != want:
        raise AssertionError(f"latency lab: CR kernel {launches} launches ({grid} CUDA launches), scan kernel "
                             f"{scan_launches}; the rows count {want}")
    return dict(paths=cr_paths, scan_paths=scan_paths, rows=rows)


def phase_multihost(kernel, warm):
    """Phase 17: BASELINE config 5's batch-sharded tick (the double
    integrator and cart-pole) and cart-pole's BatchSolver(mesh=) through
    ctdirect_tpu_torch.multihost's run and checks in a one-rank NCCL world
    (MULTIHOST_SIZES), from `warm` (problem -> the warm state of phase 5's
    or phase 8's cold start, which is the run's own under the same
    options). Returns the paths' kernel records."""
    from ctdirect_tpu_torch import multihost

    cfg = multihost.default_cfg()
    for name, (per_card, ticks) in MULTIHOST_SIZES.items():
        cfg["problems"][name].update(batch_per_chip=per_card, timed=ticks,
                                     warm={f: getattr(warm[name], f).cpu().numpy() for f in warm[name]._fields})
    t0 = time.perf_counter()
    results = multihost.run(1, cfg, timeout=SHARD_TIMEOUT)
    log(f"BASELINE config 5: multihost.run in a one-rank NCCL world, {time.perf_counter() - t0:.1f} s")
    summary = multihost.report(results, cfg, log=lambda m: log("  " + m))
    if summary["failed"]:
        raise AssertionError(f"phase 17: {summary['failed']}")
    (r,) = results[1]
    paths = [path_record(f"mpc_tick_{tag}_batch_sharded_nccl", torch.float64, r[name]["replay"]["launches"],
                         r[name]["replay"]["grid_launches"], r[name]["replay"]["launches"] * r[name]["per"])
             for name, tag in (("double_integrator_minenergy", "di"), ("cartpole", "cartpole"))]
    per = r["cartpole"]["per"]
    for call, suffix in (("first", "_first_call"), ("replay", "")):
        c = r["cartpole"]["solver"]["calls"][call]
        paths.append(path_record(f"batch_solve_cartpole_batch_sharded_nccl{suffix}", torch.float64, c["launches"],
                                 c["grid_launches"], c["launches"] * per))
    return paths


def kernel_name(mangled):
    """`up_odd<double>` from `_ZN<len><namespace><len>up_oddIdE...`,
    `scan_kernel<float, 16, 0>` from `...scan_kernelIfLi16ELi0EE...`."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    name = rest[m.end():m.end() + int(m.group(1))]
    tail = rest[m.end() + int(m.group(1)):]
    t = re.match(r"I([df])((?:Li\d+E)*)E", tail)
    if not t:
        return f"{name}<?>"
    return f"{name}<{', '.join([dict(d='double', f='float')[t.group(1)], *re.findall(r'Li(\d+)E', t.group(2))])}>"


def ptxas_report(build_log):
    """Registers, stack frame and spills of every kernel in `nvcc -Xptxas -v`'s
    log; fails on a spill or a stack frame of MAX_STACK_BYTES or more."""
    rows, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = dict(kernel=kernel_name(m.group(1)))
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    if not rows or any("stack" not in r or "registers" not in r for r in rows):
        raise AssertionError(f"ptxas: could not read registers / stack / spills per kernel from the build log")
    for r in rows:
        log(f"ptxas {r['kernel']}: {r['registers']} registers, {r['stack']} B stack frame, "
            f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")
    bad = [r for r in rows if r["spill_stores"] or r["spill_loads"] or r["stack"] >= MAX_STACK_BYTES]
    if bad:
        raise AssertionError(f"ptxas: spills or a stack frame >= {MAX_STACK_BYTES} B: {bad}")
    return rows


def kernel_entries(kres, paths, sres, scan_paths):
    """One JSON entry per kernel entry point (the CR kernel's and the scan
    kernel's, f32 and f64): its launches (block solves) on every path (the
    CR kernel's CUDA launches too), and the times, bounds and library times
    that phase 3 measured at each shape; the entry's own numbers are those
    of its first shape (the CR kernel: the MPC tick; the scan kernel:
    quadrotor's chain)."""
    entries = []
    for dtype in sorted({r["dtype"] for r in kres}):
        shapes = [r for r in kres if r["dtype"] == dtype]
        on = [dict(path=p["path"], launches=p["launches"], grid_launches=p["grid_launches"])
              for p in paths if p["dtype"] == dtype]
        first = shapes[0]
        entries.append(dict(
            name=f"cr_solve_{dtype.replace('float', 'f')}", route="cuda",
            source="ctdirect_tpu_torch/csrc/cr_solve.cu", replaces="ctdirect_tpu/solver/pallas_cr.py:282",
            launches=sum(p["launches"] for p in on), grid_launches=sum(p["grid_launches"] for p in on),
            max_abs_err=max(r["max_abs_err"] for r in shapes), ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_us"] / 1e3, bound_by=first["bound_by"], library_ms=first["library_ms"],
            paths=on, shapes=shapes))
    for dtype in ("float64", "float32"):
        shapes = [r for r in sres if r["dtype"] == dtype]
        on = [p for p in scan_paths if p["dtype"] == dtype]
        first = shapes[0]
        entries.append(dict(
            name=f"scan_solve_{dtype.replace('float', 'f')}", route="cuda",
            source="ctdirect_tpu_torch/csrc/scan_solve.cu",
            replaces="no Pallas kernel: ctdirect_tpu/native/__init__.py:71 (csrc/blocktri.cpp) and "
                     "ctdirect_tpu/solver/structured_kkt.py:665 (lax.scan)",
            launches=sum(p["launches"] for p in on), max_abs_err=max(r["max_abs_err"] for r in shapes),
            ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_us"] / 1e3,
            bound_by=first["bound_by"], library_ms=first["library_ms"], floor_ms=first["floor_us"] / 1e3,
            us_per_step=first["us_per_step"], floor_share=first["floor_share"],
            resident_chains_per_sm=first["resident_chains_per_sm"], paths=on, shapes=shapes))
    return entries


def main():
    t_start = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path,
                        help="an earlier cr_solve.cu (one thread per instance) to time against in phase 3")
    parser.add_argument("--old-scan", type=Path,
                        help="an earlier scan_solve.cu to hold bitwise and time against in phase 3")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    # the random test chains and the dense-residual oracle are the CPU tests' own
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem, problem_names
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel
    from ctdirect_tpu_torch.solver.scan_kernel import scan_solve_batched as scan

    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # one nvcc per kernel library, all started together: the CR kernel's and
    # the scan kernel's, one per width (scan_kernel.WIDTH_KEYS)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        cr_build, scan_builds = pool.submit(kernel.library, verbose=True), pool.submit(scan.build_all)
        builds = [cr_build.result(), *scan_builds.result()]
    ptxas = []
    for path, build_s, build_log in builds:
        log(f"built {path.name} in {build_s:.2f} s")
        ptxas += ptxas_report(build_log)

    t_phase = time.perf_counter()

    def phase_done(what):
        nonlocal t_phase
        log(f"[{what}: {time.perf_counter() - t_phase:.1f} s; {time.perf_counter() - t_start:.1f} s in all]")
        t_phase = time.perf_counter()

    phase_done("phases 1-2")
    kres = phase_kernel_vs_plain(kernel, old_kernel(args.old) if args.old else None)
    sres = phase_scan_vs_plain(scan, old_scan_kernel(args.old_scan) if args.old_scan else None)
    phase_done("phase 3")
    scan_paths = [phase_front_door(ct, get_problem, scan)]
    phase_done("phase 4")

    rng = np.random.default_rng(0)
    xs = [torch.tensor(0.03 * rng.standard_normal((B, 2)), dtype=torch.float64, device="cuda")
          for _ in range(WARMUP_TICKS + TIMED_TICKS)]
    main = {dt: phase_main_path(ct, get_problem, kernel, scan, dt, xs) for dt in (torch.float32, torch.float64)}
    du = (main[torch.float32]["u0"] - main[torch.float64]["u0"]).abs().max().item()
    if not du < 1e-8:
        raise AssertionError(f"f32 vs f64 block solve: final u0 differ by {du:.3e}")
    log(f"f32 vs f64 block solve: final u0 agree to {du:.3e}")
    phase_done("phase 5")
    for dt, m in main.items():
        phase_device_split("f32" if dt == torch.float32 else "f64", m["ctrl"], m["make_ctrl"], m["states"], xs)
    phase_done("phase 6")

    scan_paths.append(phase_front_door_default(ct, get_problem, scan))
    phase_done("phase 7")
    tick = phase_cartpole_tick(ct, get_problem, kernel, scan)
    phase_done("phase 8")
    batch = phase_cartpole_batch(ct, kernel, tick["docp"], tick["warm"])
    phase_done("phase 9")
    goddard = phase_goddard(ct, get_problem, kernel, kres)
    phase_done("phase 10")
    suite = phase_sweep(f"suite_trapeze_N{SUITE_N}", [(name, SUITE_N) for name in SUITE], kernel, profile=None)
    phase_done("phase 11")
    grid = phase_grid_continuation(ct, get_problem, kernel, goddard["sols"]["f32"])
    phase_done("phase 12")
    fixture_ci = phase_fixture_ci(ct, get_problem, problem_names)
    phase_done("phase 13")
    sharded = phase_sharded(kernel, kres, main, goddard["sols"]["f64"].objective, xs)
    phase_done("phase 14")
    orbit = phase_orbit_scenarios(kernel)
    phase_done("phase 15")
    ladder = phase_sweep("suite_ladder_cut", LADDER_CUT, kernel, profile="goddard_all")
    phase_done("phase 16")
    config5 = phase_multihost(kernel, {"double_integrator_minenergy": main[torch.float64]["warm"],
                                       "cartpole": tick["warm"]})
    phase_done("phase 17")
    lab = phase_lab(kernel, scan)
    phase_done("phase 18")

    paths = [*main[torch.float32]["paths"], *main[torch.float64]["paths"], *tick["paths"], *batch["paths"],
             *goddard["paths"], suite, grid, fixture_ci["path"], *sharded, *orbit["paths"], ladder, *config5,
             *lab["paths"]]
    scan_paths += [*main[torch.float32]["scan_paths"], *main[torch.float64]["scan_paths"], *tick["scan_paths"],
                   fixture_ci["scan_path"], *orbit["scan_paths"], *lab["scan_paths"]]
    log(f"whole script {time.perf_counter() - t_start:.1f} s (the kernels' builds included)")
    print(card)
    print(json.dumps({"kernels": kernel_entries(kres, paths, sres, scan_paths), "ptxas": ptxas}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
