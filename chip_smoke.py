"""Smoke run of povar_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the PyTorch / CUDA port's two-step solve (`bundle_adjust`: step
1, pOSE VarProj LM; step 2, Riemannian LM) through the entry points a
user calls, at the venice-89 scale of bench.py
(synthetic_bal_problem_fast(89, 110973, 5, seed=0): N = 89 cameras,
554,865 observations, O = 557,056 padded slot rows), in phases, each
printing its lines and raising on failure (a failure exits non-zero and
prints no result line):

1. device     a CUDA device, its name and power limit (nvidia-smi);
2. build      the twenty-seven kernels of povar_tpu_torch/csrc/ (and
              the f64 instantiations of the five camera-table ones, of
              fifteen structured ones and of the three slot kernels), and
              the device LM loop's two (lm.cu), from source;
3. kernels    each step-1 kernel (the fused term over the problem's slot
              parts; poba_t3 and apply_ldiff_stored of the
              POWER_SCHUR_COMPLEMENT apply) and the five camera-table
              kernels at venice-89 shapes on seeded inputs against its
              plain PyTorch version on the same card (each output scaled
              per entry or per camera, see ELEM; cam_gather and e0_u bit
              for bit, cam_gather also at 132 rows over N = 1024 and on
              cam[1:]; cam_scatter_add, e0_u, e0_scatter and hpp_b at
              both steps' shapes, cam_scatter_add also at the Schur
              corrections' 144 / 121 rows), with CUDA-event times
              (median of 20 calls) and profiler device times (mean of
              20) for both, and those of `index_select` beside
              cam_gather and of `index_add_` beside cam_scatter_add, the
              one PyTorch call that computes each; prepare also without
              its per-camera sums (sums=False); prepare, hpp_b_structured,
              e0_term_parts, schur_diag_structured and
              e0_scatter_structured also on the camera-sorted lane
              orders (the 1-device mesh solver's step-1 operands; each
              part's landmarks sorted by first camera) and on seeded
              cameras at N = 1024 (hpp_b_structured also at N = 2048,
              its global route);
              cam_scatter_add, e0_scatter and hpp_b again at N = 1024
              (the Schur kernel's and hpp_b's global-atomic routes, the
              others' shared copies), cam_scatter_add also on the rows
              sorted by camera and at N = 6000 (its global-atomic
              route), hpp_b's hpp and the Schur corrections symmetric
              bit for bit;
4. step 1     a small step-1 solve, card against CPU; the venice-89
              step-1 solve with the composed power term and with
              SolverOptions() defaults (the fused term), each with the
              launch counters zeroed just before and read just after
              (every kernel of that path must have run), accepted costs
              strictly falling and the final cost within 1e-3 of
              207.47874642216357 (JAX, BENCH_r05.json); a warm repeat;
              the warm bench iteration (bench.py's definition: linearize
              + trial, eta = 0, m = 10, 50 chained, one sync) under both
              terms, with a profiler breakdown;
5. kernels2   each step-2 kernel at venice-89 shapes on the step-2 state
              of the card's step-1 result (`create_homogeneous`) with
              seeded operands, against its plain version, then again on
              the well-conditioned rows alone (|1/p2| at most CALM of
              tools/step2_spread.py times the median), pose_error2
              under NONE, HUBER and CAUCHY, and two of its calls bit for
              bit; prepare2, hppb2, e0_term2_parts, schur_diag2 and
              scatter2 also on the camera-sorted lane orders (the
              1-device mesh solver's step-2 operands; each part's
              landmarks sorted by first camera; the fused term) and
              hppb2, e0_term2_parts, schur_diag2 and scatter2 on seeded
              cameras at N = 1024 (schur_diag2's
              global route; hppb2 also at N = 2048, its global route),
              schur_diag2's corrections symmetric bit for bit;
6. E0         the fused E0 operator of each step against the composed
              one per camera, all landmarks narrow and with four widened
              past 16 observations (the composed suffix);
7. layouts    the unstructured layout (Lin1 / Lin2, pallas_kernels=
              "off") and the structured one at venice-89 scale from one
              landmark state, lambda 1e-4, each against an f64
              evaluation on the host CPU: per-camera b, Hpp, one E0 term
              and the power-series increment (LAYOUT_TOLS), step 1 at
              the VarProj start, step 2 on the calm landmarks of the
              homogenized step-1 result;
8. witness    step 2's first 7 iterations from that state without the
              landmarks near a camera's principal plane, twice on the
              card and once on the CPU: identical decisions and inner
              iteration counts, accepted costs within WITNESS_TOLS; for
              RIPOBA (composed term) and RIPCG (defaults otherwise);
9. pipeline   `bundle_adjust` of a small problem, card against CPU; the
              venice-89 `bundle_adjust` with SolverOptions() defaults and
              with the composed term (counters zeroed just before each,
              read just after): step 1 within 1e-3 of 207.4787, step 2
              within STEP2_BAND x 1845.1889071641926 and 100x below its
              start, the state finite; a warm repeat; the warm step-2
              bench iteration under both terms;
9a. device_loop  the device LM loop (solver/device_loop.py, the
              default under device_lm_loop="auto" in every phase that does
              not say "off"): lm_step (csrc/lm.cu) bit for bit against its
              plain version on edge cases of every cost channel and accept
              rule, lm_condition's region count, and a captured graph of
              nested WHILE and IF nodes against the same loops on the host;
              (a) the small and ring problems (`small_case` defaults and
              composed, `ring_pipeline` PSC and f32 of
              tools/step2_spread.py): the card's device loop against the
              card's host loop and against the CPU's device loop, the same
              decisions and counts, costs within SMALL_TOLS / RING_TOLS;
              (b) venice-89 in pure f64: POWER_VARPROJ step 1 and the
              WITNESS_ITERS-iteration RIPOBA start from its homogenized
              result on the calm landmarks, device loop against host loop
              on the card: the same decisions and counts, accepted costs
              within F64_TOL; (c)-(e) tools/loop_ab.py's `compare_loops`
              at venice-89 with SolverOptions() defaults, both steps, both
              loops, a first and a warm call: (c) the hand-written
              kernels of the path run in the warm replay: each was
              captured into a graph region whose device count of
              executions is positive (the profiler's trace of the replay,
              whose kernel names are printed beside, misses some of step
              2's graph kernels),
              (d) the blocking host synchronisations per step (at most
              trials + 1; the device loop's is 1, 3 with the capture),
              (e) wall and device time per trial, busy share, capture and
              instantiation seconds, graph nodes and pool bytes;
10. CG        the venice-89 `bundle_adjust` with PCG (SCHUR_JACOBI) and
              RIPCG: step 1 within PCG_BAND x 205.39424619627198, the
              JAX package's PCG run on the same problem
              (docs/results-venice89/runs/pcg-ripcg/venice-89/ba_log.json),
              its first three CG counts equal to that run's and all of
              them printed beside it; step 2 finite, strictly falling and
              100x below its start;
11. PSC      POWER_SCHUR_COMPLEMENT (landmark damping, the poBA apply):
              `ring_pipeline` of tools/step2_spread.py card against CPU;
              PSC_RUNS venice-89 step-1 solves (counters zeroed before
              the first, read after it), each in 51 records, below
              PSC_MAX and within PSC_BAND x 23.31876816537192, the JAX
              run (docs/results-venice89/runs/power_schur_complement-
              ripoba/venice-89/ba_log.json), the opening decisions each
              shares with it printed; `bundle_adjust` PSC + RIPOBA and PSC
              + RIPCG (counters zeroed before each): step 1 as above,
              step 2 strictly falling, 100x below its start and below
              PSC_STEP2_MAX;
12. f32      the f32 LM state: `ring_pipeline` card against CPU; the
              venice-89 `bundle_adjust` with SolverOptions() defaults and
              dtype=torch.float32 (counters zeroed before, cam_gather
              among the kernels that must run): step 1 within 1e-2 of
              207.4787, step 2 100x below its start, the state f32 and
              finite;
13. unstructured  the small case and `ring_pipeline` card against CPU
              with pallas_kernels="off" and with CHOLESKY; one venice-89
              CHOLESKY solve's time and peak device memory; the
              venice-89 `bundle_adjust` with "off" (step 1 within 1e-3
              of 207.4787, step 2 as the defaults'), with CHOLESKY +
              RIPOBA (step 1's records printed beside the JAX run's 11,
              its first trial within CHOL_FIRST_TOL of the CPU's, its
              first CHOL_SAME trials accepted, its final cost within
              CHOL_BAND x 243.9675604042901; step 2 finite, strictly
              falling and below its start, JAX's 15606.36 printed) and
              CHOLESKY + RIPCG (counters zeroed before each); CHOLESKY's
              step 1 with the JAX run's TPU arithmetic emulated
              (bf16-rounded one-hot camera sums and gathers): JAX's
              decisions AARRRA... and its final cost within 1e-3; the
              warm step-1 and step-2 bench iterations with "off";
14. spmd      the SPMD window layout on a 1-device mesh (`make_mesh(1)`;
              venice-89's plan: 73 windows of one class, one part
              (1536, 5), o_dev = 598,016 lanes, 112,128 slot rows): the
              three slot reduce/expand kernels bit for bit against their
              plain versions on the mesh solver's own operands at that
              layout and on seeded ones at the two-class plan of
              tools/step2_spread.py's `overflow_case`, with event and
              device times, bounds and the times of their PyTorch view
              formulations; `bundle_adjust(mesh=make_mesh(1))` with
              SolverOptions() defaults (counters zeroed before, read
              after: the three kernels and the composed terms launched,
              no fused term; step 1 in 25 records within 1e-3 of
              207.4787, step 2 in STEP2_BAND) and with PSC + RIPCG (step
              1 as PSC's, step 2 below PSC_STEP2_MAX); `overflow_case`
              card against CPU; the warm step-1 and step-2 bench
              iterations of the mesh against the single-device composed
              term's;
15. f64       pure f64 (`mixed_precision_solves=False`, one device,
              venice-89: the unstructured layout with f64 Jacobians,
              solves and camera-table kernels): (a) the five f64
              instantiations of the camera-table kernels against their
              plain versions at both steps' shapes (cam_gather also on
              step 2's 132-row tangent bases, cam_scatter_add also at
              R = 144 / 121), at N = 1024, and on the routes the
              venice-89 shapes do not take (cam_gather one observation
              a thread on cam[1:], hpp_b's private copies at N = 32, the
              global route of cam_scatter_add and e0_scatter at
              N = 6000), hpp_b's value groups also on the rows sorted by
              camera: cam_gather and e0_u bit for bit, per-camera
              sums within F64_CAM per camera, hpp symmetric bit for bit,
              with their times, bounds and those of `index_select` /
              `index_add_` in f64; (b) the venice-89 step 1 with
              POWER_VARPROJ defaults and (c) with CHOLESKY (its time and
              peak device memory; its final printed beside CHOL_BAND's
              243.9676 and the f32-epsilon f64 diagnostic's 143.5694689,
              neither a check), each on the card's kernels against the
              same solve with the plain versions on the card; (d) step 2
              (RIPOBA) from the homogenized result of (b), WITNESS_ITERS
              iterations on the calm landmarks, the same way: identical
              decisions and inner counts, accepted costs within F64_TOL;
              (e) one `bundle_adjust` with pure-f64 defaults (counters
              zeroed just before, read just after: the five f64
              instantiations and the f64 cost kernels launched), accepted
              costs falling, step 2 100x below its start; (f) the warm
              step-1 and step-2 bench iterations in pure f64;
16. large_n   N > 1024 on one card: (a) every kernel of both steps and
              the camera-table kernels in f32 and f64 at N = 13,682 on
              ~2^20 slot rows of a final-13682-shaped problem
              (synthetic_bal_problem_fast(13682, LARGE_N_LMS, 5, seed=0,
              locality=64)) against its plain version on the card, with
              the existing per-kernel tolerances, times and bounds (the
              routes past a block's shared memory: LARGE_N_ROUTES);
              (b) cam_gather and cam_scatter_add in f32 at R = 144 over
              O = 2^31 / 144 + 1 (R O past 2^31) against index_select
              (bit for bit) and index_add_; (c) venice-1778
              (tools/large_scale.py's scale) with SolverOptions()
              defaults: step 1's first LARGE_N_ITERS iterations on the
              card's kernels and on their plain versions on the card
              (same decisions and power-term counts, accepted costs
              within LARGE_N_TOL), then `bundle_adjust` (counters zeroed
              before, read after), each step's accepted costs falling and
              its final 100x below its start; (d) final-13682 (22.9M
              observations): `bundle_adjust` with START2_ITERS +
              FINAL_STEP2_ITERS iterations (3 + 10), and 2
              step-1 iterations each with POWER_SCHUR_COMPLEMENT (composed
              term), "off" and pure f64 (counters zeroed before each, read
              after: LARGE_N_RUNS), each cost falling, seconds and peak
              device memory printed; before them, step 1's first
              LARGE_N_ITERS iterations and one step-2 trial at
              STEP2_LAMBDA (from the homogenized VarProj initialization;
              tools/large_scale.py first_steps)
              on the card's kernels and on their plain versions: the
              same decisions and power-term counts, every step-1 trial's
              cost and the step-2 trial's l_diff and cost within
              FINAL_TOLS;
16a. mesh_large_n  the SPMD window layout past 1,024 cameras on a
              1-device mesh (`make_mesh(1)`), on large_n's venice-1778
              and final-13682 problems: (a) each scale's plan at D = 1
              (tools/large_scale.py plan_stats: plan and combine seconds,
              lane utilization, windows and parts per class,
              has_duplicates, lanes against observations); (b)
              venice-1778: the mesh's first LARGE_N_ITERS step-1
              iterations on the card's kernels (counters zeroed before,
              read after) and on their plain versions, the slot kernels'
              too: the same decisions and power-term counts, accepted
              costs within MESH_LARGE_N_TOL; (c) venice-1778:
              `bundle_adjust(mesh=make_mesh(1))` capped at MESH_BA_ITERS
              (counters zeroed before), each step's accepted costs
              falling; (d) final-13682: the mesh's first step-1
              iteration and one step-2 trial at STEP2_LAMBDA from the
              homogenized VarProj start (tools/large_scale.py
              first_steps; counters zeroed before the kernels' run, read
              after) on the kernels and on the plain versions: the same
              decisions and counts, every step-1 trial's cost and the
              trial's l_diff and cost within MESH_FINAL_TOLS; (e) the
              three slot kernels at final-13682's lanes and slot rows on
              seeded operands, bit for bit against their plain
              versions, with the loop timer, events, the bound and the
              view formulation's time; (f) D = 2 on the one card: two
              gloo ranks on cuda:0 (tools/gloo_card.py, a harness, not a
              user option; each rank first tries all_reduce, all_gather
              and broadcast on CUDA tensors, which torch 2.11's gloo
              takes), venice-1778's first LARGE_N_ITERS step-1
              iteration against a 1-device mesh's: the same decisions
              and counts, accepted costs within MESH_D2_TOL;
16b. spmd_f64  the mesh's pure f64 (`mixed_precision_solves=False` on
              a 1-device mesh: the structured window layout with f64
              storage and solves, tools/step2_spread.py's f64 helpers):
              (a) the fifteen structured f64 instantiations against their
              plain versions on the card (F64_SPECS per kind), each call
              one counted launch of its `_f64` name, with events, device
              and loop times and bounds, the Schur-Jacobi corrections
              symmetric bit for bit: at venice-89's 1-device mesh
              operands (its slot layout, its step-2 linearization at the
              homogenized VarProj start, seeded operands beside them) and
              on seeded operands at N = 13,682 over ~2^20 slot rows
              (large_n (a)'s problem), the routes past a block's shared
              memory; the three slot kernels' f64 instantiations bit for
              bit at the venice-89 layout (on the mesh solver's own
              operands) and at final-13682's 39.3M lanes (mesh_large_n
              (e)'s layout, seeded), timed; (b) venice-89 step 1 on the
              mesh in pure f64 with POWER_VARPROJ defaults on the
              kernels (counters zeroed before, read after) and on their
              plain versions on the card: the same decisions and counts,
              accepted costs within F64_MESH_TOLS, then its RIPOBA
              witness (WITNESS_ITERS iterations on the calm landmarks of
              its homogenized result) the same way, and one
              `bundle_adjust(mesh=make_mesh(1))` in pure f64 (counters
              zeroed before: the path's f64 kernels launched, no f32
              structured or slot kernel), accepted costs falling, step 2
              100x below its start; (c) (b)'s step 1 against the one
              device's pure f64 (the unstructured layout) on the card;
              (d) POWER_SCHUR_COMPLEMENT and PCG step 1 on the mesh (8
              iterations each) and PSC's RIPCG witness, kernels against
              plain versions; (e) venice-1778's first LARGE_N_ITERS
              step-1 iteration on the mesh in pure f64, kernels against
              plain versions; (f) the warm step-1 and step-2 bench
              iterations of the mesh in pure f64 at venice-89 and
              venice-1778;
16c. band_chol  CHOLESKY at any camera count (solver/band_chol.py;
              tools/large_scale.py band_run prints each run's route, bw,
              K, S, plan seconds and bytes, set-up seconds, ms of a
              trial, an assembly and a factorization and solve, and peak
              device memory): (a) venice-89 (no band: one supernode)
              and large_scale.BANDED_1000 (a band of S >= 2 supernodes,
              so the coupling blocks and the sweeps run): one
              linearization solved by the banded route (the dense one
              closed, `banded_route`) and by the dense one on the card,
              in mixed precision and pure f64, the increments within
              BAND_DENSE_TOLS; (b) venice-1778 (large_n's problem):
              CHOLESKY's first BAND_ITERS iterations on the card's
              kernels (counters zeroed before, read after) and on their
              plain versions, the same decisions, every trial's cost
              within BAND_TOL, the banded increment's residual at the
              VarProj start (large_scale.band_residual, S applied
              matrix-free as PCG applies it) within
              BAND_RESIDUAL_TOLS; then a CHOLESKY + RIPOBA
              `bundle_adjust` capped at BAND_BA_ITERS (counters zeroed
              before), accepted costs falling in both steps; (c)
              venice-1778-uniform: the full band with the JAX package's
              "FULL dense RCS" warning, one iteration; (d) final-13682
              (large_n's problem): two banded iterations, the cost
              falling, the residual as (b)'s; (e) final-13682-adversarial:
              the PCG fallback with its "falling back to PCG" warning,
              one trial with CG iterations; hpp_b's and
              cam_scatter_add's launches in each run printed;
16d. detailed_timing  the staged host loop (`detailed_timing=True`;
              tools/stage_timing.py): (a) the venice-89 `bundle_adjust`
              with SolverOptions() defaults and detailed_timing (counters
              zeroed before, read after: the path's kernels, no lm
              kernel), step 1 in 25 records within 1e-3 of 207.4787, step
              2 in STEP2_BAND; in each record with a valid step the spans
              the JAX package's staged solvers fill each > 0, the spans
              summing to at most the record's iteration_time
              (stage_timing.check_spans); each step's per-span medians,
              and the staged, host-loop and device-loop wall ms per
              iteration of warm calls; (b) pure f64 step 1 at venice-89
              with POWER_VARPROJ and with CHOLESKY, staged against the
              fused host loop (device_lm_loop="off") on the card: the same
              decisions and counts, accepted costs within F64_TOL /
              F64_CHOL_TOL; (c) venice-89 written as BAL text, tokenized
              natively (utils/native.py) and with numpy: the same f64
              bits, both times printed;
17. cli       `python -m povar_tpu_torch.cli` in a subprocess with
              defaults, on tests/data/mini-bal-12-48-pre.txt and on the
              venice-89 problem written as BAL text, each after
              --create-dataset, venice-89 also with --mesh-devices 1:
              ba_log.json written, accepted costs strictly falling in
              both steps.

The second-to-last line is {"kernels": [...]}: per kernel, and per f64
instantiation (`<name>_f64`: the camera-table kernels', the structured
kernels' and the slot kernels'), its route,
source, replaced TPU kernel, launches in the first venice-89 run of the
main path that runs it (`launches_run` names it), max abs error against
the plain version, event times of kernel and plain version (the step-1
shape where a kernel runs in both steps), the least time the card could
take for the same call (`bound_ms`: the bytes the call must move at
3.35 TB/s or its arithmetic at the peak rate of its type, whichever is
larger; in f64 for the f64 instantiations) and `library_ms` (the event
time of `index_select` for cam_gather, of `index_add_` for
cam_scatter_add, each in the kernel's type, of the strided view
sum or broadcast for the three slot kernels; null for the others: no
single PyTorch call computes their functions); then one entry
`<name>@N13682` per route of LARGE_N_ROUTES, with large_n (a)'s numbers
and the launches of the first final-13682 run of (d) that runs it
(`launches_run`), and one per slot kernel with mesh_large_n (e)'s
numbers and the launches of its (d). lm_step and lm_condition replace
no TPU kernel (`replaces` null); their launches are those of the
device-loop runs, rebuilt from the graphs' region counts
(solver/device_loop.py). Each phase's line prints the seconds the
script has run. The last line is {"ok": true, "device": {...}}. Needs the repository (the package and its
kernel sources) beside this file; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

JAX_FINAL_COST = 207.47874642216357  # BENCH_r05.json e2e_final_cost_step1
JAX_FINAL_COST2 = 1845.1889071641926  # BENCH_r05.json e2e_final_cost_step2
JAX_RECORDS = 76  # BENCH_r05.json e2e_iterations (both steps' records)
# PCG (SCHUR_JACOBI) step 1 of the JAX package on the same problem:
# docs/results-venice89/runs/pcg-ripcg/venice-89/ba_log.json (made by
# scripts/gen_solver_matrix.py), its final cost, records and CG counts
JAX_PCG_COST = 205.39424619627198
JAX_PCG_COST2 = 6276.55332830183  # its RIPCG step 2 (a chaotic end state)
JAX_PCG_CG = [0, 3, 3, 6, 9, 7, 6, 5, 5, 5, 5, 4, 3, 3, 3, 2, 2, 2, 2, 2, 2,
              2, 2, 2, 2, 2, 2]
# PCG's step 1 is not reproducible to 1e-3: sixteen card runs of it
# (povar_tpu_torch/tools/step2_spread.py --pcg 16, an H100 80GB HBM3 at
# 700 W) ended between 203.76 and 216.56 (0.992x to 1.054x the JAX
# value, median 205.28), with eight different CG count sequences that
# all begin [3, 3, 6] and part at the fourth solve (7 to 11): the
# truncated CG stops on the q-tolerance test (eta = 1e-2), and near a
# tie f32 rounding decides it. The JAX run is one sample of that spread.
# So PCG's final step-1 cost is held to PCG_BAND x JAX_PCG_COST and its
# first PCG_SAME CG counts to the JAX run's exactly.
PCG_BAND = (0.98, 1.08)
PCG_SAME = 3
# POWER_SCHUR_COMPLEMENT: the JAX run on the same problem ends step 1 at
# its 50-iteration cap at 23.3188 (tools/step2_spread.py JAX_PSC_COST,
# JAX_PSC_DECISIONS), far below the VarProj basin (~207) that a wrong
# poBA apply falls into; its RIPOBA step 2 descends geometrically to
# 2.09e-5 and its RIPCG one to 6.9e-11. PSC_RUNS step-1 solves are held
# to PSC_BAND x that cost and below PSC_MAX, and each step 2 below
# PSC_STEP2_MAX. `step2_spread --psc 16` and this script's first run (24
# solves, an H100 80GB HBM3 at 700 W) ended all in 51 records at
# 23.2471-23.2628 (0.9969x-0.9976x JAX), every one with JAX's 50
# decisions and the same power-term counts, which part from JAX's at
# trials 30-31 only (7, 8 against 6, 7). Trial by trial the card's costs
# leave JAX's gradually (1e-5 by trial 11, 0.5% by trial 25), so the
# offset is the trajectory's, not one trial's. PSC_BAND holds the card's
# spread with about three times its width below it, and JAX's own value
# above it: a systematic error of half a percent fails. Step 2 after PSC
# does not always descend geometrically: `step2_spread --psc-ba` runs of
# PSC + RIPOBA `bundle_adjust` on an H100 80GB HBM3 at 700 W mostly end
# at 1e-5-1e-4 but some stall at 0.3-0.45 in rejection runs near the
# 50-iteration cap (PERF.md); the VarProj basin's step 2 ends at
# ~1.8e3. PSC_STEP2_MAX keeps that distinction with about twice the
# worst stall's headroom.
PSC_RUNS = 8
PSC_BAND = (0.995, 1.001)
PSC_MAX = 30.0
PSC_STEP2_MAX = 1.0
# the f32 state's step 1 against the f64 JAX run: within 1e-2 relative
F32_STEP1_TOL = 1e-2
# CHOLESKY: the JAX run on the same problem (docs/results-venice89/runs/
# cholesky-ripoba/venice-89/ba_log.json, tools/step2_spread.py
# JAX_CHOL_COSTS) takes 11 records, AARRRA then descent to the function
# tolerance at 243.9675604042901, on a TPU v5e whose unstructured layout
# runs every camera sum and gather, and S = -A A^T, as default-precision
# (bf16-operand) matmuls. The port's f32 arithmetic takes another path:
# `step2_spread --chol 8` on an H100 80GB HBM3 at 700 W and this script's
# runs accepted every trial (26 records) and ended at 144.97-145.45
# (0.594x-0.596x JAX); the plain versions on the CPU (`--chol 1
# --chol-device cpu`) also accepted every trial (29 records) and ended at
# 82.12: their first trial costs agree to 1.8e-6, the second to 5e-4
# (the f32 S's conditioning at lambda 2e-4 amplifies the rounding of two
# arithmetics), and the flat pOSE valley does the rest. So CHOLESKY is
# held to the first trial's cost within CHOL_FIRST_TOL of the CPU's
# CHOL_FIRST, its first CHOL_SAME trials accepted as on both devices, and
# its final cost within CHOL_BAND x JAX's, about twice the card's spread
# on each side of it.
CHOL_FIRST = 244.0243280214527
CHOL_FIRST_TOL = 1e-4
CHOL_SAME = 10
CHOL_BAND = (0.59, 0.60)
# pure f64 (the f64 phase): the venice-89 solves on the card's kernels
# and on their plain versions on the card must take the same decisions
# and inner counts, with every accepted cost within F64_TOL relative (f64
# sums in other orders); the f64 instantiations' per-camera sums within
# F64_CAM of their plain versions per camera. `step2_spread --f64 16` on
# an H100 80GB HBM3 at 700 W (16 runs a side, each kernel run against
# each plain run): POWER_VARPROJ's accepted costs at most 5.8e-11 apart,
# RIPOBA's step 2 1.2e-15, CHOLESKY's 1.713e-9 (within one side 1.1e-11
# on the kernels and 8.6e-11 on the plain versions: the kernels' order of
# sums moves its ill-conditioned dense system the same way every run).
# So CHOLESKY is held to F64_CHOL_TOL, twice its largest gap, and the
# others to F64_TOL. CHOLESKY's step 1 in f64 with the f32 solves' Jacobi
# epsilon (tools/step2_spread.py --chol-f64, on an H100 80GB HBM3 at
# 700 W and on the CPU) ended at CHOL_F64_DIAGNOSTIC; pure f64 takes the
# f64 epsilon, so the two are printed side by side, not compared.
F64_TOL = 1e-9
F64_CHOL_TOL = 3.43e-9
F64_CAM = ("cam", 1e-12)
CHOL_F64_DIAGNOSTIC = 143.5694689
# each layout's f32 operators against their f64 evaluation at venice-89
# scale (check_layouts), per step and per camera: b, Hpp, one E0 term and
# the power-series increment. Two runs on an H100 80GB HBM3 at 700 W put
# step 1 at b <= 1.0e-6, Hpp <= 4.2e-6, E0 <= 2.5e-4, increment <= 1.6e-5
# for either layout, and step 2 at b 6.2e-3-1.0e-2 / 2.4e-3-6.9e-3
# (unstructured / structured), Hpp 1.8e-6, E0 <= 7.3e-4, increment
# 2.5e-2 / 0.8e-2-2.1e-2: step 2's per-camera gradient is a sum of nearly
# cancelling terms near the step-1 optimum, so both f32 layouts lose two
# digits of it and the increment follows, by an amount that changes with
# the step-1 result. Step 1 keeps 6-25x headroom, step 2 ~10x; a wrong
# formula is off by O(1).
LAYOUT_TOLS = {
    1: {"b": 1e-5, "Hpp": 1e-4, "E0": 2e-3, "increment": 1e-4},
    2: {"b": 0.1, "Hpp": 1e-4, "E0": 5e-3, "increment": 0.3},
}
# Step 2 of this noise-free problem stops at its 50-iteration cap in
# mid-descent along a chaotic path: from ONE step-1 result, twenty runs
# on an H100 ended between 1644 and 1801 (the f32 atomics' order
# alone), and thirty bundle_adjust runs between 1689 and 6006 (0.92x to
# 3.26x the JAX value), their step-2 start costs spread from 8.0e5 to
# 1.7e9 by step 1's own rounding (povar_tpu_torch/tools/step2_spread.py;
# PERF.md). No run can match one 50-iteration snapshot to 1e-3, so the
# 50-iteration end state is held only to a sanity band around the JAX
# value that covers that measured spread, and to a drop of at least 100x
# below its start; the tight check of step 2 at this scale is the
# witness (check_step2_witness: its first iterations, card against CPU).
STEP2_BAND = (0.5, 4.0)
STEP2_DROP = 1e-2
# large N (the large_n phase): (a)'s problem has final-13682's cameras,
# camera locality and track length with fewer landmarks (~2^20 slot
# rows, so the plain versions stay cheap); (c) the venice-1778 step 1's
# first LARGE_N_ITERS iterations (tools/large_scale.py: past the first,
# its trajectory is chaotic in f32 rounding on either side) on the card's
# kernels and on their plain versions on the card must take the same
# decisions and power-term counts, with every accepted cost within
# LARGE_N_TOL relative: twice the largest gap of two calls of `python -m
# povar_tpu_torch.tools.large_scale spread --runs 8` (each of 8 kernel
# runs against each of 8 plain runs: 3.44e-6 and 6.66e-6; within the
# kernel runs <= 6.1e-8, within the plain ones, whose index_add_ sums in
# a run-dependent order, <= 7.3e-6; NVIDIA H100 80GB HBM3, 700 W), as
# F64_CHOL_TOL was set.
LARGE_N = 13_682
LARGE_N_LMS = 209_716
LARGE_N_TOL = 1.34e-5
# (d) final-13682's first step-1 iteration and one step-2 trial from the
# homogenized VarProj initialization (tools/large_scale.py first_steps),
# on the card's kernels and on their plain versions on the card: the same
# decisions and power-term counts, every step-1 trial's cost and the
# step-2 trial's l_diff and cost within FINAL_TOLS[step] relative, twice
# the largest kernel-against-plain gap of `python -m
# povar_tpu_torch.tools.large_scale spread final-13682` (each kernel run
# against each plain run; step 1 in nine calls of 4 to 12 runs: 6.77e-4
# at most, within the kernel runs <= 6.3e-7, within the plain ones,
# whose index_add_ sums 22.9M rows in a run-dependent order, <= 5.4e-4;
# the step-2 trial in two calls of 6 runs: 1.59e-8, 1.78e-8,
# within each side <= 1.3e-8; NVIDIA H100 80GB HBM3, 700 W), as
# LARGE_N_TOL was set
FINAL_TOLS = (1.36e-3, 3.55e-8)
# the kernels whose routes past a block's shared memory N = 13,682 takes
# (csrc/pose_common.cuh launch_tiles; prepare's global sums, prepare2's
# global accumulator; the tables the others read in place at any N): the
# `kernels` line's `<name>@N13682` entries
LARGE_N_ROUTES = ("prepare", "e0_factor", "e0_u_structured", "apply_ldiff",
                  "pose_error", "e0_term_parts", "poba_t3",
                  "apply_ldiff_stored", "prepare2", "mat_dot2", "ldiff2",
                  "e0_term2_parts", "e0_u", "e0_u_f64")
# the mesh_large_n phase (the SPMD window layout on a 1-device mesh):
# (b) venice-1778's first step-1 iteration and (d) final-13682's and
# one step-2 trial at STEP2_LAMBDA from the homogenized VarProj start, on
# the card's kernels and on their plain versions (the slot kernels'
# too), relative, as LARGE_N_TOL and FINAL_TOLS: twice the largest
# kernel-against-plain gap of `python -m povar_tpu_torch.tools.large_scale
# spread --mesh` in two calls (venice-1778, 6 and 16 runs a side: 5.74e-6
# and 6.60e-6, within the kernel runs <= 8.7e-7, within the plain ones,
# whose index_add_ sums in a run-dependent order, <= 1.06e-5;
# final-13682, 4 and 8 runs a side: step 1 3.76e-4 and 5.04e-4, within
# the kernel runs 0, within the plain ones <= 6.8e-4; the step-2 trial
# 1.17e-8 and 1.19e-8; NVIDIA H100 80GB HBM3, 700 W)
MESH_LARGE_N_TOL = 1.32e-5
MESH_FINAL_TOLS = (1.01e-3, 2.38e-8)
# (c)'s capped bundle_adjust(mesh=make_mesh(1)) at venice-1778: step 2
# starts from the LM loop's own point, where its first trials may be NaN
# or rising by f32 rounding (tools/large_scale.py START2_ITERS), so it
# gets as many iterations as final-13682's does; a step-2 iteration of
# the mesh there takes ~35 ms of wall on an H100 (tools/large_scale.py
# mesh)
MESH_BA_ITERS = (3, 10)
# (f) D = 2 on one card: venice-1778's first LARGE_N_ITERS step-1
# iteration against a 1-device mesh's (the second trial is chaotic: a
# 1-device mesh once rejected it at 2357 where D = 2 took 2158), accepted
# costs within MESH_D2_TOL relative: twice the largest gap of any two runs
# of `python -m povar_tpu_torch.tools.gloo_card --runs 8` (8 + 8 runs:
# 7.71e-7, every run A with 1 term; NVIDIA H100 80GB HBM3, 700 W)
MESH_D2_TOL = 1.55e-6
# the mesh's pure f64 (the spmd_f64 phase): each f64 instantiation's
# outputs against its plain version on the card, by kind (tools/
# parity.py), held to the f64 phase's 1e-12 (F64, F64_CAM): the kernels
# build with --fmad=false, so elementwise outputs agree bit for bit, and
# the per-camera and block sums differ by their order alone (largest
# measured 1.6e-13 per camera, hppb2 and prepare2 at venice-89's
# near-plane rows, 1.8e-16 for l_diff, 0 elementwise; NVIDIA H100 80GB
# HBM3, 700 W). The mesh's solves on the kernels against the same on
# the plain versions (F64_MESH_TOLS: the step-1 solves of
# tools/step2_spread.py's F64_MESH_CONFIGS, their step-2 witnesses, the
# mesh's POWER_VARPROJ step 1 against one device's, venice-1778's first
# iteration), relative: each twice the largest gap, kernel runs against
# plain runs and within either side, of two calls of `python -m
# povar_tpu_torch.tools.step2_spread --runs 0 --long 0 --f64-mesh N` (4
# and 8 runs a side: step 1 POWER_VARPROJ 4.70e-12 / 1.37e-11, PSC 8
# iterations 1.10e-14 / 2.56e-14, PCG 8 iterations 1.57e-12 / 2.28e-12;
# the RIPOBA witness 4.35e-16 / 8.70e-16, RIPCG's 7.25e-16 (8 runs; from
# PSC's 8 iterations it parted by 1.7e-3 between kernel runs, so the
# witnesses start from POWER_VARPROJ's converged step 1); the mesh
# against one device 2.57e-12 / 2.98e-12) and of `python -m
# povar_tpu_torch.tools.large_scale spread venice-1778 --mesh --f64`
# (4 / 8 runs: 7.71e-15 / 2.17e-14); NVIDIA H100 80GB HBM3, 700 W
F64_SPECS = {"elem": ("elem", 1e-12), "cam": F64_CAM,
             "scalar": ("scalar", 1e-12)}
F64_MESH_TOLS = {"varproj step 1": 2.73e-11,
                 "varproj RIPOBA witness": 1.74e-15,
                 "varproj RIPCG witness": 1.45e-15,
                 "varproj mesh vs one device": 5.96e-12,
                 "psc step 1": 5.11e-14, "pcg step 1": 4.57e-12,
                 "venice-1778": 4.33e-14}
# the banded CHOLESKY (the band_chol phase, solver/band_chol.py): (a)
# the banded increment of one linearization against the dense one on the
# card, relative in norm, mixed precision and pure f64, at venice-89 (one
# supernode) and at large_scale.BANDED_1000 (S = 8: the coupling blocks
# and the sweeps); (b) venice-1778's first BAND_ITERS CHOLESKY
# iterations on the card's kernels and on their plain versions, every
# trial's cost within BAND_TOL relative; (b) and (d) the banded
# increment's residual ||S x - b|| / ||b|| at the VarProj start of
# venice-1778 and final-13682, S applied matrix-free
# (large_scale.band_residual). Each is twice the largest gap of a spread
# measured on the card, as LARGE_N_TOL was set: `python -m
# povar_tpu_torch.tools.large_scale band-spread` (fresh linearizations at
# lambda 1e-4) in calls of 6, 16 and 8 runs: venice-89 7.95e-4 / 8.95e-4
# / 8.20e-4 mixed, 1.70e-12 / 1.86e-12 / 1.32e-12 f64; in the call of 8
# runs BANDED_1000 2.97e-4 mixed, 4.98e-13 f64, and the residuals
# 4.5e-7-9.28e-7 at venice-1778, 4.2e-7-8.54e-7 at final-13682 (a
# wrong coupling block gives ~7e-2: tests/test_torch_band_chol.py);
# `large_scale spread venice-1778 --solver CHOLESKY` in two calls of 4
# and 8 runs a side (each kernel run against each plain run): 1.22e-4 /
# 1.49e-4, within the kernel runs <= 1.0e-4, within the plain ones <=
# 1.6e-4, every run's decisions AA; NVIDIA H100 80GB HBM3, 700 W
BAND_DENSE_TOLS = {"venice-89": {"mixed": 1.79e-3, "f64": 3.72e-12},
                   "banded-1000": {"mixed": 5.93e-4, "f64": 9.95e-13}}
BAND_TOL = 2.99e-4
BAND_RESIDUAL_TOLS = {"venice-1778": 1.86e-6, "final-13682": 1.71e-6}
# (b)'s capped CHOLESKY + RIPOBA bundle_adjust at venice-1778
BAND_BA_ITERS = (3, 5)
N_CAMS, N_LMS, OBS_PER_LM = 89, 110_973, 5
REPS = 20
SOURCES = {"pose_kernels": "povar_tpu_torch/csrc/pose1.cu",
           "pose2_kernels": "povar_tpu_torch/csrc/pose2.cu",
           "cam_kernels": "povar_tpu_torch/csrc/cam.cu",
           "spmd_kernels": "povar_tpu_torch/csrc/spmd.cu",
           "lm_kernels": "povar_tpu_torch/csrc/lm.cu"}
REPLACES = {
    # the device LM loop's bookkeeping and condition kernels replace no
    # TPU kernel (csrc/lm.cu says why they exist)
    "lm_step": None,
    "lm_condition": None,
    "class_part_sums": "povar_tpu/ops/pallas_spmd.py:79",
    "class_expand_rows": "povar_tpu/ops/pallas_spmd.py:109",
    "class_reduce_reexpand": "povar_tpu/ops/pallas_spmd.py:144",
    "poba_t3": "povar_tpu/ops/pallas_pose.py:938",
    "apply_ldiff_stored": "povar_tpu/ops/pallas_pose.py:1096",
    "cam_gather": "povar_tpu/ops/pallas_cam.py:176",
    "cam_scatter_add": "povar_tpu/ops/pallas_cam.py:207",
    "e0_u": "povar_tpu/ops/pallas_cam.py:242",
    "e0_scatter": "povar_tpu/ops/pallas_cam.py:278",
    "hpp_b": "povar_tpu/ops/pallas_cam.py:333",
    "e0_term_parts": "povar_tpu/ops/pallas_pose.py:748",
    "schur_diag_structured": "povar_tpu/ops/pallas_pose.py:1020",
    "e0_term2_parts": "povar_tpu/ops/pallas_pose2.py:512",
    "schur_diag2": "povar_tpu/ops/pallas_pose2.py:601",
    "prepare": "povar_tpu/ops/pallas_pose.py:285",
    "e0_factor": "povar_tpu/ops/pallas_pose.py:385",
    "hpp_b_structured": "povar_tpu/ops/pallas_pose.py:489",
    "e0_u_structured": "povar_tpu/ops/pallas_pose.py:568",
    "e0_scatter_structured": "povar_tpu/ops/pallas_pose.py:623",
    "apply_ldiff": "povar_tpu/ops/pallas_pose.py:846",
    "pose_error": "povar_tpu/ops/pallas_pose.py:1319",
    "prepare2": "povar_tpu/ops/pallas_pose2.py:157",
    "hppb2": "povar_tpu/ops/pallas_pose2.py:267",
    "mat_dot2": "povar_tpu/ops/pallas_pose2.py:347",
    "scatter2": "povar_tpu/ops/pallas_pose2.py:412",
    "ldiff2": "povar_tpu/ops/pallas_pose2.py:667",
    "pose_error2": "povar_tpu/ops/pallas_pose2.py:822",
}
# (kind, tolerance) of each output, the kinds of
# povar_tpu_torch/tools/parity.py: elementwise outputs entry by entry
# against |plain| + the median |plain| of their row (the kernels build
# with --fmad=false, so only the rounding of the plain version's own
# operations can differ); per-camera sums camera by camera against that
# camera's largest |plain|, and l_diff against |plain| (both also see
# the order of f32 atomics); the f64 cost against |plain| (the order of
# f64 sums); counts and flags exactly
ELEM, CAM, SUM = ("elem", 1e-5), ("cam", 1e-4), ("scalar", 1e-4)
F64, EXACT = ("scalar", 1e-12), ("exact", 0.0)
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 and f64 rates
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# arithmetic per observation, counted roughly from the kernel sources
# (a multiply, an add, a division, a square root or an atomic add each
# count one); at these rates it never sets the bound, the bytes do
FLOPS_PER_OBS = {
    "prepare": 110, "e0_factor": 90, "hpp_b_structured": 230,
    "e0_u_structured": 40, "e0_scatter_structured": 60, "apply_ldiff": 90,
    "pose_error": 60, "prepare2": 110, "hppb2": 130, "mat_dot2": 40,
    "scatter2": 45, "ldiff2": 55, "pose_error2": 45,
    "e0_term_parts": 80, "schur_diag_structured": 160,
    "e0_term2_parts": 80, "schur_diag2": 175, "poba_t3": 95,
    "apply_ldiff_stored": 110, "cam_gather": 0,
    # the camera-table kernels at their step-1 shapes (R = 12; (dl, dc) =
    # (3, 12); (k, d) = (4, 12): b and the upper triangle, 90 sums), and
    # their f64 instantiations, counted at the f64 rate
    "cam_scatter_add": 12, "e0_u": 72, "e0_scatter": 84, "hpp_b": 720,
    "cam_gather_f64": 0, "cam_scatter_add_f64": 12, "e0_u_f64": 72,
    "e0_scatter_f64": 84, "hpp_b_f64": 720,
}
# the structured kernels' f64 instantiations (the mesh's pure f64) do the
# f32 ones' arithmetic, counted at the f64 rate
FLOPS_PER_OBS.update({f"{k}_f64": FLOPS_PER_OBS[k] for k in (
    "prepare", "e0_factor", "hpp_b_structured", "e0_u_structured",
    "e0_scatter_structured", "apply_ldiff", "poba_t3", "apply_ldiff_stored",
    "schur_diag_structured", "prepare2", "hppb2", "mat_dot2", "scatter2",
    "ldiff2", "schur_diag2")})
# the kernels each venice-89 run of the main path must launch
STEP1_COMPOSED = {"prepare", "e0_factor", "hpp_b_structured",
                  "e0_u_structured", "e0_scatter_structured", "apply_ldiff",
                  "pose_error"}
STEP1_FUSED = STEP1_COMPOSED - {"e0_u_structured",
                                "e0_scatter_structured"} | {"e0_term_parts"}
STEP2_COMPOSED = {"prepare2", "hppb2", "mat_dot2", "scatter2", "ldiff2",
                  "pose_error2"}
STEP2_FUSED = STEP2_COMPOSED - {"scatter2"} | {"e0_term2_parts"}
# POWER_SCHUR_COMPLEMENT applies through poba_t3 + apply_ldiff_stored;
# an f32 state's cost goes through cam_gather, not the f64 cost kernels
STEP1_PSC = STEP1_FUSED - {"apply_ldiff"} | {"poba_t3", "apply_ldiff_stored"}
F32_PATH = (STEP1_FUSED | STEP2_FUSED) - {"pose_error", "pose_error2"} | {
    "cam_gather"}
# the unstructured layout (Lin1 / Lin2): the five camera-table kernels and
# the f64 cost kernels; CHOLESKY's dense solve runs no power series, so no
# e0_u / e0_scatter, and its step 2 stays structured
UNSTRUCTURED = {"cam_gather", "cam_scatter_add", "e0_u", "e0_scatter",
                "hpp_b"}
STEP1_CHOL = {"cam_gather", "cam_scatter_add", "hpp_b", "pose_error"}
# the SPMD window layout: the composed terms (a mesh has no fused-term
# plan, as in the JAX package) and its three slot kernels
SPMD = {"class_part_sums", "class_expand_rows", "class_reduce_reexpand"}
FUSED_TERMS = {"e0_term_parts", "e0_term2_parts"}
# pure f64: both steps on the unstructured layout through the f64
# instantiations, the cost through the f64 cost kernels
F64_PATH = {"cam_gather_f64", "cam_scatter_add_f64", "e0_u_f64",
            "e0_scatter_f64", "hpp_b_f64", "pose_error", "pose_error2"}
# the large_n phase's final-13682 runs, in the order they run: each route
# entry's launches are those of the first that runs its kernel
LARGE_N_RUNS = {
    "bundle_adjust final-13682": STEP1_FUSED | STEP2_FUSED,
    "step 1 PSC composed final-13682": STEP1_COMPOSED - {"apply_ldiff"} | {
        "poba_t3", "apply_ldiff_stored"},
    "step 1 off final-13682": UNSTRUCTURED | {"pose_error"},
    "step 1 f64 final-13682": F64_PATH - {"pose_error2"},
}
# the device LM loop's kernels (ops/lm_kernels.py), in every run that
# takes it: SolverOptions()'s "auto" on one device, unless step 1 is
# CHOLESKY (its step 2 takes it); never on a mesh
LM = {"lm_step", "lm_condition"}
# the CUDA kernel (csrc/) each wrapper of the default path launches, by
# the name the profiler gives it
KERNEL_SYMBOLS = {
    "prepare": "prepare_kernel", "e0_factor": "e0_factor_kernel",
    "hpp_b_structured": "hpp_b_kernel", "e0_term_parts": "e0_term_kernel",
    "apply_ldiff": "ldiff_kernel", "pose_error": "pose_error_kernel",
    "prepare2": "prepare2_kernel", "hppb2": "hppb2_kernel",
    "e0_term2_parts": "e0_term2_kernel", "mat_dot2": "mat_dot2_kernel",
    "ldiff2": "ldiff2_kernel", "pose_error2": "pose_error2_kernel",
    "lm_step": "lm_step_kernel", "lm_condition": "lm_condition_kernel",
}
LARGE_N_RUNS = {k: v | LM for k, v in LARGE_N_RUNS.items()}
PATHS = {
    **LARGE_N_RUNS,
    "bundle_adjust venice-1778": STEP1_FUSED | STEP2_FUSED,
    "bundle_adjust f64": F64_PATH,
    "bundle_adjust spmd": STEP1_COMPOSED | STEP2_COMPOSED | SPMD,
    "bundle_adjust spmd PSC+RIPCG": (
        STEP1_COMPOSED - {"apply_ldiff"} | {"poba_t3", "apply_ldiff_stored"}
        | STEP2_COMPOSED | {"schur_diag2"} | SPMD),
    "bundle_adjust off": UNSTRUCTURED | {"pose_error", "pose_error2"},
    "bundle_adjust CHOLESKY+RIPOBA": STEP1_CHOL | STEP2_FUSED,
    "bundle_adjust CHOLESKY+RIPCG": STEP1_CHOL | STEP2_FUSED | {"schur_diag2"},
    "step 1 PSC": STEP1_PSC,
    "bundle_adjust PSC+RIPOBA": STEP1_PSC | STEP2_FUSED,
    "bundle_adjust PSC+RIPCG": STEP1_PSC | STEP2_FUSED | {"schur_diag2"},
    "bundle_adjust f32": F32_PATH,
    "step 1 composed": STEP1_COMPOSED,
    "step 1 defaults": STEP1_FUSED,
    "bundle_adjust defaults": STEP1_FUSED | STEP2_FUSED,
    "bundle_adjust PCG+RIPCG": STEP1_FUSED | STEP2_FUSED
    | {"schur_diag_structured", "schur_diag2"},
    "bundle_adjust composed": STEP1_COMPOSED | STEP2_COMPOSED,
}
PATHS = {k: v if k.startswith("bundle_adjust spmd") else v | LM
         for k, v in PATHS.items()}
# the band_chol phase's runs: CHOLESKY's step 1 takes the host loop (no
# lm kernels); its PCG fallback runs the unstructured CG's kernels
BAND_RUNS = {
    "step 1 CHOLESKY venice-1778": STEP1_CHOL,
    "bundle_adjust CHOLESKY+RIPOBA venice-1778": STEP1_CHOL | STEP2_FUSED | LM,
    "step 1 CHOLESKY venice-1778-uniform": STEP1_CHOL,
    "step 1 CHOLESKY final-13682": STEP1_CHOL,
    "step 1 CHOLESKY final-13682-adversarial": STEP1_CHOL | {"e0_u",
                                                             "e0_scatter"},
}
PATHS.update(BAND_RUNS)
# the detailed_timing phase's staged run: the host loop, no lm kernel
PATHS["bundle_adjust staged"] = STEP1_FUSED | STEP2_FUSED
# the mesh_large_n phase's runs (a mesh runs the composed terms and the
# host loop); the slot kernels' `<name>@N13682` entries take their
# launches from the last
MESH_FINAL_RUN = "first steps spmd final-13682"
PATHS.update({
    "step 1 spmd venice-1778": STEP1_COMPOSED | SPMD,
    "bundle_adjust spmd venice-1778": STEP1_COMPOSED | STEP2_COMPOSED | SPMD,
    MESH_FINAL_RUN: STEP1_COMPOSED | STEP2_COMPOSED | SPMD,
})
# the spmd_f64 phase's runs (the mesh's pure f64): the f64 instantiations
# of the composed terms' path and of the slot kernels, the cost through
# the f64 cost kernels; a witness's calm sub-problem may have landmarks
# with several slot rows (no reduce-reexpand then)
F64_STEP1 = {f"{k}_f64" for k in STEP1_COMPOSED - {"pose_error"}} | {
    "pose_error"}
F64_STEP2 = {f"{k}_f64" for k in STEP2_COMPOSED - {"pose_error2"}} | {
    "pose_error2"}
SPMD_F64 = {f"{k}_f64" for k in SPMD}
F64_WITNESS = F64_STEP2 | {"class_part_sums_f64", "class_expand_rows_f64"}
PATHS.update({
    "step 1 spmd f64": F64_STEP1 | SPMD_F64,
    "witness spmd f64 RIPOBA": F64_WITNESS,
    "step 1 spmd f64 PSC": (F64_STEP1 - {"apply_ldiff_f64"}
                            | {"poba_t3_f64", "apply_ldiff_stored_f64"}
                            | SPMD_F64),
    "witness spmd f64 RIPCG": F64_WITNESS | {"schur_diag2_f64"},
    "step 1 spmd f64 PCG": F64_STEP1 | {"schur_diag_structured_f64"}
    | SPMD_F64,
    "bundle_adjust spmd f64": F64_STEP1 | F64_STEP2 | SPMD_F64,
    "step 1 spmd f64 venice-1778": F64_STEP1 | SPMD_F64,
})


T_START = time.perf_counter()


def phase(name: str) -> None:
    """Open a phase: its name and the script's seconds so far."""
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median of `reps` CUDA-event timings of one call, after a warm-up.
    The events bracket the whole call, so a call whose host side
    (Python, allocation, launch) outlasts its device work is timed at
    its host cost: see device_us for the device's own time."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# profiler windows device_us opens before it gives up on one call
PROFILE_WINDOWS = 5
LOOP_REPS = 50


def loop_ms(fn, reps: int = LOOP_REPS) -> float:
    """The loop timer (tools/cam_ab.py's): CUDA events around `reps`
    back-to-back calls, after a warm-up, over `reps`."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_us(fn, reps: int = REPS) -> float:
    """Device time of one call in microseconds: the summed durations of
    every device operation (kernels, fills, copies) the profiler records
    over `reps` calls, divided by `reps`, from a window that recorded
    every operation of the calls. A call of `fn` runs a fixed number k of
    device operations, and the profiler now and then records none in a
    window or drops some (19 of 20 seen; PERF.md §6): k is taken as the
    largest ceil(recorded / reps) of the windows opened, and a window
    that recorded fewer than k reps operations is opened again, up to
    PROFILE_WINDOWS times (as tools/cam_ab.py counts them). Past that
    the fullest window's time is scaled by k reps over its operations,
    and a line says so; no operation recorded in any window raises
    rather than report 0.0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    k, best = 0, None
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        k = max(k, -(-len(ops) // reps))
        if ops and len(ops) == k * reps:
            return sum(ops) / reps
        if ops and (best is None or len(ops) > len(best)):
            best = ops
    if best is None:
        raise AssertionError(f"device_us: {PROFILE_WINDOWS} profiler windows "
                             f"of {reps} calls recorded no device operation")
    print(f"device_us: {PROFILE_WINDOWS} windows short of {k * reps} device "
          f"operations, the fullest recorded {len(best)}; scaled", flush=True)
    return sum(best) * k / len(best)


def kernel_us(fn, name: str, reps: int = REPS) -> float:
    """Device time in microseconds of one launch of the kernel `name`
    (KERNEL_SYMBOLS) by `fn`: the mean of the profiler's durations of
    that kernel alone over `reps` calls (device_us sums every device
    operation of a call; the profiler drops some, so this divides by the
    launches it recorded; NaN where PROFILE_WINDOWS windows recorded
    none: a diagnostic, not a check)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and KERNEL_SYMBOLS[name] in e.name]
        if ops:
            return sum(ops) / len(ops)
    return float("nan")


def _outputs(out):
    """A wrapper's result as a tuple of tensors (the cost's dict in its
    key order; the None a call returns for an output it skips left
    out)."""
    if isinstance(out, dict):
        return tuple(out.values())
    return tuple(t for t in out if t is not None) if isinstance(
        out, tuple) else (out,)


def compare(name, got, want, specs):
    """Each output against its plain version, scaled by its (kind, tol)
    in `specs` (povar_tpu_torch/tools/parity.py); raises on a miss.
    Returns (largest absolute error, the scaled error of each output)."""
    from povar_tpu_torch.tools.parity import scaled_error

    outs = list(zip(_outputs(got), _outputs(want)))
    if len(outs) != len(specs):
        raise AssertionError(f"{name}: {len(outs)} outputs, {len(specs)} specs")
    worst, rels = 0.0, []
    for k, ((g, w), (kind, tol)) in enumerate(zip(outs, specs)):
        try:
            rel = scaled_error(g, w, kind)
        except ValueError as e:
            raise AssertionError(f"{name}[{k}]: {e}") from e
        if not rel <= tol:
            raise AssertionError(f"{name}[{k}]: scaled error ({kind}) "
                                 f"{rel:.3e} > {tol:g}")
        worst = max(worst, float((g.double() - w.double()).abs().max()))
        rels.append(rel)
    return worst, rels


def bound_ms(name, inputs, outputs, n_obs, n_read=None):
    """The least time the card could take for one call: the larger of the
    bytes it must move (each input read once, each output written once)
    over the HBM bandwidth and its arithmetic over the peak rate of its
    type. `n_read`: observation rows whose operands the kernel reads
    (the kernels that skip dead rows read only the gate of the others);
    per-observation inputs other than the first (the gate) scale by it.
    A pair (n_gate, n_read) also scales the gate, for the fused terms,
    which read only the rows of their slot parts. Returns (ms, "bytes"
    or "operations")."""
    n_gate, n_read = (n_read if isinstance(n_read, tuple)
                      else (n_obs, n_obs if n_read is None else n_read))
    moved = 0.0
    for k, t in enumerate(x for x in inputs if x is not None):
        per_obs = t.dim() > 0 and t.shape[-1] == n_obs
        scale = (n_read if k > 0 else n_gate) / n_obs if per_obs else 1.0
        moved += t.numel() * t.element_size() * scale
    moved += sum(t.numel() * t.element_size() for t in _outputs(outputs))
    dtype = (torch.float64 if name in ("pose_error", "pose_error2")
             or name.endswith("_f64") else torch.float32)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = FLOPS_PER_OBS[name] * n_read / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def run_cases(kernels, plain, cases, n_obs, time_variants=False,
              loop=False):
    """Each case (name, variant, call, inputs, specs, n_read[, library]):
    the kernel against its plain version on the same card; the case of
    each kernel without a variant label (and, with `time_variants`, every
    case) gets event and device times and its bound, and those of
    `library` (a PyTorch call that computes the same function) where one
    is given; the unlabelled case's are the kernel's result, with `loop`
    also its loop timer (loop_ms, `loop_ms`). Returns {name: result
    dict}."""
    results = {}
    for name, variant, run, inputs, specs, n_read, *library in cases:
        got = run(kernels)
        torch.cuda.synchronize()
        want = run(plain)
        err, rels = compare(f"{name} {variant or ''}".strip(), got, want,
                            specs)
        rel = " ".join(f"{x:.1e}" for x in rels)
        res = results.setdefault(name, dict(max_abs_err=0.0))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        label = f"{name:<22} max_abs_err {err:.3e} scaled [{rel}]"
        if variant and not time_variants:
            print(f"{label} ({variant})", flush=True)
            continue
        ms = cuda_ms(lambda: run(kernels))
        plain_ms = cuda_ms(lambda: run(plain))
        b_ms, b_by = bound_ms(name, inputs, got, n_obs, n_read)
        lib = library[0] if library else None
        lib_ms = cuda_ms(lib) if lib is not None else None
        if not variant:
            res.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms)
        lib_txt = ("" if lib is None else
                   f"  library: events {lib_ms:.4f} ms device "
                   f"{device_us(lib):.1f} us")
        if loop and not variant:
            res["loop_ms"] = loop_ms(lambda: run(kernels))
            lib_txt += f"  loop: kernel {res['loop_ms'] * 1e3:.1f} us"
        print(f"{label}  events: kernel {ms:.4f} ms plain {plain_ms:.4f} ms  "
              f"device: kernel {device_us(lambda: run(kernels)):.1f} us "
              f"plain {device_us(lambda: run(plain)):.1f} us  bound "
              f"{b_ms * 1e3:.1f} us ({b_by}){lib_txt}"
              + (f" ({variant})" if variant else ""), flush=True)
    return results


def kernel_inputs(solver, problem, seed=0):
    """Seeded inputs at the solver's shapes: the real slot layout (cam,
    uv, mask) and numpy-seeded random operands."""
    rng = np.random.default_rng(seed)
    dev = solver.device
    o, n = int(solver.obs.cam.shape[0]), solver.n_cams
    mask = solver._mask1

    def f32(*shape, lo=None, hi=None):
        a = (rng.standard_normal(shape) if lo is None
             else rng.uniform(lo, hi, shape))
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    sw = f32(1, o, lo=0.5, hi=1.0) * mask
    return dict(
        cam=solver.obs.cam, uv=solver._uv_s, mask=mask,
        ct=torch.as_tensor(
            problem.cam_space.reshape(n, 12).T.copy(), dtype=torch.float32,
            device=dev,
        ),
        x=f32(3, o), sw=sw, w=sw * sw, r_w=f32(4, o) * mask,
        jls=f32(3, o, lo=0.1, hi=1.0), hib=f32(3, o), lh=f32(9, o),
        h=f32(9, o) * mask, z=f32(12, n), sb=f32(3, o), inc=f32(12, n),
        inc_lm=f32(3, o),
        ct64=torch.as_tensor(
            problem.cam_space.reshape(n, 12).T.copy(), dtype=torch.float64,
            device=dev,
        ),
        x64=torch.as_tensor(rng.standard_normal((3, o)), device=dev),
        uv64=solver.obs.uv,
    )


def check_kernels(solver, problem, alpha):
    from povar_tpu_torch.ops import cam_kernels as ck
    from povar_tpu_torch.ops import cam_ref as cr
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops import pose_ref as pr

    d = kernel_inputs(solver, problem)
    o = int(d["cam"].shape[0])
    results = run_cases(pk, pr, step1_cases(solver, d, alpha), o, loop=True)

    # the camera gather of the f32 state's cost, bit for bit, beside the
    # one PyTorch call that computes it (index_select on an int64 index);
    # then 132 rows over N = 1024 seeded cameras (in row blocks) and one
    # observation a thread (cam[1:]: O odd, cam not aligned to fours)
    cam64 = d["cam"].long()
    results.update(run_cases(ck, cr, [(
        "cam_gather", None, lambda m: m.cam_gather(d["ct"], d["cam"]),
        [d["cam"], d["ct"]], [EXACT], None,
        lambda: d["ct"].index_select(1, cam64),
    )], o))
    rng = np.random.default_rng(6)
    cam_big = torch.as_tensor(rng.integers(0, 1024, o).astype(np.int32),
                              device=solver.device)
    t_big = torch.as_tensor(rng.standard_normal((132, 1024)),
                            dtype=torch.float32, device=solver.device)
    cam1 = d["cam"][1:]
    run_cases(ck, cr, [
        ("cam_gather", "R = 132, N = 1024",
         lambda m: m.cam_gather(t_big, cam_big), [cam_big, t_big], [EXACT],
         None),
        ("cam_gather", "cam[1:]", lambda m: m.cam_gather(d["ct"], cam1),
         [cam1, d["ct"]], [EXACT], None)], o, time_variants=True)

    n = solver.n_cams
    check_symmetric("schur_diag_structured (venice-89)",
                    pk.schur_diag_structured(d["cam"], d["x"], d["h"], n))
    for name, label, args, kw, inputs, specs, n_read, n_obs in (
            kernels1_shapes(problem, solver, d, alpha)):
        run_cases(pk, pr, [(name, label,
                            lambda m, f=name, x=args, k=kw: getattr(m, f)(
                                *x, **k), inputs, specs, n_read)],
                  n_obs, time_variants=True)
        if name == "schur_diag_structured":
            check_symmetric(f"{name} {label}", pk.schur_diag_structured(*args))
    return results


def step1_cases(solver, d, alpha):
    """run_cases' cases of the eleven step-1 kernels on the inputs `d`
    (kernel_inputs) of `solver`'s layout; the fused term over its plan's
    parts."""
    n, o = solver.n_cams, int(d["cam"].shape[0])
    live = int((d["mask"] > 0).sum())
    a = dict(alpha=alpha)
    parts = solver.e0_plan.parts
    covered = sum(g * w for _ofs, g, w in parts)
    print(f"fused-term plan: parts (ofs, g, w) {parts}, {covered} of {o} "
          f"rows, suffix {solver.e0_plan.suffix}", flush=True)

    def case(name, run, keys, specs, n_read=None):
        return (name, None, run, [d[k] for k in keys], specs, n_read)

    cases = [
        case("prepare",
             lambda m: m.prepare(d["cam"], d["ct"], d["x"], d["uv"],
                                 d["mask"], robust=0, huber=1.0, **a),
             ("cam", "ct", "x", "uv", "mask"), [ELEM] * 4 + [CAM]),
        case("e0_factor",
             lambda m: m.e0_factor(d["cam"], d["ct"], d["uv"], d["w"],
                                   d["jls"], d["lh"], **a),
             ("cam", "ct", "uv", "w", "jls", "lh"), [ELEM]),
        case("hpp_b_structured",
             lambda m: m.hpp_b_structured(d["cam"], d["ct"], d["x"], d["uv"],
                                          d["sw"], d["r_w"], d["jls"],
                                          d["hib"], n, **a),
             ("sw", "cam", "ct", "x", "uv", "r_w", "jls", "hib"),
             [CAM, CAM], live),
        case("e0_u_structured",
             lambda m: m.e0_u_structured(d["cam"], d["x"], d["h"], d["z"]),
             ("cam", "x", "h", "z"), [ELEM]),
        case("e0_scatter_structured",
             lambda m: m.e0_scatter_structured(d["cam"], d["x"], d["h"],
                                               d["sb"], n),
             ("cam", "x", "h", "sb"), [CAM]),
        case("apply_ldiff",
             lambda m: m.apply_ldiff(d["cam"], d["x"], d["uv"], d["sw"],
                                     d["r_w"], d["jls"], d["inc_lm"],
                                     d["ct"], d["inc"], **a),
             ("sw", "cam", "x", "uv", "r_w", "jls", "inc_lm", "ct", "inc"),
             [SUM], live),
        case("pose_error",
             lambda m: m.pose_error(d["cam"], d["ct64"], d["x64"], d["uv64"],
                                    d["mask"], robust=0, huber=1.0, **a),
             ("mask", "cam", "ct64", "x64", "uv64"), [F64, F64, EXACT], live),
        case("e0_term_parts",
             lambda m: m.e0_term_parts(d["cam"], d["x"], d["h"], d["z"],
                                       parts, n),
             ("cam", "x", "h", "z"), [CAM], (covered, covered)),
        case("schur_diag_structured",
             lambda m: m.schur_diag_structured(d["cam"], d["x"], d["h"], n),
             ("h", "cam", "x"), [CAM], live),
        case("poba_t3",
             lambda m: m.poba_t3(d["cam"], d["ct"], d["x"], d["uv"], d["sw"],
                                 d["r_w"], d["jls"], d["z"], **a),
             ("cam", "ct", "x", "uv", "sw", "r_w", "jls", "z"), [ELEM]),
        case("apply_ldiff_stored",
             lambda m: m.apply_ldiff_stored(d["cam"], d["x"], d["uv"],
                                            d["sw"], d["r_w"], d["jls"],
                                            d["inc_lm"], d["ct"], d["z"],
                                            **a),
             ("cam", "x", "uv", "sw", "r_w", "jls", "inc_lm", "ct", "z"),
             [SUM]),
    ]
    return cases


def check_symmetric(label, corr):
    """A Schur-Jacobi correction [144, N] is symmetric bit for bit per
    camera: its last block writes a row and its mirror from one sum."""
    c = corr.view(12, 12, corr.shape[-1])
    if not torch.equal(c, c.transpose(0, 1)):
        raise AssertionError(f"{label}: corr is not symmetric")
    print(f"{label}: corr symmetric bit for bit", flush=True)


def kernels1_shapes(problem, solver, d, alpha):
    """The shapes beside check_kernels' venice-89 rows at which prepare,
    hpp_b_structured, e0_term_parts, schur_diag_structured and
    e0_scatter_structured are held to their plain versions and timed:
    (a) prepare without its per-camera sums (sums=False, as the
    back-substitution and the landmark initialization call it); (b) the
    camera-sorted lane orders, prepare, hpp_b_structured,
    schur_diag_structured and e0_scatter_structured on the 1-device mesh
    solver's own step-1 operands (the SPMD window order, 598,016 lanes;
    its linearization at the VarProj start, and its landmark solve's
    Hll^-1 bl there; h and sb seeded, zero on the masked lanes) and the
    fused term on the venice-89 operands `d` (kernel_inputs) with each
    part's landmarks sorted by the camera of their first slot row (the
    order the window plan packs them in, the same parts); (c) seeded
    cameras on the venice-89 rows, N = 1024 for all five
    (schur_diag_structured's global route, e0_scatter_structured's
    shared copies) and N = 2048 for hpp_b_structured (its global-memory
    route). Returns (kernel, label,
    args, kwargs, inputs for bound_ms, specs, n_read, O) per shape; also
    tools/pose1_ab.py's shapes."""
    from povar_tpu_torch import SolverOptions, Stage1Solver
    from povar_tpu_torch.tools.pose2_ab import first_camera_rows

    parts = solver.e0_plan.parts
    covered = sum(g * w for _ofs, g, w in parts)
    o = int(d["cam"].shape[0])
    hpp_keys = ("cam", "ct", "x", "uv", "sw", "r_w", "jls", "hib")
    e0_keys = ("cam", "x", "h", "z")

    def hpp(x, label, n):
        return ("hpp_b_structured", label,
                tuple(x[k] for k in hpp_keys) + (n,), dict(alpha=alpha),
                [x[k] for k in ("sw", "cam", "ct", "x", "uv", "r_w", "jls",
                                "hib")], [CAM, CAM],
                int((x["sw"] > 0).sum()), int(x["cam"].shape[0]))

    def e0(x, label, n):
        return ("e0_term_parts", label,
                tuple(x[k] for k in e0_keys) + (parts, n), {},
                [x[k] for k in e0_keys], [CAM], (covered, covered), o)

    def schur(x, label, n):
        return ("schur_diag_structured", label,
                (x["cam"], x["x"], x["h"], n), {},
                [x[k] for k in ("h", "cam", "x")], [CAM],
                int(x["h"].ne(0).any(dim=0).sum()), int(x["cam"].shape[0]))

    def scatter(x, label, n):
        keys = ("cam", "x", "h", "sb")
        return ("e0_scatter_structured", label,
                tuple(x[k] for k in keys) + (n,), {}, [x[k] for k in keys],
                [CAM], None, int(x["cam"].shape[0]))

    def prep(x, label, sums=True):
        args = tuple(x[k] for k in ("cam", "ct", "x", "uv", "mask"))
        return ("prepare", label, args,
                dict(alpha=alpha, robust=0, huber=1.0, sums=sums), list(args),
                [ELEM] * 4 + [CAM] if sums else [ELEM] * 2, None,
                int(x["cam"].shape[0]))

    ms = stage_solver(Stage1Solver, problem, SolverOptions(), mesh=True)
    c = torch.as_tensor(problem.cam_space, device="cuda")
    lin = ms.linearize(c, ms.lm_pack(ms.initialize_varproj(c)))
    _hll_inv, hib, jls, _lh = ms._hll_pieces_s(lin)
    lanes = int(ms.obs.cam.shape[0])

    def masked(rows, seed):
        return torch.as_tensor(
            np.random.default_rng(seed).standard_normal((rows, lanes)),
            dtype=torch.float32, device="cuda") * ms._mask1

    mesh = dict(cam=ms.obs.cam, ct=lin.ct, x=lin.x, uv=ms._uv_s, sw=lin.sw,
                r_w=lin.r_w, jls=jls, hib=hib, mask=ms._mask1,
                h=masked(9, 5), sb=masked(3, 6))
    rows = first_camera_rows(d["cam"], parts)
    by_first = dict(d, **{k: d[k][..., rows].contiguous()
                          for k in ("cam", "x", "h")})

    def with_cameras(n, seed):
        rng = np.random.default_rng(seed)
        cam = rng.integers(0, n, o).astype(np.int32)
        ct = rng.standard_normal((12, n))
        return dict(d, cam=torch.as_tensor(cam, device="cuda"),
                    ct=torch.as_tensor(ct, dtype=torch.float32,
                                       device="cuda"),
                    z=torch.as_tensor(rng.standard_normal((12, n)),
                                      dtype=torch.float32, device="cuda"))

    big = {n: with_cameras(n, n // 1024) for n in (1024, 2048)}
    return [
        prep(d, "(a) sums=False", sums=False),
        prep(mesh, "(b) mesh window order"),
        hpp(mesh, "(b) mesh window order", ms.n_cams),
        schur(mesh, "(b) mesh window order", ms.n_cams),
        scatter(mesh, "(b) mesh window order", ms.n_cams),
        e0(by_first, "(b) landmarks by first camera", solver.n_cams),
        prep(big[1024], "(c) N = 1024"),
        hpp(big[1024], "(c) N = 1024", 1024),
        e0(big[1024], "(c) N = 1024", 1024),
        schur(big[1024], "(c) N = 1024, global route", 1024),
        scatter(big[1024], "(c) N = 1024, shared copies", 1024),
        hpp(big[2048], "(c) N = 2048, global route", 2048),
    ]


def check_cam_kernels(solver, seed=2):
    """The four camera-table kernels of the unstructured layout (C2-C5)
    on the problem's slot layout with seeded operands, zeroed on the pad
    rows as the solvers' operands are, against their plain versions on
    the card: at both steps' shapes, each timed (the step-1 shape is the
    kernel's row), with `index_add_` beside cam_scatter_add; then C2, C4
    and C5 again on seeded cameras over N = 1024 (hpp_b's global-atomic
    route); C2 at R = 12 and 144 also on the rows sorted by camera and on
    seeded cameras over N = 6000 (its global-atomic route). e0_u sums its
    terms in its plain version's order: bit for bit; hpp_b's hpp is
    symmetric bit for bit."""
    from povar_tpu_torch.ops import cam_kernels as ck
    from povar_tpu_torch.ops import cam_ref as cr

    rng = np.random.default_rng(seed)
    dev = solver.device
    cam, mask = solver.obs.cam, solver._mask1
    o = int(cam.shape[0])

    def f32(rows, cols=None):
        a = torch.as_tensor(rng.standard_normal((rows, cols or o)),
                            dtype=torch.float32, device=dev)
        return a if cols else a * mask

    def index_add(v, cam, n):
        cam64 = cam.long()
        return lambda: torch.zeros((v.shape[0], n), device=dev).index_add_(
            1, cam64, v)

    def cases(cam, n, tag):
        """Step-1 shapes first (R = 12, (dl, dc) = (3, 12), (k, d) =
        (4, 12)), then step 2's and the Schur corrections' widths."""
        out = []
        for r, label in ((12, None), (144, "R = 144, step-1 Schur"),
                         (121, "R = 121, step-2 Schur")):
            v = f32(r)
            out.append(("cam_scatter_add", ", ".join(x for x in (label, tag)
                                                       if x) or None,
                        lambda m, v=v: m.cam_scatter_add(v, cam, n), [cam, v],
                        [CAM], None, index_add(v, cam, n)))
        for dc, label in ((12, None), (11, "(dl, dc) = (3, 11)")):
            w, x, sb = f32(3 * dc), f32(dc, n), f32(3)
            variant = ", ".join(v for v in (label, tag) if v) or None
            if tag is None:
                out.append(("e0_u", variant,
                            lambda m, w=w, x=x: m.e0_u(w, cam, x),
                            [cam, w, x], [EXACT], None))
            out.append(("e0_scatter", variant,
                        lambda m, w=w, sb=sb: m.e0_scatter(w, cam, sb, n),
                        [cam, w, sb], [CAM], None))
        for k, d, label in ((4, 12, None), (2, 11, "(k, d) = (2, 11)")):
            jp, rt = f32(k * d), f32(k)
            out.append(("hpp_b", ", ".join(v for v in (label, tag) if v)
                        or None,
                        lambda m, jp=jp, rt=rt: m.hpp_b(jp, rt, cam, n),
                        [cam, jp, rt], [CAM, CAM], None))
        return out

    results = run_cases(ck, cr, cases(cam, solver.n_cams, None), o,
                        time_variants=True)
    nb = 1024
    cam_big = torch.as_tensor(rng.integers(0, nb, o).astype(np.int32),
                              device=dev)
    run_cases(ck, cr, cases(cam_big, nb, "N = 1024"), o, time_variants=True)
    for c, n in ((cam, solver.n_cams), (cam_big, nb)):
        check_hpp_symmetric(ck, f32, c, n)
    # cam_scatter_add on the rows sorted by camera (whole warps on one
    # camera) and on its global route (seeded cameras over N = 6000: not
    # one copy of 11 N floats fits a block)
    by_cam = torch.argsort(cam.long(), stable=True)
    cam_sorted = cam[by_cam].contiguous()
    nw = 6000
    cam_wide = torch.as_tensor(rng.integers(0, nw, o).astype(np.int32),
                               device=dev)
    c2 = []
    for r in (12, 144):
        v = f32(r)
        vs = v[:, by_cam].contiguous()
        for label, c, x, n in (("sorted by camera", cam_sorted, vs,
                                solver.n_cams),
                               (f"N = {nw}, global route", cam_wide, v, nw)):
            c2.append(("cam_scatter_add", f"R = {r}, {label}",
                       lambda m, x=x, c=c, n=n: m.cam_scatter_add(x, c, n),
                       [c, x], [CAM], None, index_add(x, c, n)))
    run_cases(ck, cr, c2, o, time_variants=True)
    return results


def check_kernels2(solver2, cams_h, lms_h, seed=1, loop=False):
    """The eight step-2 kernels on the step-2 state (cams_h, lms_h) of the
    card's step-1 result: the linearization's own per-observation
    operands plus seeded zt, sb, mat6, hib and ilm4; the fused term over
    `solver2`'s plan (`loop`: run_cases')."""
    from povar_tpu_torch.ops import pose2_kernels as pk2
    from povar_tpu_torch.ops import pose2_ref as pr2
    from povar_tpu_torch.tools.step2_spread import CALM

    lin = solver2.linearize(cams_h, solver2.lm_pack(lms_h))
    rng = np.random.default_rng(seed)
    dev = solver2.device
    o, n = int(solver2.obs.cam.shape[0]), solver2.n_cams

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=dev)

    d = dict(
        cam=solver2.obs.cam, ct=lin.ct, x4=lin.x4, uv=solver2._uv_s,
        mask=solver2._mask1, mm=lin.mm, sw=lin.sw, r_w=lin.r_w,
        jlns=lin.jlns, jls8=lin.jls8,
        zt=f32(12, n), sb=f32(3, o), mat6=f32(6, o), hib=f32(3, o),
        ilm4=f32(4, o),
        ct64=solver2._cam_table(cams_h, torch.float64),
        x4_64=solver2._expand_L(solver2._lm_rows(solver2.lm_pack(lms_h))),
        uv64=solver2.obs.uv,
    )
    live = int((d["sw"] > 0).sum())
    live_mask = int((d["mask"] > 0).sum())
    print(f"step-2 state: {live} of {o} rows live after the validity "
          f"check ({live_mask} unmasked)", flush=True)

    # the same state restricted to its well-conditioned rows, every
    # per-observation operand zeroed on the others (dead rows): the rows
    # of landmarks near a camera's principal plane dominate whole-output
    # maxima and sums, here the largest entries are those of typical rows
    zinv = d["mm"][2].abs()
    live_rows = d["sw"][0] > 0
    med = float(zinv[live_rows].median())
    calm = (live_rows & (zinv <= CALM * med)).to(torch.float32)[None]
    n_calm = int(calm.sum())
    print(f"well-conditioned rows: {n_calm} of {live} live rows have "
          f"|1/p2| <= {CALM:g} x median {med:.4g} (max {float(zinv.max()):.4g})",
          flush=True)
    if n_calm < 0.9 * live:
        raise AssertionError(f"only {n_calm} of {live} rows well-conditioned")
    dc = dict(d, **{k: d[k] * calm
                    for k in ("mask", "sw", "mm", "r_w", "jlns", "jls8")})

    parts = solver2.e0_plan.parts
    covered = sum(g * w for _ofs, g, w in parts)
    main_valid = solver2.use_valid_only
    prep_specs = [ELEM] * 5 + [CAM]
    err_specs = [EXACT, F64, F64, EXACT, F64, F64, EXACT]

    def cases_on(d, tag):
        """The six kernels' cases on operands `d`. Without `tag` the
        first case of each kernel is its timed one; every other case is
        a variant named by its options and `tag`."""
        obs = [d[k] for k in ("cam", "x4", "mm", "sw")]

        def case(name, variant, run, keys, specs, n_read=None):
            label = ", ".join(v for v in (variant, tag) if v) or None
            return (name, label, run, [d[k] for k in keys], specs, n_read)

        live_d = int((d["sw"] > 0).sum())

        def prep(use_valid, robust):
            return lambda m: m.prepare2(d["cam"], d["ct"], d["x4"], d["uv"],
                                        d["mask"], use_valid=use_valid,
                                        robust=robust, huber=1.0)

        def err2(robust):
            return lambda m: m.pose_error2(d["cam"], d["ct64"], d["x4_64"],
                                           d["uv64"], d["mask"],
                                           robust=robust, huber=1.0)

        prep_in = ("cam", "ct", "x4", "uv", "mask")
        return [
            case("prepare2", None, prep(main_valid, 0), prep_in, prep_specs),
            case("prepare2", f"use_valid={not main_valid}",
                 prep(not main_valid, 0), prep_in, prep_specs),
            case("prepare2", "use_valid=True, HUBER", prep(True, 1), prep_in,
                 prep_specs),
            case("prepare2", "use_valid=False, HUBER", prep(False, 1),
                 prep_in, prep_specs),
            case("hppb2", None,
                 lambda m: m.hppb2(*obs, d["r_w"], d["jlns"], d["hib"], n),
                 ("sw", "cam", "x4", "mm", "r_w", "jlns", "hib"), [CAM, CAM],
                 live),
            case("mat_dot2", None,
                 lambda m: m.mat_dot2(*obs, d["mat6"], None, d["zt"],
                                      add_r=False),
                 ("cam", "x4", "mm", "sw", "mat6", "zt"), [ELEM]),
            case("mat_dot2", "add_r",
                 lambda m: m.mat_dot2(*obs, d["jlns"], d["r_w"], d["zt"],
                                      add_r=True),
                 (), [ELEM]),
            case("scatter2", None,
                 lambda m: m.scatter2(*obs, d["mat6"], d["sb"], n),
                 ("sw", "cam", "x4", "mm", "mat6", "sb"), [CAM], live),
            case("ldiff2", None,
                 lambda m: m.ldiff2(*obs, d["r_w"], d["jls8"], d["ilm4"],
                                    d["zt"]),
                 ("cam", "x4", "mm", "sw", "r_w", "jls8", "ilm4", "zt"),
                 [SUM]),
            case("pose_error2", None, err2(0),
                 ("mask", "cam", "ct64", "x4_64", "uv64"), err_specs,
                 live_mask),
            case("pose_error2", "HUBER", err2(1), (), err_specs),
            case("pose_error2", "CAUCHY", err2(2), (), err_specs),
            case("e0_term2_parts", None,
                 lambda m: m.e0_term2_parts(*obs, d["mat6"], d["zt"], parts,
                                            n),
                 ("sw", "cam", "x4", "mm", "mat6", "zt"), [CAM],
                 (covered, live_d)),
            case("schur_diag2", None,
                 lambda m: m.schur_diag2(*obs, d["mat6"], n),
                 ("sw", "cam", "x4", "mm", "mat6"), [CAM], live_d),
        ]

    results = run_cases(pk2, pr2, cases_on(d, None)
                        + cases_on(dc, "well-conditioned rows"), o,
                        loop=loop)
    # the cost sums its blocks' partials in a fixed order, without
    # floating-point atomics: two calls give the same bits
    for robust in (0, 1, 2):
        calls = [pk2.pose_error2(d["cam"], d["ct64"], d["x4_64"], d["uv64"],
                                 d["mask"], robust=robust, huber=1.0)
                 for _ in range(2)]
        if not all(torch.equal(calls[0][k], calls[1][k]) for k in calls[0]):
            raise AssertionError(f"pose_error2 (robust {robust}): two calls "
                                 f"differ: {calls}")
    print("pose_error2: two calls bit-identical under NONE, HUBER and "
          "CAUCHY", flush=True)
    return results


def check_kernels2_orders(problem, solver2, cams_h, lms_h, seed=4):
    """prepare2, hppb2, e0_term2_parts, schur_diag2 and scatter2 beside
    their venice-89 rows, each against its plain version and timed, on
    lines of their own: (b) the camera-sorted lane orders, prepare2,
    hppb2, schur_diag2 and scatter2 on the 1-device mesh solver's own
    step-2 operands (the SPMD window order; prepare2 on its linearization's
    camera table and landmarks; its landmark solve's Hll^-1 bl at lambda
    1e-4; mat6 and sb seeded) and the fused term on
    the venice-89 operands with each part's landmarks sorted by the camera
    of their first slot row (the order the window plan packs them in, the
    same parts); (c) seeded cameras on the venice-89 rows, N = 1024 for
    all four (schur_diag2's global route, scatter2's shared copies) and
    N = 2048 for hppb2 (its global-memory route); schur_diag2's output
    symmetric bit for bit at venice-89, (b) and (c)."""
    from povar_tpu_torch import SolverOptions, Stage2Solver
    from povar_tpu_torch.ops import pose2_kernels as pk2
    from povar_tpu_torch.ops import pose2_ref as pr2
    from povar_tpu_torch.tools.pose2_ab import first_camera_rows

    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device="cuda")

    # scatter2's seeded sb from a generator of its own (the operands
    # drawn from `rng` stay those of earlier trees' runs)
    sb_rng = np.random.default_rng(seed + 1)

    def operands(s, lm):
        lin = s.linearize(cams_h, s.lm_pack(lm))
        o = int(s.obs.cam.shape[0])
        return lin, dict(cam=s.obs.cam, x4=lin.x4, mm=lin.mm, sw=lin.sw,
                         r_w=lin.r_w, jlns=lin.jlns, hib=f32(3, o),
                         mat6=f32(6, o), zt=f32(12, s.n_cams), n=s.n_cams,
                         sb=torch.as_tensor(sb_rng.standard_normal((3, o)),
                                            dtype=torch.float32,
                                            device="cuda"))

    _lin, d = operands(solver2, lms_h)
    parts = solver2.e0_plan.parts
    o = int(d["cam"].shape[0])
    mesh_s = stage_solver(Stage2Solver, problem, SolverOptions(), mesh=True)
    mesh_lin, mesh = operands(mesh_s,
                              mesh_s.pad_landmarks(lms_h.cpu().numpy()))
    # the mesh solver's own landmark solve (lambda 1e-4), as its RIPOBA
    # trial hands hppb2 its Hll^-1 bl
    mesh["hib"] = mesh_s._prep_hll_s(mesh_lin, 1e-4)[1]
    rows = first_camera_rows(d["cam"], parts)
    keys = ("cam", "x4", "mm", "sw", "r_w", "jlns", "hib", "mat6")
    by_first = dict(d, **{k: d[k][..., rows].contiguous() for k in keys})

    def with_cameras(n):
        return dict(d, n=n, zt=f32(12, n), cam=torch.as_tensor(
            rng.integers(0, n, o).astype(np.int32), device="cuda"))

    def hppb2(x, label):
        args = [x[k] for k in ("cam", "x4", "mm", "sw", "r_w", "jlns", "hib")]
        return ("hppb2", label, lambda m: m.hppb2(*args, x["n"]),
                [x[k] for k in ("sw", "cam", "x4", "mm", "r_w", "jlns",
                                "hib")], [CAM, CAM],
                int((x["sw"] > 0).sum()))

    def schur2(x, label):
        args = [x[k] for k in ("cam", "x4", "mm", "sw", "mat6")]
        return ("schur_diag2", label, lambda m: m.schur_diag2(*args, x["n"]),
                [x[k] for k in ("sw", "cam", "x4", "mm", "mat6")], [CAM],
                int((x["sw"] > 0).sum()))

    def scatter2(x, label):
        keys = ("cam", "x4", "mm", "sw", "mat6", "sb")
        args = [x[k] for k in keys]
        return ("scatter2", label, lambda m: m.scatter2(*args, x["n"]),
                [x["sw"]] + [x[k] for k in keys if k != "sw"], [CAM],
                int((x["sw"] > 0).sum()))

    def prep2(s, lin, label):
        args = (s.obs.cam, lin.ct, lin.x4, s._uv_s, s._mask1)
        return ("prepare2", label,
                lambda m: m.prepare2(*args, use_valid=s.use_valid_only,
                                     robust=0, huber=1.0),
                list(args), [ELEM] * 5 + [CAM], None)

    def e0(x, label):
        args = [x[k] for k in ("cam", "x4", "mm", "sw", "mat6", "zt")]
        covered = sum(g * w for _ofs, g, w in parts)
        return ("e0_term2_parts", label,
                lambda m: m.e0_term2_parts(*args, parts, x["n"]),
                [x[k] for k in ("sw", "cam", "x4", "mm", "mat6", "zt")],
                [CAM],
                (covered, int((x["sw"] > 0).sum())))

    run_cases(pk2, pr2, [prep2(mesh_s, mesh_lin, "(b) mesh window order"),
                         hppb2(mesh, "(b) mesh window order"),
                         schur2(mesh, "(b) mesh window order"),
                         scatter2(mesh, "(b) mesh window order")],
              int(mesh["cam"].shape[0]), time_variants=True)
    run_cases(pk2, pr2, [
        e0(by_first, "(b) landmarks by first camera"),
        hppb2(with_cameras(1024), "(c) N = 1024"),
        e0(with_cameras(1024), "(c) N = 1024"),
        hppb2(with_cameras(2048), "(c) N = 2048, global route"),
    ], o, time_variants=True)
    big = with_cameras(1024)
    run_cases(pk2, pr2, [schur2(big, "(c) N = 1024, global route"),
                         scatter2(big, "(c) N = 1024, shared copies")], o,
              time_variants=True)
    for label, x in (("venice-89", d), ("(b) mesh window order", mesh),
                     ("(c) N = 1024", big)):
        check_symmetric(f"schur_diag2 {label}", pk2.schur_diag2(
            *(x[k] for k in ("cam", "x4", "mm", "sw", "mat6")), x["n"]))


def solve(problem, options, device, log=lambda s: None):
    """Build the solver and run optimize_step1. Returns (summary,
    (cams, lms), set-up seconds, solve seconds), the solve timed to a
    device synchronisation."""
    from povar_tpu_torch import (
        SolverSummary, Stage1Solver, Timer, from_numpy, optimize_step1,
    )

    t0 = time.perf_counter()
    _, cams, lms = from_numpy(
        problem.obs_cam, problem.obs_lm, problem.obs_uv, problem.cam_space,
        problem.lm_p, device=device,
    )
    solver = Stage1Solver(
        problem.obs_cam, problem.obs_lm, problem.obs_uv,
        problem.num_cameras, problem.num_landmarks, options, device=device,
    )
    summary = SolverSummary()
    if device == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = optimize_step1(solver, cams, lms, options, summary, Timer(), log)
    if device == "cuda":
        torch.cuda.synchronize()
    return summary, out, t1 - t0, time.perf_counter() - t1


def pipeline(problem, options, device, dtype=torch.float64, mesh=False):
    """bundle_adjust of a copy of `problem` on `device` (with `mesh`, on
    a 1-device mesh there: the SPMD window layout) with an LM state of
    `dtype`. Returns (problem out, summary1, summary2, seconds), timed to
    a device synchronisation (with `mesh`, the plan's build included)."""
    from povar_tpu_torch import bundle_adjust, make_mesh

    p = copy.deepcopy(problem)
    # the mesh plan an earlier check cached on `problem` is built again
    # inside the timed run, as a user's first call builds it
    vars(p).pop("_spmd_plan_cache", None)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, s1, s2 = bundle_adjust(p, options, log=lambda s: None, dtype=dtype,
                                device=device,
                                mesh=make_mesh(1, device) if mesh else None)
    if device == "cuda":
        torch.cuda.synchronize()
    return out, s1, s2, time.perf_counter() - t0


def check_small():
    """The step-1 slice on a small problem, card against CPU (plain
    versions): the same decisions and term counts, costs within 1e-3
    relative (f32 inner solves in another summation order)."""
    from povar_tpu_torch import SolverOptions, synthetic_bal_problem
    from povar_tpu_torch.tools.step2_spread import trajectory

    problem, _ = synthetic_bal_problem(n_cams=8, n_lms=60, obs_per_lm=5,
                                       seed=7)
    opts = SolverOptions()
    opts.max_num_iterations_step_1 = 6
    opts.fused_power_term = False
    opts.device_lm_loop = "off"
    trajs = [trajectory(solve(problem, opts, dev)[0]) for dev in ("cuda", "cpu")]
    gap = 0.0
    for (ok_g, it_g, c_g), (ok_c, it_c, c_c) in zip(*trajs):
        if (ok_g, it_g) != (ok_c, it_c):
            raise AssertionError(f"small solve: card {trajs[0]} != cpu {trajs[1]}")
        gap = max(gap, abs(c_g - c_c) / abs(c_c))
    if len(trajs[0]) != len(trajs[1]) or not gap <= 1e-3:
        raise AssertionError(f"small solve: cost gap {gap:.3e} (> 1e-3)")
    print(f"small problem (8 cams, 60 lms): card == cpu decisions over "
          f"{len(trajs[0])} iterations, max cost gap {gap:.3e}", flush=True)


def check_small_pipeline(config="composed"):
    """bundle_adjust on the small case of povar_tpu_torch/tools/
    step2_spread.py (`small_case`: the problem of tests/test_torch_stage2
    .py's pipeline test) under SMALL_CONFIGS[config], card against CPU:
    identical accept/reject decisions and inner counts in both steps,
    final costs within that module's SMALL_TOLS (2e-3 for step 1, 1e-3
    for step 2, set from fifty measured card runs). "cholesky" (its step
    2 starts where the small problem is chaotic): step 2 finite and below
    its start instead."""
    from povar_tpu_torch.tools.step2_spread import SMALL_TOLS, small_case

    problem, opts = small_case(config)
    runs = {dev: pipeline(problem, opts, dev)[1:3] for dev in ("cuda", "cpu")}
    for step, tol, g, c in zip((1, 2), SMALL_TOLS, runs["cuda"],
                               runs["cpu"]):
        dg = [(it.step_is_successful, it.linear_solver_iterations)
              for it in g.iterations]
        dc = [(it.step_is_successful, it.linear_solver_iterations)
              for it in c.iterations]
        fg, fc = g.final_cost.all.error, c.final_cost.all.error
        gap = abs(fg - fc) / abs(fc)
        print(f"small pipeline ({config}) step {step}: {len(dg)} records, "
              f"card == cpu decisions and counts: {dg == dc}, final {fg!r} "
              f"vs cpu {fc!r} (gap {gap:.3e})", flush=True)
        if step == 2 and config == "cholesky":
            if not (np.isfinite(fg) and fg < g.initial_cost.all.error):
                raise AssertionError(f"small {config} step 2: {fg}")
        elif dg != dc or not gap <= tol:
            raise AssertionError(f"small {config} step {step}: card {dg} "
                                 f"vs cpu {dc}, gap {gap:.3e} (> {tol:g})")


def check_ring(config):
    """`ring_pipeline` of povar_tpu_torch/tools/step2_spread.py under
    `config` ("psc": POWER_SCHUR_COMPLEMENT + RIPOBA; "f32": defaults with
    an f32 state) on the card and on the CPU: identical decisions and
    inner counts in both steps, every cost within RING_TOLS[config]
    relative of the CPU's."""
    from povar_tpu_torch.tools.step2_spread import (
        RING_TOLS, ring_compare, ring_pipeline,
    )

    card, cpu = (ring_pipeline(config, dev) for dev in ("cuda", "cpu"))
    for step, g, (same, gap), tol in zip((1, 2), card,
                                         ring_compare(card, cpu),
                                         RING_TOLS[config]):
        if not same:
            raise AssertionError(f"ring {config} step {step}: card and cpu "
                                 "decisions or counts differ")
        print(f"ring pipeline ({config}) step {step}: card == cpu decisions "
              f"and counts over {len(g.iterations)} records, largest cost gap "
              f"{gap:.3e} (tolerance {tol:g}), final "
              f"{g.final_cost.all.error!r}", flush=True)
        if not gap <= tol:
            raise AssertionError(f"ring {config} step {step}: cost gap "
                                 f"{gap:.3e} > {tol:g}")


def check_psc_step1(label, decisions, final):
    """Raise unless a venice-89 PSC step 1 (its accept/reject string
    after record 0 and its final cost) took JAX's 50 trials and ended
    below PSC_MAX and within PSC_BAND x the JAX cost; print where its
    decisions part from the JAX run's."""
    from povar_tpu_torch.tools.step2_spread import (
        JAX_PSC_COST, JAX_PSC_DECISIONS, same_prefix,
    )

    n = same_prefix(decisions)
    print(f"{label}: {len(decisions) + 1} records, final {final!r} "
          f"({final / JAX_PSC_COST:.4f}x JAX), first {n} decisions equal "
          f"to JAX's" + ("" if n == len(JAX_PSC_DECISIONS) else
                         f", parting at trial {n + 1}: {decisions[n:n + 1]} "
                         f"vs {JAX_PSC_DECISIONS[n]}"), flush=True)
    if len(decisions) != len(JAX_PSC_DECISIONS):
        raise AssertionError(f"{label}: {len(decisions)} trials, JAX 50")
    if not (final < PSC_MAX and PSC_BAND[0] * JAX_PSC_COST <= final
            <= PSC_BAND[1] * JAX_PSC_COST):
        raise AssertionError(f"{label}: final cost {final} outside "
                             f"{PSC_BAND} x {JAX_PSC_COST} or >= {PSC_MAX}")


def check_psc(problem, counts):
    """POWER_SCHUR_COMPLEMENT at venice-89: PSC_RUNS step-1 solves
    (counters zeroed before the first), then `bundle_adjust` with RIPOBA
    and with RIPCG (counters zeroed before each, kept in `counts`)."""
    from povar_tpu_torch import SolverOptions
    from povar_tpu_torch.ops import launches
    from povar_tpu_torch.options import SolverType, SolverTypeRiemannian
    from povar_tpu_torch.tools.step2_spread import (
        JAX_PSC_COST, JAX_PSC_DECISIONS, JAX_PSC_TERMS, psc_spread,
    )

    check_ring("psc")
    print(f"JAX PSC step 1: A{JAX_PSC_DECISIONS}, terms {JAX_PSC_TERMS}, "
          f"final {JAX_PSC_COST!r}", flush=True)
    launches.reset_launch_counts()
    recs = psc_spread(problem, 1)
    check_counts("step 1 PSC", launches.launch_counts())
    recs += psc_spread(problem, PSC_RUNS - 1)
    for k, r in enumerate(recs):
        print(f"PSC step 1 run {k}: terms {r['terms']}", flush=True)
        check_falling(r["label"], [c for c, ok in zip(
            r["costs"], "A" + r["decisions"]) if ok == "A"])
        check_psc_step1(f"PSC step 1 run {k}", r["decisions"], r["final"])
    bench_step1(problem, SolverOptions(
        solver_type_step_1=SolverType.POWER_SCHUR_COMPLEMENT), "step-1 PSC")

    for path, step2 in (("bundle_adjust PSC+RIPOBA",
                         SolverTypeRiemannian.RIPOBA),
                        ("bundle_adjust PSC+RIPCG",
                         SolverTypeRiemannian.RIPCG)):
        opts = SolverOptions(
            solver_type_step_1=SolverType.POWER_SCHUR_COMPLEMENT,
            solver_type_step_2=step2,
        )
        launches.reset_launch_counts()
        out, p1, p2, secs = pipeline(problem, opts, "cuda")
        counts[path] = launches.launch_counts()
        print(f"-- {path}: {secs:.3f} s", flush=True)
        check_counts(path, counts[path])
        check_psc_step1(f"{path} step 1", "".join(
            "A" if it.step_is_successful else "R"
            for it in p1.iterations[1:]), p1.final_cost.all.error)
        its2 = p2.iterations
        print(f"step 2: {p2.solver_type}, {len(its2)} records "
              f"({p2.termination_type}), "
              f"{''.join('A' if it.step_is_successful else 'R' for it in its2[1:])}"
              f", initial {its2[0].cost.all.error!r} final "
              f"{p2.final_cost.all.error!r}", flush=True)
        check_falling(f"{path} step 2", [it.cost.all.error for it in its2
                                         if it.step_is_successful])
        check_final(2, p2)
        if not p2.final_cost.all.error < PSC_STEP2_MAX:
            raise AssertionError(f"{path}: step 2 ends at "
                                 f"{p2.final_cost.all.error} >= "
                                 f"{PSC_STEP2_MAX}")
        if not all(np.isfinite(a).all() for a in (out.cam_space, out.lm_p_h)):
            raise AssertionError("non-finite optimized state")


def check_f32(problem, counts):
    """The f32 LM state: `ring_pipeline` card against CPU, then the
    venice-89 `bundle_adjust` with SolverOptions() defaults and
    dtype=torch.float32 (counters zeroed before, kept in `counts`)."""
    from povar_tpu_torch import SolverOptions
    from povar_tpu_torch.ops import launches

    check_ring("f32")
    path = "bundle_adjust f32"
    launches.reset_launch_counts()
    out, f1, f2, secs = pipeline(problem, SolverOptions(), "cuda",
                                 dtype=torch.float32)
    counts[path] = launches.launch_counts()
    print(f"-- {path}: {secs:.3f} s", flush=True)
    check_counts(path, counts[path])
    report_step(1, f1, JAX_FINAL_COST,
                (1 - F32_STEP1_TOL, 1 + F32_STEP1_TOL))
    report_step(2, f2, JAX_FINAL_COST2)
    print(f"f32 state: {len(f1.iterations)} + {len(f2.iterations)} records",
          flush=True)
    if out.cam_space.dtype != np.float32 or out.lm_p_h.dtype != np.float32:
        raise AssertionError(f"f32 state came back as {out.cam_space.dtype}")
    if not all(np.isfinite(a).all() for a in (out.cam_space, out.lm_p_h)):
        raise AssertionError("non-finite optimized state")


def check_step2_witness(problem, opts, cams_h, lms_h,
                        counts_when_rejected=True):
    """Step 2 at venice-89 width from one homogenized step-1 state
    (cams_h, lms_h), its first WITNESS_ITERS iterations twice on the card
    and once through the plain versions on the CPU (`step2_witness` of
    povar_tpu_torch/tools/step2_spread.py, which leaves out the landmarks
    near a camera's principal plane): the same accept/reject decisions
    and inner iteration counts (power terms, or the CG iterations of the
    accepted trials: see WITNESS_TOLS) in all three, the initial
    cost within 1e-12 and the k-th accepted cost within WITNESS_TOLS[k]
    relative of the CPU's."""
    from povar_tpu_torch.tools.step2_spread import (
        CALM, WITNESS_TOLS, step2_witness, witness_gaps,
    )

    print(f"step-2 witness solver: {opts.solver_type_step_2.value}, "
          f"fused_power_term={opts.fused_power_term}", flush=True)
    args, runs = step2_witness(problem, opts, cams_h, lms_h)
    print(f"step-2 witness problem: {args[4]} of {problem.num_landmarks} "
          f"landmarks, {len(args[0])} of {problem.num_observations} "
          f"observations (|1/p2| <= {CALM:g} x median everywhere)",
          flush=True)
    for label, (traj, secs) in runs.items():
        seq = "".join("A" if ok else "R" for ok, _n, _c in traj[1:])
        print(f"step-2 witness {label:<10} {secs:7.2f} s  {seq}  terms "
              f"{[n for _ok, n, _c in traj[1:]]}  initial {traj[0][2]!r} "
              f"last accepted {[c for ok, _n, c in traj if ok][-1]!r}",
              flush=True)
    for label, (same, init, gaps) in witness_gaps(
            runs, counts_when_rejected).items():
        print(f"step-2 witness {label} vs cpu: initial cost gap {init:.2e}, "
              f"accepted costs' gaps {[f'{x:.2e}' for x in gaps]}", flush=True)
        if not same:
            raise AssertionError(f"step-2 witness: {label} decisions "
                                 f"{runs[label][0]} != cpu {runs['cpu'][0]}")
        if not (init <= 1e-12
                and all(x <= t for x, t in zip(gaps, WITNESS_TOLS))):
            raise AssertionError(f"step-2 witness: {label} costs off the "
                                 f"cpu's ({init:.2e}, {gaps})")


def check_final(step, summary, jax_cost=None, band=None):
    """Raise unless the final cost of `step` meets its bound. Step 1:
    within `band` (lo, hi) times `jax_cost` where given, else within 1e-3
    relative of `jax_cost` (default the POWER_VARPROJ one). Step 2:
    finite, at most STEP2_DROP times its own initial cost, and within
    `band` times `jax_cost` where given."""
    final = summary.final_cost.all.error
    if step == 1:
        jax_cost = JAX_FINAL_COST if jax_cost is None else jax_cost
        if band is None and not abs(final - jax_cost) <= 1e-3 * jax_cost:
            raise AssertionError(f"step 1: final cost {final} off JAX "
                                 f"{jax_cost}")
    else:
        initial = summary.initial_cost.all.error
        if not (np.isfinite(final) and final <= STEP2_DROP * initial):
            raise AssertionError(f"step 2: final cost {final} not finite "
                                 f"or above {STEP2_DROP} x its initial "
                                 f"cost {initial}")
    if band is not None and not (band[0] * jax_cost <= final
                                 <= band[1] * jax_cost):
        raise AssertionError(f"step {step}: final cost {final} outside "
                             f"{band} x JAX {jax_cost}")


def report_step(step, summary, jax_cost, band=None):
    """Print one step's trajectory; raise unless accepted costs fall
    strictly and the final cost meets `check_final`."""
    its = summary.iterations
    seq = "".join("A" if it.step_is_successful else "R" for it in its[1:])
    terms = [it.linear_solver_iterations for it in its[1:]]
    final = summary.final_cost.all.error
    rel = abs(final - jax_cost) / jax_cost
    print(f"step {step}: {summary.solver_type}, iterations {len(its) - 1} "
          f"({summary.termination_type}: {summary.message})", flush=True)
    print(f"step {step}: accept/reject {seq}", flush=True)
    print(f"step {step}: inner iterations {terms}", flush=True)
    print(f"step {step}: initial cost {its[0].cost.all.error!r} final cost "
          f"{final!r} rel diff to JAX {rel:.3e}", flush=True)
    check_falling(f"step {step}",
                  [it.cost.all.error for it in its if it.step_is_successful])
    check_final(step, summary, jax_cost, band)


def check_falling(label, accepted):
    if any(b >= a for a, b in zip(accepted, accepted[1:])):
        raise AssertionError(f"{label}: accepted costs not strictly "
                             f"decreasing: {accepted}")


def check_counts(path, counts):
    """Raise unless every kernel that `path` (a key of PATHS) runs was
    launched in that run; print the counts."""
    print(f"launches ({path}) {counts}", flush=True)
    idle = sorted(k for k in PATHS[path] if counts[k] == 0)
    if idle:
        raise AssertionError(f"{path}: kernels of the path never launched: "
                             f"{idle}")


def widen(args, cams_h, lms_h, n_wide=4, extra=20, seed=3):
    """Stage-solver arguments `args` (obs_cam, obs_lm, obs_uv, N, M) with
    `extra` more observations on each of the first `n_wide` landmarks:
    slots of width > E0_TERM_MAX_W, so the fused plan gets a composed
    suffix. The new observations come from the cameras that do not
    observe the landmark yet and see it deepest in the homogeneous state
    (cams_h, lms_h): none lands near a camera's principal plane."""
    obs_cam, obs_lm, obs_uv, n_cams, n_lms = args
    rng = np.random.default_rng(seed)
    cams, lms, uvs = [obs_cam], [obs_lm], [obs_uv]
    depth = (cams_h[:, 2, :] @ lms_h[:n_wide].T).abs().cpu().numpy()
    for lm in range(n_wide):
        free = np.setdiff1d(np.arange(n_cams), obs_cam[obs_lm == lm])
        c = free[np.argsort(-depth[free, lm])[:extra]].astype(np.int32)
        cams.append(c)
        lms.append(np.full(extra, lm, np.int32))
        uvs.append(obs_uv[obs_lm == lm][:1]
                   + 0.1 * rng.standard_normal((extra, 2)))
    return (np.concatenate(cams), np.concatenate(lms), np.concatenate(uvs),
            n_cams, n_lms)


def first_term(hpp, b, lam):
    """B^-1 (-b) with B = hpp + lam I, the power series' first term: the
    operand E0 meets in a solve (a random one overflows f32 on the
    near-plane rows of step 2)."""
    from povar_tpu_torch.ops import linalg

    eye = torch.eye(hpp.shape[0], dtype=hpp.dtype, device=hpp.device)
    b_inv = linalg.inv_psd_smallf(hpp + lam * eye[:, :, None])
    return (b_inv * (-b)[None]).sum(dim=1)


def check_e0_operators(problem, cams, lms, cams_h, lms_h):
    """The fused E0 operator of each step against the composed one on
    one linearization and its first power term, per camera (CAM), at
    venice-89 scale: with every landmark narrow (the fused kernel alone)
    and with four landmarks widened past E0_TERM_MAX_W (fused parts plus
    the composed suffix). Step 1 runs on the problem, step 2 on its
    well-conditioned landmarks (`calm_subproblem`, as the witness). On
    the full step-2 state (near-plane rows in) it reports how many
    entries of each operator are not finite and raises where the fused
    one is not finite but the composed one is."""
    from povar_tpu_torch import SolverOptions, Stage1Solver, Stage2Solver
    from povar_tpu_torch.tools.step2_spread import calm_subproblem

    fused = SolverOptions()
    composed = SolverOptions(fused_power_term=False)
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    args2, lms_w = calm_subproblem(problem, cams_h, lms_h)
    lam = 1e-4

    def both(label, got, want):
        if not bool(torch.isfinite(want).all()):
            raise AssertionError(f"{label}: the composed operator is not "
                                 "finite")
        return compare(label, got, want, [CAM])[1][0]

    s2 = Stage2Solver(*args, fused, device="cuda")
    lin2 = s2.linearize(cams_h, s2.lm_pack(lms_h))
    _hi, hib_obs, b6 = s2._prep_hll_s(lin2, s2._solve_scalar(lam))
    v11 = first_term(*s2._hpp_b11(lin2, hib_obs), lam)
    c2 = Stage2Solver(*args, composed, device="cuda")
    bad_f = ~torch.isfinite(s2._e0_apply_s(lin2, b6)(v11))
    bad_c = ~torch.isfinite(c2._e0_apply_s(lin2, b6)(v11))
    print(f"full step-2 state, first power term at lambda {lam:g}: "
          f"{int((~torch.isfinite(v11)).sum())} non-finite entries of the "
          f"operand, {int(bad_f.sum())} of the fused E0, {int(bad_c.sum())} "
          f"of the composed E0", flush=True)
    if bool((bad_f & ~bad_c).any()):
        raise AssertionError("fused step-2 E0 not finite where the composed "
                             "one is")
    for label, a, a2 in (
            ("narrow", args, args2),
            ("widened", widen(args, cams_h, lms_h),
             widen(args2, cams_h, lms_w))):
        s1 = Stage1Solver(*a, fused, device="cuda")
        if (s1.e0_plan.suffix is None) != (label == "narrow"):
            raise AssertionError(f"{label}: plan {s1.e0_plan}")
        lin = s1.linearize(cams, s1.lm_pack(lms))
        _hi, hib_obs, jls_obs, lh_obs = s1._hll_pieces_s(lin)
        h = s1._h_factor_s(lin, jls_obs, lh_obs)
        v12 = first_term(*s1._hpp_b_s(lin, hib_obs, jls_obs), lam)
        c1 = Stage1Solver(*a, composed, device="cuda")
        r1 = both(f"step-1 E0 {label}", s1._e0_apply_s(lin, h)(v12),
                  c1._e0_apply_s(lin, h)(v12))

        s2 = Stage2Solver(*a2, fused, device="cuda")
        if (s2.e0_plan.suffix is None) != (label == "narrow"):
            raise AssertionError(f"{label}: step-2 plan {s2.e0_plan}")
        lin2 = s2.linearize(cams_h, s2.lm_pack(lms_w))
        _hi, hib_obs, b6 = s2._prep_hll_s(lin2, s2._solve_scalar(lam))
        v11 = first_term(*s2._hpp_b11(lin2, hib_obs), lam)
        c2 = Stage2Solver(*a2, composed, device="cuda")
        r2 = both(f"step-2 E0 {label}", s2._e0_apply_s(lin2, b6)(v11),
                  c2._e0_apply_s(lin2, b6)(v11))
        print(f"E0 fused vs composed, {label} (step-1 suffix "
              f"{None if s1.e0_plan.suffix is None else s1.e0_plan.suffix[0]}"
              f", step 2 on {a2[4]} calm landmarks): step 1 {r1:.2e}, "
              f"step 2 {r2:.2e} scaled per camera", flush=True)


def check_layouts(problem, cams_h, lms_h, lam=1e-4):
    """Both layouts' f32 operators at venice-89 scale against an f64
    evaluation of the unstructured formulas on the host CPU
    (tools/step2_spread.f64_twin), each fed the same landmark state: the
    per-camera b and Hpp, one E0 term (on the f64 first power term) and
    the power-series increment of one solve at `lam`, each per camera
    within its LAYOUT_TOLS entry, with the same term count; the gap
    between the two layouts printed. Step 1 at the VarProj-initialized
    start; step 2 on the well-conditioned landmarks of the homogenized
    step-1 result (`calm_subproblem`, as the witness)."""
    from povar_tpu_torch import SolverOptions, Stage1Solver, Stage2Solver
    from povar_tpu_torch.tools.parity import scaled_error
    from povar_tpu_torch.tools.step2_spread import calm_subproblem, f64_twin

    off, auto = SolverOptions(pallas_kernels="off"), SolverOptions()
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    args2, lms_w = calm_subproblem(problem, cams_h, lms_h)
    c = torch.as_tensor(problem.cam_space, device="cuda")
    n = problem.num_cameras
    for step in (1, 2):
        t0 = time.perf_counter()
        cls, a = (Stage1Solver, args) if step == 1 else (Stage2Solver, args2)
        su, ss = (cls(*a, o, device="cuda") for o in (off, auto))
        sr = f64_twin(cls, a, off)
        if step == 1:
            cams, lms = c, ss.initialize_varproj(c)
            lam_l = None  # VarProj: undamped landmark blocks
        else:
            cams, lms = cams_h, lms_w
            lam_l = ss._solve_scalar(lam)
        lu, ls = su.linearize(cams, lms), ss.linearize(cams, ss.lm_pack(lms))
        lr = sr.linearize(cams.cpu(), lms.cpu())

        def unstructured(s, lin):
            """(b, Hpp, the E0 operator) of a Lin1 / Lin2."""
            jp, jl = ((lin.Jp, lin.Jl) if step == 1
                      else (lin.Jp_ns, lin.Jl_ns))
            hll_inv, hll_inv_bl = s._hll_inv_u(jl, lin.r, lam_l)
            hpp, b = s._hpp_b_u(jp, jl, lin.r, hll_inv_bl)
            w = s._e0_factor_u(jp, jl, hll_inv)
            return b, hpp, lambda v: s._e0_w_matvec(v, w)

        if step == 1:
            _hi, hib_obs, jls_obs, lh_obs = ss._hll_pieces_s(ls)
            hpp_s, b_s = ss._hpp_b_s(ls, hib_obs, jls_obs)
            e0_s = ss._e0_apply_s(ls, ss._h_factor_s(ls, jls_obs, lh_obs))
        else:
            _hi, hib_obs, b6 = ss._prep_hll_s(ls, lam_l)
            hpp_s, b_s = ss._hpp_b11(ls, hib_obs)
            e0_s = ss._e0_apply_s(ls, b6)
        b_u, hpp_u, e0_u = unstructured(su, lu)
        b_r, hpp_r, e0_r = unstructured(sr, lr)
        v = first_term(hpp_r, b_r, lam)
        v32 = v.to("cuda", torch.float32)
        (inc_u, n_u), (inc_s, n_s), (inc_r, n_r) = (
            s.solve(lin, lam) for s, lin in ((su, lu), (ss, ls), (sr, lr)))
        outs = {"b": (b_u, b_s, b_r), "Hpp": (hpp_u, hpp_s, hpp_r),
                "E0": (e0_u(v32), e0_s(v32), e0_r(v)),
                "increment": (inc_u, inc_s, inc_r)}

        def gap(got, want):
            return scaled_error(got.cpu().double().reshape(-1, n),
                                want.cpu().double().reshape(-1, n), "cam")

        gaps = {k: [gap(x, r) for x in (u, s_)] + [gap(u, s_)]
                for k, (u, s_, r) in outs.items()}
        tols = LAYOUT_TOLS[step]
        print(f"step {step} layouts (lambda {lam:g}"
              + ("" if step == 1 else f", {args2[4]} calm landmarks")
              + f", {time.perf_counter() - t0:.1f} s), per camera against "
              "f64 (unstructured / structured; the two apart): "
              + ", ".join(f"{k} {u:.2e} / {s_:.2e}; {us:.2e}"
                          for k, (u, s_, us) in gaps.items())
              + f"; power terms {n_u} / {n_s} / f64 {n_r}", flush=True)
        over = {k: g[:2] for k, g in gaps.items() if not max(g[:2]) <= tols[k]}
        if not n_u == n_s == n_r or over:
            raise AssertionError(f"step {step} layouts: {over} over {tols}, "
                                 f"or terms {n_u} / {n_s} / {n_r}")


def check_chol_step1(label, summary, tpu=False):
    """Print a venice-89 CHOLESKY step 1 beside JAX's 11 records; raise
    unless its accepted costs fall strictly and: with `tpu` (the JAX
    run's one-hot arithmetic emulated, tools/step2_spread.
    emulate_tpu_onehot) its decisions are JAX's and its final cost within
    1e-3 of JAX's; otherwise its first trial's cost is within
    CHOL_FIRST_TOL of CHOL_FIRST, its first CHOL_SAME trials were
    accepted and its final cost is within CHOL_BAND x JAX's."""
    from povar_tpu_torch.tools.step2_spread import (
        JAX_CHOL_COSTS, JAX_CHOL_DECISIONS,
    )

    its = summary.iterations
    seq = "".join("A" if it.step_is_successful else "R" for it in its[1:])
    final = summary.final_cost.all.error
    print(f"{label}: {len(its)} records ({summary.termination_type}), A{seq}"
          f" (JAX A{JAX_CHOL_DECISIONS}), final {final!r} "
          f"({final / JAX_CHOL_COSTS[-1]:.6f}x JAX)", flush=True)
    for k in range(max(len(its), len(JAX_CHOL_COSTS))):
        ours = its[k] if k < len(its) else None
        cost = "-" if ours is None or ours.cost is None else repr(
            ours.cost.all.error)
        print(f"  record {k:2d}: "
              + (f"{'A' if ours.step_is_successful else 'R'} {cost:>22} "
                 f"lambda {1.0 / ours.trust_region_radius:.3e}" if ours
                 else " " * 45)
              + (f"   JAX {JAX_CHOL_COSTS[k]!r}"
                 if k < len(JAX_CHOL_COSTS) else ""), flush=True)
    check_falling(label, [it.cost.all.error for it in its
                          if it.step_is_successful])
    if tpu:
        if seq != JAX_CHOL_DECISIONS:
            raise AssertionError(f"{label}: decisions A{seq} != JAX's "
                                 f"A{JAX_CHOL_DECISIONS}")
        check_final(1, summary, JAX_CHOL_COSTS[-1])
        return
    first = its[1].cost.all.error
    if not abs(first - CHOL_FIRST) <= CHOL_FIRST_TOL * CHOL_FIRST:
        raise AssertionError(f"{label}: first trial's cost {first!r} off "
                             f"{CHOL_FIRST!r} (the CPU's)")
    if seq[:CHOL_SAME] != "A" * CHOL_SAME:
        raise AssertionError(f"{label}: opening decisions A{seq[:CHOL_SAME]}"
                             f" (every device accepted the first {CHOL_SAME})")
    check_final(1, summary, JAX_CHOL_COSTS[-1], CHOL_BAND)


def chol_solve_memory(problem, opts, label):
    """One warm venice-89 CHOLESKY solve at lambda 1e-4 under `opts`
    from the VarProj start: its time and peak device memory, printed."""
    from povar_tpu_torch import Stage1Solver

    s = Stage1Solver(problem.obs_cam, problem.obs_lm, problem.obs_uv,
                     problem.num_cameras, problem.num_landmarks, opts,
                     device="cuda")
    c = torch.as_tensor(problem.cam_space, device="cuda")
    lin = s.linearize(c, s.initialize_varproj(c))
    s.solve(lin, 1e-4)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    inc, _n = s.solve(lin, 1e-4)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"{label} (venice-89, lambda 1e-4, warm): {secs * 1e3:.1f} ms, "
          f"peak device memory {peak / 2**30:.3f} GiB "
          f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} "
          f"GiB held before), increment {inc.dtype}, finite: "
          f"{bool(torch.isfinite(inc).all())}", flush=True)


def check_unstructured(problem, counts):
    """The unstructured layout and CHOLESKY: `small_case` and
    `ring_pipeline` card against CPU with each; one venice-89 CHOLESKY
    solve's time and peak memory; the venice-89 CHOLESKY step 1 with the
    JAX run's TPU arithmetic emulated (its decisions and final cost); the
    venice-89 `bundle_adjust` with pallas_kernels="off", with CHOLESKY +
    RIPOBA and with CHOLESKY + RIPCG (counters zeroed just before each,
    kept in `counts`)."""
    from povar_tpu_torch import (
        SolverOptions, SolverSummary, Stage1Solver, Timer, from_numpy,
        optimize_step1,
    )
    from povar_tpu_torch.ops import launches
    from povar_tpu_torch.options import SolverType, SolverTypeRiemannian
    from povar_tpu_torch.tools.step2_spread import (
        JAX_CHOL_COST2, emulate_tpu_onehot,
    )

    for config in ("off", "cholesky"):
        check_small_pipeline(config)
        check_ring(config)

    chol = SolverOptions(solver_type_step_1=SolverType.CHOLESKY)
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    chol_solve_memory(problem, chol, "CHOLESKY solve")

    # the JAX run's TPU arithmetic emulated: its decisions and final cost
    s = emulate_tpu_onehot(Stage1Solver(*args, chol, device="cuda"))
    _p, c0, l0 = from_numpy(problem.obs_cam, problem.obs_lm, problem.obs_uv,
                            problem.cam_space, problem.lm_p, device="cuda")
    tpu = SolverSummary()
    optimize_step1(s, c0, l0, chol, tpu, Timer(), log=lambda x: None)
    check_chol_step1("CHOLESKY step 1, one-hot sums and gathers in bf16 as "
                     "on the TPU", tpu, tpu=True)
    del s

    runs = (("bundle_adjust off", SolverOptions(pallas_kernels="off")),
            ("bundle_adjust CHOLESKY+RIPOBA", chol),
            ("bundle_adjust CHOLESKY+RIPCG", SolverOptions(
                solver_type_step_1=SolverType.CHOLESKY,
                solver_type_step_2=SolverTypeRiemannian.RIPCG)))
    for path, opts in runs:
        launches.reset_launch_counts()
        out, p1, p2, secs = pipeline(problem, opts, "cuda")
        counts[path] = launches.launch_counts()
        print(f"-- {path}: {secs:.3f} s, {len(p1.iterations)} + "
              f"{len(p2.iterations)} records", flush=True)
        check_counts(path, counts[path])
        if path == "bundle_adjust off":
            report_step(1, p1, JAX_FINAL_COST)
            report_step(2, p2, JAX_FINAL_COST2, STEP2_BAND)
        else:
            check_chol_step1(f"{path} step 1", p1)
            its2 = p2.iterations
            print(f"step 2: {p2.solver_type}, {len(its2)} records "
                  f"({p2.termination_type}), "
                  f"{''.join('A' if it.step_is_successful else 'R' for it in its2[1:])}"
                  f", initial {its2[0].cost.all.error!r} final "
                  f"{p2.final_cost.all.error!r} (JAX's RIPOBA run: "
                  f"{JAX_CHOL_COST2!r}, recorded, not compared)", flush=True)
            check_falling(f"{path} step 2", [it.cost.all.error for it in its2
                                             if it.step_is_successful])
            if not (np.isfinite(p2.final_cost.all.error)
                    and p2.final_cost.all.error < its2[0].cost.all.error):
                raise AssertionError(f"{path}: step 2 did not fall below its "
                                     "start")
        if not all(np.isfinite(a).all() for a in (out.cam_space, out.lm_p_h)):
            raise AssertionError("non-finite optimized state")


def check_cam_kernels_f64(solver, seed=5):
    """(a) of the f64 phase: the five camera-table kernels' f64
    instantiations on the venice-89 slot layout of `solver` with seeded
    f64 operands, zeroed on the pad rows as the solvers' operands are,
    against their plain versions on the card: at both steps' shapes
    (the step-1 shape is the kernel's row, each timed beside
    `index_select` / `index_add_` in f64), at N = 1024 (cam_gather's
    132 rows in row blocks), and on the routes venice-89 does not take
    (cam_gather at one observation a thread: cam[1:], O odd; hpp_b at
    N = 32: private copies; N = 6000: cam_scatter_add's and e0_scatter's
    global route); hpp_b's value groups also on the rows sorted by camera
    (whole warps on one camera). cam_gather and e0_u bit for bit,
    per-camera sums within F64_CAM, hpp symmetric bit for bit. Returns
    {name: result dict} of the f64 names."""
    from povar_tpu_torch.ops import cam_kernels as ck
    from povar_tpu_torch.ops import cam_ref as cr

    rng = np.random.default_rng(seed)
    dev = solver.device
    cam, mask = solver.obs.cam, solver._mask1.double()
    o = int(cam.shape[0])
    n89 = solver.n_cams

    def f64(rows, cols=None):
        a = torch.as_tensor(rng.standard_normal((rows, cols or o)),
                            dtype=torch.float64, device=dev)
        return a if cols else a * mask

    def seeded_cams(n):
        return torch.as_tensor(rng.integers(0, n, o).astype(np.int32),
                               device=dev)

    def index_add(v, c, n):
        c64 = c.long()
        return lambda: torch.zeros((v.shape[0], n), dtype=v.dtype,
                                   device=dev).index_add_(1, c64, v)

    def gather(table, c):
        c64 = c.long()
        return lambda: table.index_select(1, c64)

    def label(*parts):
        return ", ".join(p for p in parts if p) or None

    def cases(c, n, tag, kernels):
        out = []
        if "cam_gather" in kernels:
            for r, lab in ((12, None), (132, "R = 132, step-2 bases")):
                t = f64(r, n)
                out.append(("cam_gather_f64", label(lab, tag),
                            lambda m, t=t: m.cam_gather(t, c), [c, t],
                            [EXACT], None, gather(t, c)))
            # one observation a thread: O odd, cam not aligned to pairs
            c1 = c[1:]
            out.append(("cam_gather_f64", label("cam[1:]", tag),
                        lambda m, t=t, c1=c1: m.cam_gather(t, c1), [c1, t],
                        [EXACT], None, gather(t, c1)))
        if "cam_scatter_add" in kernels:
            for r, lab in ((12, None), (144, "R = 144, step-1 Schur"),
                           (121, "R = 121, step-2 Schur")):
                v = f64(r)
                out.append(("cam_scatter_add_f64", label(lab, tag),
                            lambda m, v=v: m.cam_scatter_add(v, c, n),
                            [c, v], [F64_CAM], None, index_add(v, c, n)))
        for dc, lab in ((12, None), (11, "(dl, dc) = (3, 11)")):
            w, x, sb = f64(3 * dc), f64(dc, n), f64(3)
            if "e0_u" in kernels:
                out.append(("e0_u_f64", label(lab, tag),
                            lambda m, w=w, x=x: m.e0_u(w, c, x),
                            [c, w, x], [EXACT], None))
            if "e0_scatter" in kernels:
                out.append(("e0_scatter_f64", label(lab, tag),
                            lambda m, w=w, sb=sb: m.e0_scatter(w, c, sb, n),
                            [c, w, sb], [F64_CAM], None))
        if "hpp_b" in kernels:
            for k, d, lab in ((4, 12, None), (2, 11, "(k, d) = (2, 11)")):
                jp, rt = f64(k * d), f64(k)
                out.append(("hpp_b_f64", label(lab, tag),
                            lambda m, jp=jp, rt=rt: m.hpp_b(jp, rt, c, n),
                            [c, jp, rt], [F64_CAM, F64_CAM], None))
        return out

    every = ("cam_gather", "cam_scatter_add", "e0_u", "e0_scatter", "hpp_b")
    results = run_cases(ck, cr, cases(cam, n89, None, every), o,
                        time_variants=True)
    others = [(1024, "N = 1024", every),
              (32, "N = 32, private copies", ("hpp_b",)),
              (6000, "N = 6000, global route",
               ("cam_scatter_add", "e0_scatter"))]
    for n, tag, kernels in others:
        c = seeded_cams(n)
        run_cases(ck, cr, cases(c, n, tag, kernels), o, time_variants=True)
        if "hpp_b" in kernels:
            check_hpp_symmetric(ck, f64, c, n)
    check_hpp_symmetric(ck, f64, cam, n89)
    # hpp_b's value groups on the rows sorted by camera: every warp on
    # one camera (a reduce-scatter tree)
    by_cam = torch.argsort(cam.long(), stable=True)
    cam_sorted = cam[by_cam].contiguous()

    def sorted_f64(rows):
        return f64(rows)[:, by_cam].contiguous()
    run_cases(ck, cr, [
        ("hpp_b_f64", f"(k, d) = ({k}, {d}), sorted by camera",
         lambda m, jp=jp, rt=rt: m.hpp_b(jp, rt, cam_sorted, n89),
         [cam_sorted, jp, rt], [F64_CAM, F64_CAM], None)
        for k, d, jp, rt in ((k, d, sorted_f64(k * d), sorted_f64(k))
                             for k, d in ((4, 12), (2, 11)))],
        o, time_variants=True)
    check_hpp_symmetric(ck, sorted_f64, cam_sorted, n89)
    return results


def check_hpp_symmetric(ck, operand, cam, n):
    """hpp_b's hpp symmetric bit for bit at both shapes, for operands
    made by `operand(rows)`."""
    for k, d in ((4, 12), (2, 11)):
        jp, rt = operand(k * d), operand(k)
        hpp = ck.hpp_b(jp, rt, cam, n)[0].view(d, d, n)
        if not torch.equal(hpp, hpp.transpose(0, 1)):
            raise AssertionError(f"hpp_b {jp.dtype} (k, d) = {(k, d)}, "
                                 f"N = {n}: hpp not symmetric bit for bit")
    print(f"hpp_b {jp.dtype}: hpp symmetric bit for bit at both shapes, "
          f"N = {n}", flush=True)


def check_same_run(label, got, want, tol=F64_TOL, every=False,
                   other="plain versions"):
    """Raise unless the summaries `got` (the card's kernels) and `want`
    (their plain versions on the card) took the same decisions and inner
    counts, with every accepted cost (and the initial one; with `every`
    each trial's, rejected ones too) within `tol` relative; print both.
    Returns the largest gap."""
    dg = [(it.step_is_successful, it.linear_solver_iterations)
          for it in got.iterations]
    dw = [(it.step_is_successful, it.linear_solver_iterations)
          for it in want.iterations]
    if dg != dw:
        raise AssertionError(f"{label}: {dg} vs {other} {dw}")
    gaps = [abs(g.cost.all.error - w.cost.all.error) / abs(w.cost.all.error)
            for g, w in zip(got.iterations, want.iterations)
            if g.step_is_successful or g is got.iterations[0]
            or (every and g.cost is not None)]
    gap = max(gaps)
    seq = "".join("A" if ok else "R" for ok, _n in dg[1:])
    print(f"{label}: {len(dg)} records ({got.termination_type}), {seq}, "
          f"inner {[n for _ok, n in dg[1:]]}; final "
          f"{got.final_cost.all.error!r} ({other} "
          f"{want.final_cost.all.error!r}); same decisions and counts "
          f"{dg == dw}, largest accepted-cost gap {gap:.3e} (tolerance "
          f"{tol:g})", flush=True)
    if not gap <= tol:
        raise AssertionError(f"{label}: accepted-cost gap {gap:.3e} "
                             f"(> {tol:g})")
    check_falling(label, [it.cost.all.error for it in got.iterations
                          if it.step_is_successful])
    return gap


def check_f64(problem, counts):
    """The pure-f64 phase (15 in the module docstring): (a) the five f64
    instantiations, (b)-(d) the venice-89 solves card kernels against
    card plain versions, (e) one `bundle_adjust` with pure-f64 defaults
    (counters zeroed just before, kept in `counts`), (f) the warm bench
    iterations. Returns the kernel results of (a)."""
    from povar_tpu_torch import (
        SolverOptions, SolverSummary, Stage1Solver, Stage2Solver, Timer,
        create_homogeneous, optimize_step2,
    )
    from povar_tpu_torch.ops import launches
    from povar_tpu_torch.options import SolverType
    from povar_tpu_torch.tools.step2_spread import (
        CALM, JAX_CHOL_COSTS, WITNESS_ITERS, calm_subproblem, plain_step1,
    )

    t_phase = time.perf_counter()
    f64 = SolverOptions(mixed_precision_solves=False)
    chol = SolverOptions(mixed_precision_solves=False,
                         solver_type_step_1=SolverType.CHOLESKY)
    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    probe = Stage1Solver(*args, f64, device="cuda")
    if not (probe.unstructured and probe.solve_dtype == torch.float64
            and probe.jacobi_eps == 1e-5):
        raise AssertionError("pure f64: not the unstructured layout with f64 "
                             "solves and the f64 Jacobi epsilon")
    t0 = time.perf_counter()
    results = check_cam_kernels_f64(probe)
    print(f"(a) f64 kernels {time.perf_counter() - t0:.1f} s", flush=True)

    def step1(opts, plain):
        with (plain_step1(cams=True) if plain else contextlib.nullcontext()):
            return solve(problem, opts, "cuda")

    runs = {}
    for tag, opts in (("(b) POWER_VARPROJ", f64), ("(c) CHOLESKY", chol)):
        t0 = time.perf_counter()
        (got, out, _su, secs), (want, _o, _sp, secs_p) = (
            step1(opts, plain) for plain in (False, True))
        check_same_run(f"{tag} step 1, pure f64", got, want,
                       F64_CHOL_TOL if opts is chol else F64_TOL)
        runs[tag] = (got, out)
        print(f"{tag}: {secs:.3f} s on the kernels, {secs_p:.3f} s on the "
              f"plain versions ({time.perf_counter() - t0:.1f} s with "
              "set-up)", flush=True)
    final = runs["(c) CHOLESKY"][0].final_cost.all.error
    print(f"(c) CHOLESKY pure f64 final {final!r}: {final / JAX_CHOL_COSTS[-1]:.6f}x "
          f"CHOL_BAND's {JAX_CHOL_COSTS[-1]!r} (band {CHOL_BAND}), "
          f"{final / CHOL_F64_DIAGNOSTIC:.6f}x the f32-epsilon f64 "
          f"diagnostic's {CHOL_F64_DIAGNOSTIC!r}; recorded, not compared",
          flush=True)

    chol_solve_memory(problem, chol, "(c) CHOLESKY solve in f64")

    t0 = time.perf_counter()
    cams, lms = runs["(b) POWER_VARPROJ"][1]
    cams_h, lms_h = create_homogeneous(cams, lms)
    args2, lms_w = calm_subproblem(problem, cams_h, lms_h, CALM)
    o2 = copy.deepcopy(f64)
    o2.max_num_iterations_step_2 = WITNESS_ITERS
    step2 = {}
    for plain in (False, True):
        s2 = Stage2Solver(*args2, o2, device="cuda")
        summary = SolverSummary()
        with (plain_step1(cams=True, step2=True) if plain
              else contextlib.nullcontext()):
            optimize_step2(s2, cams_h, lms_w, o2, summary, Timer(),
                           log=lambda x: None)
        step2[plain] = summary
    check_same_run(f"(d) RIPOBA step 2 pure f64, {WITNESS_ITERS} iterations "
                   f"on {args2[4]} calm landmarks", step2[False], step2[True])
    print(f"(d) {time.perf_counter() - t0:.1f} s", flush=True)

    path = "bundle_adjust f64"
    launches.reset_launch_counts()
    out, p1, p2, secs = pipeline(problem, f64, "cuda")
    counts[path] = launches.launch_counts()
    print(f"-- (e) {path}: {secs:.3f} s, {len(p1.iterations)} + "
          f"{len(p2.iterations)} records", flush=True)
    check_counts(path, counts[path])
    for step, summary in ((1, p1), (2, p2)):
        its = summary.iterations
        print(f"step {step}: {summary.solver_type}, "
              f"{''.join('A' if it.step_is_successful else 'R' for it in its[1:])}"
              f", inner {[it.linear_solver_iterations for it in its[1:]]}, "
              f"initial {its[0].cost.all.error!r} final "
              f"{summary.final_cost.all.error!r}", flush=True)
        check_falling(f"{path} step {step}", [
            it.cost.all.error for it in its if it.step_is_successful])
    print(f"step 1 final against the mixed-precision JAX run's "
          f"{JAX_FINAL_COST!r}: "
          f"{p1.final_cost.all.error / JAX_FINAL_COST - 1.0:+.3e} (recorded, "
          "not compared)", flush=True)
    check_final(2, p2)
    if not all(np.isfinite(a).all() for a in (out.cam_space, out.lm_p_h)):
        raise AssertionError("non-finite optimized state")

    bench_step1(problem, f64, "step-1 f64")
    bench_step2(problem, f64, "step-2 f64")
    print(f"f64 phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results


def spmd_library(name, x, layout):
    """The PyTorch view formulation of a slot kernel (`library_ms`): per
    part, a strided view of the lanes summed over its slot elements, or
    the rows broadcast over them into a view of a zeroed lane array."""
    k = x.shape[0]

    def parts():
        lofs = rofs = 0
        for cl in layout:
            p = 0
            for cap, w in cl.parts:
                yield lofs, p, rofs, cl, cap, w
                p += cap * w
                rofs += cl.n_windows * cap
            lofs += cl.n_windows * cl.win_lanes

    def sums(x):
        return torch.cat([
            x[:, lofs:lofs + cl.n_windows * cl.win_lanes].view(
                k, cl.n_windows, cl.win_lanes)[..., p:p + cap * w].view(
                k, cl.n_windows, w, cap).sum(2).reshape(k, -1)
            for lofs, p, _r, cl, cap, w in parts()], dim=1)

    def expand(rows):
        o_dev = sum(cl.n_windows * cl.win_lanes for cl in layout)
        out = torch.zeros((k, o_dev), dtype=rows.dtype, device=rows.device)
        for lofs, p, rofs, cl, cap, w in parts():
            n = cl.n_windows
            out[:, lofs:lofs + n * cl.win_lanes].view(
                k, n, cl.win_lanes)[..., p:p + cap * w].view(
                k, n, w, cap).copy_(rows[:, rofs:rofs + n * cap].view(
                    k, n, 1, cap).expand(k, n, w, cap))
        return out

    return {"class_part_sums": lambda: sums(x),
            "class_expand_rows": lambda: expand(x),
            "class_reduce_reexpand": lambda: expand(sums(x))}[name]


def check_spmd_kernels(problem):
    """The three slot kernels against their plain versions, bit for bit:
    at the venice-89 1-device plan on the mesh solver's own operands
    (ata [9, O] and atr [3, O] of `prepare`, the landmark tables jl_scale
    [3, L] and hll_raw [9, L] of a linearization, the E0 term's u [3, O]),
    and at the two-class plan of `overflow_case` on seeded ones (K = 1,
    3, 9). Times (events and device) of kernel, plain version and the
    PyTorch view formulation at venice-89 (part sums K = 9, expansion
    K = 3, reduce-reexpand K = 3), the bound from the bytes. Returns the
    kernels' result dicts. Also: the f64 cost on the mesh expands the
    state through the expansion kernel and gives the single-device
    cost."""
    from povar_tpu_torch import Stage1Solver, SolverOptions
    from povar_tpu_torch.ops import launches, pose_kernels, spmd_kernels
    from povar_tpu_torch.ops import spmd_ref
    from povar_tpu_torch.parallel import spmd
    from povar_tpu_torch.tools.step2_spread import overflow_case

    s = stage_solver(Stage1Solver, problem, SolverOptions(), mesh=True)
    print(f"venice-89 SPMD plan (D = 1): {s.plan.layout}, o_dev "
          f"{s.plan.o_dev}, slot rows {s.plan.n_rows_dev}, lane utilization "
          f"{s.plan.lane_utilization:.4f}", flush=True)
    c = torch.as_tensor(problem.cam_space, device="cuda")
    lm = s.lm_pack(s.initialize_varproj(c))
    lin = s.linearize(c, lm)
    _rw, _sw, ata, atr, _jpsq = pose_kernels.prepare(
        s.obs.cam, lin.ct, lin.x, s._uv_s, s._mask1, alpha=s.alpha,
        robust=s.robust, huber=s.huber, sums=False)
    _hi, _hib, jls_obs, lh_obs = s._hll_pieces_s(lin)
    h = s._h_factor_s(lin, jls_obs, lh_obs)
    z = lin.pose_scale * torch.randn_like(lin.pose_scale)
    u = pose_kernels.e0_u_structured(s.obs.cam, lin.x, h, z)
    lay = s.layout
    timed = {"class_part_sums": ata, "class_expand_rows": lin.jl_scale,
             "class_reduce_reexpand": u}
    venice = {"class_part_sums": [atr],
              "class_expand_rows": [lin.hll_raw.reshape(9, -1).contiguous()],
              "class_reduce_reexpand": []}
    ovf, _opts = overflow_case()
    plan = spmd.build_spmd_plan(ovf.obs_cam, ovf.obs_lm, ovf.num_cameras,
                                ovf.num_landmarks, 1, spmd.PART_ALIGN)
    o_dev, n_rows = spmd_ref.layout_sizes(plan.layout)
    print(f"overflow_case plan (D = 1): {len(plan.layout)} classes, parts "
          f"per class {[len(cl.parts) for cl in plan.layout]}, o_dev "
          f"{o_dev}, slot rows {n_rows}, duplicates {plan.has_duplicates}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    results = {}
    for name in spmd_kernels.KERNELS:
        kernel = getattr(spmd_kernels, name)
        plain = getattr(spmd_ref, name)
        cols = n_rows if name == "class_expand_rows" else o_dev
        cases = [(lay, x) for x in [timed[name]] + venice[name]]
        cases += [(plan.layout, torch.randn((k, cols), generator=gen,
                                            device="cuda"))
                  for k in (1, 3, 9)]
        for layout, x in cases:
            got = kernel(x, layout)
            torch.cuda.synchronize()
            if not torch.equal(got, plain(x, layout)):
                raise AssertionError(f"{name}: kernel != plain version at "
                                     f"{tuple(x.shape)}")
        x = timed[name]
        out = kernel(x, lay)
        lib = spmd_library(name, x, lay)
        # the view formulation's sum may take another order: 1e-6
        if not torch.allclose(lib(), out, rtol=1e-6, atol=1e-6 * float(
                out.abs().max())):
            raise AssertionError(f"{name}: view formulation != kernel")
        moved = (x.numel() + out.numel()) * 4
        res = dict(max_abs_err=0.0, ms=cuda_ms(lambda: kernel(x, lay)),
                   plain_ms=cuda_ms(lambda: plain(x, lay)),
                   bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                   library_ms=cuda_ms(lib))
        results[name] = res
        print(f"{name:<22} bit-equal at {len(cases)} operands; venice-89 "
              f"{tuple(x.shape)} -> {tuple(out.shape)}: events kernel "
              f"{res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms view "
              f"formulation {res['library_ms']:.4f} ms; device kernel "
              f"{device_us(lambda: kernel(x, lay)):.1f} us plain "
              f"{device_us(lambda: plain(x, lay)):.1f} us view "
              f"{device_us(lib):.1f} us; bound {res['bound_ms'] * 1e3:.1f} "
              f"us ({moved / 1e6:.2f} MB at 3.35 TB/s)", flush=True)

    # the f64 cost of every mesh trial expands the state through the
    # expansion kernel (its f32 hi and lo halves, one launch) and gives
    # the single-device cost (native f64 state) within 1e-10: 48 of the
    # state's 53 bits, f64 sums in another order
    one = stage_solver(Stage1Solver, problem, SolverOptions())
    canon = s.unpad_landmarks(s.lm_unpack(lm))
    launches.reset_launch_counts()
    e_mesh = float(s.compute_error(c, lm)["error_all"])
    n_expand = launches.launch_counts()["class_expand_rows"]
    e_one = float(one.compute_error(
        c, one.lm_pack(torch.as_tensor(canon, device="cuda")))["error_all"])
    gap = abs(e_mesh - e_one) / abs(e_one)
    print(f"f64 cost on the mesh {e_mesh!r} ({n_expand} class_expand_rows "
          f"launch) against one device {e_one!r}: gap {gap:.3e}", flush=True)
    if n_expand != 1 or not gap <= 1e-10:
        raise AssertionError(f"mesh f64 cost: {n_expand} expansions, gap "
                             f"{gap:.3e} (> 1e-10)")
    return results


def check_spmd(problem, counts):
    """The SPMD window layout on a 1-device mesh at venice-89:
    `bundle_adjust` with defaults and with PSC + RIPCG (counters zeroed
    before each, kept in `counts`), `overflow_case` card against CPU
    (step 1's decisions and counts identical, its costs within
    OVERFLOW_TOL; step 2 finite and falling), and the warm bench
    iterations of the mesh beside the single-device composed term's."""
    from povar_tpu_torch import SolverOptions
    from povar_tpu_torch.ops import launches
    from povar_tpu_torch.options import SolverType, SolverTypeRiemannian
    from povar_tpu_torch.tools.step2_spread import OVERFLOW_TOL, overflow_case

    defaults = SolverOptions()
    psc = SolverOptions(solver_type_step_1=SolverType.POWER_SCHUR_COMPLEMENT,
                        solver_type_step_2=SolverTypeRiemannian.RIPCG)
    for path, opts in (("bundle_adjust spmd", defaults),
                       ("bundle_adjust spmd PSC+RIPCG", psc)):
        launches.reset_launch_counts()
        out, p1, p2, secs = pipeline(problem, opts, "cuda", mesh=True)
        counts[path] = launches.launch_counts()
        print(f"-- {path}: {secs:.3f} s, {len(p1.iterations)} + "
              f"{len(p2.iterations)} records", flush=True)
        check_counts(path, counts[path])
        if any(counts[path][k] for k in FUSED_TERMS):
            raise AssertionError(f"{path}: a fused term ran on the mesh")
        if path == "bundle_adjust spmd":
            report_step(1, p1, JAX_FINAL_COST)
            if len(p1.iterations) != 25:
                raise AssertionError(f"step 1: {len(p1.iterations)} "
                                     "records, not 25")
            report_step(2, p2, JAX_FINAL_COST2, STEP2_BAND)
        else:
            check_psc_step1(f"{path} step 1", "".join(
                "A" if it.step_is_successful else "R"
                for it in p1.iterations[1:]), p1.final_cost.all.error)
            its2 = p2.iterations
            print(f"step 2: {p2.solver_type}, {len(its2)} records "
                  f"({p2.termination_type}), initial "
                  f"{its2[0].cost.all.error!r} final "
                  f"{p2.final_cost.all.error!r}", flush=True)
            check_falling(f"{path} step 2", [
                it.cost.all.error for it in its2 if it.step_is_successful])
            check_final(2, p2)
            if not p2.final_cost.all.error < PSC_STEP2_MAX:
                raise AssertionError(f"{path}: step 2 ends at "
                                     f"{p2.final_cost.all.error}")
        if not all(np.isfinite(a).all() for a in (out.cam_space, out.lm_p_h)):
            raise AssertionError("non-finite optimized state")

    small, opts = overflow_case()
    runs = {dev: pipeline(small, opts, dev, mesh=True)[1:3]
            for dev in ("cuda", "cpu")}
    (g1, g2), (c1, _c2) = runs["cuda"], runs["cpu"]
    dg = [(it.step_is_successful, it.linear_solver_iterations)
          for it in g1.iterations]
    dc = [(it.step_is_successful, it.linear_solver_iterations)
          for it in c1.iterations]
    gap = max(abs(g.cost.all.error - c.cost.all.error) / c.cost.all.error
              for g, c in zip(g1.iterations, c1.iterations))
    print(f"overflow_case on the mesh: step 1 card == cpu decisions and "
          f"counts {dg == dc}, largest cost gap {gap:.3e}; step 2 "
          f"{g2.initial_cost.all.error!r} -> {g2.final_cost.all.error!r}",
          flush=True)
    if dg != dc or not gap <= OVERFLOW_TOL:
        raise AssertionError(f"overflow_case: card {dg} vs cpu {dc}, gap "
                             f"{gap:.3e} (> {OVERFLOW_TOL:g})")
    if not (np.isfinite(g2.final_cost.all.error)
            and g2.final_cost.all.error < g2.initial_cost.all.error):
        raise AssertionError("overflow_case: step 2 did not fall")

    composed = SolverOptions(fused_power_term=False)
    for step, bench in ((1, bench_step1), (2, bench_step2)):
        bench(problem, composed, f"step-{step} composed (single device)")
        bench(problem, defaults, f"step-{step} spmd (1-device mesh)",
              mesh=True)


def f64_operands(o, n, cam, mask, uv, seed, lin2=None):
    """Seeded f64 operands of the fifteen structured f64 instantiations
    over `o` slot rows and `n` cameras (cam [O] i32, mask [1, O] f32, uv
    [2, O] f64), zeroed on the masked rows as the solvers' are; step 2's
    table keeps p2 in [2.5, 9] for the seeded landmarks
    (tests/test_torch_cuda.py's `_inputs`), or with `lin2` (a pure-f64
    step-2 linearization on these rows) the linearization's own table,
    landmarks, projection cache, weights and Jacobian rows."""
    rng = np.random.default_rng(seed)
    m = mask.double()

    def f(*shape, lo=None, hi=None, masked=False):
        a = (rng.standard_normal(shape) if lo is None
             else rng.uniform(lo, hi, shape))
        t = torch.as_tensor(a, dtype=torch.float64, device="cuda")
        return t * m if masked else t

    ct = f(12, n)
    ct2 = ct.clone()
    ct2[8:11] *= 0.1
    ct2[11] = f(n, lo=3.0, hi=4.0)
    x4 = f(4, o)
    x4[3] = f(o, lo=1.0, hi=2.0)
    sw = f(1, o, lo=0.5, hi=1.0, masked=True)
    d = dict(cam=cam, mask=mask, uv=uv, ct=ct, x=f(3, o), sw=sw, w=sw * sw,
             r_w=f(4, o, masked=True), jls=f(3, o, lo=0.1, hi=1.0),
             hib=f(3, o), lh=f(9, o), h=f(9, o, masked=True), z=f(12, n),
             sb=f(3, o), inc=f(12, n), inc_lm=f(3, o), ct2=ct2, x4=x4,
             mm=f(3, o, masked=True), sw2=sw, r_w2=f(2, o, masked=True),
             jlns=f(6, o), jls8=f(8, o), mat6=f(6, o), ilm4=f(4, o))
    if lin2 is not None:
        d.update(ct2=lin2.ct, x4=lin2.x4, mm=lin2.mm, sw2=lin2.sw,
                 r_w2=lin2.r_w, jlns=lin2.jlns, jls8=lin2.jls8)
    return d


def f64_cases(d, n, alpha):
    """run_cases' cases of the fifteen structured f64 instantiations
    (`<name>_f64`: the nine step-1 ones, ops/pose_kernels.py, then the
    six step-2 ones, ops/pose2_kernels.py) on the f64 operands `d`
    (f64_operands) over `n` cameras, each output held to F64_SPECS of its
    kind. Returns (step-1 cases, step-2 cases)."""
    a = dict(alpha=alpha)
    live = int((d["sw"] > 0).sum())
    live2 = int((d["sw2"] > 0).sum())
    elem, cam, total = F64_SPECS["elem"], F64_SPECS["cam"], F64_SPECS["scalar"]

    def case(name, run, keys, specs, n_read=None):
        return (f"{name}_f64", None, run, [d[k] for k in keys], specs, n_read)

    obs2 = ("cam", "x4", "mm", "sw2")
    o2 = [d[k] for k in obs2]
    step1 = [
        case("prepare",
             lambda m: m.prepare(d["cam"], d["ct"], d["x"], d["uv"],
                                 d["mask"], robust=0, huber=1.0, **a),
             ("cam", "ct", "x", "uv", "mask"), [elem] * 4 + [cam]),
        case("e0_factor",
             lambda m: m.e0_factor(d["cam"], d["ct"], d["uv"], d["w"],
                                   d["jls"], d["lh"], **a),
             ("cam", "ct", "uv", "w", "jls", "lh"), [elem]),
        case("hpp_b_structured",
             lambda m: m.hpp_b_structured(d["cam"], d["ct"], d["x"], d["uv"],
                                          d["sw"], d["r_w"], d["jls"],
                                          d["hib"], n, **a),
             ("sw", "cam", "ct", "x", "uv", "r_w", "jls", "hib"),
             [cam, cam], live),
        case("e0_u_structured",
             lambda m: m.e0_u_structured(d["cam"], d["x"], d["h"], d["z"]),
             ("cam", "x", "h", "z"), [elem]),
        case("e0_scatter_structured",
             lambda m: m.e0_scatter_structured(d["cam"], d["x"], d["h"],
                                               d["sb"], n),
             ("cam", "x", "h", "sb"), [cam]),
        case("apply_ldiff",
             lambda m: m.apply_ldiff(d["cam"], d["x"], d["uv"], d["sw"],
                                     d["r_w"], d["jls"], d["inc_lm"],
                                     d["ct"], d["inc"], **a),
             ("sw", "cam", "x", "uv", "r_w", "jls", "inc_lm", "ct", "inc"),
             [total], live),
        case("poba_t3",
             lambda m: m.poba_t3(d["cam"], d["ct"], d["x"], d["uv"], d["sw"],
                                 d["r_w"], d["jls"], d["z"], **a),
             ("cam", "ct", "x", "uv", "sw", "r_w", "jls", "z"), [elem]),
        case("apply_ldiff_stored",
             lambda m: m.apply_ldiff_stored(d["cam"], d["x"], d["uv"],
                                            d["sw"], d["r_w"], d["jls"],
                                            d["inc_lm"], d["ct"], d["z"],
                                            **a),
             ("cam", "x", "uv", "sw", "r_w", "jls", "inc_lm", "ct", "z"),
             [total]),
        case("schur_diag_structured",
             lambda m: m.schur_diag_structured(d["cam"], d["x"], d["h"], n),
             ("h", "cam", "x"), [cam], live),
    ]
    step2 = [
        case("prepare2",
             lambda m: m.prepare2(d["cam"], d["ct2"], d["x4"], d["uv"],
                                  d["mask"], use_valid=True, robust=0,
                                  huber=1.0),
             ("cam", "ct2", "x4", "uv", "mask"), [elem] * 5 + [cam]),
        case("hppb2",
             lambda m: m.hppb2(*o2, d["r_w2"], d["jlns"], d["hib"], n),
             ("sw2", "cam", "x4", "mm", "r_w2", "jlns", "hib"), [cam, cam],
             live2),
        case("mat_dot2",
             lambda m: m.mat_dot2(*o2, d["mat6"], None, d["z"], add_r=False),
             ("cam", "x4", "mm", "sw2", "mat6", "z"), [elem]),
        case("scatter2",
             lambda m: m.scatter2(*o2, d["mat6"], d["sb"], n),
             ("sw2", "cam", "x4", "mm", "mat6", "sb"), [cam], live2),
        case("ldiff2",
             lambda m: m.ldiff2(*o2, d["r_w2"], d["jls8"], d["ilm4"], d["z"]),
             ("cam", "x4", "mm", "sw2", "r_w2", "jls8", "ilm4", "z"),
             [total]),
        case("schur_diag2",
             lambda m: m.schur_diag2(*o2, d["mat6"], n),
             ("sw2", "cam", "x4", "mm", "mat6"), [cam], live2),
    ]
    return step1, step2


def check_f64_kernels(d, n, alpha, label, loop=False):
    """The fifteen structured f64 instantiations against their plain
    versions on the card on the operands `d` (f64_operands) over `n`
    cameras, each call one counted launch of its `_f64` name (and none
    of the f32 one), with run_cases' times (`loop`: the loop timer too);
    the Schur-Jacobi corrections symmetric bit for bit. Returns {name:
    result dict}."""
    from povar_tpu_torch.ops import launches
    from povar_tpu_torch.ops import pose2_kernels as pk2
    from povar_tpu_torch.ops import pose2_ref as pr2
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops import pose_ref as pr

    o = int(d["cam"].shape[0])
    step1, step2 = f64_cases(d, n, alpha)
    print(f"{label}: O = {o} rows, N = {n}", flush=True)
    for kernels, cases in ((pk, step1), (pk2, step2)):
        for name, _v, run, *_rest in cases:
            launches.reset_launch_counts()
            run(kernels)
            torch.cuda.synchronize()
            counts = launches.launch_counts()
            if counts[name] != 1 or counts[name.removesuffix("_f64")]:
                raise AssertionError(f"{label} {name}: launches {counts}")
    results = run_cases(pk, pr, step1, o, loop=loop)
    results.update(run_cases(pk2, pr2, step2, o, loop=loop))
    check_symmetric(f"schur_diag_structured_f64 ({label})",
                    pk.schur_diag_structured(d["cam"], d["x"], d["h"], n))
    check_symmetric(f"schur_diag2_f64 ({label})",
                    pk2.schur_diag2(d["cam"], d["x4"], d["mm"], d["sw2"],
                                    d["mat6"], n))
    return results


def check_spmd_f64_slots(operands, layout, label, timed=False, loop=False):
    """The three slot kernels' f64 instantiations on `operands` ({name:
    [K, .] f64 tensors}) of `layout`, bit for bit against their plain
    versions (both add the slot elements left to right), one counted
    launch of the `_f64` name a call (the pure-f64 expansion: hi_lo off);
    with `timed`, the first operand's events, device times, bound (8 B a
    lane and slot row) and view formulation, and with `loop` the loop
    timer. Returns {`<name>_f64`: result dict}."""
    from povar_tpu_torch.ops import launches, spmd_kernels, spmd_ref

    results = {}
    for name, xs in operands.items():
        kernel = getattr(spmd_kernels, name)
        plain = getattr(spmd_ref, name)
        for x in xs:
            launches.reset_launch_counts()
            got = kernel(x, layout)
            torch.cuda.synchronize()
            counts = launches.launch_counts()
            if counts[f"{name}_f64"] != 1 or counts[name]:
                raise AssertionError(f"{label} {name}: launches {counts}")
            if got.dtype != torch.float64 or not torch.equal(
                    got, plain(x, layout)):
                raise AssertionError(f"{label} {name}_f64: kernel != plain "
                                     f"version at {tuple(x.shape)}")
        if not timed:
            print(f"{label} {name}_f64: bit-equal at "
                  f"{[tuple(x.shape) for x in xs]}", flush=True)
            continue
        x = xs[0]
        out = kernel(x, layout)
        lib = spmd_library(name, x, layout)
        moved = (x.numel() + out.numel()) * 8
        res = dict(max_abs_err=0.0, ms=cuda_ms(lambda: kernel(x, layout)),
                   plain_ms=cuda_ms(lambda: plain(x, layout)),
                   bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                   library_ms=cuda_ms(lib))
        if loop:
            res["loop_ms"] = loop_ms(lambda: kernel(x, layout))
        results[f"{name}_f64"] = res
        print(f"{label} {name}_f64 bit-equal at "
              f"{[tuple(x.shape) for x in xs]}; {tuple(x.shape)} -> "
              f"{tuple(out.shape)}: events kernel {res['ms']:.4f} ms plain "
              f"{res['plain_ms']:.4f} ms view formulation "
              f"{res['library_ms']:.4f} ms; device kernel "
              f"{device_us(lambda: kernel(x, layout)):.1f} us"
              + (f", loop {res['loop_ms'] * 1e3:.1f} us" if loop else "")
              + f"; bound {res['bound_ms'] * 1e3:.1f} us ({moved / 1e6:.2f} "
              "MB at 3.35 TB/s)", flush=True)
    return results


def check_spmd_f64(problem, counts, large):
    """The spmd_f64 phase (16b in the module docstring): the mesh's pure
    f64. `large`: the large_n phase's venice-1778 problem and the
    mesh_large_n phase's final-13682 layout. Returns the kernel results
    of the eighteen `<name>_f64` entries."""
    from povar_tpu_torch import (
        SolverOptions, Stage1Solver, Stage2Solver, create_homogeneous,
        make_mesh, synthetic_bal_problem_fast,
    )
    from povar_tpu_torch.ops import launches, pose_kernels, spmd_ref
    from povar_tpu_torch.tools.large_scale import (
        LARGE_N_ITERS, first_iterations, stage_solvers,
    )
    from povar_tpu_torch.tools.step2_spread import (
        F64_MESH_CONFIGS, WITNESS_ITERS, f64_mesh_witness, f64_options,
        f64_step1,
    )

    t_phase = time.perf_counter()
    f64 = SolverOptions(mixed_precision_solves=False)
    # (a) the kernels at venice-89's 1-device mesh operands: the mesh
    # solvers' slot layout, their step-2 linearization at the homogenized
    # VarProj start, seeded f64 operands beside it
    t0 = time.perf_counter()
    s1 = stage_solver(Stage1Solver, problem, f64, mesh=True)
    s2 = stage_solver(Stage2Solver, problem, f64, mesh=True)
    if s1.unstructured or s2.unstructured or {
            s1.solve_dtype, s2.solve_dtype} != {torch.float64}:
        raise AssertionError("the mesh's pure f64 is not the structured "
                             "layout with f64 solves")
    c = torch.as_tensor(problem.cam_space, device="cuda")
    lm = s1.lm_pack(s1.initialize_varproj(c))
    c2, lm2 = create_homogeneous(c, s1.lm_unpack(lm))
    lin2 = s2.linearize(c2, s2.lm_pack(lm2))
    o, n = int(s1.obs.cam.shape[0]), s1.n_cams
    d = f64_operands(o, n, s1.obs.cam, s1._mask1, s1._uv_s, 11, lin2)
    results = check_f64_kernels(d, n, f64.alpha,
                                "(a) venice-89 1-device mesh", loop=True)
    lay = s1.layout
    _rw, _sw, ata, atr, _jpsq = pose_kernels.prepare(
        s1.obs.cam, s1._cam_table(c, torch.float64), d["x"], s1._uv_s,
        s1._mask1, alpha=f64.alpha, robust=0, huber=1.0, sums=False)
    lin1 = s1.linearize(c, lm)
    results.update(check_spmd_f64_slots({
        "class_part_sums": [ata, atr],
        "class_expand_rows": [lin1.jl_scale,
                              lin1.hll_raw.reshape(9, -1).contiguous()],
        "class_reduce_reexpand": [d["h"][:3].contiguous()],
    }, lay, "(a) venice-89 1-device mesh", timed=True, loop=True))
    del s1, s2, lin1, lin2, d, ata, atr
    print(f"(a) venice-89 {time.perf_counter() - t0:.1f} s", flush=True)

    # (a) at N = 13,682 on ~2^20 slot rows (large_n (a)'s problem) and
    # the slot kernels at final-13682's 39.3M lanes (mesh_large_n (e)'s
    # layout), seeded operands
    t0 = time.perf_counter()
    pa = synthetic_bal_problem_fast(LARGE_N, LARGE_N_LMS, OBS_PER_LM, seed=0,
                                    locality=64)
    sa = Stage1Solver(pa.obs_cam, pa.obs_lm, pa.obs_uv, pa.num_cameras,
                      pa.num_landmarks, f64, device="cuda")
    o = int(sa.obs.cam.shape[0])
    d = f64_operands(o, LARGE_N, sa.obs.cam, sa._mask1, sa._uv_s, 12)
    check_f64_kernels(d, LARGE_N, f64.alpha, f"(a) N = {LARGE_N}",
                      loop=True)
    del sa, d, pa
    lay = large.pop("final-13682 layout")
    o_dev, n_rows = spmd_ref.layout_sizes(lay)
    gen = torch.Generator(device="cuda").manual_seed(13)
    check_spmd_f64_slots({
        name: [torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float64)]
        for name, shape in (("class_part_sums", (9, o_dev)),
                            ("class_expand_rows", (3, n_rows)),
                            ("class_reduce_reexpand", (3, o_dev)))},
        lay, f"(a) final-13682 layout (o_dev {o_dev}, {n_rows} slot rows)",
        timed=True, loop=True)
    torch.cuda.empty_cache()
    print(f"(a) N = {LARGE_N} and final-13682 {time.perf_counter() - t0:.1f} "
          "s", flush=True)

    # (b) venice-89 step 1 on the mesh in pure f64 with defaults, on the
    # kernels and on their plain versions, then its RIPOBA witness; one
    # bundle_adjust(mesh=make_mesh(1)) for the path's launches
    t0 = time.perf_counter()
    ends = {}
    for tag, path in (("varproj", "step 1 spmd f64"),
                      ("psc", "step 1 spmd f64 PSC"),
                      ("pcg", "step 1 spmd f64 PCG")):
        solver1, iters1, witnesses = F64_MESH_CONFIGS[tag]
        opts = f64_options(solver1, iters1)
        launches.reset_launch_counts()
        got, ends[tag], secs = f64_step1(problem, opts, False)
        counts[path] = launches.launch_counts()
        check_counts(path, counts[path])
        want, _end, secs_p = f64_step1(problem, opts, True)
        check_same_run(f"({'b' if tag == 'varproj' else 'd'}) {path}, pure "
                       "f64", got, want, F64_MESH_TOLS[f"{tag} step 1"])
        print(f"  {secs:.3f} s on the kernels, {secs_p:.3f} s on the plain "
              "versions", flush=True)
        if tag == "varproj":
            one, _end, secs_o = f64_step1(problem, opts, False, mesh=False)
            check_same_run("(c) step 1 pure f64, the mesh against one "
                           "device", got, one,
                           F64_MESH_TOLS["varproj mesh vs one device"],
                           other="one device")
            print(f"  one device {secs_o:.3f} s", flush=True)
        for s2t in witnesses:
            state = create_homogeneous(*ends[tag])
            wopts = f64_options(solver1, iters1, s2t)
            path2 = f"witness spmd f64 {s2t.value}"
            launches.reset_launch_counts()
            wg, m, secs = f64_mesh_witness(problem, *state, wopts, False)
            counts[path2] = launches.launch_counts()
            check_counts(path2, counts[path2])
            wp, _m, secs_p = f64_mesh_witness(problem, *state, wopts, True)
            check_same_run(f"({'b' if s2t.value == 'RIPOBA' else 'd'}) "
                           f"{s2t.value} step 2 pure f64 on the mesh, "
                           f"{WITNESS_ITERS} iterations on {m} calm "
                           "landmarks", wg, wp,
                           F64_MESH_TOLS[f"{tag} {s2t.value} witness"])
    print(f"(b)-(d) {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    path = "bundle_adjust spmd f64"
    launches.reset_launch_counts()
    out, p1, p2, secs = pipeline(problem, f64, "cuda", mesh=True)
    counts[path] = launches.launch_counts()
    print(f"-- (b) {path}: {secs:.3f} s, {len(p1.iterations)} + "
          f"{len(p2.iterations)} records", flush=True)
    check_counts(path, counts[path])
    f32_ran = sorted(k for k in (STEP1_COMPOSED | STEP2_COMPOSED | SPMD
                                 | FUSED_TERMS) - {"pose_error",
                                                   "pose_error2"}
                     if counts[path][k])
    if f32_ran:
        raise AssertionError(f"{path}: f32 kernels ran: {f32_ran}")
    for step, summary in ((1, p1), (2, p2)):
        its = summary.iterations
        print(f"step {step}: {''.join('A' if it.step_is_successful else 'R' for it in its[1:])}"
              f", inner {[it.linear_solver_iterations for it in its[1:]]}, "
              f"initial {its[0].cost.all.error!r} final "
              f"{summary.final_cost.all.error!r}", flush=True)
        check_falling(f"{path} step {step}", [
            it.cost.all.error for it in its if it.step_is_successful])
    check_final(2, p2)
    if not all(np.isfinite(a).all() for a in (out.cam_space, out.lm_p_h)):
        raise AssertionError("non-finite optimized state")
    print(f"(b) {time.perf_counter() - t0:.1f} s", flush=True)

    # (e) venice-1778's first step-1 iteration on the 1-device mesh in
    # pure f64, on the kernels (counters zeroed before, read after) and on
    # their plain versions
    t0 = time.perf_counter()
    pc = large["venice-1778"]
    sv, _s2 = stage_solvers(pc, f64, make_mesh(1))
    path = "step 1 spmd f64 venice-1778"
    launches.reset_launch_counts()
    got, secs_k = first_iterations(pc, False, stage1=sv)
    counts[path] = launches.launch_counts()
    check_counts(path, counts[path])
    want, secs_p = first_iterations(pc, True, stage1=sv)
    check_same_run(f"(e) venice-1778 mesh step 1 pure f64, first "
                   f"{LARGE_N_ITERS} iterations", got, want,
                   F64_MESH_TOLS["venice-1778"])
    print(f"(e) {secs_k:.2f} s on the kernels, {secs_p:.2f} s on the plain "
          f"versions; {time.perf_counter() - t0:.1f} s with set-up",
          flush=True)
    del sv, _s2

    # (f) the warm bench iterations of the mesh in pure f64, venice-89
    # and venice-1778
    for prob, scale in ((problem, "venice-89"), (pc, "venice-1778")):
        for step, bench in ((1, bench_step1), (2, bench_step2)):
            bench(prob, f64, f"step-{step} spmd f64 {scale} (1-device mesh)",
                  mesh=True)
    vars(pc).pop("_spmd_plan_cache", None)
    print(f"spmd_f64 phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return results


def check_lm_kernels():
    """The device LM loop's two kernels (ops/lm_kernels.py, csrc/lm.cu)
    against their plain versions on the card: lm_step bit for bit on
    every edge case of tests/test_torch_cuda.py's `_lm_cases` under each
    optimized-cost channel and accept rule, lm_condition's region count;
    then a captured graph of nested WHILE loops and an IF node (the
    machinery the device loop runs on) against the same loops run on the
    host, replayed twice. Returns their kernel results (times of one call
    at the device loop's shapes, its ~0.5 KB over HBM as the bound)."""
    from povar_tpu_torch.ops import lm_kernels
    from povar_tpu_torch.solver.device_loop import (
        MAX_REGIONS, EagerControl, capture,
    )

    dev = torch.device("cuda")
    nan = float("nan")
    row = [10.0, 3.0, 9.0, 2.5, 100.0, 90.0]
    st0 = [1.0, 0.0, 1e-4, 2.0, 12.0, 4.0, 11.0, 3.0, 100.0, 90.0,
           12.0, 4.0, 11.0, 3.0, 100.0, 90.0]
    cases = [([1, 1, 2.5, 4], {}), ([1, 1, -2.5, 4], {}),
             ([1, 1, 0.0, 3], {}), ([1, 1, nan, 2], {}), ([0, 1, 2.5, 5], {}),
             ([1, 0, 2.5, 5], {}), ([1, 1, 2.5, 1], {2: 1e-16}),
             ([1, 1, -2.5, 1], {2: 1e31, 3: 64.0}),
             ([1, 1, 2.5, 1], {10: 10.0 + 1e-9, 12: 9.0 + 1e-9}),
             ([1, 1, 2.5, 1], {0: 5.0})]
    T = 5
    worst, n = 0.0, 0
    for oc in (0, 1, 2):
        for step1 in (1, 0):
            p = lm_kernels.LmParams(1e-16, 1e32, 1e-6, 0.0, 2.0, 2.0, T, oc,
                                    step1)
            for tail, head in cases:
                st = list(st0)
                for k, v in head.items():
                    st[k] = v
                trial = torch.tensor(row + tail, dtype=torch.float64,
                                     device=dev)
                outs = []
                for fn in (lm_kernels.lm_step, lm_kernels.lm_step_ref):
                    s = torch.tensor(st, dtype=torch.float64, device=dev)
                    tr = torch.zeros((T, len(lm_kernels.TRACE_COLS)),
                                     dtype=torch.float64, device=dev)
                    fl = torch.zeros(3, dtype=torch.bool, device=dev)
                    fn(trial, s, tr, fl, p)
                    outs.append(torch.cat([s, tr.reshape(-1),
                                           fl.double()]).cpu())
                same = torch.equal(outs[0].isnan(), outs[1].isnan())
                diff = (outs[0] - outs[1]).nan_to_num().abs().max().item()
                if not (same and diff == 0.0):
                    raise AssertionError(f"lm_step oc={oc} step1={step1} "
                                         f"{tail} {head}: off its plain "
                                         f"version by {diff}")
                worst, n = max(worst, diff), n + 1
    print(f"lm_step: {n} edge cases bit for bit against its plain version",
          flush=True)

    # one call at the device loop's shapes, timed
    p = lm_kernels.LmParams(1e-16, 1e32, 1e-6, 0.0, 2.0, 2.0, 50, 0, 1)
    trial = torch.tensor(row + [1, 1, 2.5, 4], dtype=torch.float64,
                         device=dev)
    st = torch.tensor(st0, dtype=torch.float64, device=dev)
    tr = torch.zeros((50, len(lm_kernels.TRACE_COLS)), dtype=torch.float64,
                     device=dev)
    fl = torch.zeros(3, dtype=torch.bool, device=dev)

    def step(fn):
        return lambda: (st.copy_(torch.tensor(st0, dtype=torch.float64,
                                              device=dev)),
                        fn(trial, st, tr, fl, p))

    moved = 8 * (trial.numel() + 2 * st.numel() + len(
        lm_kernels.TRACE_COLS)) + 3
    results = {"lm_step": dict(
        max_abs_err=worst, ms=cuda_ms(step(lm_kernels.lm_step)),
        plain_ms=cuda_ms(step(lm_kernels.lm_step_ref)),
        bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)}

    counts = torch.zeros(MAX_REGIONS, dtype=torch.int64, device=dev)
    want = counts.clone()
    lm_kernels.lm_condition(None, None, counts, 3)
    lm_kernels.lm_condition_ref(want, 3)
    err = float((counts - want).abs().max())
    if err:
        raise AssertionError(f"lm_condition: counts {counts} != {want}")

    K = 7

    def program(ctl, x, acc):
        def body():
            x.add_(1)
            ctl.cond(x % 3 == 0, lambda: acc.add_(10))
            j = torch.zeros((), dtype=torch.int64, device=x.device)

            def inner():
                j.add_(1)
                acc.add_(1)
                return j < x

            ctl.while_loop(j < x, inner)
            return x < K

        ctl.while_loop(x < K, body)

    x0 = torch.zeros((), dtype=torch.int64)
    a0 = torch.zeros((), dtype=torch.int64)
    program(EagerControl(), x0, a0)
    x = torch.zeros((), dtype=torch.int64, device=dev)
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    counts.zero_()
    g = capture(dev, lambda ctl: program(ctl, x, acc), counts)
    for _ in range(2):
        x.zero_()
        acc.zero_()
        counts.zero_()
        g.launch()
        got = (int(x), int(acc), counts.tolist()[:3])
        want_g = (int(x0), int(a0), [K, K // 3, K * (K + 1) // 2])
        if got != want_g:
            raise AssertionError(f"graph of WHILE / IF nodes: {got} != "
                                 f"{want_g}")
    print(f"graph of WHILE / IF nodes: x {int(x)}, acc {int(acc)}, region "
          f"executions {counts.tolist()[:3]} equal the host loops' in two "
          f"replays (capture {g.capture_s * 1e3:.1f} ms, instantiate "
          f"{g.instantiate_s * 1e3:.1f} ms)", flush=True)
    del g

    def cond_call():
        lm_kernels.lm_condition(None, None, counts, 0)

    results["lm_condition"] = dict(
        max_abs_err=err, ms=cuda_ms(cond_call),
        plain_ms=cuda_ms(lambda: lm_kernels.lm_condition_ref(counts, 0)),
        bound_ms=16 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)
    # the kernels' own device time: the timed lm_step calls also reset
    # the state from the host, a copy of their own
    step_us = kernel_us(step(lm_kernels.lm_step), "lm_step")
    cond_us = kernel_us(cond_call, "lm_condition")
    print(f"lm_step device {step_us:.2f} us, lm_condition device "
          f"{cond_us:.2f} us (profiler, the kernel alone)", flush=True)
    return results


def check_device_loop(problem, counts):
    """The device LM loop phase (module docstring): (a) the small and ring
    problems, card device loop against card host loop and CPU device
    loop; (b) venice-89 pure f64, POWER_VARPROJ step 1 and the step-2
    witness start, device loop against host loop on the card; (c) the
    hand-written kernels in the replays' profiles; (d) blocking host
    synchronisations per step; (e) the warm iteration's wall and device
    time and busy share under both loops, the graph's capture and
    instantiation time, nodes and memory (tools/loop_ab.py)."""
    from povar_tpu_torch import (
        SolverOptions, SolverSummary, Stage2Solver, Timer, create_homogeneous,
        optimize_step2,
    )
    from povar_tpu_torch.tools.loop_ab import compare_loops
    from povar_tpu_torch.tools.step2_spread import (
        CALM, RING_TOLS, SMALL_TOLS, WITNESS_ITERS, calm_subproblem,
        ring_compare, ring_pipeline, small_case,
    )

    t_phase = time.perf_counter()
    # (a)
    for config in ("defaults", "composed"):
        jp, off = small_case(config, "off")
        _, on = small_case(config, "on")
        runs = {"card host": pipeline(jp, off, "cuda")[1:3],
                "card device": pipeline(jp, on, "cuda")[1:3],
                "cpu device": pipeline(jp, on, "cpu")[1:3]}
        for other in ("card host", "cpu device"):
            for step, tol, g, c in zip((1, 2), SMALL_TOLS,
                                       runs["card device"], runs[other]):
                dg = [(it.step_is_successful, it.linear_solver_iterations)
                      for it in g.iterations]
                dc = [(it.step_is_successful, it.linear_solver_iterations)
                      for it in c.iterations]
                fg, fc = g.final_cost.all.error, c.final_cost.all.error
                gap = abs(fg - fc) / abs(fc)
                print(f"(a) small ({config}) step {step}: card device loop "
                      f"vs {other}: same decisions and counts {dg == dc}, "
                      f"final gap {gap:.3e} (tolerance {tol:g})", flush=True)
                if dg != dc or not gap <= tol:
                    raise AssertionError(f"(a) small {config} step {step}: "
                                         f"device loop vs {other}")
    for config in ("psc", "f32"):
        card = ring_pipeline(config, "cuda", "on")
        for other, dev, loop in (("card host", "cuda", "off"),
                                 ("cpu device", "cpu", "on")):
            ref = ring_pipeline(config, dev, loop)
            for step, (same, gap), tol in zip(
                    (1, 2), ring_compare(card, ref), RING_TOLS[config]):
                print(f"(a) ring ({config}) step {step}: card device loop vs "
                      f"{other}: same decisions and counts {same}, largest "
                      f"cost gap {gap:.3e} (tolerance {tol:g})", flush=True)
                if not (same and gap <= tol):
                    raise AssertionError(f"(a) ring {config} step {step}: "
                                         f"device loop vs {other}")

    # (b)
    t0 = time.perf_counter()
    f64 = {m: SolverOptions(mixed_precision_solves=False, device_lm_loop=m)
           for m in ("auto", "off")}
    (got, out, _s, secs), (want, _o, _s2, secs_h) = (
        solve(problem, f64[m], "cuda") for m in ("auto", "off"))
    check_same_run("(b) POWER_VARPROJ step 1, pure f64", got, want,
                   other="the host loop")
    cams_h, lms_h = create_homogeneous(*out)
    args2, lms_w = calm_subproblem(problem, cams_h, lms_h, CALM)
    step2 = {}
    for m in ("auto", "off"):
        o2 = copy.deepcopy(f64[m])
        o2.max_num_iterations_step_2 = WITNESS_ITERS
        summary = SolverSummary()
        optimize_step2(Stage2Solver(*args2, o2, device="cuda"), cams_h,
                       lms_w, o2, summary, Timer(), log=lambda x: None)
        step2[m] = summary
    check_same_run(f"(b) RIPOBA step 2, pure f64, {WITNESS_ITERS} iterations "
                   f"on {args2[4]} calm landmarks", step2["auto"],
                   step2["off"], other="the host loop")
    print(f"(b) step 1 {secs:.3f} s device loop, {secs_h:.3f} s host loop; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (c)-(e)
    res = compare_loops(problem, SolverOptions(), "(e) venice-89")
    for step, need in ((1, STEP1_FUSED), (2, STEP2_FUSED)):
        warm = res[f"step{step} auto warm"]
        names = warm.pop("kernels")
        res[f"step{step} off warm"].pop("kernels")
        ran = set(warm.pop("ran"))
        symbols = {KERNEL_SYMBOLS[k] for k in need | LM}
        traced = sorted(k for k in symbols if any(k in n for n in names))
        print(f"(c) step {step}: the warm replay's trace names "
              f"{len(names)} device operations, among them the path's "
              f"hand-written kernels {traced}, not "
              f"{sorted(symbols - set(traced))}; by the graph's region "
              f"counts the replay ran {sorted((need | LM) & ran)}", flush=True)
        # a region's device count rises after the last node of its body:
        # each kernel captured there ran in the replay
        if not (need | LM) <= ran:
            raise AssertionError(f"(c) step {step}: kernels of the path not "
                                 f"run in the replay: "
                                 f"{sorted((need | LM) - ran)}")
    for step in (1, 2):
        for call in ("first", "warm"):
            r = res[f"step{step} auto {call}"]
            print(f"(d) step {step} device loop, {call} call: {r['syncs']} "
                  f"blocking host synchronisations for {r['trials']} "
                  f"trials; host loop "
                  f"{res[f'step{step} off {call}']['syncs']}", flush=True)
            if r["syncs"] > r["trials"] + 1:
                raise AssertionError(f"(d) step {step}: {r['syncs']} syncs "
                                     f"for {r['trials']} trials")
    print(f"device_loop phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def check_detailed_timing(problem, counts):
    """The detailed_timing phase (16c in the module docstring): (a) the
    staged `bundle_adjust` with defaults, its spans and medians, the
    three loops' wall ms per iteration; (b) pure f64 step 1, staged
    against the fused host loop, POWER_VARPROJ and CHOLESKY; (c) the
    native BAL tokenizer against numpy at venice-89's size."""
    from povar_tpu_torch import SolverOptions
    from povar_tpu_torch.ops import launches
    from povar_tpu_torch.options import SolverType
    from povar_tpu_torch.tools import stage_timing as st

    t_phase = time.perf_counter()
    # (a)
    staged = SolverOptions(detailed_timing=True)
    path = "bundle_adjust staged"
    launches.reset_launch_counts()
    _, s1, s2, first_s = pipeline(problem, staged, "cuda")
    counts[path] = launches.launch_counts()
    check_counts(path, counts[path])
    report_step(1, s1, JAX_FINAL_COST)
    report_step(2, s2, JAX_FINAL_COST2, STEP2_BAND)
    if len(s1.iterations) != 25:
        raise AssertionError(f"(a) step 1: {len(s1.iterations)} records, "
                             "not 25")
    for step, solver, summary in ((1, "POWER_VARPROJ", s1),
                                  (2, "RIPOBA", s2)):
        n = st.check_spans(step, solver, summary)
        print(f"(a) step {step}: the spans of {solver} > 0 in each of {n} "
              f"records with a valid step, summing to at most their "
              f"iteration_time", flush=True)
    walls = {}
    for label, opts in (("staged", staged),
                        ("host loop", SolverOptions(device_lm_loop="off")),
                        ("device loop", SolverOptions())):
        _, w1, w2, secs = pipeline(problem, opts, "cuda")
        walls[label] = (st.wall_ms_per_iteration(w1),
                        st.wall_ms_per_iteration(w2), secs)
        if label == "staged":
            check_final(1, w1)
            st.check_spans(1, "POWER_VARPROJ", w1)
            st.check_spans(2, "RIPOBA", w2)
            for step, w in ((1, w1), (2, w2)):
                print(st.format_medians(f"(a) staged step {step} warm, "
                                        "median ms",
                                        st.span_medians_ms(w)), flush=True)
    print(f"(a) staged bundle_adjust: first {first_s:.3f} s", flush=True)
    for label, (m1, m2, secs) in walls.items():
        print(f"(a) {label}: wall ms per iteration step 1 {m1:.3f}, step 2 "
              f"{m2:.3f}; warm bundle_adjust {secs:.3f} s", flush=True)

    # (b)
    for st1, tol in ((SolverType.POWER_VARPROJ, F64_TOL),
                     (SolverType.CHOLESKY, F64_CHOL_TOL)):
        runs = {}
        for label, kw in (("staged", dict(detailed_timing=True)),
                          ("fused", dict(device_lm_loop="off"))):
            opts = SolverOptions(mixed_precision_solves=False, **kw)
            opts.solver_type_step_1 = st1
            runs[label], _out, _s, runs[label + " s"] = solve(
                problem, opts, "cuda")
        check_same_run(f"(b) {st1.value} step 1, pure f64, staged",
                       runs["staged"], runs["fused"], tol=tol,
                       other="the fused host loop")
        print(f"(b) {st1.value}: staged {runs['staged s']:.3f} s, fused "
              f"host loop {runs['fused s']:.3f} s", flush=True)

    # (c)
    r = st.bal_load(problem, "problem-89-110973-pre")
    print(f"(c) venice-89 BAL text, {r['tokens']} tokens: the same f64 bits "
          f"natively and with numpy; written in {r['write_s']:.2f} s, numpy "
          f"{r['numpy_s']:.3f} s, native {r['native_s']:.3f} s", flush=True)
    print(f"detailed_timing phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def large_cam_cases(cam, n, mask, seed=7):
    """run_cases' cases of the five camera-table kernels in f32 and f64
    (`<name>_f64`) at their step-1 shapes (R = 12; (dl, dc) = (3, 12);
    (k, d) = (4, 12)) over `n` cameras, operands seeded and zero on the
    slot pad rows (`mask`); `index_select` / `index_add_` beside
    cam_gather / cam_scatter_add."""
    rng = np.random.default_rng(seed)
    o = int(cam.shape[0])
    cam64 = cam.long()
    out = []
    for dtype, sfx in ((torch.float32, ""), (torch.float64, "_f64")):
        def rand(rows, cols=None, dtype=dtype):
            a = torch.as_tensor(rng.standard_normal((rows, cols or o)),
                                dtype=dtype, device="cuda")
            return a if cols else a * mask.to(dtype)

        table, v, w, x, sb = rand(12, n), rand(12), rand(36), rand(12, n), \
            rand(3)
        jp, rt = rand(48), rand(4)
        out += [
            ("cam_gather" + sfx, None, lambda m, t=table: m.cam_gather(t, cam),
             [cam, table], [EXACT], None,
             lambda t=table: t.index_select(1, cam64)),
            ("cam_scatter_add" + sfx, None,
             lambda m, v=v: m.cam_scatter_add(v, cam, n), [cam, v], [CAM],
             None, lambda v=v: torch.zeros((12, n), dtype=v.dtype,
                                           device="cuda").index_add_(1, cam64,
                                                                     v)),
            ("e0_u" + sfx, None, lambda m, w=w, x=x: m.e0_u(w, cam, x),
             [cam, w, x], [EXACT], None),
            ("e0_scatter" + sfx, None,
             lambda m, w=w, sb=sb: m.e0_scatter(w, cam, sb, n), [cam, w, sb],
             [CAM], None),
            ("hpp_b" + sfx, None,
             lambda m, jp=jp, rt=rt: m.hpp_b(jp, rt, cam, n), [cam, jp, rt],
             [CAM, CAM], None),
        ]
    return out


def check_large_n(counts, keep):
    """The large_n phase (16 in the module docstring). Returns the
    `kernels` line's entries of LARGE_N_ROUTES, keyed `<name>@N13682`,
    and leaves its venice-1778 and final-13682 problems in `keep` (the
    band_chol phase runs them too)."""
    from povar_tpu_torch import (
        SolverOptions, Stage1Solver, Stage2Solver, create_homogeneous,
        synthetic_bal_problem_fast,
    )
    from povar_tpu_torch.ops import cam_kernels as ck
    from povar_tpu_torch.ops import cam_ref as cr
    from povar_tpu_torch.ops import launches
    from povar_tpu_torch.ops import pose_kernels as pk
    from povar_tpu_torch.ops import pose_ref as pr
    from povar_tpu_torch.options import SolverType
    from povar_tpu_torch.tools.large_scale import (
        FINAL_STEP2_ITERS, LARGE_N_ITERS, START2_ITERS, STEP2_LAMBDA,
        accepted_costs, first_iterations, first_steps, make_problem,
    )

    t_phase = time.perf_counter()
    defaults = SolverOptions()

    # (a) every kernel at N = 13,682 on ~2^20 slot rows of a
    # final-13682-shaped problem, against its plain version
    t0 = time.perf_counter()
    pa = synthetic_bal_problem_fast(LARGE_N, LARGE_N_LMS, OBS_PER_LM, seed=0,
                                    locality=64)
    args = (pa.obs_cam, pa.obs_lm, pa.obs_uv, pa.num_cameras,
            pa.num_landmarks)
    s1 = Stage1Solver(*args, defaults, device="cuda")
    d = kernel_inputs(s1, pa)
    o = int(d["cam"].shape[0])
    print(f"(a) N = {LARGE_N}, {pa.num_observations} observations -> O = "
          f"{o} slot rows", flush=True)
    timed = run_cases(pk, pr, step1_cases(s1, d, defaults.alpha), o,
                      loop=True)
    check_symmetric(f"schur_diag_structured (N = {LARGE_N})",
                    pk.schur_diag_structured(d["cam"], d["x"], d["h"],
                                             LARGE_N))
    c = torch.as_tensor(pa.cam_space, device="cuda")
    cams_h, lms_h = create_homogeneous(c, s1.initialize_varproj(c))
    s2 = Stage2Solver(*args, defaults, device="cuda")
    timed.update(check_kernels2(s2, cams_h, lms_h, loop=True))
    timed.update(run_cases(ck, cr, large_cam_cases(d["cam"], LARGE_N,
                                                   d["mask"]), o, loop=True))
    del s1, s2, d, c, cams_h, lms_h
    print(f"(a) {time.perf_counter() - t0:.1f} s", flush=True)

    # (b) cam_gather and cam_scatter_add in f32 at R O just past 2^31
    t0 = time.perf_counter()
    r = 144
    ob = 2**31 // r + 1
    rng = np.random.default_rng(8)
    cam_b = torch.as_tensor(rng.integers(0, LARGE_N, ob).astype(np.int32),
                            device="cuda")
    table = torch.as_tensor(rng.standard_normal((r, LARGE_N)),
                            dtype=torch.float32, device="cuda")
    cam64 = cam_b.long()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    got = ck.cam_gather(table, cam_b)
    ev[1].record()
    want = table.index_select(1, cam64)
    ev[2].record()
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    print(f"(b) cam_gather R = {r}, O = {ob} (R O = {r * ob} > 2^31): bit "
          f"for bit {same}; {ev[0].elapsed_time(ev[1]):.2f} ms, index_select "
          f"{ev[1].elapsed_time(ev[2]):.2f} ms", flush=True)
    if not same:
        raise AssertionError("(b) cam_gather past 2^31 differs from "
                             "index_select")
    del want
    ev[0].record()
    sums = ck.cam_scatter_add(got, cam_b, LARGE_N)
    ev[1].record()
    want = torch.zeros((r, LARGE_N), device="cuda").index_add_(1, cam64, got)
    ev[2].record()
    torch.cuda.synchronize()
    err, rels = compare("(b) cam_scatter_add", sums, want, [CAM])
    print(f"(b) cam_scatter_add R = {r}, O = {ob}: max_abs_err {err:.3e} "
          f"scaled {rels[0]:.1e}; {ev[0].elapsed_time(ev[1]):.2f} ms, "
          f"index_add_ {ev[1].elapsed_time(ev[2]):.2f} ms; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del got, want, sums, cam_b, cam64, table

    # (c) venice-1778 with SolverOptions() defaults: the first iterations
    # on the card's kernels and on their plain versions, then the whole
    # bundle_adjust
    t0 = time.perf_counter()
    pc = make_problem("venice-1778")
    (got, secs_k), (want, secs_p) = (first_iterations(pc, plain)
                                     for plain in (False, True))
    check_same_run(f"(c) venice-1778 step 1, first {LARGE_N_ITERS} "
                   "iterations", got, want, LARGE_N_TOL)
    print(f"(c) {secs_k:.2f} s on the kernels, {secs_p:.2f} s on the plain "
          "versions", flush=True)
    path = "bundle_adjust venice-1778"
    launches.reset_launch_counts()
    _out, p1, p2, secs = pipeline(pc, defaults, "cuda")
    counts[path] = launches.launch_counts()
    check_counts(path, counts[path])
    for step, summary in ((1, p1), (2, p2)):
        costs = accepted_costs(summary)
        print(f"(c) {path} step {step}: {len(summary.iterations)} records, "
              f"{costs[0]!r} -> {costs[-1]!r} ({costs[-1] / costs[0]:.3e})",
              flush=True)
        check_falling(f"{path} step {step}", costs)
        if not costs[-1] <= STEP2_DROP * costs[0]:
            raise AssertionError(f"{path} step {step}: final {costs[-1]!r} "
                                 f"not 100x below {costs[0]!r}")
    print(f"(c) bundle_adjust {secs:.2f} s; phase part "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    keep["venice-1778"] = pc

    # (d) final-13682: step 1's first iteration and one step-2 trial on
    # the card's kernels and on their plain versions (one pair of stage
    # solvers; tools/large_scale.py first_steps), then a few iterations of
    # each step, and of step 1 with POWER_SCHUR_COMPLEMENT (composed
    # term), "off" and pure f64
    t0 = time.perf_counter()
    pd = keep["final-13682"] = make_problem("final-13682")
    print(f"(d) final-13682: {pd.num_observations} observations, generated "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    args = (pd.obs_cam, pd.obs_lm, pd.obs_uv, pd.num_cameras,
            pd.num_landmarks)
    s1 = Stage1Solver(*args, defaults, device="cuda")
    s2 = Stage2Solver(*args, defaults, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    got1, got2, start2, secs_k = first_steps(pd, s1, s2, False)
    want1, want2, _start2, secs_p = first_steps(pd, s1, s2, True, start2)
    check_same_run(f"(d) final-13682 step 1, first {LARGE_N_ITERS} "
                   "iteration, every trial's cost", got1, want1,
                   FINAL_TOLS[0], every=True)
    gap2 = max(abs(got2[k] - want2[k]) / abs(want2[k])
               for k in ("l_diff", "cost"))
    print(f"(d) final-13682 step-2 trial at lambda {STEP2_LAMBDA:g}: kernels "
          f"{got2}, plain versions {want2}; largest gap {gap2:.3e} "
          f"(tolerance {FINAL_TOLS[1]:g})", flush=True)
    if (got2["ok"], got2["terms"]) != (want2["ok"], want2["terms"]) or not (
            got2["ok"] and gap2 <= FINAL_TOLS[1]):
        raise AssertionError(f"(d) final-13682 step-2 trial: kernels {got2} "
                             f"vs plain versions {want2}")
    print(f"(d) {secs_k:.2f} s on the kernels, {secs_p:.2f} s on the plain "
          f"versions ({time.perf_counter() - t1:.1f} s with set-up), peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB", flush=True)
    del s1, s2, start2
    # step 2 from the loop's own start: its first trials are NaN or
    # rising by f32 rounding alone (tools/large_scale.py starts)
    ba = SolverOptions(max_num_iterations_step_1=START2_ITERS,
                       max_num_iterations_step_2=FINAL_STEP2_ITERS)
    step1_runs = {
        "step 1 PSC composed final-13682": SolverOptions(
            solver_type_step_1=SolverType.POWER_SCHUR_COMPLEMENT,
            fused_power_term=False, max_num_iterations_step_1=2),
        "step 1 off final-13682": SolverOptions(
            pallas_kernels="off", max_num_iterations_step_1=2),
        "step 1 f64 final-13682": SolverOptions(
            mixed_precision_solves=False, max_num_iterations_step_1=2),
    }
    for path in LARGE_N_RUNS:
        t1 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        launches.reset_launch_counts()
        if path in step1_runs:
            summaries = (solve(pd, step1_runs[path], "cuda")[0],)
        else:
            _out, p1, p2, _secs = pipeline(pd, ba, "cuda")
            summaries = (p1, p2)
        counts[path] = launches.launch_counts()
        check_counts(path, counts[path])
        for step, summary in enumerate(summaries, 1):
            its = summary.iterations
            costs = [it.cost.all.error for it in its if it.cost is not None]
            seq = "".join("A" if it.step_is_successful else "R"
                          for it in its[1:])
            print(f"(d) {path} step {step}: {len(its)} records, {seq}, "
                  f"costs {costs}", flush=True)
            if not (np.isfinite(costs).all()
                    and summary.final_cost.all.error < costs[0]):
                raise AssertionError(f"(d) {path} step {step}: cost did not "
                                     f"fall: {costs}")
        print(f"(d) {path}: {time.perf_counter() - t1:.1f} s with set-up, "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
    print(f"large_n phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    for name, res in timed.items():
        print(f"N = {LARGE_N}: {name:<22} loop {res['loop_ms']:.4f} ms, "
              f"events: kernel {res['ms']:.4f} ms plain "
              f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']})", flush=True)
    return {f"{name}@N{LARGE_N}": timed[name] for name in LARGE_N_ROUTES}


def check_mesh_large_n(counts, large):
    """The mesh_large_n phase (16a in the module docstring). `large`: the
    venice-1778 and final-13682 problems the large_n phase made. Returns
    the `kernels` line's `<slot kernel>@N13682` entries."""
    from povar_tpu_torch import SolverOptions, make_mesh
    from povar_tpu_torch.ops import launches, spmd_kernels, spmd_ref
    from povar_tpu_torch.tools import gloo_card
    from povar_tpu_torch.tools.large_scale import (
        LARGE_N_ITERS, STEP2_LAMBDA, accepted_costs, first_iterations,
        first_steps, plan_stats, stage_solvers,
    )

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    defaults = SolverOptions()
    # (a) each scale's plan at D = 1, kept on the problem for the mesh
    # solvers below
    for scale in ("venice-1778", "final-13682"):
        plan_stats(large[scale], 1, f"(a) {scale}", trace=False)

    # (b) venice-1778: the mesh's first step-1 iterations on the card's
    # kernels and on their plain versions, one mesh stage-1 solver
    t0 = time.perf_counter()
    pc = large["venice-1778"]
    s1, _s2 = stage_solvers(pc, defaults, make_mesh(1))
    print(f"(b) venice-1778 mesh solvers set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    path = "step 1 spmd venice-1778"
    launches.reset_launch_counts()
    got, secs_k = first_iterations(pc, False, stage1=s1)
    counts[path] = launches.launch_counts()
    check_counts(path, counts[path])
    want, secs_p = first_iterations(pc, True, stage1=s1)
    check_same_run(f"(b) venice-1778 mesh step 1, first {LARGE_N_ITERS} "
                   "iterations", got, want, MESH_LARGE_N_TOL)
    print(f"(b) {secs_k:.2f} s on the kernels, {secs_p:.2f} s on the plain "
          "versions", flush=True)
    del s1, _s2

    # (c) venice-1778: bundle_adjust on the 1-device mesh, capped
    t0 = time.perf_counter()
    path = "bundle_adjust spmd venice-1778"
    ba = SolverOptions(max_num_iterations_step_1=MESH_BA_ITERS[0],
                       max_num_iterations_step_2=MESH_BA_ITERS[1])
    launches.reset_launch_counts()
    _out, p1, p2, secs = pipeline(pc, ba, "cuda", mesh=True)
    counts[path] = launches.launch_counts()
    check_counts(path, counts[path])
    for step, summary in ((1, p1), (2, p2)):
        costs = accepted_costs(summary)
        print(f"(c) {path} step {step}: {len(summary.iterations)} records, "
              f"{costs[0]!r} -> {costs[-1]!r}", flush=True)
        check_falling(f"{path} step {step}", costs)
        if len(costs) < 2:
            raise AssertionError(f"{path} step {step}: no step taken")
    print(f"(c) bundle_adjust(mesh=make_mesh(1)) {secs:.2f} s with its plan; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (d) final-13682: the mesh's first step-1 iteration and one step-2
    # trial from the homogenized VarProj start, on the card's kernels
    # (counters zeroed before, read after) and on their plain versions
    t0 = time.perf_counter()
    pd = large["final-13682"]
    s1, s2 = stage_solvers(pd, defaults, make_mesh(1))
    print(f"(d) final-13682 mesh solvers set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    path = MESH_FINAL_RUN
    launches.reset_launch_counts()
    got1, got2, start2, secs_k = first_steps(pd, s1, s2, False)
    counts[path] = launches.launch_counts()
    check_counts(path, counts[path])
    want1, want2, _start2, secs_p = first_steps(pd, s1, s2, True, start2)
    check_same_run(f"(d) final-13682 mesh step 1, first {LARGE_N_ITERS} "
                   "iteration, every trial's cost", got1, want1,
                   MESH_FINAL_TOLS[0], every=True)
    gap2 = max(abs(got2[k] - want2[k]) / abs(want2[k])
               for k in ("l_diff", "cost"))
    print(f"(d) final-13682 mesh step-2 trial at lambda {STEP2_LAMBDA:g}: "
          f"kernels {got2}, plain versions {want2}; largest gap {gap2:.3e} "
          f"(tolerance {MESH_FINAL_TOLS[1]:g})", flush=True)
    if (got2["ok"], got2["terms"]) != (want2["ok"], want2["terms"]) or not (
            got2["ok"] and gap2 <= MESH_FINAL_TOLS[1]):
        raise AssertionError(f"(d) final-13682 mesh step-2 trial: kernels "
                             f"{got2} vs plain versions {want2}")
    print(f"(d) {secs_k:.2f} s on the kernels, {secs_p:.2f} s on the plain "
          f"versions, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # (e) the three slot kernels at final-13682's slot-row counts, on
    # seeded operands of the mesh's layout, against their plain versions
    # (bit for bit), with the loop timer, events and the bound
    lay = s1.layout
    o_dev, n_rows = spmd_ref.layout_sizes(lay)
    gen = torch.Generator(device="cuda").manual_seed(9)
    operands = {"class_part_sums": (9, o_dev),
                "class_expand_rows": (3, n_rows),
                "class_reduce_reexpand": (3, o_dev)}
    timed = {}
    for name, shape in operands.items():
        kernel = getattr(spmd_kernels, name)
        plain = getattr(spmd_ref, name)
        x = torch.randn(shape, generator=gen, device="cuda")
        out = kernel(x, lay)
        torch.cuda.synchronize()
        if not torch.equal(out, plain(x, lay)):
            raise AssertionError(f"(e) {name}: kernel != plain version at "
                                 f"{shape}")
        moved = (x.numel() + out.numel()) * 4
        res = dict(max_abs_err=0.0, ms=cuda_ms(lambda: kernel(x, lay)),
                   plain_ms=cuda_ms(lambda: plain(x, lay)),
                   bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                   library_ms=cuda_ms(spmd_library(name, x, lay)),
                   loop_ms=loop_ms(lambda: kernel(x, lay)))
        timed[name] = res
        print(f"(e) {name:<22} bit-equal at {shape} -> {tuple(out.shape)} "
              f"(o_dev {o_dev}, {n_rows} slot rows): loop "
              f"{res['loop_ms'] * 1e3:.1f} us, events kernel "
              f"{res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms view "
              f"formulation {res['library_ms']:.4f} ms, bound "
              f"{res['bound_ms'] * 1e3:.1f} us", flush=True)
    del s1, s2, start2

    # (f) D = 2 on the one card: two gloo ranks on cuda:0
    # (tools/gloo_card.py, a harness, not a user option), each first
    # trying the mesh's collectives on CUDA tensors; venice-1778's first
    # LARGE_N_ITERS step-1 iteration against a 1-device mesh's
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    gap = gloo_card.compare(1)
    print(f"(f) D = 2 on one card: largest cost gap {gap:.3e} (tolerance "
          f"{MESH_D2_TOL:g}); {time.perf_counter() - t0:.1f} s", flush=True)
    if not gap <= MESH_D2_TOL:
        raise AssertionError(f"(f) D = 2 against D = 1: cost gap {gap:.3e} "
                             f"(> {MESH_D2_TOL:g})")
    # the plans leave the problems: the band_chol phase copies them;
    # the final-13682 layout stays for the spmd_f64 phase's slot kernels
    for problem in large.values():
        vars(problem).pop("_spmd_plan_cache", None)
    large["final-13682 layout"] = lay
    print(f"mesh_large_n phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {f"{name}@N{LARGE_N}": res for name, res in timed.items()}


def check_band_chol(problem, counts, large):
    """The band_chol phase (16b in the module docstring). `large`: the
    venice-1778 and final-13682 problems the large_n phase made."""
    from povar_tpu_torch import SolverOptions, Stage1Solver
    from povar_tpu_torch.options import SolverType
    from povar_tpu_torch.ops import launches
    from povar_tpu_torch.problem.synthetic import synthetic_bal_problem_fast
    from povar_tpu_torch.tools.large_scale import (
        BAND_ITERS, BANDED_1000, band_run, banded_route, make_problem,
        recorded_costs, route_of,
    )

    t_phase = time.perf_counter()

    # (a) venice-89 (one supernode) and BANDED_1000 (S >= 2): the banded
    # increment of one linearization against the dense route's, both on
    # the card
    n_cams, n_lms, obs_per_lm, locality = BANDED_1000
    banded = synthetic_bal_problem_fast(n_cams, n_lms, obs_per_lm, seed=0,
                                        locality=locality)
    for name, pa, route in (("venice-89", problem, "full band"),
                            ("banded-1000", banded, "band")):
        args = (pa.obs_cam, pa.obs_lm, pa.obs_uv, pa.num_cameras,
                pa.num_landmarks)
        cams = torch.as_tensor(pa.cam_space, device="cuda")
        for config, mixed in (("mixed", True), ("f64", False)):
            opts = SolverOptions(solver_type_step_1=SolverType.CHOLESKY,
                                 mixed_precision_solves=mixed)
            dense = Stage1Solver(*args, opts, device="cuda")
            # venice-89's landmarks see cameras at random: RCM finds no
            # band and the plan is the full one, with the JAX package's
            # warning
            with banded_route(), warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                band = Stage1Solver(*args, opts, device="cuda")
            meta = band._band_plan.meta
            lin = dense.linearize(cams, dense.initialize_varproj(cams))
            want, _ = dense.solve_cholesky(lin, 1e-4)
            got, n_it = band.solve_cholesky(lin, 1e-4)
            gap = float((got - want).norm() / want.norm())
            tol = BAND_DENSE_TOLS[name][config]
            print(f"(a) {name} {config}: {route_of(band)} (bw {meta.bw}, K "
                  f"{meta.K}, S {meta.S}) against {route_of(dense)} at "
                  f"lambda 1e-4: relative gap {gap:.3e} (tolerance "
                  f"{tol:g})", flush=True)
            if not (route_of(dense) == "dense" and route_of(band) == route
                    and (meta.S >= 2) == (route == "band") and n_it == 0
                    and gap <= tol):
                raise AssertionError(f"(a) {name} {config}: banded vs dense "
                                     f"{gap:.3e}, {n_it} iterations")
            del dense, band, lin, want, got
    del banded

    def run(label, problem, iters, route, warning=None, plain=False,
            path=None, residual=None):
        """band_run on the card, its route, warning and counts checked;
        with `residual` (a scale) the banded increment's residual within
        BAND_RESIDUAL_TOLS[residual]."""
        res = band_run(problem, label, iters, plain=plain)
        if res["route"] != route:
            raise AssertionError(f"{label}: route {res['route']}, not {route}")
        if len(res["warned"]) != (warning is not None) or (
                warning is not None and warning not in res["warned"][0]):
            raise AssertionError(f"{label}: warnings {res['warned']}")
        if path is not None:
            counts[path] = res["launches"]
            check_counts(path, counts[path])
        costs = res["costs"]
        if not (np.isfinite(costs).all() and res["records"] == iters + 1):
            raise AssertionError(f"{label}: {res['records']} records, costs "
                                 f"{costs}")
        print(f"{label}: route {res['route']}, bw {res['bw']}, K {res['K']}, "
              f"S {res['S']}, plan {res['plan_s']} s "
              f"({res['plan_bytes']} B on the card), set-up "
              f"{res['setup_s']:.2f} s, {iters} iterations in "
              f"{res['step1_s']:.2f} s, {res['decisions']}, inner "
              f"{res['inner']}; ms a trial {res['trial_ms']:.2f}, assembly "
              f"{res.get('assembly_ms')}, factorization and solve "
              f"{res.get('factor_solve_ms')}; peak device memory "
              f"{res['peak_gib']:.2f} GiB", flush=True)
        if residual is not None:
            tol = BAND_RESIDUAL_TOLS[residual]
            print(f"{label}: banded increment's residual ||S x - b|| / ||b|| "
                  f"{res['residual']:.3e} (tolerance {tol:g})", flush=True)
            if not res["residual"] <= tol:
                raise AssertionError(f"{label}: residual {res['residual']}")
        return res

    # (b) venice-1778 CHOLESKY: the first iterations on the card's
    # kernels and on their plain versions, then a capped CHOLESKY +
    # RIPOBA bundle_adjust
    t0 = time.perf_counter()
    pc = large["venice-1778"]
    got = run("(b) venice-1778", pc, BAND_ITERS, "band",
              path="step 1 CHOLESKY venice-1778", residual="venice-1778")
    want = run("(b) venice-1778 plain versions", pc, BAND_ITERS, "band",
               plain=True)
    check_same_run(f"(b) venice-1778 CHOLESKY step 1, first {BAND_ITERS} "
                   "iterations, every trial's cost", got["summary"],
                   want["summary"], BAND_TOL, every=True)
    path = "bundle_adjust CHOLESKY+RIPOBA venice-1778"
    ba = SolverOptions(solver_type_step_1=SolverType.CHOLESKY,
                       max_num_iterations_step_1=BAND_BA_ITERS[0],
                       max_num_iterations_step_2=BAND_BA_ITERS[1])
    torch.cuda.reset_peak_memory_stats()
    launches.reset_launch_counts()
    _out, p1, p2, secs = pipeline(pc, ba, "cuda")
    counts[path] = launches.launch_counts()
    check_counts(path, counts[path])
    for step, summary in ((1, p1), (2, p2)):
        costs = recorded_costs(summary)
        accepted = [it.cost.all.error for it in summary.iterations
                    if it.step_is_successful]
        print(f"(b) {path} step {step}: {len(summary.iterations)} records, "
              f"costs {costs}", flush=True)
        check_falling(f"(b) {path} step {step}", accepted)
        if not summary.final_cost.all.error < costs[0]:
            raise AssertionError(f"(b) {path} step {step}: cost did not "
                                 f"fall: {costs}")
    print(f"(b) bundle_adjust {secs:.2f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (c) venice-1778-uniform: no band, the full band, one iteration
    t0 = time.perf_counter()
    run("(c) venice-1778-uniform", make_problem("venice-1778-uniform"), 1,
        "full band", warning="FULL dense RCS",
        path="step 1 CHOLESKY venice-1778-uniform")
    print(f"(c) {time.perf_counter() - t0:.1f} s", flush=True)

    # (d) final-13682: two banded iterations, the cost falling
    t0 = time.perf_counter()
    res = run("(d) final-13682", large["final-13682"], 2, "band",
              path="step 1 CHOLESKY final-13682", residual="final-13682")
    if not res["summary"].final_cost.all.error < res["costs"][0]:
        raise AssertionError(f"(d) final-13682: cost did not fall: "
                             f"{res['costs']}")
    print(f"(d) {time.perf_counter() - t0:.1f} s", flush=True)

    # (e) final-13682-adversarial: the PCG fallback, one trial
    t0 = time.perf_counter()
    res = run("(e) final-13682-adversarial",
              make_problem("final-13682-adversarial"), 1, "pcg",
              warning="falling back to PCG",
              path="step 1 CHOLESKY final-13682-adversarial")
    if not res["inner"][1] >= 1:
        raise AssertionError(f"(e) CG iterations {res['inner']}")
    print(f"(e) {time.perf_counter() - t0:.1f} s", flush=True)
    for path in BAND_RUNS:
        print(f"{path}: hpp_b {counts[path]['hpp_b']}, cam_scatter_add "
              f"{counts[path]['cam_scatter_add']} launches", flush=True)
    print(f"band_chol phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def stage_solver(cls, problem, options, mesh=False):
    """`cls` (Stage1Solver or Stage2Solver) for `problem` on the card, or
    with `mesh` its SPMD counterpart on a 1-device mesh."""
    from povar_tpu_torch import make_mesh
    from povar_tpu_torch.parallel import spmd
    from povar_tpu_torch.solver.pipeline import _make_spmd_plan

    if not mesh:
        return cls(problem.obs_cam, problem.obs_lm, problem.obs_uv,
                   problem.num_cameras, problem.num_landmarks, options,
                   device="cuda")
    cls = {"Stage1Solver": spmd.SpmdStage1Solver,
           "Stage2Solver": spmd.SpmdStage2Solver}[cls.__name__]
    return cls(_make_spmd_plan(problem, 1), problem.obs_uv,
               problem.num_cameras, problem.num_landmarks, options,
               make_mesh(1))


def bench_step1(problem, options, label, mesh=False) -> None:
    """The warm step-1 bench iteration under `options` (linearize + trial
    from the VarProj-initialized start, bench_options), on a 1-device
    mesh with `mesh`."""
    from povar_tpu_torch import Stage1Solver
    from povar_tpu_torch.tools.large_scale import bench_options

    s = stage_solver(Stage1Solver, problem, bench_options(options), mesh)
    c = torch.as_tensor(problem.cam_space, device="cuda")

    def step(c, lm):
        lin = s.linearize(c, lm)
        nc, nl, _ok, _it, _ld, err = s.trial(c, lm, lin, 1e-4)
        return nc, nl, err["error_all"]

    bench_iterations(step, c, s.lm_pack(s.initialize_varproj(c)), label)


def bench_step2(problem, options, label, mesh=False) -> None:
    """The warm step-2 bench iteration under `options` (linearize + trial
    from the homogenized VarProj-initialized start, bench_options), on a
    1-device mesh with `mesh`."""
    from povar_tpu_torch import Stage1Solver, Stage2Solver, create_homogeneous
    from povar_tpu_torch.tools.large_scale import bench_options

    c = torch.as_tensor(problem.cam_space, device="cuda")
    lm0 = stage_solver(Stage1Solver, problem, options,
                       mesh).initialize_varproj(c)
    c2, lm2 = create_homogeneous(c, lm0)
    s2 = stage_solver(Stage2Solver, problem, bench_options(options), mesh)

    def step(c, lm):
        lin = s2.linearize(c, lm)
        nc, nl, _ok, _it, _ld, err = s2.trial(c, lm, lin, 1e-4)
        return nc, nl, err["error_all"]

    bench_iterations(step, c2, s2.lm_pack(lm2), label)


def bench_iterations(step, c, lm, label, reps: int = 50) -> None:
    """Warm time of one chained iteration (bench.py's definition: 50
    chained calls, one synchronisation), the kernels one iteration
    launches, then its profile."""
    from povar_tpu_torch.ops import launches

    launches.reset_launch_counts()
    step(c, lm)
    torch.cuda.synchronize()
    print(f"{label} iteration launches: "
          f"{ {k: v for k, v in launches.launch_counts().items() if v} }",
          flush=True)
    t0 = time.perf_counter()
    cc, ll = c, lm
    for _ in range(reps):
        cc, ll, err = step(cc, ll)
    float(err)
    per_it = (time.perf_counter() - t0) / reps
    print(f"warm {label} iteration (linearize + trial, eta=0, m=10, "
          f"{reps} chained): {per_it * 1e3:.3f} ms", flush=True)
    profile_iterations(step, c, lm)


def check_cli(problem):
    """`python -m povar_tpu_torch.cli` as a user runs it, in a
    subprocess on the card with SolverOptions() defaults: on the BAL
    fixture tests/data/mini-bal-12-48-pre.txt and on `problem` written as
    BAL text by write_bal_text, each after --create-dataset. Raises
    unless each run exits 0 and writes a ba_log.json with both steps'
    records and strictly falling accepted costs in each."""
    import os
    import shutil

    from povar_tpu_torch.problem.synthetic import write_bal_text

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))

    def cli(cwd, *argv):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "povar_tpu_torch.cli", *argv], cwd=cwd,
            env=env, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise AssertionError(f"cli {argv}: exit {proc.returncode}\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        return time.perf_counter() - t0

    for label in ("mini-bal-12-48", "venice-89"):
        d = os.path.join(work, label)
        os.makedirs(d)
        name = f"problem-{label}-pre.txt"
        t0 = time.perf_counter()
        if label == "venice-89":
            write_bal_text(os.path.join(d, name), problem.num_cameras,
                           problem.num_landmarks, problem.obs_cam,
                           problem.obs_lm, problem.obs_uv, lm_p=problem.lm_p)
        else:
            shutil.copy(os.path.join(root, "tests", "data",
                                     "mini-bal-12-48-pre.txt"),
                        os.path.join(d, name))
        write_s = time.perf_counter() - t0
        create_s = cli(d, "--input", name, "--create-dataset")
        solve_s = cli(d, "--input", os.path.join("data_custom", name))
        if label == "venice-89":
            mesh_s = cli(d, "--input", os.path.join("data_custom", name),
                         "--mesh-devices", "1", "--log-file", "mesh.json")
            with open(os.path.join(d, "mesh.json")) as f:
                mesh_log = json.load(f)
            for key in ("iterations1", "iterations"):
                check_falling(f"cli {label} --mesh-devices 1 {key}",
                              [it["cost"] for it in mesh_log[key]
                               if it["step_is_successful"]])
            print(f"cli {label} --mesh-devices 1: solve {mesh_s:.2f} s, "
                  f"{len(mesh_log['iterations1'])} + "
                  f"{len(mesh_log['iterations'])} records, final costs "
                  f"{mesh_log['iterations1'][-1]['cost']!r} "
                  f"{mesh_log['iterations'][-1]['cost']!r}", flush=True)
        with open(os.path.join(d, "ba_log.json")) as f:
            log = json.load(f)
        for key in ("iterations1", "iterations"):
            check_falling(f"cli {label} {key}",
                          [it["cost"] for it in log[key]
                           if it["step_is_successful"]])
        print(f"cli {label}: BAL text {write_s:.2f} s, --create-dataset "
              f"{create_s:.2f} s, solve {solve_s:.2f} s (process, load and "
              f"kernel library included); {len(log['iterations1'])} + "
              f"{len(log['iterations'])} records ({log['solver1']['solver_type']}"
              f", {log['solver']['solver_type']}), final costs "
              f"{log['iterations1'][-1]['cost']!r} "
              f"{log['iterations'][-1]['cost']!r}", flush=True)
    shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from povar_tpu_torch import (
        SolverOptions, Stage1Solver, Stage2Solver, create_homogeneous,
        synthetic_bal_problem_fast,
    )
    from povar_tpu_torch.ops import _build, launches
    from povar_tpu_torch.options import SolverType, SolverTypeRiemannian

    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} x{torch.cuda.device_count()}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in _build.build_log().splitlines():
        if "Function properties" in line or "Used" in line or "spill" in line:
            print("  ptxas " + line.strip(), flush=True)

    phase("kernels (venice-89 shapes)")
    t0 = time.perf_counter()
    problem = synthetic_bal_problem_fast(N_CAMS, N_LMS, OBS_PER_LM, seed=0)
    defaults = SolverOptions()
    # the composed power term (e0_u/e0_scatter, mat_dot2/scatter2)
    opts = SolverOptions(fused_power_term=False)
    probe = Stage1Solver(
        problem.obs_cam, problem.obs_lm, problem.obs_uv,
        problem.num_cameras, problem.num_landmarks, defaults, device="cuda",
    )
    print(f"problem {problem.num_observations} obs -> O = "
          f"{probe.obs.cam.shape[0]} padded, N = {probe.n_cams}; set-up "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    results = check_kernels(probe, problem, defaults.alpha)
    results.update(check_cam_kernels(probe))
    del probe

    phase("step 1")
    check_small()
    launches.reset_launch_counts()
    summary, (cams, lms), setup_s, solve_s = solve(problem, opts, "cuda")
    check_counts("step 1 composed", launches.launch_counts())
    report_step(1, summary, JAX_FINAL_COST)
    print(f"composed term: first solve {solve_s:.3f} s (solver set-up "
          f"{setup_s:.3f} s)", flush=True)
    if tuple(cams.shape) != (N_CAMS, 3, 4) or tuple(lms.shape) != (N_LMS, 3):
        raise AssertionError(f"output shapes {cams.shape} {lms.shape}")
    if not (bool(torch.isfinite(cams).all()) and bool(torch.isfinite(lms).all())):
        raise AssertionError("non-finite optimized state")

    launches.reset_launch_counts()
    summary_d, _, setup_d, solve_d = solve(problem, defaults, "cuda")
    check_counts("step 1 defaults", launches.launch_counts())
    report_step(1, summary_d, JAX_FINAL_COST)
    summary2, _, setup2_s, warm_s = solve(problem, defaults, "cuda")
    check_final(1, summary2)
    print(f"SolverOptions() defaults: first solve {solve_d:.3f} s, warm "
          f"{warm_s:.3f} s (solver set-up {setup_d:.3f} / {setup2_s:.3f} s), "
          f"{len(summary2.iterations) - 1} iterations, final cost "
          f"{summary2.final_cost.all.error!r}", flush=True)

    args = (problem.obs_cam, problem.obs_lm, problem.obs_uv,
            problem.num_cameras, problem.num_landmarks)
    for label, base in (("step-1 defaults", defaults),
                        ("step-1 composed", opts)):
        bench_step1(problem, base, label)

    phase("kernels2 (venice-89 shapes, step-2 state of the step-1 result)")
    t0 = time.perf_counter()
    probe2 = Stage2Solver(*args, defaults, device="cuda")
    print(f"step-2 solver set-up {time.perf_counter() - t0:.2f} s", flush=True)
    cams_h, lms_h = create_homogeneous(cams, lms)
    results.update(check_kernels2(probe2, cams_h, lms_h, loop=True))
    check_kernels2_orders(problem, probe2, cams_h, lms_h)
    del probe2

    phase("E0 operators: fused against composed (venice-89)")
    check_e0_operators(problem, cams, lms, cams_h, lms_h)

    phase("layouts: unstructured against structured (venice-89)")
    check_layouts(problem, cams_h, lms_h)

    phase("step-2 witness (venice-89, card against CPU from one state)")
    check_step2_witness(problem, opts, cams_h, lms_h)
    ripcg = SolverOptions(solver_type_step_2=SolverTypeRiemannian.RIPCG)
    check_step2_witness(problem, ripcg, cams_h, lms_h,
                        counts_when_rejected=False)

    phase("pipeline (bundle_adjust)")
    check_small_pipeline()
    t0 = time.perf_counter()
    Stage1Solver(*args, defaults, device="cuda")
    Stage2Solver(*args, defaults, device="cuda")
    torch.cuda.synchronize()
    setup_e2e = time.perf_counter() - t0
    counts = {}
    for path, o in (("bundle_adjust defaults", defaults),
                    ("bundle_adjust composed", opts)):
        launches.reset_launch_counts()
        out, p1, p2, e2e_s = pipeline(problem, o, "cuda")
        counts[path] = launches.launch_counts()
        print(f"-- {path}", flush=True)
        check_counts(path, counts[path])
        report_step(1, p1, JAX_FINAL_COST)
        report_step(2, p2, JAX_FINAL_COST2, STEP2_BAND)
        records = len(p1.iterations) + len(p2.iterations)
        print(f"iteration records {records} ({len(p1.iterations)} + "
              f"{len(p2.iterations)}; BENCH_r05 e2e_iterations "
              f"{JAX_RECORDS}, recorded, not compared)", flush=True)
        print(f"first bundle_adjust {e2e_s:.3f} s (both solvers' set-up, "
              f"measured apart: {setup_e2e:.3f} s)", flush=True)
        if (out.cam_space.shape != (N_CAMS, 3, 4)
                or out.lm_p_h.shape != (N_LMS, 4)):
            raise AssertionError(f"output shapes {out.cam_space.shape} "
                                 f"{out.lm_p_h.shape}")
        if not all(np.isfinite(a).all() for a in (out.cam_space, out.lm_p_h,
                                                  out.lm_p)):
            raise AssertionError("non-finite optimized state")

    _, w1, w2, warm_e2e = pipeline(problem, defaults, "cuda")
    check_final(1, w1)
    check_final(2, w2, JAX_FINAL_COST2, STEP2_BAND)
    print(f"warm bundle_adjust (defaults) {warm_e2e:.3f} s, "
          f"{len(w1.iterations)} + {len(w2.iterations)} records, final costs "
          f"{w1.final_cost.all.error!r} {w2.final_cost.all.error!r}",
          flush=True)

    for label, base in (("step-2 defaults", defaults),
                        ("step-2 composed", opts)):
        bench_step2(problem, base, label)

    phase("device_loop (the device LM loop against the host loop)")
    results.update(check_lm_kernels())
    check_device_loop(problem, counts)

    phase("CG solvers (bundle_adjust, PCG with SCHUR_JACOBI + RIPCG)")
    pcg = SolverOptions(solver_type_step_1=SolverType.PCG,
                        solver_type_step_2=SolverTypeRiemannian.RIPCG)
    path = "bundle_adjust PCG+RIPCG"
    launches.reset_launch_counts()
    out, q1, q2, pcg_s = pipeline(problem, pcg, "cuda")
    counts[path] = launches.launch_counts()
    check_counts(path, counts[path])
    report_step(1, q1, JAX_PCG_COST, PCG_BAND)
    cg1 = [it.linear_solver_iterations for it in q1.iterations]
    print(f"step 1: {len(cg1)} records, CG iterations {cg1}; JAX "
          f"{len(JAX_PCG_CG)} records, {JAX_PCG_CG}", flush=True)
    if cg1[:PCG_SAME + 1] != JAX_PCG_CG[:PCG_SAME + 1]:
        raise AssertionError(f"step 1: first CG counts {cg1} != JAX "
                             f"{JAX_PCG_CG}")
    report_step(2, q2, JAX_PCG_COST2)
    print(f"PCG+RIPCG bundle_adjust {pcg_s:.3f} s, "
          f"{len(q1.iterations)} + {len(q2.iterations)} records", flush=True)
    if not all(np.isfinite(a).all() for a in (out.cam_space, out.lm_p_h)):
        raise AssertionError("non-finite optimized state")

    phase("PSC (POWER_SCHUR_COMPLEMENT, step 1 spread and bundle_adjust)")
    check_psc(problem, counts)

    phase("f32 (the f32 LM state, bundle_adjust)")
    check_f32(problem, counts)

    phase("unstructured (pallas_kernels='off' and CHOLESKY)")
    check_unstructured(problem, counts)
    off = SolverOptions(pallas_kernels="off")
    bench_step1(problem, off, "step-1 off")
    bench_step2(problem, off, "step-2 off")

    phase("f64 (pure f64, mixed_precision_solves=False, one device, "
          "venice-89)")
    results.update(check_f64(problem, counts))

    phase("spmd (the SPMD window layout on a 1-device mesh, venice-89)")
    t0 = time.perf_counter()
    results.update(check_spmd_kernels(problem))
    check_spmd(problem, counts)
    print(f"spmd phase {time.perf_counter() - t0:.1f} s", flush=True)

    phase(f"large_n (N > 1024 on one card: N = {LARGE_N} routes, R O past "
          "2^31, venice-1778, final-13682)")
    large = {}
    results.update(check_large_n(counts, large))

    phase("mesh_large_n (the SPMD window layout past 1024 cameras on a "
          "1-device mesh: venice-1778, final-13682)")
    results.update(check_mesh_large_n(counts, large))

    phase("spmd_f64 (the mesh's pure f64: the window layout's f64 "
          "kernels on a 1-device mesh)")
    results.update(check_spmd_f64(problem, counts, large))

    phase("band_chol (CHOLESKY at any camera count: the banded "
          "factorization, its full band and its PCG fallback)")
    check_band_chol(problem, counts, large)
    del large

    phase("detailed_timing (the staged host loop, per-stage spans; the "
          "native BAL tokenizer)")
    check_detailed_timing(problem, counts)

    phase("cli (python -m povar_tpu_torch.cli, SolverOptions() defaults)")
    check_cli(problem)

    def launched(name, runs=PATHS):
        """(count, run) of `name` in the first run of `runs` that runs it
        (for a kernel, a venice-89 run; for a `<name>@N13682` route, a
        final-13682 run of the large_n phase)."""
        path = next(p for p in counts if p in runs and name in runs[p])
        return counts[path][name], path

    def entry(m, name, route=None):
        base = name.removesuffix("_f64")
        count, run = (
            launched(name) if route is None
            else launched(name, {MESH_FINAL_RUN: PATHS[MESH_FINAL_RUN]})
            if name in SPMD else launched(name, LARGE_N_RUNS))
        key = name if route is None else f"{name}@N{route}"
        return dict(name=key, route="cuda",
                    source=SOURCES[m.__name__.split(".")[-1]],
                    replaces=REPLACES[base], launches=count,
                    launches_run=run, **results[key])

    print(f"chip_smoke {time.perf_counter() - T_START:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": [
        entry(m, name) for m in launches.MODULES for name in m.LAUNCHES
    ] + [
        entry(m, name, LARGE_N) for m in launches.MODULES
        for name in m.LAUNCHES if name in LARGE_N_ROUTES or name in SPMD
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


def profile_iterations(step, c, lm, reps: int = 5) -> None:
    """Device time by kernel over `reps` chained iterations, and the
    device's busy share of the wall time (torch.profiler; diagnostics
    only: a profiler that records nothing prints so and fails nothing)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            c, lm, err = step(c, lm)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = kern.get(e.name, (0.0, 0))
            kern[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    if not kern:
        print("profile: no device events recorded", flush=True)
        return
    busy = sum(t for t, _n in kern.values())
    calls = sum(n for _t, n in kern.values())
    print(f"profile over {reps} iterations: device {busy / reps:.1f} us/it "
          f"of {wall_us / reps:.1f} us/it wall (busy share "
          f"{busy / wall_us:.3f}); {calls / reps:.0f} device ops/it",
          flush=True)
    for name, (t, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t / reps:9.1f} us/it {n / reps:7.1f} calls/it  "
              f"{name[:90]}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
