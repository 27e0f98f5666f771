#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`mmd_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Takes no arguments and reads no environment variables; paths resolve from
this file. Phases, one short line each:

1. card: name and power limit (nvidia-smi), torch and CUDA versions
2. build: the three CUDA kernels (the grid-SDF lookup, the collision guide
   and the guide loop), one nvcc per source, all started together, into
   build/
3. kernel: the grid-SDF kernel against its plain torch version on the
   EnvConveyor2D and EnvEmptyNoWait2D grids
   (out-of-range points, points on cell edges, ragged counts, a strided
   view, the finalize's (64, 379, 2) interpolated waypoints, the training
   summary's (25, 379, 2), the task sampler's 1024 and 2048 candidates, a
   generated context's (20, 379, 2), the linear data's (500, 379, 2) and a
   10-problem batched finalize's (640, 379, 2)), which must agree exactly;
   at (64, 379, 2) and (640, 379, 2) the kernel's device time a launch (a
   profiler trace), and the wrapper and the plain version timed with CUDA
   events
4. collision: the collision-guide kernel against its plain version (the
   guide's autograd code, on the card, over the plain torch lookup) on both
   maps and a scene whose two
   grids tie everywhere, at (64, 64, 4) and (3, 64, 64, 4), with waypoints on
   cell edges, in objects, in the walls' margin, in corners and at the hinge,
   which must agree exactly; both timed at the guide's (64, 64, 4)
17. guide loop (run after phase 4, before phase 5): the guide-loop kernel
   (a guided step's 20 guide iterations in one launch) against its plain
   version (`guide_loop_plain`, its lookup in plain torch too) in every
   case of `mmd_torch.tools.guide_cases.LOOP_CASES` at full width (B=64):
   both maps, the edge waypoints (cell edges, hinge, tied grids), a
   constraint set of K = 3, P = 2 with an inactive row, an inactive set,
   R = 3 soft paths, the ECBS root's R = 9 soft rows, a local replan's 8
   constraints of 2 points, 10 problems on one scene, 3 stacked tiles, H =
   2 and 128; each one launch, exactly equal. Then its device time a
   launch (a profiler trace), the wrapper's ms (CUDA events) and its bound
   (bytes, cells, operations) at the plan's (64, 64, 4), the root's, the
   local replan's, 10 problems' and 3 tiles' shapes, and at the plan's the
   plain version's and today's per-iteration loop's ms (20 guide_gradient
   calls and hard.apply)
5. slice: full-width MPD plans (B=64, H=64, 25+1 DDPM steps, guided steps
   x 20 guide iterations) on the EnvEmptyNoWait2D checkpoint for 3
   antipodal pairs of the 10-agent circle, and one EnvConveyor2D plan; each
   must launch the guide loop once per guided step (14), the collision
   guide never and the lookup once (the finalize), and every NoWait plan
   must succeed
6. replay: the first NoWait plan again on the CPU with the same noise,
   whose trajs_final must agree within CPU_TOL; the EnvConveyor2D plan again
   on the card with every kernel routed to its plain torch version, which
   must agree within REPLAY_TOL; and the EnvConveyor2D plan on the CPU,
   reported beside the CPU's own change under a 1e-7 relative change of the
   initial noise
7. team: prioritized planning (PP) of the 10-robot circle of
   EnvEmptyNoWait2D at the same full width, through
   `PrioritizedPlanning.plan`, with ten planners sharing one model (seeds
   0-9, as bench.py builds them). A warm-up team pass runs first under
   torch's sync debug mode, which must report no host sync inside the
   loop; then the team plan, which must take the device pass, succeed
   with no conflict (`count_conflicts` of its paths too) and launch the
   guide loop 10 x 14 times, no collision guide and the lookup 10 times;
   then the same plan replayed on the card with every kernel routed to its
   plain version, which must choose the same indices and agree within
   REPLAY_TOL. It prints the team's wall seconds, each agent's seconds
   (CUDA events between the agents) and the launches. Then the ten agents
   as one batched fresh sampler call (`PrioritizedTeam.plan_problems`, the
   CBS/XCBS root's): 14 guide-loop launches and one lookup for all ten;
   then that call's chain with the UNet run 64 rows at a time
   (`RowChunked`), each DDPM step within CPU_TOL of each agent's single
   step fed the same x. The UNet runs at 64 rows there because cuDNN
   chooses its convolution algorithm by batch size, so a row need not be
   summed in one order at 640 rows and at 64; the unchunked chain's steps
   against the single steps are printed beside it as a reading of that
8. cbs: the XECBS search of the 10-robot circle, the main path of the
   repository's bench.py (bfloat16 UNet, DDPM, B=64, H=64), through
   `CBS.plan`, with ten planners sharing one model seeded as bench.py
   seeds them. The bfloat16 forward is held first against the float32 one
   at B=64 (BF16_TOL of the largest |eps|). A warm-up search runs under
   torch's sync debug mode: every host sync it reports must come from the
   search's one reading function (`cbs.to_host`), and inside the ECBS root
   there must be at most one read per agent. Then the measured search,
   which must succeed with no conflict (`count_conflicts` of its paths
   too) and launch the guide loop exactly 14 times per fresh sampler call
   and 4 per local one, no collision guide and the lookup once per call, by
   the
   search's own count of its calls (`timing["sampler_calls"]`), with one
   local call for each chain step's two children; then the same search
   replayed on the card (the
   generators restored) with every kernel routed to its plain version,
   which must make the same expansions and choose the same indices, and
   agree within REPLAY_TOL. The search takes JAX's default path, the root
   and a speculative greedy chain from it (`fused.root_greedy`): it must
   accept at least one greedy step. It prints the wall seconds, the
   expansions, the host's waits by phase, the plans by kind, the UNet
   forwards, the chain's flag reads, the accepted steps and the audit's
   events. Then the same search from the warm-up's draws with the greedy
   chain turned off on the instance, so that every node goes through the
   host-driven one-node expansion (`CBS.expand`, `fused.expand_children`),
   which the search still takes where the chain does not apply, for the
   frontier's recovery and for ECBS's starved children: run under sync
   debug mode (every sync from `cbs.to_host`, at most one read per agent
   in the root), it must read its children through that expansion and
   none through a chain, make one local sampler call a children read (a
   conflict's children, and again the ones the soft rows starved), succeed
   with no conflict, launch 14 x fresh + 4 x local guide loops and one
   lookup a sampler call, and replay exactly with every plain version
9. tiles: multi-tile planning (`MPDEnsemble`, float32, B=64, H=64, 25+1
   DDPM steps) on the 2x2 staggered instance EnvTestTwoByTwoRobotPlanarDiskRandom
   (seed 0, 4 agents, stagger dt = 10; its 2x2 grid's tiles EnvEmptyNoWait2D,
   EnvConveyor2D and EnvHighways2D twice, on the repository's checkpoints). First
   the collision-guide kernel on three stacked scenes (EnvConveyor2D,
   EnvHighways2D, EnvEmptyNoWait2D) at (3, 64, 64, 4) against its plain
   version, exactly, and timed. Then agent 0's 3-tile skeleton plans fresh
   and then locally from that batch: each must have a free sample, its seams
   must hold within SEAM_TOL, and each must launch the guide loop once per
   guided step for all its tiles (14 fresh, 4 local), no collision guide
   and the lookup once per tile. Then the XECBS search through `CBS.plan`:
   a warm-up under torch's sync debug mode (every sync from
   `cbs.to_host`), the search, which must succeed with no conflict and
   launch exactly 14 x fresh + 4 x local guide loops and 3 x plans
   lookups, and its replay with every kernel routed to its plain version,
   which must be exact. Then PP on the same team (its status printed, not
   held; its warm-up's syncs held as XECBS's) with 14 guide loops and 3
   lookups per plan
10. train: the TemporalUnet diffusion model trained on the card at full
   width (32 x (1, 2, 4), H=64, D=4, 25 exponential steps) with the recipe
   of `mmd_torch.train.trainer` (Adam 3e-4, global-norm clip 1.0, EMA 0.995
   every 10 steps, batch 128). First TRAIN_PARITY_STEPS float32 steps from
   one seeded init on the card and on the CPU, on the same batches, t and
   noise drawn on the host, with the EMA reset and then blended
   (PARITY_EMA), and gradient norms on both sides of the clip's 1.0:
   losses within TRAIN_PARITY_TOL relative, parameters and EMA within
   TRAIN_PARITY_TOL absolute; then one bfloat16-compute loss and its
   gradients on both (BF16_PARITY_LOSS_TOL, BF16_PARITY_COSINE). Then `train` for
   TRAIN_STEPS float32 steps on EnvEmptyNoWait2D's 10000 trajectories
   (500 held out, logged every TRAIN_LOG_EVERY) with every chunk between two
   log points under torch's sync debug mode "error", so that a host wait
   inside one fails the phase; its logged step-TRAIN_STEPS loss must lie in
   TRAIN_BAND. Then BF16_TRAIN_STEPS bfloat16-compute steps: finite losses,
   float32 master parameters. Kernels a step from a profiler trace. Then
   the sampling summary on the EMA parameters (3 lookups, each run again
   through the kernel and the plain version on its points, exactly), a checkpoint
   saved under build/ and loaded back (the EMA weights exactly), and one
   full-width MPD plan with the loaded model, which must launch the
   guide loop 14 times, no collision guide and the lookup once. It prints the logged and
   validation losses, ms a step (CUDA events) and steps a second of both
   precisions, kernels a step, the summary and the plan
12. eval (run after phase 10, before the report): `evaluate` of
   `mmd_torch.tools.eval_model` at full width (B=64, 25+1 DDPM steps),
   EVAL_TASKS tasks on each of the five maps in float32, then EVAL_TASKS
   EnvConveyor2D tasks with the bfloat16 UNet and EVAL_TASKS in float32
   DDIM. Each float32 DDPM row must succeed on every task and lie within
   EVAL_FREE_BAND (fraction-free) and EVAL_ADHERENCE_BAND (adherence) below
   MODEL_EVAL.yaml's JAX row; the bf16 and DDIM rows are printed beside
   JAX's. Every plan must launch the guide loop 14 times (3 for DDIM: 3
   guided substeps), no collision guide and the lookup once. Then the
   first DDIM plan again on the card with every kernel routed to its plain
   version (its
   generator state restored), which must agree within REPLAY_TOL
13. datagen: `generate_context_trajectories` (native RRT required, 20
   trajectories, H=64, 300 GPMP2 iterations) for DATAGEN_CONTEXTS contexts
   of EnvConveyor2D (skills, RRT*) and of EnvHighways2D (corner gating),
   after one warm-up context. GPMP2 runs under torch's sync debug mode
   "error", so a host wait inside its loop fails the phase; each context
   must launch the lookup once per iteration and once more (the
   classification), and the contexts must launch no collision guide and
   no guide loop. It prints each context's keep rate, wall seconds, its
   host RRT and spline seconds and GPMP2's device time (CUDA events). The
   last context's GPMP2 runs again with the plain lookup, which must agree
   exactly (NaN where a factor failed, in both), and once more under the
   profiler (kernels an iteration, device busy time and idle share, the
   kernels with the most device time). Then EnvEmptyNoWait2D's
   linear data at DATAGEN_LINEAR contexts, saved under build/ and read back
   by `TrajectoryDataset.load_trajectories`, equal
14. experiments (after phase 13, before the report): a paired sweep
   through `run_multi_agent_experiment` of
   `mmd_torch.tools.launch_multi_agent_experiment`, on the 2x2 instance at
   TILES_AGENTS agents, stagger STAGGER_DT, float32, EXPERIMENT_TRIALS
   trials each of XECBS and PP with a EXPERIMENT_RUNTIME_LIMIT s limit,
   saved under build/. No trial may raise (the sweep's own count); every
   trial must save results.pkl and results.txt; the aggregate must have
   the keys of the JAX package's (read from results/multitile-r5 as text);
   XECBS must succeed in at least EXPERIMENT_XECBS_MIN trials, and every
   SUCCESS must audit at 0 contacts again. Over the phase the guide loop
   must launch 14 x fresh + 4 x local sampler calls, the collision guide
   never and the lookup 3 x plans, by the plans each trial saved, and 2 x
   4 more a trial (the
   team's check of its starts and of its goals on the grid's 4 tiles). PP's
   success rate and each trial's status are printed beside JAX's for the
   same problems (results/multitile-r5, read as text), not held, with each
   cell's mean planning time, expansions and adherence. Then a `Launcher`
   pool of 2 spawned workers, started after this process has used CUDA:
   each of its 2 runs must launch the lookup once in a worker and agree
   with the plain version
15. speculative (after phase 14, before the report): (a) bench.py's
   XECBS-R (`mmd_torch.bench`'s planners and team: the 10-robot circle,
   bf16, one root repair round): a warm-up under torch's sync debug mode
   (every sync from `cbs.to_host`), the search, which must succeed with no
   conflict, plan its 20 fresh plans (the team root and the repair round)
   in 2 sampler calls, and launch exactly 14 x fresh + 4 x local guide
   loops, no collision guide and one lookup a sampler call, and its replay
   with every kernel routed to its plain version (generators restored),
   which must be exact;
   (b) one trial of JAX's dense grid (EnvConveyor2DRobotPlanarDiskRandom,
   DENSE_AGENTS agents, the vd checkpoint, float32, XECBS, frontier width
   2, DENSE_RUNTIME_LIMIT s; trial DENSE_TRIAL) through
   `run_multi_agent_trial`: it must succeed, audit at 0 contacts, run at
   least one frontier round of two nodes, and launch exactly what its
   sampler-call counts say (14 / 4 guide loops a call, one lookup a call
   and one for each of the team's two checks)
16. baselines (after phase 15, before the report): `mmd_torch.tools.
   bench_kernels` once (the lookup against its plain version at 4096 and
   65536 points, which must match); then (a) CHOMP, STOMP, MPPI and
   stochastic GPMP (`mmd_torch.datagen.classical`) at their configs'
   defaults for BASELINE_PARTICLES copies of the straight line of
   BASELINE_TASK on EnvConveyor2D, (b) one full-width MPD plan on the
   EnvConveyor2D checkpoint with the guide's knobs of ZOO_GUIDE
   (interpolated collision and three zoo terms), (b') the same plan with
   the three zoo terms alone, whose guide the guide-loop kernel does not
   compute, so that it runs its iterations one `guide_gradient` at a time
   with the collision-guide kernel, (c) the planar arm's
   `plan_arm_gpmp2` at its defaults (16 particles, H=64, 400 iterations) on
   EnvDropRegion2D from along +x to along +y. Each runs after a short
   warm-up under torch's sync debug mode "error" (a host wait inside it
   fails the phase), must launch the lookup exactly once an iteration (a
   + 0, (b) once a guide call + 1 and no collision guide, (b') 1 and the
   collision guide once a guide call, (c) 400 + 1) and no guide loop, and
   must equal its replay with every kernel routed to its plain version,
   the generator restored. It prints each run's seconds, launches and outcome
   (waypoints in collision and free particles before and after; the plan's
   free samples; the arm's free particles, at least one), and the lookup's
   device time, wrapper and plain ms and bound at each run's shape
18. rest of the port (after phase 16, before the report): (a) the UNet's
   optional modes at the flagship's width (32 x (1, 2, 4), B = 64, H = 64,
   state 4, context 32), self_attention off and on x each
   conditioning_type, parameters from a fixed generator: a float32 forward
   on the card against the CPU's within CPU_TOL, its ms by CUDA events;
   the bfloat16 twin refuses every optional mode (ValueError), and on the
   plain UNet it is held against the CPU's bf16 twin at BF16_TOL and
   BF16_MEAN_TOL; (b) `sample_gp_prior` at B = 64, H = 64 on one set of
   draws, card against CPU within twice the CPU's own float32-against-
   float64 gap, measured in the run; (c) the SDF and gradient fields of
   `viz` (n = 200 -> (40000, 2) and n = 40 -> (1600, 2)) on EnvConveyor2D
   and EnvEmptyNoWait2D through the lookup kernel, one launch each, exactly
   equal to the plain lookup, and the kernel's device us a launch at
   (40000, 2) from a profiler trace with its byte bound; (d) one UNet
   forward's FLOPs at B = 64, the card's dense bf16 peak, and phase 8's
   XECBS search's unet_evals, model_gflops and mfu_pct (its wall seconds,
   no new search); the kernel build's compile seconds of phase 2 (> 0) and
   of one later plan, sync-free, (0.0); (e) a profiler trace of one plan,
   sync-free, whose Chrome trace file must name the guide-loop kernel
19. sharding (after phase 18, before the report): (a) in this process, a
   1-rank NCCL process group and make_mesh([1], ("agent",)): the 10-robot
   XECBS of phase 8 (bf16, DDPM) with the mesh against the same search
   without one from the same seeds: the same expansions and bitwise-equal
   paths, and its launches as phase 8 counts them; (b) two spawned ranks
   on the one card over gloo with CUDA tensors (`parallel.sharding.spawn`,
   `tools.shard_cases.chip_case`): the 10-robot fresh team root in f32, 5
   agents a rank, bitwise equal across the ranks and within CPU_TOL of the
   unsharded root on the same draws in this process, each rank launching
   14 guide loops and 1 lookup; XECBS-R (one repair round, bf16) on the
   circle, and (a)'s XECBS, whose serial ECBS root every rank plans whole
   with rank 0's plans broadcast: each SUCCESS with 0 conflicts on each
   rank, both ranks' paths bitwise equal, each rank's launches as its
   sampler calls, expansions beside the unsharded search's; then, in the
   same two ranks (a spawn costs seconds), the dry run's ranks
   (`parallel.dryrun.dryrun_rank`, as `dryrun_multichip(2, "gloo",
   "cuda")` runs them), checked and reported by the dry run's own
   `report` with its OK line (its 2-D section needs 4 ranks); (c) the
   phase's seconds, bounded by SHARDING_BUDGET_S
11. one JSON line of kernel numbers (launches: the sum over the paths,
   each counted from 0 just before it and read just after; the sampler's
   paths launch the guide loop and no collision guide, phase 16's
   zoo-term plan the collision guide and no guide loop; launches by path:
   the
   four plans of phase 5, the team plan of
   phase 7, the two searches of phase 8, phase 9's two plans, search and PP team,
   phase 10's, phases 12, 13 and 14's, phase 15's two, phase 16's six,
   phase 18's fields and plans, and phase 19's 1-rank search and each
   spawned rank's root, XECBS-R and XECBS, counted in the rank;
   ms, plain and bound: the collision
   guide at phase 9's stacked (3, 64, 64, 4), with phase 4's (64, 64, 4)
   beside them; the guide loop at phase 17's (64, 64, 4), its other shapes
   and cases beside; `launch_floor_us`: the device time of a 1-element `fill_`
   from a profiler trace, the least a launch costs; the lookup's numbers at
   both phase 3 shapes and at phase 16's, and bench_kernels' rows), the
   run's seconds against DEADLINE_S, then the contract line
   {"ok": true, "device": {...}}

Any failure raises and exits non-zero; a self-imposed deadline of
DEADLINE_S seconds does the same. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
DEADLINE_S = 900
# Card against CPU on the NoWait plan: the map has no obstacles, so the
# sampler has no SDF cell edges to amplify a rounding difference; only the
# float32 summation orders of cuDNN and the CPU convolutions differ. Run on
# the CPU against JAX, the same plan agrees to ~1e-5. 1e-3 is 2% of the
# robot's radius (0.05), far below anything that changes a classification.
# On EnvConveyor2D a waypoint that a rounding difference moves across a cell
# edge reads another cell's gradient, and the guide amplifies that: the
# CPU's own plan moves by more than 1e-3 when its initial noise changes by
# 1e-7 relative. So there the kernels are held on the card, against their
# plain versions in the same plan, exactly (REPLAY_TOL).
CPU_TOL = 1e-3
# The collision-guide kernel does its plain version's float32 operations in
# the same order, the clip's norm included: (a^2 + b^2) + (c^2 + d^2) is how
# torch's CUDA reduction sums four channels. So on the card it must agree
# exactly, and does.
COLLISION_TOL = 0.0
# With both kernels routed to their plain versions the EnvConveyor2D plan
# runs the same arithmetic, so it must agree exactly.
REPLAY_TOL = 0.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM data sheet, float32 outside the tensor cores
FINALIZE_SHAPE = (64, 379)  # classification points: B=64 x (63 x 6 + 1)
BATCHED_FINALIZE_SHAPE = (640, 379)  # a batched finalize of 10 problems' 64 each
SUMMARY_SHAPE = (25, 379)   # the training summary's: 25 samples x (63 x 6 + 1)
CONTEXT_SHAPE = (20, 379)   # a generated context's classification: 20 trajectories
LINEAR_SHAPE = (500, 379)   # the linear data's classification: 500 contexts
# random_coll_free_q's candidates: an evaluation task's start and goal, and
# the 500 linear contexts' 1000 starts and goals.
FILTER_POINTS = (1024, 2048)
GUIDE_SHAPE = (64, 64, 4)   # one guide call: B=64 x H=64 waypoints
GUIDE_STEPS = 20            # a guided step's guide iterations (DiffusionConfig)
# The guide-loop kernel's float32 operations, counted from its source
# (guide_loop.cu, collision_terms.cuh; a fused multiply-add through double
# counts 2): a waypoint's unnormalize and hard conditions every iteration;
# an inner waypoint's collision terms (70), GP prior (74) and step (6); a
# ball (a constraint's point in range, a soft row's unmasked centre); a
# term's clip, weight and sum (a constraint, the soft paths).
LOOP_OPS = {"waypoint": 28, "inner": 150, "ball": 12, "term": 20}
# The guide-loop cases timed: the main path's plan (1, 64, 64, 4), the ECBS
# root's with R = 9 soft rows, 10 problems and 3 tiles.
LOOP_TIMED = ("conveyor", "root", "local", "problems", "tiles")
NOWAIT_PAIRS = (0, 3, 6)   # of the 10-agent circle (multi_agent_utils.py:82-90)
CONVEYOR_TASK = ((-0.8, 0.0), (0.8, 0.0))  # straight through the centre box
TEAM_AGENTS = 10  # the 10-robot circle of bench.py
# The bfloat16 forward against the float32 one, on the card: both round to
# bf16's 8 significant bits in every conv and dense layer; JAX's own bf16
# forward differs from its float32 one by 0.7% of the largest |eps| on the
# CPU (tests/test_torch_unet.py). Held at 2% of the largest |eps|.
BF16_TOL = 2e-2
# The bfloat16 twin against its CPU self on the same input: both round
# every op to bf16 in their own summation order; held at the mean band
# that tests/test_torch_unet.py holds the port's bf16 forward to flax's at.
BF16_MEAN_TOL = 5e-3
# Phase 18: the UNet's optional modes at the flagship's width (B, H, D, E);
# GP-prior draws at the reference's 5 s over H waypoints; the fields of
# viz at PlanningVisualizer's defaults (n = 200: (40000, 2); n = 40).
UNET_MODES_SHAPE = (64, 64, 4, 32)
UNET_MODES_SEED = 18
GP_DURATION, GP_SEED = 5.0, 18
VIZ_SDF_N, VIZ_GRAD_N = 200, 40
# Phase 19: the draws of the sharded and unsharded team roots, and the
# phase's bound in seconds.
SHARD_SEED = 19
SHARDING_BUDGET_S = 60.0
TILES_INSTANCE = "EnvTestTwoByTwoRobotPlanarDiskRandom"
TILES_AGENTS = 4
STAGGER_DT = 10
STACKED_ENVS = ("EnvConveyor2D", "EnvHighways2D", "EnvEmptyNoWait2D")
# A plan's seams after the cross-conditioning, read back from its global
# trajectories: unnormalizing and normalizing again rounds by a few float32
# ulps of 1 (~1e-7).
SEAM_TOL = 1e-6
TRAIN_SEED = 18  # the JAX trainer's default seed, which the committed model used
TRAIN_STEPS, TRAIN_LOG_EVERY, BF16_TRAIN_STEPS = 2000, 1000, 200
# The card-against-CPU steps run the recipe with the EMA reset every 2
# steps before step 5 and blended from then on, so that 12 steps cross
# both of its branches (the recipe's first EMA update is at step 10).
TRAIN_PARITY_STEPS = 12
PARITY_EMA = {"step_start_ema": 5, "update_ema_every": 2}
# The card's train steps against the CPU's: cuDNN and the CPU sum the
# convolutions in other orders, and Adam divides the gradients' rounding
# differences by their own scale; a step of lr 3e-4 moves a parameter by
# about 3e-4. Measured on the H100 over 3 steps of the recipe: losses
# 9.2e-8 relative, parameters 6.7e-6 absolute. Parameters and EMA are held
# within it absolutely, losses relatively.
TRAIN_PARITY_TOL = 1e-4
# One bfloat16-compute loss and its gradients, card against CPU on the same
# parameters and draws: each rounds every conv and dense output to bf16's 8
# significant bits, in its own summation order. Held as the port's bf16 step
# is held against JAX's on the CPU (tests/test_torch_train.py): the loss
# within 1e-2 relative, the gradients' cosine at least 0.999.
BF16_PARITY_LOSS_TOL, BF16_PARITY_COSINE = 1e-2, 0.999
# The logged loss at step 2000 (the mean over steps 1001-2000) of the JAX
# package's train() on this recipe and data: the committed history
# (data_trained_models/EnvEmptyNoWait2D-RobotPlanarDisk/train_losses.npy)
# and tools/jax_train_band.py at seeds 0, 1 and 2 on the CPU (JAX 0.9.0).
# The port's must lie within [0.8 x their least, 1.2 x their most].
JAX_STEP2000_LOSSES = (0.0749758333, 0.0692303479, 0.0693059564, 0.0697581619)
TRAIN_BAND = (0.8 * min(JAX_STEP2000_LOSSES), 1.2 * max(JAX_STEP2000_LOSSES))
TRAIN_MODELS = os.path.join(ROOT, "build", "chip_smoke_train")  # gitignored
# The evaluation (phase 12): tasks a map, and the bands around MODEL_EVAL.yaml's
# float32 DDPM rows (JAX, 50 tasks): success must be 1.0 as JAX's on all five
# maps; fraction-free within 0.05; adherence within 0.2, since at 10 tasks one
# task moves it by 0.1. The bfloat16 and DDIM rows on EVAL_EXTRA_MAP are
# printed beside JAX's, not held (JAX's bf16 DDIM succeeds 0.1 there).
EVAL_TASKS = 10
EVAL_MAPS = ("EnvEmpty2D", "EnvEmptyNoWait2D", "EnvConveyor2D", "EnvHighways2D",
             "EnvDropRegion2D")
EVAL_EXTRA_MAP = "EnvConveyor2D"
EVAL_FREE_BAND, EVAL_ADHERENCE_BAND = 0.05, 0.2
# Data generation (phase 13) at scripts/generate_data.py's widths: 20
# trajectories a context, H = 64, 300 GPMP2 iterations; the linear data of
# EnvEmptyNoWait2D at the reference's 500 contexts.
DATAGEN_MAPS = ("EnvConveyor2D", "EnvHighways2D")
DATAGEN_CONTEXTS, DATAGEN_TRAJS, DATAGEN_ITERS, DATAGEN_LINEAR = 2, 20, 300, 500
DATAGEN_SEED = 0
# JAX's free trajectories of the 20 planned in the same contexts on the CPU
# (tools/jax_datagen_keep.py, JAX 0.9.0, the native RRT): printed beside the
# port's, not held, since the native RRT is built with -march=native and
# another CPU may round its paths otherwise.
JAX_KEPT = {("EnvConveyor2D", 0): 1, ("EnvConveyor2D", 1): 20, ("EnvHighways2D", 0): 20,
            ("EnvHighways2D", 1): 20}
DATAGEN_OUT = os.path.join(ROOT, "build", "chip_smoke_data")  # gitignored
# The experiments (phase 14): JAX's 2x2 sweep at 10 trials a cell
# (results/multitile-r5, frontier width 2, which changes the search's order
# and not its result) succeeds in 10 of 10 XECBS trials at 4 agents; the
# port's must succeed in at least 9. The 30 s limit bounds the phase.
EXPERIMENT_TRIALS = 10
EXPERIMENT_RUNTIME_LIMIT = 30.0
EXPERIMENT_XECBS_MIN = 9
EXPERIMENT_OUT = os.path.join(ROOT, "build", "chip_smoke_experiments")  # gitignored
JAX_SWEEP = os.path.join(ROOT, "results", "multitile-r5")
SPAWN_WORKERS = 2
# The speculative search (phase 15): JAX's dense Conveyor vd grid at its
# round-4 protocol (scripts/r5_stage_cd.sh:13-18 in f32: frontier width 2,
# 60 s), at its smallest cell. Trial DENSE_TRIAL of the sweep's paired
# problems runs a frontier round of two nodes here on an H100 (28.0-33.5
# s, 12 expansions; trial 0 took 42 expansions and 44.9-61.4 s in sweeps).
DENSE_INSTANCE = "EnvConveyor2DRobotPlanarDiskRandom"
DENSE_AGENTS, DENSE_TRIAL, DENSE_RUNTIME_LIMIT, DENSE_WIDTH = 12, 1, 60.0, 2
VD_MODELS = os.path.join(ROOT, "data_trained_models_vd")
VD_DATA = os.path.join(ROOT, "data_trajectories_vd")
# The baselines (phase 16): the four classical optimizers at their configs'
# defaults for BASELINE_PARTICLES copies of the straight line through
# EnvConveyor2D's centre box (tests/test_classical.py's task); one
# full-width MPD plan on the EnvConveyor2D checkpoint with the guide's
# collision on the 1.5x-interpolated trajectory and three zoo terms, each
# weighted as the collision term (ZOO_GUIDE); the planar arm's GPMP2 at its
# defaults on EnvDropRegion2D (tests/test_kinematics.py's problem).
BASELINE_PARTICLES, BASELINE_SEED = 64, 0
BASELINE_TASK = ((-0.8, -0.02), (0.8, -0.02))
ZOO_GUIDE = dict(interpolate_collision=True, weight_max_velocity=2e-2, max_velocity=0.5,
                 weight_chomp_smoothness=2e-2, weight_joint_limits=2e-2)
ARM_LINKS, ARM_LINK_LENGTH = 3, 0.2
ARM_GOAL = (1.5707963267948966, 0.0, 0.0)  # from along +x to along +y

_phase = ["start"]


def _on_deadline(signum, frame):
    print(f"chip_smoke: deadline of {DEADLINE_S} s passed in phase "
          f"'{_phase[0]}'", flush=True)
    raise TimeoutError(f"deadline passed in phase {_phase[0]}")


def phase(name: str):
    _phase[0] = name


def load_planner(env_name: str, start, goal, device: str):
    """The repository's checkpoint and dataset metadata as an MPD."""
    from mmd_torch.planners.single_agent.mpd import load_planner as load

    return load(os.path.join(ROOT, "data_trained_models"),
                os.path.join(ROOT, "data_trajectories"), env_name, start, goal, device)


def load_team(env_name: str, starts, goals, device: str):
    """One planner per agent, sharing one model, seeded 0..n-1."""
    from mmd_torch.planners.single_agent.mpd import load_planners

    return load_planners(os.path.join(ROOT, "data_trained_models"),
                         os.path.join(ROOT, "data_trajectories"), env_name, starts, goals,
                         device=device)


@contextlib.contextmanager
def routed(module, name: str, fn):
    """Bind module.name to fn for the block, then restore it."""
    kept = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, kept)


def counts() -> dict:
    """Every kernel's launches so far, by kernel (as a spawned rank of
    phase 19 counts its own)."""
    from mmd_torch.tools.shard_cases import launches

    return launches()


def zero_counts():
    """Set every kernel's launch count to 0: a counted path starts."""
    from mmd_torch.ops.collision_guide import collision_guide
    from mmd_torch.ops.guide_loop import guide_loop_cuda
    from mmd_torch.ops.sdf_kernel import grid_lookup

    guide_loop_cuda.launches = collision_guide.launches = grid_lookup.launches = 0


def grown(before: dict) -> dict:
    """The launches since `before` (a `counts()`), by kernel."""
    return {k: v - before[k] for k, v in counts().items()}


def want(guide_loop: int = 0, collision_guide: int = 0, grid_sdf_lookup: int = 0) -> dict:
    return {"guide_loop": guide_loop, "collision_guide": collision_guide,
            "grid_sdf_lookup": grid_sdf_lookup}


def plain_lookup():
    """Route the lookup kernel's wrapper to its plain version for the block."""
    from mmd_torch.ops import sdf_kernel

    return routed(sdf_kernel, "grid_lookup_cuda", sdf_kernel.grid_lookup_plain)


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel's wrapper to its plain version for the block: the
    lookup, the collision guide and the guide loop."""
    from mmd_torch.costs import guide

    with plain_lookup(), routed(guide, "collision_guide", guide.collision_guide_plain), \
            routed(guide, "guide_loop_cuda", guide.guide_loop_plain):
        yield


def kernel_points(n: int, grid, seed: int):
    """n query points: uniform over [-1.2, 1.2]^2 (so some fall outside the
    grid), points exactly on cell edges, and the box corners and far points."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, 2)).astype(np.float32)
    lo = np.asarray(grid.lower, np.float32)
    span = np.asarray(grid.upper, np.float32) - lo
    k = rng.integers(0, grid.shape[0] + 1, (n // 4, 2)).astype(np.float32)
    pts[: n // 4] = lo + k / np.float32(grid.shape[0]) * span  # cell edges
    extra = np.array([[-1, -1], [1, 1], [-1, 1], [10, -10], [-10, 10]], np.float32)
    pts[n // 4: n // 4 + len(extra)] = extra
    return pts


def time_lookup(scene, tables, pts) -> dict:
    """The lookup kernel at pts's shape: its device time a launch (a
    profiler trace), the wrapper's and the plain version's ms (CUDA
    events), and the least bytes: each point read once (8 B), each output
    written once (24 B a point: two values and two gradients) and each
    distinct cell's 24 B of the function's data (two values and two
    gradients; the record's 8 B of padding are not the function's) read
    once."""
    import torch

    from mmd_torch.ops import sdf_kernel
    from mmd_torch.tools.profile_plan import _traced

    box = (scene.grid.lower, scene.grid.upper)

    def run():
        return sdf_kernel.grid_lookup_cuda(pts, tables, *box)

    run()
    _, events = _traced(lambda: [run() for _ in range(200)], host=False)
    hits = [e.time_range.elapsed_us() for e in events if "grid_sdf_lookup_kernel" in e.name]
    out = {"device_us": sum(hits) / len(hits), "ms": cuda_ms(run),
           "plain_ms": cuda_ms(lambda: sdf_kernel.grid_lookup_plain(pts, tables, *box))}
    i, j = sdf_kernel.cell_index(pts, scene.grid.shape, *box)
    out["points"] = pts.numel() // 2
    out["cells"] = int(torch.unique(i * scene.grid.shape[1] + j).numel())
    out["bytes"] = out["points"] * (8 + 24) + 24 * out["cells"]
    out["bound_ms"] = out["bytes"] / HBM_BYTES_PER_S * 1e3
    return out


def cuda_ms(fn, n_iter: int = 200, n_warm: int = 20) -> float:
    import torch

    for _ in range(n_warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    signal.signal(signal.SIGALRM, _on_deadline)
    signal.alarm(DEADLINE_S)
    t_start = time.perf_counter()

    import numpy as np

    from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
    from mmd_torch.costs.guide import GuideConfig, collision_guide_plain
    from mmd_torch.envs.envs import make_env
    from mmd_torch.experiments.status import TrialSuccessStatus
    from mmd_torch.ops import collision_guide as cg
    from mmd_torch.ops import sdf_kernel
    from mmd_torch.ops import guide_loop as gl
    from mmd_torch.ops.build import find_nvcc, load_kernels
    from mmd_torch.ops.collision_guide import collision_guide
    from mmd_torch.ops.sdf_kernel import grid_lookup_cuda, grid_lookup_plain
    from mmd_torch.parallel.team import PrioritizedTeam, plan_prioritized_scan
    from mmd_torch.planners.multi_agent.conflict_detection import count_conflicts
    from mmd_torch.planners.multi_agent.prioritized_planning import PrioritizedPlanning
    from mmd_torch.tools.guide_cases import HINGE_CUTOFF, tied_scene, waypoints
    from mmd_torch.utils.profiling import compile_time_monitor

    dev = "cuda"

    phase("card")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"card: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    phase("build")
    t0 = time.perf_counter()
    with compile_time_monitor() as build_compile:
        load_kernels()
    print(f"build: grid_sdf.cu, collision_guide.cu and guide_loop.cu with {find_nvcc()}, one "
          f"nvcc each, all started together, in {time.perf_counter() - t0:.2f} s "
          f"(compile_time_monitor: {build_compile['compile_s']:.3f} s)")

    phase("kernel")
    lookup_err = 0.0
    for env_name in ("EnvConveyor2D", "EnvEmptyNoWait2D"):
        scene = make_env(env_name, dev).scene
        tables = [(scene.grid.values, scene.grid.grads),
                  (scene.extra_grid.values, scene.extra_grid.grads)]
        batch = torch.from_numpy(kernel_points(64 * 64 * 2, scene.grid, 3)).to(dev)
        n_final = FINALIZE_SHAPE[0] * FINALIZE_SHAPE[1]
        cases = {n: torch.from_numpy(kernel_points(n, scene.grid, n)).to(dev)
                 for n in (n_final, 65536, 4032, 999)}
        cases["guide view"] = batch.reshape(64, 64, 4)[:, 1:, :2]  # a strided view
        for n in FILTER_POINTS:
            cases[f"filter {n}"] = torch.from_numpy(kernel_points(n, scene.grid, n + 1)).to(dev)
        for case, shape in (("summary", SUMMARY_SHAPE), ("context", CONTEXT_SHAPE),
                            ("linear", LINEAR_SHAPE), ("batched", BATCHED_FINALIZE_SHAPE)):
            cases[case] = torch.from_numpy(kernel_points(
                shape[0] * shape[1], scene.grid, shape[0])).to(dev).reshape(*shape, 2)
        for case, pts in cases.items():
            ref = grid_lookup_plain(pts, tables, scene.grid.lower, scene.grid.upper)
            got = grid_lookup_cuda(pts, tables, scene.grid.lower, scene.grid.upper)
            torch.cuda.synchronize()
            for g, w in zip(got, ref):
                err = float((g - w).abs().max())
                if not torch.equal(g, w):
                    raise RuntimeError(f"lookup kernel != plain on {env_name}, {case}: "
                                       f"max abs err {err}")
                lookup_err = max(lookup_err, err)
        print(f"kernel: {env_name} lookup equal to plain at {n_final}/65536/4032/999 "
              f"points, the filter's {FILTER_POINTS} candidates, a strided (64, 63, 2) "
              f"view, the summary's {SUMMARY_SHAPE + (2,)}, a context's "
              f"{CONTEXT_SHAPE + (2,)}, the linear data's {LINEAR_SHAPE + (2,)} and a "
              f"batched finalize's {BATCHED_FINALIZE_SHAPE + (2,)}")

    scene = make_env("EnvConveyor2D", dev).scene
    tables = [(scene.grid.values, scene.grid.grads),
              (scene.extra_grid.values, scene.extra_grid.grads)]
    box = (scene.grid.lower, scene.grid.upper)
    lookup_at = {}
    for shape in (FINALIZE_SHAPE, BATCHED_FINALIZE_SHAPE):
        lookup_at[shape] = time_lookup(scene, tables, torch.from_numpy(kernel_points(
            shape[0] * shape[1], scene.grid, 7)).to(dev).reshape(*shape, 2))
        t = lookup_at[shape]
        print(f"kernel: lookup at {shape + (2,)} ({t['points']} pts x 2 grids, {t['cells']} "
              f"distinct cells): device {t['device_us']:.4f} us a launch; wrapper "
              f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms; bound {t['bound_ms']:.6f} ms "
              f"({t['bytes']} B)")
    main_lookup = lookup_at[FINALIZE_SHAPE]
    lookup_ms, lookup_plain_ms = main_lookup["ms"], main_lookup["plain_ms"]
    lookup_bound_ms = main_lookup["bound_ms"]

    phase("collision")
    # The plain version's lookup runs in plain torch too, so that the kernel
    # is held against plain torch only.
    collision_err, n_cases = 0.0, 0
    for cutoff in (GuideConfig().obstacle_cutoff_margin, HINGE_CUTOFF):
        cfg = GuideConfig(obstacle_cutoff_margin=cutoff)
        conveyor_scene = make_env("EnvConveyor2D", dev).scene
        scenes = {"EnvConveyor2D": conveyor_scene,
                  "EnvEmptyNoWait2D": make_env("EnvEmptyNoWait2D", dev).scene,
                  "tied": tied_scene(conveyor_scene, cfg.collision_margin)}
        for name, sc in scenes.items():
            for shape in (GUIDE_SHAPE, (3, *GUIDE_SHAPE)):
                u = torch.from_numpy(waypoints(shape, sc, cfg.collision_margin,
                                               len(name) + len(shape))).to(dev)
                got = collision_guide(u, sc, cfg)
                with plain_lookup():
                    ref = collision_guide_plain(u, sc, cfg)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                if not err <= COLLISION_TOL or got[..., 2:].any():
                    raise RuntimeError(f"collision kernel != plain on {name}, {shape}, "
                                       f"cutoff {cutoff}: max abs err {err}")
                collision_err = max(collision_err, err)
                n_cases += 1
    print(f"collision: kernel against plain in {n_cases} cases (2 maps and a tied scene, "
          f"(64, 64, 4) and (3, 64, 64, 4), default and hinge margins): max abs err "
          f"{collision_err:.3e} (tolerance {COLLISION_TOL})")

    cfg = GuideConfig()
    u = torch.from_numpy(waypoints(GUIDE_SHAPE, scene, cfg.collision_margin, 11)).to(dev)
    collision_ms = cuda_ms(lambda: collision_guide(u, scene, cfg))
    with plain_lookup():
        collision_plain_ms = cuda_ms(lambda: collision_guide_plain(u, scene, cfg))
    # Least bytes: each inner row read once (16 B; the first and last
    # waypoints' outputs are 0 whatever they hold), each distinct cell of
    # the inner rows read once (24 B: two grids' value and gradient; the
    # table's 8 B of padding are not the function's), each row written
    # once (16 B).
    q = u[:, 1:-1, :2].contiguous()
    i, j = sdf_kernel.cell_index(q, scene.grid.shape, *box)
    n_cells = int(torch.unique(i * scene.grid.shape[1] + j).numel())
    n_rows = u.numel() // 4
    collision_bytes = (q.numel() // 2) * 16 + n_rows * 16 + n_cells * 24
    collision_bound_ms = collision_bytes / HBM_BYTES_PER_S * 1e3
    print(f"collision: {GUIDE_SHAPE} on EnvConveyor2D: kernel {collision_ms:.5f} ms, "
          f"plain {collision_plain_ms:.5f} ms, bound {collision_bound_ms:.6f} ms "
          f"({collision_bytes} B, {n_cells} cells)")

    phase("guide loop")
    loop = run_guide_loop_phase(dev)

    phase("slice")
    starts, goals = get_start_goal_pos_circle(10)
    pairs = list(zip(starts, goals))
    nowait = [load_planner("EnvEmptyNoWait2D", *pairs[k], dev) for k in NOWAIT_PAIRS]
    conveyor = load_planner("EnvConveyor2D", *CONVEYOR_TASK, dev)
    cfg = nowait[0].cfg
    guided_steps = cfg.n_guided_steps()
    t0 = time.perf_counter()
    nowait[0]()  # warm-up
    print(f"slice: warm-up plan {time.perf_counter() - t0:.3f} s; expecting "
          f"{guided_steps} guide-loop launches a plan (one a guided step, each "
          f"{cfg.n_guide_steps} iterations), no collision guide and 1 lookup (finalize)")
    # Noise of the plans that phase 6 replays.
    replay = {0: nowait[0].draw_noise(), len(NOWAIT_PAIRS): conveyor.draw_noise()}
    zero_counts()  # main path starts
    runs = [(f"EnvEmptyNoWait2D pair {k}", p) for k, p in zip(NOWAIT_PAIRS, nowait)]
    runs.append(("EnvConveyor2D", conveyor))
    outs, plan_s = [], []
    for n, (label, planner) in enumerate(runs):
        before = counts()
        out = planner(noise=replay.get(n))
        grew = grown(before)
        outs.append(out)
        plan_s.append(out.t_total)
        print(f"slice: {label}: {out.t_total:.3f} s, success {out.success_free_trajs}, "
              f"fraction_free {out.fraction_free_trajs:.3f}, launches {grew}")
        if grew != want(guided_steps, 0, 1):
            raise RuntimeError(f"{label}: launched {grew}, expected "
                               f"{want(guided_steps, 0, 1)}")
        if not torch.isfinite(out.trajs_final).all() or out.trajs_final.shape != (
                cfg.n_samples, cfg.horizon, cfg.state_dim):
            raise RuntimeError(f"{label}: trajs_final not finite of the expected shape")
        if label.startswith("EnvEmptyNoWait2D") and out.success_free_trajs != 1:
            raise RuntimeError(f"{label}: no collision-free trajectory")
    main_launches = counts()  # main path ends

    phase("replay")

    def max_diff(a, b) -> float:
        return float((a.trajs_final.cpu() - b.trajs_final.cpu()).abs().max())

    def on_cpu(noise, scale=1.0):
        return type(noise)(x_T=noise.x_T.cpu() * scale, steps=noise.steps.cpu())

    cpu_out = load_planner("EnvEmptyNoWait2D", *pairs[NOWAIT_PAIRS[0]], "cpu")(
        noise=on_cpu(replay[0]))
    diff = max_diff(outs[0], cpu_out)
    print(f"replay: {runs[0][0]} on the CPU in {cpu_out.t_total:.3f} s, "
          f"max |trajs_final card - cpu| {diff:.3e} (tolerance {CPU_TOL})")
    if not diff <= CPU_TOL:
        raise RuntimeError(f"card and CPU plans differ by {diff} > {CPU_TOL}")

    n = len(NOWAIT_PAIRS)  # the EnvConveyor2D plan
    # This replay only: every kernel gives way to its plain version.
    with plain_kernels():
        plain_out = conveyor(noise=replay[n])
    diff = max_diff(outs[n], plain_out)
    print(f"replay: {runs[n][0]} on the card with every plain version, "
          f"max |trajs_final kernels - plain| {diff:.3e} (tolerance {REPLAY_TOL})")
    if not diff <= REPLAY_TOL:
        raise RuntimeError(f"the kernels' and the plain versions' plans differ by {diff}")
    cpu_conveyor = load_planner("EnvConveyor2D", *CONVEYOR_TASK, "cpu")
    cpu_out = cpu_conveyor(noise=on_cpu(replay[n]))
    nudged = cpu_conveyor(noise=on_cpu(replay[n], 1.0 + 1e-7))
    print(f"replay: {runs[n][0]} max |trajs_final card - cpu| "
          f"{max_diff(outs[n], cpu_out):.3e}; cpu under a 1e-7 relative change "
          f"of x_T {max_diff(cpu_out, nudged):.3e} (reported, not held)")

    phase("team")
    team_starts, team_goals = get_start_goal_pos_circle(TEAM_AGENTS)
    team_planners = load_team("EnvEmptyNoWait2D", team_starts, team_goals, dev)
    pp = PrioritizedPlanning(team_planners, team_starts, team_goals)
    # Warm-up: one team pass with every host sync inside it reported.
    t0 = time.perf_counter()
    team, warm_noise = PrioritizedTeam.of(team_planners, pp.margin), pp._team_noise()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            plan_prioritized_scan(team, warm_noise)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    print(f"team: warm-up team pass {time.perf_counter() - t0:.3f} s, host syncs "
          f"inside the loop: {len(syncs)}")
    if syncs:
        raise RuntimeError(f"the team loop synced the host {len(syncs)} times: {syncs[:3]}")
    team_noise = pp._team_noise()  # the draws of the plan the replay repeats
    zero_counts()  # team path starts
    paths, _, status, n_conflicts = pp.plan(noise_l=team_noise)
    team_launches = counts()  # team path ends
    timing = dict(pp.timing)
    print(f"team: {TEAM_AGENTS}-robot PP in {timing['plan_s']:.3f} s ({timing['device_calls']} "
          f"host wait(s), {timing['device_s']:.3f} s), status {status}, conflicts "
          f"{n_conflicts}, device pass {pp.used_scan}, launches {team_launches}")
    print("team: agent seconds " + " ".join(f"{a:.4f}" for a in timing.get("agent_s", [])))
    if not pp.used_scan:
        raise RuntimeError("the team plan did not take the device pass")
    if (status != TrialSuccessStatus.SUCCESS or n_conflicts != 0
            or count_conflicts(paths, pp.margin) != 0):
        raise RuntimeError(f"team plan: status {status}, {n_conflicts} conflicts")
    if team_launches != want(TEAM_AGENTS * guided_steps, 0, TEAM_AGENTS):
        raise RuntimeError(f"team plan launched {team_launches}, expected "
                           f"{want(TEAM_AGENTS * guided_steps, 0, TEAM_AGENTS)}")
    if len(paths) != TEAM_AGENTS or not all(
            p.shape == (cfg.horizon, cfg.state_dim) and np.isfinite(p).all() for p in paths):
        raise RuntimeError("team paths not finite of the expected shape")
    kept = pp.final
    with plain_kernels():
        pp.plan(noise_l=team_noise)
    diff = float((kept.paths_all - pp.final.paths_all).abs().max())
    print(f"replay: team plan on the card with every plain version in "
          f"{pp.timing['plan_s']:.3f} s, indices equal {kept.ix_best == pp.final.ix_best}, "
          f"max |trajs_final kernels - plain| {diff:.3e} (tolerance {REPLAY_TOL})")
    if kept.ix_best != pp.final.ix_best or not diff <= REPLAY_TOL:
        raise RuntimeError(f"the kernels' and the plain versions' team plans differ by {diff}")
    batched = batched_against_looped(team, team_noise)

    phase("cbs")
    cbs = run_cbs_phase(dev, cfg)

    phase("tiles")
    tiles = run_tiles_phase(dev)

    phase("train")
    trained = run_train_phase(dev, guided_steps)

    phase("eval")
    evaluated = run_eval_phase(dev)

    phase("datagen")
    generated = run_datagen_phase(dev)

    phase("experiments")
    experiments = run_experiments_phase(dev)

    phase("speculative")
    speculative = run_speculative_phase(dev, cfg)

    phase("baselines")
    baselines = run_baselines_phase(dev)

    phase("rest")
    rest = run_rest_phase(dev, smi, cbs["summary"], build_compile["compile_s"])

    phase("sharding")
    sharded = run_sharding_phase(dev, cfg)

    phase("report")
    floor_us = launch_floor_us()
    print(f"report: launch floor (a 1-element fill_) {floor_us:.4f} us on the device")

    def launches(name):
        by_path = {"slice": main_launches[name], "team": team_launches[name],
                   **{k: v[name] for k, v in cbs["launches"].items()}}
        by_path.update({k: v[name] for k, v in tiles["launches"].items()})
        by_path["train"] = trained["launches"][name]
        by_path["eval"] = evaluated["launches"][name]
        by_path["datagen"] = generated["launches"][name]
        by_path["experiments"] = experiments["launches"][name]
        by_path.update({k: v[name] for k, v in speculative["launches"].items()})
        by_path.update({k: v[name] for k, v in baselines["launches"].items()})
        by_path.update({k: v[name] for k, v in rest["launches"].items()})
        by_path.update({k: v[name] for k, v in sharded["launches"].items()})
        # Every path of the run, each counted from 0 just before it and read
        # just after: the sampler's guide loops launch the guide-loop kernel;
        # phase 16's zoo-term plan, the one path whose guide runs its
        # iterations one at a time with the collision kernel, launches the
        # collision guide.
        return {"launches": sum(by_path.values()), "launches_by_path": by_path,
                "launch_floor_us": floor_us}

    stacked = tiles["kernel"]
    kernels = [{
        "name": "grid_sdf_lookup", "route": "cuda", "source": "mmd_torch/csrc/grid_sdf.cu",
        "replaces": sdf_kernel.REPLACES, **launches("grid_sdf_lookup"),
        "max_abs_err": max(lookup_err, trained["lookup_err"], baselines["lookup_err"],
                           rest["lookup_err"]),
        "ms": lookup_ms,
        "plain_ms": lookup_plain_ms,
        "bound_ms": lookup_bound_ms, "bound_by": "bytes", "library_ms": None,
        "shapes": {str(list(shape)): {k: v for k, v in t.items()}
                   for shape, t in lookup_at.items()},
        "baseline_shapes": baselines["lookup_at"], "bench_kernels": baselines["bench_kernels"],
        "viz_field": rest["lookup_at"],
    }, {
        "name": "collision_guide", "route": "cuda",
        "source": "mmd_torch/csrc/collision_guide.cu", "replaces": cg.REPLACES,
        **launches("collision_guide"), "max_abs_err": max(collision_err, stacked["max_abs_err"]),
        "ms": stacked["ms"], "plain_ms": stacked["plain_ms"], "bound_ms": stacked["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "shape": list(stacked["shape"]),
        "single_scene": {"shape": list(GUIDE_SHAPE), "ms": collision_ms,
                         "plain_ms": collision_plain_ms, "bound_ms": collision_bound_ms},
    }, {
        "name": "guide_loop", "route": "cuda", "source": "mmd_torch/csrc/guide_loop.cu",
        "replaces": gl.REPLACES, **launches("guide_loop"), "max_abs_err": loop["max_abs_err"],
        "ms": loop["ms"], "plain_ms": loop["plain_ms"], "bound_ms": loop["bound_ms"],
        "bound_by": loop["bound_by"], "library_ms": None, "shape": loop["shape"],
        "device_us": loop["device_us"], "per_iteration_ms": loop["per_iteration_ms"],
        "cases": loop["cases"], "timed": loop["timed"],
    }]
    print(json.dumps({"kernels": kernels, "plan_s": plan_s,
                      "team": {"agents": TEAM_AGENTS, "plan_s": timing["plan_s"],
                               "agent_s": timing.get("agent_s"), "status": str(status),
                               "conflicts": n_conflicts, "batched": batched},
                      "xecbs": cbs["summary"], "tiles": tiles["summary"],
                      "train": trained["summary"], "eval": evaluated["summary"],
                      "datagen": generated["summary"], "experiments": experiments["summary"],
                      "speculative": speculative["summary"],
                      "baselines": baselines["summary"], "rest": rest["summary"],
                      "sharding": sharded["summary"],
                      "total_s": round(time.perf_counter() - t_start, 3),
                      "deadline_s": DEADLINE_S}))
    print(f"report: the whole run took {time.perf_counter() - t_start:.1f} s of its "
          f"{DEADLINE_S} s deadline")
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

def _sync_origins(caught):
    """(syncs from `cbs.to_host`, other syncs) among caught warnings of
    torch's sync debug mode, by the Python line that made each."""
    import inspect

    from mmd_torch.planners.multi_agent import cbs as cbs_module

    lines, first = inspect.getsourcelines(cbs_module.to_host)
    span = range(first, first + len(lines))
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    ours = [w for w in syncs if os.path.samefile(w.filename, cbs_module.__file__)
            and w.lineno in span]
    return ours, [f"{w.filename}:{w.lineno}" for w in syncs if w not in ours]


def run_cbs_phase(dev, cfg):
    """Phase 8 (module docstring): the XECBS search of bench.py's main path."""
    import numpy as np
    import torch

    from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
    from mmd_torch.experiments.status import TrialSuccessStatus
    from mmd_torch.planners.multi_agent.cbs import CBS
    from mmd_torch.planners.multi_agent.conflict_detection import count_conflicts
    from mmd_torch.planners.single_agent.mpd import load_planners
    from mmd_torch.train.checkpoint import load_checkpoint

    starts, goals = get_start_goal_pos_circle(TEAM_AGENTS)
    planners = load_planners(os.path.join(ROOT, "data_trained_models"),
                             os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                             starts, goals, seeds=[0 * 1000 + i for i in range(TEAM_AGENTS)],
                             device=dev, bf16=True)
    p0 = planners[0]
    f32_model, _, _ = load_checkpoint(os.path.join(
        ROOT, "data_trained_models", "EnvEmptyNoWait2D-RobotPlanarDisk"), device=dev)
    x = p0.draw_noise().x_T
    t = torch.arange(x.shape[0], device=dev) % p0.cfg.n_diffusion_steps
    with torch.no_grad():
        eps_bf16, eps_f32 = p0.model(x, t), f32_model(x, t)
    bf16_err = float((eps_bf16 - eps_f32).abs().max() / eps_f32.abs().max())
    print(f"cbs: bf16 UNet forward at B={x.shape[0]} against float32: max |diff| "
          f"{bf16_err:.4f} of max |eps| (tolerance {BF16_TOL})")
    if eps_bf16.dtype != torch.float32 or not bf16_err <= BF16_TOL:
        raise RuntimeError(f"bf16 forward off by {bf16_err} of max |eps|")

    def search(host_driven=False):
        team = CBS(planners, starts, goals, is_ecbs=True, is_xcbs=True)
        if host_driven:
            # No node takes the greedy chain, so every node goes through
            # the one-node `expand` (`fused.expand_children`), as nodes with
            # more constraints on an agent than the chain's buffers take, the
            # frontier's recovery, and ECBS's starved children.
            team._greedy_kbuf = lambda state: None
        return team

    def under_sync_debug(team):
        """team.plan under torch's sync debug mode: its result, and its
        host syncs from cbs.to_host and from elsewhere."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = team.plan(runtime_limit=600)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, *_sync_origins(caught)

    def check_syncs(name, team, others):
        root_reads = team.timing.get("device_root_calls", 0) - 1  # the last follows the loop
        if others:
            raise RuntimeError(f"{name}: host syncs outside cbs.to_host: {others[:5]}")
        if root_reads > TEAM_AGENTS:
            raise RuntimeError(f"{name}: {root_reads} reads inside the ECBS root")
        return root_reads

    def check_search(name, team, out, launches):
        """The search's result and its launches against its own counts of
        its sampler calls: 14 guide loops a fresh call and 4 a local one,
        whatever its number of problems, no collision guide, and one lookup
        a call."""
        paths, n_exp, status, n_conflicts = out
        fresh, local = calls_of(team.timing)
        if (status != TrialSuccessStatus.SUCCESS or n_conflicts != 0
                or count_conflicts(paths, team.margin) != 0):
            raise RuntimeError(f"{name} search: status {status}, {n_conflicts} conflicts")
        expected = want(per_fresh * fresh + per_local * local, 0, fresh + local)
        if launches != expected:
            raise RuntimeError(f"{name} search launched {launches}, expected {expected} "
                               f"({fresh} fresh sampler calls, {local} local ones)")
        if len(paths) != TEAM_AGENTS or not all(
                p.shape == (cfg.horizon, cfg.state_dim) and np.isfinite(p).all() for p in paths):
            raise RuntimeError(f"{name} paths not finite of the expected shape")

    def check_replay(name, team, n_exp, states, host_driven=False):
        """The same search on the card with every kernel routed to its plain
        version, the generators restored: exact."""
        for p, state in zip(planners, states):
            p._generator.set_state(state)
        replay = search(host_driven)
        with plain_kernels():
            _, replay_exp, _, _ = replay.plan(runtime_limit=600)
        kept = team.final
        diff = float((kept.paths_all - replay.final.paths_all).abs().max())
        same = replay_exp == n_exp and kept.ix_best == replay.final.ix_best
        print(f"replay: {name} search on the card with every plain version in "
              f"{replay.timing['plan_s']:.3f} s, {replay_exp} expansions, indices equal "
              f"{kept.ix_best == replay.final.ix_best}, max |trajs_final kernels - plain| "
              f"{diff:.3e} (tolerance {REPLAY_TOL})")
        if not same or not diff <= REPLAY_TOL:
            raise RuntimeError(f"{name}: the kernels' and the plain versions' searches "
                               f"differ: expansions {n_exp}/{replay_exp}, max diff {diff}")

    def waits_of(timing):
        return {k[len("device_"):-2]: v for k, v in timing.items()
                if k.startswith("device_") and k.endswith("_s") and k != "device_s"}

    per_fresh, per_local = cfg.n_guided_steps(), cfg.n_guided_steps(3)
    first_states = [p._generator.get_state() for p in planners]
    warm = search()
    t0 = time.perf_counter()
    (_, warm_exp, warm_status, _), ours, others = under_sync_debug(warm)
    root_reads = check_syncs("XECBS", warm, others)
    print(f"cbs: warm-up XECBS search {time.perf_counter() - t0:.3f} s, {warm_status}, "
          f"{warm_exp} expansions; host syncs: {len(ours)} from cbs.to_host "
          f"({warm.timing['device_calls']} reads), {len(others)} elsewhere; reads inside "
          f"the ECBS root: {root_reads} for {TEAM_AGENTS} agents")

    kept_states = [p._generator.get_state() for p in planners]
    xecbs = search()
    if not xecbs._root_greedy_eligible():
        raise RuntimeError("the XECBS search does not take the fused root and greedy chain")
    xecbs.greedy_audit = []
    zero_counts()  # xecbs path starts
    out = xecbs.plan(runtime_limit=600)
    launches = counts()  # xecbs path ends
    _, n_exp, status, n_conflicts = out
    timing = dict(xecbs.timing)
    fresh, local = timing["plans_fresh"], timing["plans_local"]
    calls_fresh, calls_local = calls_of(timing)
    waits = waits_of(timing)
    print(f"cbs: {TEAM_AGENTS}-robot XECBS (bf16, DDPM) in {timing['plan_s']:.3f} s, {status}, "
          f"{n_conflicts} conflicts, {n_exp} expansions; host waits {timing['device_calls']} "
          f"({timing['device_s']:.3f} s) by phase {waits}; plans fresh {fresh}, local {local}; "
          f"sampler calls fresh {calls_fresh}, local {calls_local}; "
          f"UNet forwards {timing['unet_forwards']}; launches {launches}")
    # Every local call of the root + chain search is a chain step's two
    # children: 4 guide loops for both, not 8.
    if local != 2 * calls_local or calls_local < 1:
        raise RuntimeError(f"XECBS: {local} local plans in {calls_local} sampler calls, "
                           f"not one call a chain step")
    greedy = audit_summary(xecbs.greedy_audit, timing)
    print(f"cbs: greedy chain: {greedy['reads']} flag reads, {greedy['steps']} accepted "
          f"steps; audit {xecbs.greedy_audit}")
    if greedy["steps"] == 0:
        raise RuntimeError("the XECBS search took no greedy step")
    check_search("XECBS", xecbs, out, launches)
    check_replay("XECBS", xecbs, n_exp, kept_states)

    # The host-driven expansion, from the warm-up's draws: its run under
    # sync debug mode is the one whose launches count.
    for p, state in zip(planners, first_states):
        p._generator.set_state(state)
    host = search(host_driven=True)
    if host._root_greedy_eligible():
        raise RuntimeError("the host-driven XECBS search takes the greedy chain")
    zero_counts()  # xecbs_host path starts
    host_out, host_ours, host_others = under_sync_debug(host)
    host_launches = counts()  # xecbs_host path ends
    host_root_reads = check_syncs("host-driven XECBS", host, host_others)
    _, host_exp, host_status, host_conflicts = host_out
    ht = dict(host.timing)
    expand_reads = ht.get("device_children_calls", 0) + ht.get("device_expand_calls", 0)
    host_calls = calls_of(ht)
    # One sampler call a conflict's children (and one more for the ones an
    # ECBS expansion's soft rows starved), each read once.
    if host_calls[1] != ht.get("device_children_calls", 0):
        raise RuntimeError(f"host-driven XECBS: {host_calls[1]} local sampler calls for "
                           f"{ht.get('device_children_calls', 0)} children reads")
    print(f"cbs: host-driven {TEAM_AGENTS}-robot XECBS (one-node expand, under sync debug "
          f"mode) in {ht['plan_s']:.3f} s, {host_status}, {host_conflicts} conflicts, "
          f"{host_exp} expansions; host syncs: {len(host_ours)} from cbs.to_host, "
          f"{len(host_others)} elsewhere; host waits {ht['device_calls']} by phase "
          f"{waits_of(ht)}; plans fresh {ht['plans_fresh']}, local {ht['plans_local']}; "
          f"sampler calls fresh {host_calls[0]}, local {host_calls[1]}; "
          f"launches {host_launches}")
    if expand_reads == 0 or ht.get("device_greedy_calls", 0) or host_exp == 0:
        raise RuntimeError(f"the host-driven search made {host_exp} expansions with "
                           f"{expand_reads} children/expand reads and "
                           f"{ht.get('device_greedy_calls', 0)} greedy reads")
    check_search("host-driven XECBS", host, host_out, host_launches)
    check_replay("host-driven XECBS", host, host_exp, first_states, host_driven=True)
    return {"launches": {"xecbs": launches, "xecbs_host": host_launches}, "summary": {
        "agents": TEAM_AGENTS, "plan_s": timing["plan_s"], "expansions": n_exp,
        "status": str(status), "conflicts": n_conflicts, "device_s": timing["device_s"],
        "device_calls": timing["device_calls"], "waits_s": waits, "plans_fresh": fresh,
        "plans_local": local, "sampler_calls": [calls_fresh, calls_local],
        "unet_forwards": timing["unet_forwards"],
        "bf16_err": bf16_err, "warmup_syncs": len(ours), "root_reads": root_reads,
        "greedy": greedy, "host_driven": {
            "plan_s_sync_debug": ht["plan_s"], "expansions": host_exp,
            "status": str(host_status), "conflicts": host_conflicts,
            "expand_reads": expand_reads, "root_reads": host_root_reads,
            "syncs": len(host_ours), "plans_fresh": ht["plans_fresh"],
            "plans_local": ht["plans_local"], "sampler_calls": list(host_calls)}}}


def batched_against_looped(team, noise_l) -> dict:
    """The team's agents as one fresh sampler call (`plan_problems`, the
    CBS/XCBS root's): it must launch the guide loop once a guided step, no
    collision guide and the lookup once for all agents. Then that call's chain with the
    UNet run B rows at a time (`RowChunked`): every DDPM step against each
    agent's single step fed the same x, on the card, within CPU_TOL. cuDNN
    chooses its convolution algorithm by batch size, so a row need not be
    summed in one order at A * B rows and at B; the chain at A * B rows,
    as the planners run it, is held the same way and printed as a reading
    of that difference."""
    import torch

    from mmd_torch.costs.guide import GuideData
    from mmd_torch.models import diffusion
    from mmd_torch.models.diffusion import HardConds, SamplerNoise
    from mmd_torch.tools.row_chunked import RowChunked

    p0, A = team.p0, len(noise_l)
    cfg = p0.cfg
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = team.plan_problems(noise_l)
    free = res.free_mask.any(dim=-1).cpu()
    batch_s = time.perf_counter() - t0
    grew, expected = grown(before), want(cfg.n_guided_steps(), 0, 1)
    print(f"team: the {A} agents as one batched fresh call in {batch_s:.3f} s, every agent "
          f"free {bool(free.all())}, launches {grew} (expected {expected})")
    if grew != expected or res.trajs_final.shape[0] != A:
        raise RuntimeError(f"the batched call launched {grew}, expected {expected}")
    hard = HardConds(mask=team.hard_team.mask, values=team.hard_team.values[:, None])
    gd = GuideData(scene=p0.scene, normalizer=p0.dataset.normalizer,
                   constraints=team.base_cset)
    noise = SamplerNoise.stack(noise_l)

    def step_errs(model):
        _, chain = diffusion.guided_p_sample_loop(model, p0.schedule, hard, cfg, noise, gd=gd,
                                                  guide_cfg=p0.guide_cfg)
        return [max(float((diffusion._ddpm_step(
            p0.model, p0.schedule, chain[k, a], i, noise.steps[k, a],
            HardConds(mask=hard.mask, values=team.hard_team.values[a]), gd, cfg,
            p0.guide_cfg, i < cfg.t_start_guide) - chain[k + 1, a]).abs().max())
            for a in range(A)) for k, i in enumerate(cfg.step_indices())]

    errs = step_errs(RowChunked(p0.model, cfg.n_samples))
    rows_errs = step_errs(p0.model)
    print(f"team: the batched call's {len(errs)} DDPM steps, UNet at {cfg.n_samples} rows, "
          f"against each agent's single step fed the same x: max |diff| {max(errs):.3e} "
          f"(tolerance {CPU_TOL}); by step {[f'{e:.2e}' for e in errs]}")
    print(f"team: the same at {A * cfg.n_samples} UNet rows (cuDNN's algorithm by batch "
          f"size, a reading): max |diff| {max(rows_errs):.3e}; by step "
          f"{[f'{e:.2e}' for e in rows_errs]}")
    if not max(errs) <= CPU_TOL:
        raise RuntimeError(f"a batched step differs from the looped one: {errs}")
    return {"agents": A, "batch_s": batch_s, "launches": grew, "step_errs": errs,
            "step_errs_unchunked": rows_errs}


def calls_of(timing) -> tuple:
    """A search's sampler calls, (fresh, local), from its `timing`."""
    local = timing["sampler_calls_local"]
    return timing["sampler_calls"] - local, local


def audit_summary(audit, timing) -> dict:
    """A search's greedy audit: its accepted steps, its events by kind and
    the chains' flag reads."""
    kinds = [e[0] for e in audit]
    return {"steps": kinds.count("step"), "reads": timing.get("device_greedy_calls", 0),
            "events": {k: kinds.count(k) for k in ("step", "stop", "freeze", "starved")}}


def load_tiles_trial(planner_class: str, device: str):
    """The multi-tile instance's team (seed 0, TILES_AGENTS agents, stagger
    STAGGER_DT), built as a trial builds it from the repository's
    checkpoints."""
    from mmd_torch.experiments.problems import get_planning_problem
    from mmd_torch.experiments.trial import ModelRegistry, build_multi_agent_trial

    registry = ModelRegistry(os.path.join(ROOT, "data_trained_models"),
                             os.path.join(ROOT, "data_trajectories"), device=device)
    starts, goals, ids, skeletons = get_planning_problem(TILES_INSTANCE, TILES_AGENTS, seed=0)
    return build_multi_agent_trial(planner_class, starts, goals, ids, skeletons, registry,
                                   stagger_dt=STAGGER_DT)


def stacked_kernel_check(dev) -> dict:
    """Phase 9's kernel part: the collision guide on three stacked scenes
    against its plain version, its T = 1 case against the single-scene
    call, and its time and byte bound at (3, 64, 64, 4)."""
    import numpy as np
    import torch

    from mmd_torch.costs.guide import GuideConfig, collision_guide_plain
    from mmd_torch.envs.envs import SceneStack, make_env
    from mmd_torch.ops import sdf_kernel
    from mmd_torch.ops.collision_guide import collision_guide
    from mmd_torch.tools.guide_cases import HINGE_CUTOFF, waypoints

    scenes = [make_env(e, dev).scene for e in STACKED_ENVS]
    stack = SceneStack(tuple(scenes))
    err = 0.0
    for cutoff in (GuideConfig().obstacle_cutoff_margin, HINGE_CUTOFF):
        cfg = GuideConfig(obstacle_cutoff_margin=cutoff)
        u = torch.from_numpy(np.stack([waypoints(GUIDE_SHAPE, sc, cfg.collision_margin, 31 + m)
                                       for m, sc in enumerate(scenes)])).to(dev)
        got = collision_guide(u, stack, cfg)
        with plain_lookup():
            ref = collision_guide_plain(u, stack, cfg)
        one = collision_guide(u[:1].contiguous(), SceneStack((scenes[0],)), cfg)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        if not e <= COLLISION_TOL or got[..., 2:].any() or not torch.equal(
                one[0], collision_guide(u[0].contiguous(), scenes[0], cfg)):
            raise RuntimeError(f"stacked collision kernel != plain at cutoff {cutoff}: {e}")
        err = max(err, e)
    cfg = GuideConfig()
    ms = cuda_ms(lambda: collision_guide(u, stack, cfg))
    with plain_lookup():
        plain_ms = cuda_ms(lambda: collision_guide_plain(u, stack, cfg))
    # Least bytes: each tile's inner rows read once, its distinct cells
    # read once from its own table (24 B), every row written once.
    n_bytes = u.numel() // 4 * 16
    for m, sc in enumerate(scenes):
        q = u[m, :, 1:-1, :2].contiguous()
        i, j = sdf_kernel.cell_index(q, sc.grid.shape, sc.grid.lower, sc.grid.upper)
        n_bytes += q.numel() // 2 * 16 + int(torch.unique(i * sc.grid.shape[1] + j).numel()) * 24
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"tiles: stacked collision kernel against plain on {'/'.join(STACKED_ENVS)} at "
          f"{tuple(u.shape)}, default and hinge margins, and T = 1 against one scene: max abs "
          f"err {err:.3e}; kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.6f} "
          f"ms ({n_bytes} B)")
    return {"shape": tuple(u.shape), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms}


def run_tiles_phase(dev):
    """Phase 9 (module docstring): multi-tile planning on the 2x2 instance."""
    import numpy as np
    import torch

    from mmd_torch.common.experiences import PathBatchExperience
    from mmd_torch.experiments.status import TrialSuccessStatus
    from mmd_torch.experiments.trial import make_team_planner
    from mmd_torch.models.ensemble import seam_residual
    from mmd_torch.planners.multi_agent.conflict_detection import count_conflicts

    kernel = stacked_kernel_check(dev)
    trial = load_tiles_trial("XECBS", dev)
    p0 = trial.planners[0]
    cfg, n_tiles = p0.cfg, p0.n_tiles
    per_fresh, per_local = cfg.n_guided_steps(), cfg.n_guided_steps(3)

    # Agent 0's skeleton, fresh and then locally from its own batch.
    t0 = time.perf_counter()
    p0()  # warm-up
    print(f"tiles: warm-up plan of agent 0 ({'/'.join(trial.model_ids_l[0])}) "
          f"{time.perf_counter() - t0:.3f} s")
    launches, plans, kept = {}, {}, None
    for kind in ("fresh", "local"):
        zero_counts()  # plan path starts
        out = p0(experience=PathBatchExperience(kept) if kind == "local" else None)
        grew = counts()  # plan path ends
        seam = float(seam_residual(p0.local_seeds(out.trajs_iters[-1]), p0.cc))
        expected = want(per_fresh if kind == "fresh" else per_local, 0, n_tiles)
        print(f"tiles: {kind} plan of agent 0 in {out.t_total:.3f} s, success "
              f"{out.success_free_trajs}, fraction_free {out.fraction_free_trajs:.3f}, seam "
              f"residual {seam:.3e} (tolerance {SEAM_TOL}), launches {grew}")
        if grew != expected:
            raise RuntimeError(f"{kind} ensemble plan launched {grew}, expected {expected}")
        if out.success_free_trajs != 1 or not seam <= SEAM_TOL:
            raise RuntimeError(f"{kind} ensemble plan: success {out.success_free_trajs}, "
                               f"seam residual {seam}")
        if not torch.isfinite(out.trajs_final).all() or out.trajs_final.shape != (
                cfg.n_samples, n_tiles * cfg.horizon, cfg.state_dim):
            raise RuntimeError(f"{kind} ensemble plan not finite of the expected shape")
        launches[f"tiles_{kind}"] = grew
        plans[kind] = out.t_total
        kept = out.trajs_final

    def search(planner_class):
        return make_team_planner(planner_class, trial.planners, trial.start_l, trial.goal_l,
                                 start_time_l=trial.start_time_l,
                                 reference_robot=p0.robot,
                                 reference_task=trial.team.reference_task)

    def warm_up(team):
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = team.plan(runtime_limit=600)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        ours, others = _sync_origins(caught)
        print(f"tiles: warm-up {type(team).__name__} {time.perf_counter() - t0:.3f} s, "
              f"{out[2]}; host syncs: {len(ours)} from cbs.to_host "
              f"({team.timing['device_calls']} reads), {len(others)} elsewhere")
        if others:
            raise RuntimeError(f"host syncs outside cbs.to_host: {others[:5]}")
        return len(ours)

    def measured(team, name):
        zero_counts()  # path starts
        paths, n_exp, status, n_conflicts = team.plan(runtime_limit=600)
        grew = counts()  # path ends
        t = dict(team.timing)
        fresh, local = t["plans_fresh"], t["plans_local"]
        expected = want(per_fresh * fresh + per_local * local, 0, n_tiles * (fresh + local))
        waits = {k[len("device_"):-2]: v for k, v in t.items()
                 if k.startswith("device_") and k.endswith("_s") and k != "device_s"}
        print(f"tiles: {TILES_AGENTS}-agent {name} on {TILES_INSTANCE} (seed 0, stagger "
              f"{STAGGER_DT}, f32) in {t['plan_s']:.3f} s, {status}, {n_conflicts} conflicts, "
              f"{n_exp} expansions; host waits {t['device_calls']} ({t['device_s']:.4f} s) "
              f"by phase {waits}; plans fresh {fresh}, local {local}; launches {grew}")
        if grew != expected:
            raise RuntimeError(f"{name} launched {grew}, expected {expected} ({fresh} fresh, "
                               f"{local} local plans of {n_tiles} tiles)")
        L = n_tiles * cfg.horizon + max(trial.start_time_l)
        if not all(p.shape == (L, cfg.state_dim) and np.isfinite(p).all() for p in paths):
            raise RuntimeError(f"{name} paths not finite of the expected shape")
        if count_conflicts(paths, team.margin) != n_conflicts:
            raise RuntimeError(f"{name}: its paths' conflicts differ from its count")
        launches[f"tiles_{name.lower()}"] = grew
        return {"plan_s": t["plan_s"], "status": str(status), "conflicts": n_conflicts,
                "expansions": n_exp, "plans_fresh": fresh, "plans_local": local,
                "device_s": t["device_s"], "device_calls": t["device_calls"], "waits_s": waits}

    warm_syncs = warm_up(search("XECBS"))
    kept_states = [p._generator.get_state() for p in trial.planners]
    xecbs = search("XECBS")
    summary = {"agents": TILES_AGENTS, "plans_s": plans, "warmup_syncs": warm_syncs,
               "xecbs": measured(xecbs, "XECBS")}
    if (summary["xecbs"]["status"] != str(TrialSuccessStatus.SUCCESS)
            or summary["xecbs"]["conflicts"] or len(xecbs.final.ix_best) != TILES_AGENTS):
        raise RuntimeError(f"multi-tile XECBS: {summary['xecbs']}")
    for p, state in zip(trial.planners, kept_states):
        p._generator.set_state(state)
    replay = search("XECBS")
    with plain_kernels():
        _, replay_exp, _, _ = replay.plan(runtime_limit=600)
    diff = float((xecbs.final.paths_all - replay.final.paths_all).abs().max())
    same = (replay_exp == summary["xecbs"]["expansions"]
            and xecbs.final.ix_best == replay.final.ix_best)
    print(f"replay: multi-tile XECBS on the card with every plain version in "
          f"{replay.timing['plan_s']:.3f} s, {replay_exp} expansions, indices equal "
          f"{xecbs.final.ix_best == replay.final.ix_best}, max |trajs_final kernels - plain| "
          f"{diff:.3e} (tolerance {REPLAY_TOL})")
    if not same or not diff <= REPLAY_TOL:
        raise RuntimeError(f"the kernels' and the plain versions' multi-tile searches differ: "
                           f"max diff {diff}")
    summary["pp_warmup_syncs"] = warm_up(search("PP"))
    summary["pp"] = measured(search("PP"), "PP")
    print(f"tiles: PP status {summary['pp']['status']} (reported, not held)")
    return {"kernel": kernel, "launches": launches, "summary": summary}


def loop_work(x, gd, hard, cfg, n_steps: int) -> dict:
    """The guide loop's least bytes and operations on these inputs, and the
    bound they give: x read and written once, the hard mask and values, the
    normalizer, the staged constraint set and soft paths read once, and
    24 B for each distinct cell that the n_steps iterations' inner
    waypoints read (their positions from the plain version, one iteration
    at a time); the operations of LOOP_OPS, counting the balls in range
    and unmasked."""
    import torch

    from mmd_torch.costs.guide import guide_loop_plain
    from mmd_torch.envs.envs import SceneStack
    from mmd_torch.ops import sdf_kernel

    scenes = gd.scene.scenes if isinstance(gd.scene, SceneStack) else None
    grid = (scenes[0] if scenes else gd.scene).grid
    n0, n1 = grid.shape
    H = x.shape[-2]
    xg = x if x.dim() == 4 else x[None]
    G, B = xg.shape[:2]
    keys, xs = [], x
    with plain_kernels():
        for _ in range(n_steps):
            q = gd.normalizer.unnormalize(xs)
            q = (q if q.dim() == 4 else q[None])[..., 1:-1, :2]
            i, j = sdf_kernel.cell_index(q, grid.shape, grid.lower, grid.upper)
            tile = torch.arange(G, device=x.device)[:, None, None] if scenes else 0
            keys.append(((tile * n0 + i) * n1 + j).flatten())
            xs = guide_loop_plain(xs, gd, hard, cfg, 1)
    n_cells = int(torch.unique(torch.cat(keys)).numel())

    cs, spc = gd.constraints, gd.soft_paths
    staged = [cs.q, cs.t_range, cs.radius, cs.point_mask, cs.weight, cs.active] \
        if cs.n_active else []
    staged += [spc.points, spc.mask, spc.radius, spc.weight] if spc is not None else []
    n_bytes = 4 * (2 * x.numel() + hard.mask.numel() + hard.values.numel()
                   + gd.normalizer.mins.numel() + gd.normalizer.maxs.numel()
                   + sum(t.numel() for t in staged)) + 24 * n_cells
    inner = G * B * (H - 2)
    balls = terms = 0
    if cs.n_active:
        h = torch.arange(H, dtype=torch.float32, device=x.device)
        live = ((h >= cs.t_range[..., 0:1]) & (h < cs.t_range[..., 1:2])).float() \
            * cs.point_mask[..., None] * cs.active[..., None, None]       # (.., K, P, H)
        per_h = live.sum(dim=(-3, -2))[..., 1:-1]
        balls += float(per_h.sum()) * B * (G if per_h.dim() == 1 else 1)
        terms += inner * cs.max_constraints
    if spc is not None:
        per_h = (spc.mask != 0).float().sum(dim=-2)[..., 1:-1]
        balls += float(per_h.sum()) * B * (G if per_h.dim() == 1 else 1)
        terms += inner
    ops = n_steps * (LOOP_OPS["waypoint"] * G * B * H + LOOP_OPS["inner"] * inner
                     + LOOP_OPS["ball"] * balls + LOOP_OPS["term"] * terms)
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "cells": n_cells, "operations": int(ops),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def run_guide_loop_phase(dev) -> dict:
    """Phase 17 (module docstring): the guide-loop kernel against its plain
    version, timed, with its bound."""
    import torch

    from mmd_torch.costs.guide import guide_iterations, guide_loop_plain
    from mmd_torch.ops.guide_loop import guide_loop_cuda
    from mmd_torch.tools.guide_cases import LOOP_CASES, loop_case
    from mmd_torch.tools.profile_plan import _traced

    t_phase = time.perf_counter()
    err, cases = 0.0, {}
    for name in LOOP_CASES:
        x, gd, hard, cfg = loop_case(name, dev, B=GUIDE_SHAPE[0])
        before = counts()
        got = guide_loop_cuda(x, gd, hard, cfg, GUIDE_STEPS)
        launched = grown(before)
        with plain_kernels():
            expected = guide_loop_plain(x, gd, hard, cfg, GUIDE_STEPS)
        torch.cuda.synchronize()
        e, moved = float((got - expected).abs().max()), float((got - x).abs().max())
        if (launched != want(1) or not torch.equal(got, expected)
                or not torch.isfinite(got).all() or not moved > 1e-3):
            raise RuntimeError(f"guide loop {name} {tuple(x.shape)}: launched {launched}, max "
                               f"|kernel - plain| {e}, moved {moved}")
        cs, spc = gd.constraints, gd.soft_paths
        cases[name] = {"shape": list(x.shape),
                       "K_P": list(cs.q.shape[-3:-1]) if cs.n_active else [0, 0],
                       "R": spc.rows if spc is not None else 0, "moved": moved}
        err = max(err, e)
    print(f"guide loop: kernel against plain ({GUIDE_STEPS} iterations, one launch a call) in "
          f"{len(cases)} cases, exactly equal: " + ", ".join(
              f"{n} {tuple(c['shape'])} K,P {tuple(c['K_P'])} R {c['R']}"
              for n, c in cases.items()))

    timed = {}
    for name in LOOP_TIMED:
        x, gd, hard, cfg = loop_case(name, dev, B=GUIDE_SHAPE[0])

        def run():
            return guide_loop_cuda(x, gd, hard, cfg, GUIDE_STEPS)

        run()
        hits = []
        for _ in range(3):  # a trace may show none of its kernels (seen once on the H100)
            _, events = _traced(lambda: [run() for _ in range(50)], host=False)
            hits = [ev.time_range.elapsed_us() for ev in events
                    if "guide_loop_kernel" in ev.name]
            if hits:
                break
        t = {"shape": list(x.shape), "device_us": sum(hits) / len(hits) if hits else None,
             "ms": cuda_ms(run, n_iter=100)}
        if name == LOOP_TIMED[0]:  # the main path's shape: the slower paths too
            with plain_kernels():
                t["plain_ms"] = cuda_ms(lambda: guide_loop_plain(x, gd, hard, cfg, GUIDE_STEPS),
                                        n_iter=5, n_warm=1)
            t["per_iteration_ms"] = cuda_ms(
                lambda: guide_iterations(x, gd, hard, cfg, GUIDE_STEPS), n_iter=5, n_warm=1)
        t.update(loop_work(x, gd, hard, cfg, GUIDE_STEPS))
        timed[name] = t
        print(f"guide loop: {name} {tuple(x.shape)}: device {t['device_us']} us a launch; "
              f"wrapper {t['ms']:.5f} ms"
              + (f", plain {t['plain_ms']:.5f} ms, per-iteration loop (20 guide_gradient + "
                 f"hard.apply) {t['per_iteration_ms']:.5f} ms" if "plain_ms" in t else "")
              + f"; bound {t['bound_ms']:.6f} ms by {t['bound_by']} ({t['bytes']} B, "
              f"{t['cells']} cells, {t['operations']} operations)")
    main = timed[LOOP_TIMED[0]]
    print(f"guide loop: phase {time.perf_counter() - t_phase:.2f} s")
    return {"max_abs_err": err, "cases": cases, "timed": timed, "shape": main["shape"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "per_iteration_ms": main["per_iteration_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "device_us": main["device_us"]}


def launch_floor_us(n: int = 200) -> float:
    """The mean device time of a 1-element `fill_`, from a profiler trace:
    what one launch costs the device at the least. The trace may drop a
    few of the n events (194 of 200 on the H100), so the mean is over
    those it shows."""
    import torch

    from mmd_torch.tools.profile_plan import _traced

    x = torch.zeros(1, device="cuda")
    x.fill_(0.0)
    _, events = _traced(lambda: [x.fill_(1.0) for _ in range(n)], host=False)
    fills = [e.time_range.elapsed_us() for e in events if "fill" in e.name.lower()]
    if len(fills) < n // 2:
        raise RuntimeError(f"the trace shows {len(fills)} fill kernels of {n}")
    return sum(fills) / len(fills)


def train_parity(dev: str, dataset, cfg=None, n_steps: int = TRAIN_PARITY_STEPS,
                 unet_dim: int = 32):
    """n_steps float32 train steps from one seeded init on `dev` and on the
    CPU, on the same batches, t and noise drawn on the host, by `cfg`
    (default: the recipe with PARITY_EMA, whose EMA is reset every 2 steps
    before step 5 and blended from then on). Then one bfloat16-compute
    loss and its gradients on both devices, from the CPU's parameters.
    Returns (a dict of the differences and the CPU's global gradient norm
    at each step, which says on which side of the clip each step fell;
    the device's state; its model)."""
    import copy

    import torch

    from mmd_torch.models.diffusion import HardConds, diffusion_loss
    from mmd_torch.models.schedules import make_schedule
    from mmd_torch.models.temporal_unet import Bf16Forward, init_unet
    from mmd_torch.train import trainer

    cfg = cfg or trainer.TrainConfig(**PARITY_EMA)
    host = torch.Generator().manual_seed(TRAIN_SEED)
    cpu_model = init_unet(host, state_dim=dataset.state_dim, unet_input_dim=unet_dim,
                          device="cpu")
    dev_model = copy.deepcopy(cpu_model).to(dev)
    data = dataset.trajs_normalized.cpu()
    mask = dataset.train_mask.cpu()
    runs = [(where, trainer.TrainState.create(model),
             make_schedule(cfg.variance_schedule, cfg.n_diffusion_steps, device=where))
            for where, model in (("cpu", cpu_model), (dev, dev_model))]

    def draws():
        idx = torch.randint(0, data.shape[0], (cfg.batch_size,), generator=host)
        t = torch.randint(0, cfg.n_diffusion_steps, (cfg.batch_size,), generator=host)
        return data[idx], t, torch.randn((cfg.batch_size, *data.shape[1:]), generator=host)

    def loss_and_grads(forward, params, schedule, where, batch, t, noise):
        b = batch.to(where)
        loss = diffusion_loss(forward, schedule, b, HardConds(mask=mask.to(where), values=b),
                              t.to(where), noise.to(where))
        return loss.detach(), torch.autograd.grad(loss, params)

    loss_err, norms = 0.0, []
    for _ in range(n_steps):
        batch, t, noise = draws()
        out = [loss_and_grads(state.model, state.params, schedule, where, batch, t, noise)
               for where, state, schedule in runs]
        norms.append(float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(out[0][1])))))
        for (_, state, _), (_, grads) in zip(runs, out):
            trainer.apply_gradients(state, grads, cfg)
        losses = [float(loss) for loss, _ in out]
        loss_err = max(loss_err, abs(losses[1] - losses[0]) / abs(losses[0]))

    def max_abs(a_model, b_model):
        return max(float((a.cpu() - b).abs().max())
                   for a, b in zip(a_model.parameters(), b_model.parameters()))

    with torch.no_grad():
        param_err = max_abs(dev_model, cpu_model)
        ema_err = max_abs(runs[1][1].ema, runs[0][1].ema)
    # One bfloat16 loss and its gradients, both devices on the CPU's parameters.
    batch, t, noise = draws()
    bf16 = []
    for where, _, schedule in runs:
        model = copy.deepcopy(cpu_model).to(where)
        loss, grads = loss_and_grads(Bf16Forward(model), list(model.parameters()), schedule,
                                     where, batch, t, noise)
        if any(g.dtype != torch.float32 for g in grads):
            raise RuntimeError(f"bf16 gradients on {where} are not float32")
        bf16.append((float(loss), torch.cat([g.cpu().reshape(-1) for g in grads]).double()))
    (l0, g0), (l1, g1) = bf16
    return {"loss_rel": loss_err, "param_abs": param_err, "ema_abs": ema_err,
            "grad_norms": norms, "ema_step": runs[1][1].step,
            "bf16_loss_rel": abs(l1 - l0) / abs(l0),
            "bf16_grad_cosine": float(g0 @ g1 / (g0.norm() * g1.norm()))}, runs[1][1], dev_model


class GuardedChunks:
    """`trainer.train_chunk` with torch's sync debug mode "error" around
    each chunk, so that a host wait inside one raises, and each chunk timed
    by CUDA events and by the host clock (to the chunk's end on the card)."""

    def __init__(self, kept):
        self.kept, self.steps, self.ms, self.wall_s = kept, 0, 0.0, 0.0

    def __call__(self, state, forward, schedule, cfg, draw, n_steps):
        import torch

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            out = self.kept(state, forward, schedule, cfg, draw, n_steps)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        end.synchronize()
        self.wall_s += time.perf_counter() - t0
        self.ms += start.elapsed_time(end)
        self.steps += n_steps
        return out


def run_train_phase(dev, guided_steps):
    """Phase 10 (module docstring): training on the card."""
    import math

    import torch

    from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
    from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id
    from mmd_torch.models.schedules import make_schedule
    from mmd_torch.models.temporal_unet import Bf16Forward
    from mmd_torch.ops import sdf_kernel
    from mmd_torch.ops.sdf_kernel import grid_lookup
    from mmd_torch.planners.single_agent.mpd import load_planner as load
    from mmd_torch.tools.train_bench import traced_steps
    from mmd_torch.train import trainer
    from mmd_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from mmd_torch.train.summary import summary_trajectory_generation

    mid = model_id("EnvEmptyNoWait2D")
    ds = TrajectoryDataset.load_trajectories(os.path.join(ROOT, "data_trajectories"), mid,
                                             device=dev)
    cfg = trainer.TrainConfig()
    t0 = time.perf_counter()
    parity, pstate, pmodel = train_parity(dev, ds)
    print(f"train: {TRAIN_PARITY_STEPS} float32 steps at full width, card against CPU on the "
          f"same draws in {time.perf_counter() - t0:.2f} s (gradient norms "
          f"{[round(n, 4) for n in parity['grad_norms']]}, clip {cfg.clip_grad_max_norm}; "
          f"EMA to step "
          f"{parity['ema_step']}): losses {parity['loss_rel']:.3e} relative, parameters "
          f"{parity['param_abs']:.3e} and EMA {parity['ema_abs']:.3e} absolute (tolerance "
          f"{TRAIN_PARITY_TOL}); one bf16 loss {parity['bf16_loss_rel']:.3e} relative "
          f"(tolerance {BF16_PARITY_LOSS_TOL}), gradients' cosine "
          f"{parity['bf16_grad_cosine']:.6f} (at least {BF16_PARITY_COSINE})")
    if not (parity["loss_rel"] <= TRAIN_PARITY_TOL and parity["param_abs"] <= TRAIN_PARITY_TOL
            and parity["ema_abs"] <= TRAIN_PARITY_TOL
            and parity["bf16_loss_rel"] <= BF16_PARITY_LOSS_TOL
            and parity["bf16_grad_cosine"] >= BF16_PARITY_COSINE):
        raise RuntimeError(f"card and CPU train steps differ: {parity}")
    if not min(parity["grad_norms"]) < cfg.clip_grad_max_norm <= max(parity["grad_norms"]):
        raise RuntimeError(f"the parity's steps did not fall on both sides of the clip: "
                           f"{parity['grad_norms']}")

    # Kernels a step, on the parity state (5 steps of each precision traced).
    draw = trainer.StepDrawer(ds, cfg, 0, torch.Generator(device=dev).manual_seed(1))
    schedule = make_schedule(cfg.variance_schedule, cfg.n_diffusion_steps, device=dev)
    kernels = {}
    for name, forward in (("f32", pmodel), ("bf16", Bf16Forward(pmodel))):
        def step():
            trainer.train_step(pstate, forward, schedule, cfg, *draw())

        step()
        kernels[name] = len(traced_steps(step)[2]) / 5
    print(f"train: kernels a step {kernels['f32']:.1f} (f32), {kernels['bf16']:.1f} (bf16)")

    runs = {}
    for name, n_steps, log_every, bf16 in (("f32", TRAIN_STEPS, TRAIN_LOG_EVERY, False),
                                           ("bf16", BF16_TRAIN_STEPS, BF16_TRAIN_STEPS // 2,
                                            True)):
        msgs, guard = [], GuardedChunks(trainer.train_chunk)
        t0 = time.perf_counter()
        with routed(trainer, "train_chunk", guard):
            _, state, schedule, losses = trainer.train(
                ds, trainer.TrainConfig(bf16=bf16), num_train_steps=n_steps, seed=TRAIN_SEED,
                log_every=log_every, validate_every=log_every, log_fn=msgs.append)
        torch.cuda.synchronize()
        vals = [float(m.split()[-1]) for m in msgs if "val_loss" in m]
        runs[name] = {"steps": guard.steps, "losses": losses, "val_losses": vals,
                      "ms_per_step": guard.ms / guard.steps,
                      "steps_per_sec": guard.steps / guard.wall_s,
                      "wall_s": time.perf_counter() - t0, "kernels_per_step": kernels[name]}
        print(f"train: {name} {n_steps} steps in {runs[name]['wall_s']:.2f} s (no host sync "
              f"between log points), logged losses {losses}, validation {vals}, "
              f"{runs[name]['ms_per_step']:.4f} ms a step (CUDA events), "
              f"{runs[name]['steps_per_sec']:.3f} steps a second")
        if guard.steps != n_steps or not all(math.isfinite(v) for _, v in losses):
            raise RuntimeError(f"{name} run: {guard.steps} guarded steps, losses {losses}")
        if any(p.dtype != torch.float32 for p in state.model.parameters()):
            raise RuntimeError(f"{name} run: master parameters are not float32")
        if name == "f32":
            f32_state, f32_schedule = state, schedule
    final = dict(runs["f32"]["losses"])[TRAIN_STEPS]
    print(f"train: step-{TRAIN_STEPS} loss {final:.5f}, band {TRAIN_BAND[0]:.5f}-"
          f"{TRAIN_BAND[1]:.5f} (JAX's {JAX_STEP2000_LOSSES}); bf16 "
          f"{runs['bf16']['ms_per_step']:.4f} ms a step against f32 "
          f"{runs['f32']['ms_per_step']:.4f}")
    if not TRAIN_BAND[0] <= final <= TRAIN_BAND[1]:
        raise RuntimeError(f"step-{TRAIN_STEPS} loss {final} outside {TRAIN_BAND}")

    seen, kernel = [], sdf_kernel.grid_lookup_cuda  # the summary's lookups, held below

    def recorded(points, *args):
        seen.append((points.clone(), *args))
        return kernel(points, *args)

    zero_counts()  # train path starts
    with routed(sdf_kernel, "grid_lookup_cuda", recorded):
        stats = summary_trajectory_generation(f32_state.ema, f32_schedule, ds,
                                              torch.Generator(device=dev).manual_seed(0),
                                              step=TRAIN_STEPS)
    summary_lookups = grid_lookup.launches
    model_dir = os.path.join(TRAIN_MODELS, mid)
    save_checkpoint(model_dir, f32_state, ds, cfg)
    loaded, _, info = load_checkpoint(model_dir, device=dev)
    same = all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(),
                                                 f32_state.ema.state_dict().values()))
    starts, goals = get_start_goal_pos_circle(10)
    planner = load(TRAIN_MODELS, os.path.join(ROOT, "data_trajectories"), "EnvEmptyNoWait2D",
                   starts[NOWAIT_PAIRS[0]], goals[NOWAIT_PAIRS[0]], dev)
    out = planner()
    launches = counts()  # train path ends
    print(f"train: summary on the EMA parameters {stats} ({summary_lookups} lookups); "
          f"checkpoint of step {info['step']} reloaded, EMA weights equal {same}; MPD plan with "
          f"it in {out.t_total:.3f} s, success {out.success_free_trajs}, fraction_free "
          f"{out.fraction_free_trajs:.3f} (not held), launches {launches}")
    lookup_err = 0.0
    for points, *args in seen:
        for g, w in zip(kernel(points, *args), sdf_kernel.grid_lookup_plain(points, *args)):
            lookup_err = max(lookup_err, float((g - w).abs().max()))
            if not torch.equal(g, w):
                raise RuntimeError(f"lookup kernel != plain on the summary's "
                                   f"{tuple(points.shape)} points: max abs err {lookup_err}")
    print(f"train: the summary's {len(seen)} lookups at {[tuple(p.shape) for p, *_ in seen]} "
          f"again through the kernel and the plain version: equal")
    if summary_lookups != 3 or not same or info["step"] != TRAIN_STEPS:
        raise RuntimeError(f"summary lookups {summary_lookups}, weights equal {same}, "
                           f"step {info['step']}")
    if launches != want(guided_steps, 0, 4):
        raise RuntimeError(f"the trained model's plan launched {launches}, expected "
                           f"{guided_steps} guide loops and 1 lookup (+3 from the summary)")
    if not torch.isfinite(out.trajs_final).all() or out.trajs_final.shape != (64, 64, 4):
        raise RuntimeError("the trained model's plan is not finite of the expected shape")
    summary = dict(runs)
    summary.update({"parity": parity,
                    "summary": stats, "plan_s": out.t_total,
                    "plan_success": out.success_free_trajs, "band": list(TRAIN_BAND)})
    return {"launches": launches, "lookup_err": lookup_err, "summary": summary}


def run_eval_phase(dev, n_tasks: int = EVAL_TASKS, maps=EVAL_MAPS):
    """Phase 12 (module docstring): `mmd_torch.tools.eval_model`'s rates on
    the card."""
    import torch

    from mmd_torch.experiments.trial import ModelRegistry
    from mmd_torch.io.flat_yaml import load_rows
    from mmd_torch.tools.eval_model import evaluate

    jax_rows = {r["model"]: r for r in load_rows(os.path.join(ROOT, "MODEL_EVAL.yaml"))
                if "variant" not in r}
    registry = ModelRegistry(device=dev)
    plans, kept = [], {}

    def counting(i, planner):
        """Plan task i, recording its launches; keep the first DDIM task's
        planner, generator state and plan for the replay."""
        state = planner._generator.get_state()
        before = counts()
        out = planner()
        plans.append((planner.cfg.sampler, grown(before), planner.cfg.n_guided_steps()))
        if planner.cfg.sampler == "ddim" and not kept:
            kept.update(planner=planner, state=state, out=out)
        return out

    runs = [(env, {}) for env in maps]
    runs += [(EVAL_EXTRA_MAP, {"bf16": True}), (EVAL_EXTRA_MAP, {"sampler": "ddim"})]
    rows = []
    zero_counts()  # eval path starts
    t0 = time.perf_counter()
    for env, kw in runs:
        rows.append(evaluate(env, n_tasks=n_tasks, device=dev, registry=registry,
                             run_plan=counting, **kw))
    launches = counts()  # eval path ends
    wall = time.perf_counter() - t0
    failures = []
    for row in rows:
        ref = jax_rows.get(row["model"], {})
        held = "+" not in row["model"]  # the float32 DDPM rows
        print(f"eval: {row['model']} over {row['n_tasks']} tasks: fraction_free "
              f"{row['fraction_free']:.4f}, success {row['success_rate']:.2f}, adherence "
              f"{row['adherence']}, plan {row['plan_time']:.4f} s; JAX (MODEL_EVAL.yaml, 50 "
              f"tasks) {ref.get('fraction_free')}, {ref.get('success_rate')}, "
              f"{ref.get('adherence')}" + ("" if held else " (reported, not held)"))
        if held and not (row["success_rate"] == 1.0
                         and row["fraction_free"] >= ref["fraction_free"] - EVAL_FREE_BAND
                         and row["adherence"] is not None
                         and row["adherence"] >= ref["adherence"] - EVAL_ADHERENCE_BAND):
            failures.append(row["model"])
    # A DDPM plan's 14 guided steps and a DDIM plan's 3, one guide loop each.
    expected = {"ddpm": want(14, 0, 1), "ddim": want(3, 0, 1)}
    wrong = [p for p in plans if p[1] != want(p[2], 0, 1) or p[1] != expected[p[0]]]
    by_kind = {k: sorted({tuple(p[1].values()) for p in plans if p[0] == k})
               for k in expected}
    print(f"eval: {len(plans)} plans in {wall:.2f} s, launches (guide loop, collision guide, "
          f"lookup) by plan: {by_kind} (expected {expected}); totals {launches}")
    if failures:
        raise RuntimeError(f"evaluation rates outside their bands: {failures}")
    if wrong or len(plans) != n_tasks * len(runs):
        raise RuntimeError(f"evaluation plans launched {wrong[:5]}, expected {expected}")

    planner = kept["planner"]
    planner._generator.set_state(kept["state"])
    with plain_kernels():
        replay = planner(noise=planner.draw_noise())
    diff = float((kept["out"].trajs_final - replay.trajs_final).abs().max())
    print(f"replay: the first DDIM {EVAL_EXTRA_MAP} plan on the card with every plain "
          f"version, max |trajs_final kernels - plain| {diff:.3e} (tolerance {REPLAY_TOL})")
    if not diff <= REPLAY_TOL or not torch.isfinite(replay.trajs_final).all():
        raise RuntimeError(f"the kernels' and the plain versions' DDIM plans differ by {diff}")
    return {"launches": launches, "summary": {"rows": rows, "wall_s": wall,
                                              "ddim_replay_err": diff}}


class GuardedGPMP2:
    """`hybrid.gpmp2_optimize` under torch's sync debug mode "error", so that
    a host wait inside the GPMP2 loop raises; it counts the lookup's launches
    in the loop, times the loop with CUDA events, counts the particles whose
    factor failed (NaN) and keeps the last call's inputs and output for the
    replay."""

    def __init__(self, kept):
        self.kept, self.lookups, self.ms, self.nan, self.last = kept, [], [], [], None

    def __call__(self, scene, start, goal, init, cfg):
        import torch

        from mmd_torch.ops.sdf_kernel import grid_lookup

        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        before = grid_lookup.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            start_ev.record()
            out = self.kept(scene, start, goal, init, cfg)
            end_ev.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        end_ev.synchronize()
        self.lookups.append(grid_lookup.launches - before)
        self.nan.append(int(torch.isnan(out).flatten(1).any(1).sum()))
        self.ms.append(start_ev.elapsed_time(end_ev))
        self.last = (scene, start, goal, init.clone(), cfg, out.clone())
        return out


def run_datagen_phase(dev, n_contexts: int = DATAGEN_CONTEXTS,
                      n_trajectories: int = DATAGEN_TRAJS, opt_iters: int = DATAGEN_ITERS,
                      n_linear: int = DATAGEN_LINEAR):
    """Phase 13 (module docstring): data generation on the card."""
    import numpy as np
    import torch

    from mmd_torch.datagen import generate, hybrid, native_rrt
    from mmd_torch.datagen.synthetic import generate_linear_dataset
    from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id
    from mmd_torch.ops.sdf_kernel import grid_lookup
    from mmd_torch.tools.profile_plan import _busy_us, _traced

    if not native_rrt.native_available():
        raise RuntimeError(f"the native RRT ({native_rrt.SOURCE}) did not build")
    t_phase = time.perf_counter()
    guard = GuardedGPMP2(hybrid.gpmp2_optimize)

    def context(env_name, rng):
        return generate.generate_context_trajectories(
            env_name, rng, n_trajectories=n_trajectories, gpmp_opt_iters=opt_iters,
            device=dev, native=True)

    with routed(hybrid, "gpmp2_optimize", guard):
        t0 = time.perf_counter()
        context("EnvConveyor2D", np.random.default_rng(DATAGEN_SEED + 1))  # warm-up
        print(f"datagen: warm-up context {time.perf_counter() - t0:.2f} s, GPMP2 under sync "
              f"debug mode 'error' (no host sync in its loop), {guard.lookups[-1]} lookups "
              f"for {opt_iters} iterations")
        results = []
        zero_counts()  # datagen path starts
        for env_name in DATAGEN_MAPS:
            rng = np.random.default_rng(DATAGEN_SEED)
            for i in range(n_contexts):
                before = grid_lookup.launches
                ctx = context(env_name, rng)
                results.append((env_name, i, ctx, grid_lookup.launches - before,
                                guard.ms[-1], guard.lookups[-1], guard.nan[-1]))
        launches = counts()  # datagen path ends
    if launches["collision_guide"] or launches["guide_loop"]:
        raise RuntimeError(f"data generation launched {launches}; it has no guide")
    summary = []
    for env_name, i, ctx, n_lookups, gpmp2_ms, loop_lookups, nan in results:
        summary.append({"env": env_name, "context": i, "planner": ctx.planner,
                        "kept": len(ctx.trajs), "planned": ctx.n_planned,
                        "jax_kept": JAX_KEPT.get((env_name, i)), "seconds": ctx.seconds,
                        "segments_s": ctx.segments_s, "gpmp2_ms": gpmp2_ms,
                        "lookups": n_lookups, "failed_factors": nan})
        print(f"datagen: {env_name} context {i}: {len(ctx.trajs)} of {ctx.n_planned} free "
              f"(JAX on the CPU: {JAX_KEPT.get((env_name, i))}, not held), "
              f"{ctx.seconds:.3f} s wall "
              f"({ctx.segments_s:.3f} s {ctx.planner} RRT and splines on the host), GPMP2 "
              f"{gpmp2_ms:.2f} ms on the device (CUDA events), lookups {n_lookups} "
              f"({loop_lookups} in the loop), particles whose factor failed (NaN) {nan}")
        if ctx.planner != "native" or loop_lookups != opt_iters or n_lookups != opt_iters + 1:
            raise RuntimeError(f"{env_name} context: planner {ctx.planner}, lookups "
                               f"{loop_lookups} in GPMP2 and {n_lookups} in all, expected "
                               f"{opt_iters} and {opt_iters + 1}")
        if ctx.trajs.shape[1:] != (64, 4) or not np.isfinite(ctx.trajs).all():
            raise RuntimeError(f"{env_name} context: trajectories not finite of (64, 4)")
    kept = sum(s["kept"] for s in summary) / sum(s["planned"] for s in summary)
    if kept == 0:
        raise RuntimeError("no generated trajectory was free")

    scene, start, goal, init, cfg, out = guard.last
    with plain_lookup():
        replay = hybrid.gpmp2_optimize(scene, start, goal, init, cfg)
    same = torch.equal(torch.nan_to_num(replay, nan=7.0), torch.nan_to_num(out, nan=7.0))
    diff = float((replay - out).nan_to_num().abs().max())
    print(f"replay: the last context's GPMP2 ({tuple(init.shape)}, {cfg.opt_iters} iterations) "
          f"on the card with the plain lookup: equal {same}, max |diff| {diff:.3e} (tolerance "
          f"{REPLAY_TOL})")
    if not same:
        raise RuntimeError(f"the kernel's and the plain lookup's GPMP2 differ by {diff}")
    # Where GPMP2's time goes: one traced run of the same call.
    _, events = _traced(lambda: hybrid.gpmp2_optimize(scene, start, goal, init, cfg), host=False)
    busy_s = _busy_us(events) / 1e6
    by_name = {}
    for e in events:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    loop_s = guard.ms[-1] / 1e3
    gpmp2_trace = {"kernels_per_iter": len(events) / cfg.opt_iters, "busy_s": busy_s,
                   "idle_share": 1.0 - busy_s / loop_s, "top_us": top}
    print(f"datagen: GPMP2 traced: {len(events) / cfg.opt_iters:.1f} kernels an iteration, "
          f"device busy {busy_s:.4f} s of the untraced loop's {loop_s:.4f} s (idle share "
          f"{gpmp2_trace['idle_share']:.3f}); most device time: "
          + ", ".join(f"{n} {us:.0f} us" for n, us in top))

    t0 = time.perf_counter()
    linear = generate_linear_dataset("EnvEmptyNoWait2D", n_contexts=n_linear, seed=DATAGEN_SEED,
                                     device=dev)
    linear_s = time.perf_counter() - t0
    linear.save(DATAGEN_OUT)
    back = TrajectoryDataset.load_trajectories(DATAGEN_OUT, model_id("EnvEmptyNoWait2D"),
                                               device=dev)
    same_data = torch.equal(back.trajs, linear.trajs)
    print(f"datagen: EnvEmptyNoWait2D linear data at {n_linear} contexts: {linear.n_trajs} "
          f"free trajectories in {linear_s:.3f} s, saved under build/ and read back equal "
          f"{same_data}")
    if not same_data or linear.n_trajs == 0:
        raise RuntimeError("the linear dataset did not read back equal")
    phase_s = time.perf_counter() - t_phase
    print(f"datagen: phase {phase_s:.2f} s")
    return {"launches": launches, "summary": {"contexts": summary, "keep_rate": kept,
                                              "phase_s": phase_s,
                                              "replay_equal": same, "gpmp2_trace": gpmp2_trace,
                                              "linear_trajs": int(linear.n_trajs),
                                              "linear_s": linear_s}}



def run_experiments_phase(dev, n_trials: int = EXPERIMENT_TRIALS):
    """Phase 14 (module docstring): a paired sweep through the experiment
    harness, and the spawn pool after CUDA."""
    import pickle
    import shutil

    from mmd_torch.experiments.experiment_utils import (
        read_aggregated_trial_results_for_experiment,
    )
    from mmd_torch.experiments.experiments import MultiAgentPlanningExperimentConfig
    from mmd_torch.experiments.launcher import Launcher
    from mmd_torch.experiments.status import TrialSuccessStatus
    from mmd_torch.experiments.trial import ModelRegistry, audit_solution_collisions
    from mmd_torch.tools.launch_multi_agent_experiment import run_multi_agent_experiment
    from mmd_torch.tools.pair_sweeps import expected_launches, text_aggregate, text_status
    from mmd_torch.tools.worker_check import lookup_on_card

    # JAX's sweep of the same cell, read as text.
    jax_cells = text_aggregate(os.path.join(JAX_SWEEP, f"analyzed_results__{TILES_INSTANCE}.txt"))
    jax_trials = os.path.join(JAX_SWEEP, f"instance_name___{TILES_INSTANCE}",
                              f"num_agents___{TILES_AGENTS}")

    t_phase = time.perf_counter()
    shutil.rmtree(EXPERIMENT_OUT, ignore_errors=True)
    planners = ("XECBS", "PP")
    cfg = MultiAgentPlanningExperimentConfig(
        time_str="chip_smoke", instance_name=TILES_INSTANCE, num_agents_l=[TILES_AGENTS],
        stagger_start_time_dt=STAGGER_DT, multi_agent_planner_class_l=list(planners),
        single_agent_planner_class="MPDEnsemble", runtime_limit=EXPERIMENT_RUNTIME_LIMIT,
        num_trials_per_combination=n_trials)
    registry = ModelRegistry(os.path.join(ROOT, "data_trained_models"),
                             os.path.join(ROOT, "data_trajectories"), device=dev)
    zero_counts()  # experiments path starts
    analyzed, n_failed = run_multi_agent_experiment(cfg, EXPERIMENT_OUT, registry)
    launches = counts()  # experiments path ends
    sweep_s = time.perf_counter() - t_phase
    if n_failed:
        raise RuntimeError(f"{n_failed} trials raised (build/chip_smoke_experiments/"
                           f"error_chip_smoke.txt)")

    trials = read_aggregated_trial_results_for_experiment(cfg, EXPERIMENT_OUT)[TILES_AGENTS]
    cell_dir = os.path.join(EXPERIMENT_OUT, "chip_smoke", f"instance_name___{TILES_INSTANCE}",
                            f"num_agents___{TILES_AGENTS}")
    saved = all(os.path.exists(os.path.join(
        cell_dir, f"planner___{p}", "single_agent_planner___MPDEnsemble", str(t), name))
        for p in planners for t in range(n_trials) for name in ("results.pkl", "results.txt"))
    with open(os.path.join(EXPERIMENT_OUT, "chip_smoke",
                           f"analyzed_results__{TILES_INSTANCE}.pkl"), "rb") as f:
        stored = pickle.load(f)
    keys_equal = all(list(stored[TILES_AGENTS][p]) == list(jax_cells[(TILES_AGENTS, p)])
                     for p in planners)
    print(f"experiments: {2 * n_trials} trials in {sweep_s:.3f} s, {n_failed} raised; every "
          f"trial saved results.pkl and results.txt {saved}; the aggregate has JAX's keys "
          f"{keys_equal}")
    if any(len(trials[p]) != n_trials for p in planners) or not saved or not keys_equal:
        raise RuntimeError(f"the sweep's tree is incomplete: {[len(trials[p]) for p in planners]} "
                           f"trials read back, saved {saved}, keys {keys_equal}")

    ids = trials["XECBS"][0].global_model_ids
    grid_tiles = len(ids) * len(ids[0])
    expected = expected_launches(trials["XECBS"] + trials["PP"], grid_tiles)
    fresh, local = expected.pop("plans_fresh"), expected.pop("plans_local")
    expected.pop("sampler_calls")
    print(f"experiments: plans fresh {fresh}, local {local}; launches {launches} (expected "
          f"{expected}: a guide loop a guided step, 3 lookups a plan and 2 x {grid_tiles} "
          f"a trial)")
    if launches != expected:
        raise RuntimeError(f"the sweep launched {launches}, expected {expected}")

    summary = {"trials": n_trials, "sweep_s": sweep_s, "launches": launches,
               "plans_fresh": fresh, "plans_local": local}
    radius = registry.get(ids[0][0])[2].robot.radius
    for p in planners:
        statuses = [str(r.success_status) for r in trials[p]]
        jax = [text_status(os.path.join(jax_trials, f"planner___{p}",
                                        "single_agent_planner___MPDEnsemble", str(t),
                                        "results.txt")) for t in range(n_trials)]
        contacts = [audit_solution_collisions(r.agent_path_l, radius) for r in trials[p]
                    if r.success_status == TrialSuccessStatus.SUCCESS]
        d, jd = analyzed[TILES_AGENTS][p], jax_cells[(TILES_AGENTS, p)]
        n_success = statuses.count("SUCCESS")
        print(f"experiments: {p}: success {d['success_rate']:.2f} ({n_success} of {n_trials}; "
              f"JAX {jd['success_rate']:.2f} of {jd['num_trials']}), mean planning time "
              f"{d['avg_planning_time']:.3f} s, expansions {d['avg_ct_expansions']:.2f}, "
              f"adherence {d['avg_data_adherence']:.4f} (JAX {jd['avg_data_adherence']:.4f}), "
              f"collisions over all trials {d['avg_collisions_all_trials']:.2f} (JAX "
              f"{jd['avg_collisions_all_trials']:.2f}); audited contacts of the successes "
              f"{contacts}")
        print(f"experiments: {p} by trial, port / JAX: "
              + ", ".join(f"{t}: {a} / {b}" for t, (a, b) in enumerate(zip(statuses, jax))))
        if any(contacts):
            raise RuntimeError(f"{p}: a SUCCESS audits at {contacts} contacts")
        summary[p] = {"successes": n_success, "success_rate": d["success_rate"],
                      "jax_success_rate": jd["success_rate"],
                      "statuses": statuses, "jax_statuses": jax,
                      "avg_planning_time": d["avg_planning_time"],
                      "avg_ct_expansions": d["avg_ct_expansions"],
                      "avg_data_adherence": d["avg_data_adherence"],
                      "avg_collisions_all_trials": d["avg_collisions_all_trials"]}
    if summary["XECBS"]["successes"] < min(EXPERIMENT_XECBS_MIN, n_trials - 1):
        raise RuntimeError(f"XECBS succeeded in {summary['XECBS']['successes']} of {n_trials}")

    t0 = time.perf_counter()
    launcher = Launcher("spawn_check", exp_fn=lookup_on_card, n_seeds=SPAWN_WORKERS,
                        n_exps_in_parallel=SPAWN_WORKERS,
                        base_dir=os.path.join(ROOT, "build", "chip_smoke_launcher"))
    launcher.add_experiment(env_name="EnvConveyor2D")
    outs = launcher.run(local=True)
    pids = {o["pid"] for o in outs if isinstance(o, dict)}
    print(f"experiments: spawn pool of {SPAWN_WORKERS} workers after CUDA init in "
          f"{time.perf_counter() - t0:.3f} s: {outs}")
    # The pool may hand both runs to one worker; each must run outside this process.
    if len(outs) != SPAWN_WORKERS or os.getpid() in pids or any(
            not isinstance(o, dict) or o["launches"] != 1 or o["max_abs_err"] != 0.0
            for o in outs):
        raise RuntimeError(f"the spawn pool failed: {outs}")
    summary["spawn_workers"] = outs
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"experiments: phase {summary['phase_s']:.2f} s")
    return {"launches": launches, "summary": summary}


def run_speculative_phase(dev, cfg):
    """Phase 15 (module docstring): bench.py's XECBS-R, and one trial of
    JAX's dense Conveyor grid at frontier width 2."""
    import numpy as np
    import torch

    from mmd_torch import bench
    from mmd_torch.experiments.experiments import MultiAgentPlanningExperimentConfig
    from mmd_torch.experiments.status import TrialSuccessStatus
    from mmd_torch.experiments.trial import ModelRegistry, run_multi_agent_trial
    from mmd_torch.planners.multi_agent import fused
    from mmd_torch.planners.multi_agent.conflict_detection import count_conflicts
    from mmd_torch.tools.pair_sweeps import expected_launches

    t_phase = time.perf_counter()
    per_fresh, per_local = cfg.n_guided_steps(), cfg.n_guided_steps(3)
    launches, summary = {}, {}

    # (a) XECBS-R through the bench's own builders.
    s = bench.settings({"MMD_BENCH_PLANNER": "XECBS-R", "MMD_BENCH_AGENTS": str(TEAM_AGENTS)})
    planners, starts, goals = bench.build_planners(s)
    warm = bench.make_team_planner(s, planners, starts, goals)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, warm_exp, warm_status, _ = warm.plan(runtime_limit=600)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    ours, others = _sync_origins(caught)
    print(f"speculative: warm-up XECBS-R {warm.timing['plan_s']:.3f} s, {warm_status}, "
          f"{warm_exp} expansions; host syncs: {len(ours)} from cbs.to_host "
          f"({warm.timing['device_calls']} reads), {len(others)} elsewhere")
    if others:
        raise RuntimeError(f"host syncs outside cbs.to_host: {others[:5]}")
    kept_states = [p._generator.get_state() for p in planners]
    team = bench.make_team_planner(s, planners, starts, goals)
    team.greedy_audit = []
    zero_counts()  # xecbs_r path starts
    paths, n_exp, status, n_conflicts = team.plan(runtime_limit=600)
    got = counts()  # xecbs_r path ends
    t = dict(team.timing)
    fresh, local = t["plans_fresh"], t["plans_local"]
    calls_fresh, calls_local = calls_of(t)
    waits = {k[len("device_"):-2]: v for k, v in t.items()
             if k.startswith("device_") and k.endswith("_s") and k != "device_s"}
    print(f"speculative: {TEAM_AGENTS}-robot XECBS-R (bf16, {team.root_repair_rounds} repair "
          f"round) in {t['plan_s']:.3f} s, {status}, {n_conflicts} conflicts, {n_exp} "
          f"expansions; host waits {t['device_calls']} by phase {waits}; plans fresh {fresh}, "
          f"local {local}; sampler calls fresh {calls_fresh}, local {calls_local}; launches "
          f"{got}; audit {team.greedy_audit}")
    # The fresh team root and the repair round: two calls of 10 agents.
    if (calls_fresh, fresh) != (2, 2 * TEAM_AGENTS):
        raise RuntimeError(f"XECBS-R made {fresh} fresh plans in {calls_fresh} sampler "
                           f"calls, not {2 * TEAM_AGENTS} in 2")
    if (status != TrialSuccessStatus.SUCCESS or n_conflicts != 0
            or count_conflicts(paths, team.margin) != 0):
        raise RuntimeError(f"XECBS-R search: status {status}, {n_conflicts} conflicts")
    if t.get("device_repair_calls") != 3:
        raise RuntimeError(f"XECBS-R read its repair {t.get('device_repair_calls')} times, "
                           f"not 3 (reselect, round, reselect)")
    expected = want(per_fresh * calls_fresh + per_local * calls_local, 0,
                    calls_fresh + calls_local)
    if got != expected:
        raise RuntimeError(f"XECBS-R launched {got}, expected {expected}")
    kept = team.final
    for p, state in zip(planners, kept_states):
        p._generator.set_state(state)
    replay = bench.make_team_planner(s, planners, starts, goals)
    with plain_kernels():
        _, replay_exp, _, _ = replay.plan(runtime_limit=600)
    diff = float((kept.paths_all - replay.final.paths_all).abs().max())
    same = replay_exp == n_exp and kept.ix_best == replay.final.ix_best
    print(f"replay: XECBS-R on the card with every plain version in "
          f"{replay.timing['plan_s']:.3f} s, {replay_exp} expansions, indices equal "
          f"{kept.ix_best == replay.final.ix_best}, max |trajs_final kernels - plain| "
          f"{diff:.3e} (tolerance {REPLAY_TOL})")
    if not same or not diff <= REPLAY_TOL:
        raise RuntimeError(f"the kernels' and the plain versions' XECBS-R differ: "
                           f"expansions {n_exp}/{replay_exp}, max diff {diff}")
    launches["xecbs_r"] = got
    summary["xecbs_r"] = {"plan_s": t["plan_s"], "status": str(status), "expansions": n_exp,
                          "plans_fresh": fresh, "plans_local": local,
                          "sampler_calls": [calls_fresh, calls_local],
                          "device_calls": t["device_calls"], "waits_s": waits,
                          "warmup_syncs": len(ours), "greedy": audit_summary(
                              team.greedy_audit, t)}

    # (b) One trial of the dense Conveyor vd grid at frontier width 2.
    exp_cfg = MultiAgentPlanningExperimentConfig(
        time_str="chip_smoke_dense", instance_name=DENSE_INSTANCE, num_agents_l=[DENSE_AGENTS],
        multi_agent_planner_class_l=["XECBS"], runtime_limit=DENSE_RUNTIME_LIMIT,
        frontier_width=DENSE_WIDTH, num_trials_per_combination=DENSE_TRIAL + 1)
    trial_cfg = exp_cfg.get_single_trial_configs_from_experiment_config()[DENSE_TRIAL]
    registry = ModelRegistry(VD_MODELS, VD_DATA, device=dev)
    rounds = []
    real_frontier = fused.frontier_greedy_expand

    def frontier(team_, noise_m, nodes, *a, **k):
        rounds.append(len(nodes))
        return real_frontier(team_, noise_m, nodes, *a, **k)

    zero_counts()  # dense path starts
    with routed(fused, "frontier_greedy_expand", frontier):
        r = run_multi_agent_trial(trial_cfg, registry, save=False)
    got = counts()  # dense path ends
    expected = expected_launches([r], grid_tiles=1)
    fresh, local = expected.pop("plans_fresh"), expected.pop("plans_local")
    calls = expected.pop("sampler_calls")
    tt = r.team_timing
    print(f"speculative: dense trial {DENSE_TRIAL} of {DENSE_INSTANCE}, {DENSE_AGENTS} agents "
          f"(vd, f32, XECBS, frontier width {DENSE_WIDTH}, {DENSE_RUNTIME_LIMIT:.0f} s): "
          f"{r.success_status}, {r.num_collisions_in_solution} collisions, "
          f"{r.num_ct_expansions} expansions in {r.planning_time:.3f} s; frontier rounds "
          f"of {rounds} nodes; plans fresh {fresh}, local {local} in {calls} sampler calls "
          f"({tt['sampler_calls_local']} local); host waits "
          f"{tt['device_calls']}; launches {got} (expected {expected})")
    if r.success_status != TrialSuccessStatus.SUCCESS or r.num_collisions_in_solution != 0:
        raise RuntimeError(f"dense trial: {r.success_status}, "
                           f"{r.num_collisions_in_solution} collisions")
    if not any(m >= 2 for m in rounds):
        raise RuntimeError(f"the dense trial ran no frontier round of two nodes: {rounds}")
    if got != expected:
        raise RuntimeError(f"the dense trial launched {got}, expected {expected}")
    if not all(np.isfinite(p).all() for p in r.agent_path_l):
        raise RuntimeError("dense trial paths not finite")
    launches["dense"] = got
    summary["dense"] = {"trial": DENSE_TRIAL, "agents": DENSE_AGENTS,
                        "planning_time": r.planning_time, "status": str(r.success_status),
                        "expansions": r.num_ct_expansions, "frontier_rounds": rounds,
                        "plans_fresh": fresh, "plans_local": local,
                        "sampler_calls": [calls - tt["sampler_calls_local"],
                                          tt["sampler_calls_local"]],
                        "adherence": r.data_adherence}
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"speculative: phase {summary['phase_s']:.2f} s")
    return {"launches": launches, "summary": summary}


class FirstPoints:
    """Wraps `sdf_kernel.grid_lookup_cuda`, keeping the first call's points
    since `points` was set to None (a copy on the card, so no host wait),
    for the phase to time the kernel at the shape the run gave it: an
    iteration's or a guide call's, not the final classification's."""

    def __init__(self, kept):
        self.kept, self.points = kept, None

    def __call__(self, points, *args):
        if self.points is None:
            self.points = points.detach().clone()
        return self.kept(points, *args)


def _same(a, b) -> bool:
    """Equal, NaN where the other is NaN."""
    import torch

    if a.is_floating_point():
        a, b = torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0)
    return torch.equal(a, b)


def _sync_free(fn):
    """fn() under torch's sync debug mode "error" (a host wait raises),
    timed from a synchronize to a synchronize: (result, seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_baselines_phase(dev):
    """Phase 16 (module docstring): the classical optimizers, a knob-guided
    MPD plan and the planar arm's GPMP2, each sync-free, counted and replayed
    with the plain lookup; the lookup timed at their shapes; bench_kernels."""
    import dataclasses

    import numpy as np
    import torch

    from mmd_torch.costs.guide import GuideConfig, GuideData
    from mmd_torch.datagen import classical
    from mmd_torch.envs.envs import make_env
    from mmd_torch.ops import sdf_kernel
    from mmd_torch.ops.sdf_kernel import grid_lookup_cuda, grid_lookup_plain
    from mmd_torch.robots import kinematics
    from mmd_torch.tasks.task import make_task
    from mmd_torch.tools import bench_kernels
    from mmd_torch.tools.profile_plan import _busy_us, _traced

    t_phase = time.perf_counter()
    rows = bench_kernels.bench()
    for row in rows:
        print(f"baselines: bench_kernels n={row['points']}: plain {row['plain_us']:.1f}us  "
              f"kernel {row['kernel_us']:.1f}us  match={row['match']}")
    if not all(row["match"] for row in rows):
        raise RuntimeError(f"bench_kernels: the kernel and its plain version differ: {rows}")

    launches, summary, lookup_at, traces = {}, {}, {}, {}
    recorder = FirstPoints(sdf_kernel.grid_lookup_cuda)

    def measured(name, fn, want_lookups, generator=None, want_guides=0):
        """One run of fn under sync debug mode "error", its launches counted
        and held (no guide loop: none of these runs guides the sampler by
        the guide-loop kernel), then its replay with every plain version
        (the generator restored), which must be equal."""
        state = None if generator is None else generator.get_state()
        recorder.points = None
        zero_counts()  # baselines path starts
        with routed(sdf_kernel, "grid_lookup_cuda", recorder):
            out, seconds = _sync_free(fn)
        got = counts()  # baselines path ends
        if got != want(0, want_guides, want_lookups):
            raise RuntimeError(f"{name} launched {got}, expected "
                               f"{want(0, want_guides, want_lookups)}")
        if generator is not None:
            generator.set_state(state)
        with plain_kernels():
            replay = fn()
        outs = out if isinstance(out, tuple) else (out,)
        reps = replay if isinstance(replay, tuple) else (replay,)
        same = all(_same(a, b) for a, b in zip(outs, reps))
        if not same:
            raise RuntimeError(f"{name}: the kernel's and the plain lookup's runs differ")
        # Where its time goes: the same run traced (device kernels only).
        if generator is not None:
            generator.set_state(state)
        _, events = _traced(fn, host=False)
        busy_s = _busy_us(events) / 1e6
        by_name = {}
        for e in events:
            by_name[e.name[:50]] = by_name.get(e.name[:50], 0.0) + e.time_range.elapsed_us()
        traces[name] = {"kernels": len(events), "busy_s": busy_s,
                        "idle_share": 1.0 - busy_s / seconds,
                        "top_us": sorted(by_name.items(), key=lambda kv: -kv[1])[:3]}
        pts = recorder.points
        at = time_lookup(scene, tables, pts)
        err = max(float((a - b).abs().max()) for a, b in zip(
            grid_lookup_cuda(pts, tables, *box), grid_lookup_plain(pts, tables, *box)))
        lookup_at[name] = {"shape": list(pts.shape), **at, "max_abs_err": err}
        launches[name] = got
        return out, seconds

    # (a) the four classical optimizers.
    task = make_task("EnvConveyor2D", dev)
    scene = task.scene
    tables = ((scene.grid.values, scene.grid.grads),
              (scene.extra_grid.values, scene.extra_grid.grads))
    box = (scene.grid.lower, scene.grid.upper)
    (sx, sy), (gx, gy) = BASELINE_TASK
    start = torch.tensor([sx, sy, 0.0, 0.0], device=dev)
    goal = torch.tensor([gx, gy, 0.0, 0.0], device=dev)
    t = torch.linspace(0.0, 1.0, 64, device=dev)[:, None]
    pos = (1 - t) * start[:2] + t * goal[:2]
    line = torch.cat([pos, torch.gradient(pos, dim=0)[0] / (5.0 / 64.0)], dim=-1)
    init = line.expand(BASELINE_PARTICLES, -1, -1).contiguous()

    def collisions(trajs):
        hit = task.compute_collision(trajs[..., :2])
        return int(hit.sum()), int((~hit.any(dim=-1)).sum())

    before = collisions(init)
    optimizers = [("chomp", classical.chomp_optimize, classical.CHOMPConfig(), False),
                  ("stomp", classical.stomp_optimize, classical.STOMPConfig(), True),
                  ("mppi", classical.mppi_optimize, classical.MPPIConfig(), True),
                  ("stoch_gpmp", classical.stoch_gpmp_optimize, classical.StochGPMPConfig(),
                   True)]
    for k, (name, fn, cfg, sampled) in enumerate(optimizers):
        gen = torch.Generator(device=dev).manual_seed(BASELINE_SEED + k) if sampled else None
        kw = {"generator": gen} if sampled else {}
        fn(scene, start, goal, init, dataclasses.replace(cfg, opt_iters=2), **kw)  # warm-up
        out, seconds = measured(name, lambda: fn(scene, start, goal, init, cfg, **kw),
                                cfg.opt_iters, gen)
        after = collisions(out)
        print(f"baselines: {name} ({BASELINE_PARTICLES} particles, {cfg.opt_iters} iterations) "
              f"in {seconds:.3f} s, no host wait; lookups {launches[name]['grid_sdf_lookup']}; "
              f"waypoints in collision {before[0]} -> {after[0]}, free particles {before[1]} "
              f"-> {after[1]}; the plain-lookup replay equal")
        if not torch.isfinite(out).all() or out.shape != init.shape:
            raise RuntimeError(f"{name}: output not finite of {tuple(init.shape)}")
        summary[name] = {"seconds": seconds, "iterations": cfg.opt_iters,
                         "collisions_before": before[0], "collisions_after": after[0],
                         "free_before": before[1], "free_after": after[1]}

    # (b) a full-width MPD plan with the guide's knobs.
    planner = load_planner("EnvConveyor2D", *CONVEYOR_TASK, dev)
    planner.guide_cfg = dataclasses.replace(planner.guide_cfg, **ZOO_GUIDE)
    guide_calls = planner.cfg.n_guided_steps() * planner.cfg.n_guide_steps
    cset, spc = planner._pack(None)
    gd = GuideData(scene=planner.scene, normalizer=planner.dataset.normalizer,
                   constraints=cset, soft_paths=spc)
    planner._plan_fresh(gd, planner.draw_noise(), planner.hard_conds)  # warm-up
    noise = planner.draw_noise()

    def zoo_plan():
        r = planner._plan_fresh(gd, noise, planner.hard_conds)
        return r.trajs_final, r.free_mask

    (trajs_final, free_mask), seconds = measured("zoo_guided_plan", zoo_plan, guide_calls + 1)
    free = int(free_mask.sum())
    print(f"baselines: MPD plan on EnvConveyor2D with {ZOO_GUIDE} in {seconds:.3f} s, no host "
          f"wait; lookups {launches['zoo_guided_plan']['grid_sdf_lookup']} ({guide_calls} guide "
          f"calls + the finalize), collision guides 0; free samples {free} of "
          f"{free_mask.numel()}; the plain-lookup replay equal")
    if not torch.isfinite(trajs_final).all():
        raise RuntimeError("the knob-guided plan is not finite")
    summary["zoo_guided_plan"] = {"seconds": seconds, "free": free,
                                  "samples": int(free_mask.numel()),
                                  "guide": {k: v for k, v in ZOO_GUIDE.items()}}
    if GuideConfig(**ZOO_GUIDE).collision_kernel_applies:
        raise RuntimeError("the knob-guided plan took the collision kernel")

    # (b') the same plan with the zoo terms alone: the guide-loop kernel does
    # not compute them, so the guide runs its iterations one guide_gradient
    # at a time, whose collision terms are the collision-guide kernel's.
    zoo_terms = {k: v for k, v in ZOO_GUIDE.items() if k != "interpolate_collision"}
    planner.guide_cfg = dataclasses.replace(planner.guide_cfg, interpolate_collision=False)
    if planner.guide_cfg.guide_loop_applies or not planner.guide_cfg.collision_kernel_applies:
        raise RuntimeError(f"the zoo-term plan's config {zoo_terms} routes wrongly")
    planner._plan_fresh(gd, planner.draw_noise(), planner.hard_conds)  # warm-up

    (trajs_final, free_mask), seconds = measured("zoo_terms_plan", zoo_plan, 1,
                                                 want_guides=guide_calls)
    free = int(free_mask.sum())
    print(f"baselines: MPD plan on EnvConveyor2D with {zoo_terms} in {seconds:.3f} s, no host "
          f"wait; launches {launches['zoo_terms_plan']} ({guide_calls} collision guides, one a "
          f"guide iteration, no guide loop, the finalize's lookup); free samples {free} of "
          f"{free_mask.numel()}; the plain replay equal")
    if not torch.isfinite(trajs_final).all():
        raise RuntimeError("the zoo-term plan is not finite")
    summary["zoo_terms_plan"] = {"seconds": seconds, "free": free,
                                 "samples": int(free_mask.numel()), "guide": zoo_terms}

    # (c) the planar arm's GPMP2 on EnvDropRegion2D.
    scene = make_env("EnvDropRegion2D", dev).scene
    tables = ((scene.grid.values, scene.grid.grads),
              (scene.extra_grid.values, scene.extra_grid.grads))
    box = (scene.grid.lower, scene.grid.upper)
    tree = kinematics.make_planar_arm(ARM_LINKS, link_length=ARM_LINK_LENGTH, device=dev)
    q_start = torch.zeros(ARM_LINKS, device=dev)
    q_goal = torch.tensor(ARM_GOAL, device=dev)
    straight_hits = bool(kinematics.arm_scene_collision(tree, scene, 0.5 * (q_start + q_goal)))
    gen = torch.Generator(device=dev).manual_seed(BASELINE_SEED)
    kinematics.plan_arm_gpmp2(tree, scene, q_start, q_goal, generator=gen, opt_iters=2)
    (trajs, free), seconds = measured(
        "arm_gpmp2", lambda: kinematics.plan_arm_gpmp2(tree, scene, q_start, q_goal,
                                                      generator=gen),
        400 + 1, gen)
    n_free = int(free.sum())
    print(f"baselines: planar arm GPMP2 (3 links of {ARM_LINK_LENGTH}, 16 particles, H=64, 400 "
          f"iterations) on EnvDropRegion2D in {seconds:.3f} s, no host wait; lookups "
          f"{launches['arm_gpmp2']['grid_sdf_lookup']}; the straight joint path collides "
          f"{straight_hits}; free particles {n_free} of {free.numel()}; the plain-lookup "
          f"replay equal")
    if n_free == 0 or not straight_hits:
        raise RuntimeError(f"arm GPMP2: {n_free} free particles, straight path collides "
                           f"{straight_hits}")
    summary["arm_gpmp2"] = {"seconds": seconds, "free": n_free, "particles": int(free.numel()),
                            "nan_particles": int(torch.isnan(trajs).flatten(1).any(1).sum())}
    for name, tr in traces.items():
        print(f"baselines: {name} traced: {tr['kernels']} kernels, device busy "
              f"{tr['busy_s']:.4f} s of the untraced {summary[name]['seconds']:.4f} s (idle "
              f"share {tr['idle_share']:.3f}); most device time: "
              + ", ".join(f"{n} {us:.0f} us" for n, us in tr["top_us"]))
        summary[name]["trace"] = tr
    for name, at in lookup_at.items():
        print(f"baselines: lookup at {name}'s {tuple(at['shape'])}: {at['device_us']:.4f} us a "
              f"launch on the device, wrapper {at['ms']:.5f} ms, plain {at['plain_ms']:.5f} ms, "
              f"bound {at['bound_ms']:.6f} ms ({at['bytes']} B, {at['cells']} cells)")
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"baselines: phase {summary['phase_s']:.2f} s")
    return {"launches": launches, "summary": summary, "lookup_at": lookup_at,
            "lookup_err": max(at["max_abs_err"] for at in lookup_at.values()),
            "bench_kernels": rows}


def run_rest_phase(dev, card: str, xecbs: dict, build_compile_s: float):
    """Phase 18 (module docstring): the UNet's optional modes, GP-prior
    sampling, the fields of viz, the FLOP accounting and a profiler trace,
    on the card."""
    import copy

    import numpy as np
    import torch

    from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
    from mmd_torch.costs.gp import sample_gp_prior
    from mmd_torch.costs.guide import GuideData
    from mmd_torch.envs.envs import make_env
    from mmd_torch.models.temporal_unet import Bf16Unet, bf16_model, init_unet
    from mmd_torch.ops import sdf_kernel
    from mmd_torch.utils.flops import mfu_pct, unet_forward_flops
    from mmd_torch.utils.profiling import compile_time_monitor, gpu_peak_flops, profiler_trace
    from mmd_torch.viz.visualizer import field_grid, grad_sdf_field, sdf_field

    t_phase = time.perf_counter()
    summary, launches = {"card": card}, {}
    B, H, D, E = UNET_MODES_SHAPE
    rng = np.random.default_rng(UNET_MODES_SEED)
    x = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 25, B))
    ctx = torch.from_numpy(rng.standard_normal((B, E)).astype(np.float32))

    # (a) the UNet's optional modes, float32, card against CPU.
    modes = {}
    for k, (attn, cond) in enumerate([(a, c) for a in (False, True)
                                      for c in ("", "concatenate", "attention", "default")]):
        cpu_net = init_unet(torch.Generator().manual_seed(UNET_MODES_SEED + k), state_dim=D,
                            unet_input_dim=32, dim_mults=(1, 2, 4), device="cpu",
                            self_attention=attn, conditioning_type=cond, context_dim=E).eval()
        card_net = copy.deepcopy(cpu_net).to(dev)
        args = (x, t) + ((ctx,) if cond else ())
        card_args = tuple(a.to(dev) for a in args)
        with torch.no_grad():
            want_eps = cpu_net(*args)
            got = card_net(*card_args)
            err = float((got.cpu() - want_eps).abs().max())
            ms = cuda_ms(lambda: card_net(*card_args), n_iter=50, n_warm=5)
        name = f"self_attention={attn} conditioning_type={cond!r}"
        print(f"rest: UNet {name} at {tuple(x.shape)}: max |card - cpu| {err:.3e} "
              f"(tolerance {CPU_TOL}), max |eps| {float(want_eps.abs().max()):.3f}, "
              f"{ms:.4f} ms a float32 forward on the card ({card})")
        if not torch.isfinite(got).all() or got.shape != (B, H, D) or not err <= CPU_TOL:
            raise RuntimeError(f"UNet {name}: card against CPU {err} > {CPU_TOL}")
        entry = {"max_abs_err": err, "ms": ms}
        if attn or cond:
            try:
                Bf16Unet(cpu_net)
            except ValueError:
                entry["bf16"] = "refused"
            else:
                raise RuntimeError(f"the bfloat16 twin accepted {name}")
        else:
            card_bf16, cpu_bf16 = bf16_model(card_net), bf16_model(cpu_net)
            with torch.no_grad():
                got16 = card_bf16(*card_args).cpu()
                want16 = cpu_bf16(*args)
                ms16 = cuda_ms(lambda: card_bf16(*card_args), n_iter=50, n_warm=5)
            rel = float((got16 - want16).abs().max() / want16.abs().max())
            mean = float((got16 - want16).abs().mean())
            print(f"rest: bf16 UNet {name}: card against the CPU's bf16 twin max |diff| {rel:.4f} "
                  f"of max |eps| (tolerance {BF16_TOL}), mean |diff| {mean:.5f} (tolerance "
                  f"{BF16_MEAN_TOL}), {ms16:.4f} ms a forward")
            if not (rel <= BF16_TOL and mean <= BF16_MEAN_TOL):
                raise RuntimeError(f"bf16 UNet: card against CPU {rel} / {mean}")
            entry["bf16"] = {"max_rel_err": rel, "mean_abs_err": mean, "ms": ms16}
        modes[name] = entry
    summary["unet_modes"] = modes

    # (b) GP-prior sampling, card against CPU on one set of draws.
    starts, goals = get_start_goal_pos_circle(TEAM_AGENTS)
    start = torch.tensor([*starts[0], 0.0, 0.0])
    goal = torch.tensor([*goals[0], 0.0, 0.0])
    dt = GP_DURATION / (H - 1)
    z = torch.from_numpy(np.random.default_rng(GP_SEED).standard_normal(
        (B, 4 * H)).astype(np.float32))
    cpu_gp = sample_gp_prior(z, start, goal, H, dt, B)
    f64 = sample_gp_prior(z, start, goal, H, dt, B, dtype=torch.float64)
    gap = float((cpu_gp.double() - f64).abs().max())
    card_gp = sample_gp_prior(z.to(dev), start.to(dev), goal.to(dev), H, dt, B)
    gp_err = float((card_gp.cpu() - cpu_gp).abs().max())
    print(f"rest: sample_gp_prior at ({B}, {H}, 4): max |card - cpu| {gp_err:.3e}; the CPU's "
          f"float32 against float64 {gap:.3e}; tolerance twice that, {2 * gap:.3e}")
    if not torch.isfinite(card_gp).all() or not gp_err <= 2 * gap:
        raise RuntimeError(f"GP prior: card against CPU {gp_err} > {2 * gap}")
    summary["gp_prior"] = {"max_abs_err": gp_err, "cpu_f32_f64_gap": gap, "tolerance": 2 * gap}

    # (c) the fields of viz through the lookup kernel, exactly the plain
    # lookup's.
    lookup_err, lookup_at, fields = 0.0, {}, {}
    for env_name in ("EnvConveyor2D", "EnvEmptyNoWait2D"):
        env = make_env(env_name, dev)
        scene = env.scene
        tables = ((scene.grid.values, scene.grid.grads),
                  (scene.extra_grid.values, scene.extra_grid.grads))
        box = (scene.grid.lower, scene.grid.upper)
        zero_counts()  # viz path starts
        sdf = sdf_field(scene, env.limits, VIZ_SDF_N)
        grad = grad_sdf_field(scene, env.limits, VIZ_GRAD_N)
        got = counts()  # viz path ends
        launches[f"viz {env_name}"] = got
        if got != want(0, 0, 2):
            raise RuntimeError(f"viz fields on {env_name} launched {got}, expected 2 lookups")
        errs = []
        for n, field, k in ((VIZ_SDF_N, sdf, 0), (VIZ_GRAD_N, grad, 1)):
            pts = torch.from_numpy(field_grid(env.limits, n)[2]).to(dev)
            plain = sdf_kernel.grid_lookup_plain(pts, tables, *box)[k][0]
            errs.append(float((field - plain).abs().max()))
        lookup_err = max(lookup_err, *errs)
        print(f"rest: viz fields on {env_name}: sdf {tuple(sdf.shape)} and gradient "
              f"{tuple(grad.shape)} through the lookup kernel, max |kernel - plain| "
              f"{errs[0]:.1e} and {errs[1]:.1e} (tolerance {REPLAY_TOL}), launches {got}")
        if max(errs) > REPLAY_TOL or not torch.isfinite(sdf).all():
            raise RuntimeError(f"viz fields on {env_name} differ from the plain lookup: {errs}")
        fields[env_name] = {"sdf_err": errs[0], "grad_err": errs[1]}
        if env_name == "EnvConveyor2D":
            pts = torch.from_numpy(field_grid(env.limits, VIZ_SDF_N)[2]).to(dev)
            at = time_lookup(scene, tables, pts)
            lookup_at = {"shape": list(pts.shape), **at, "max_abs_err": errs[0]}
            print(f"rest: lookup at the SDF field's {tuple(pts.shape)}: {at['device_us']:.4f} us a "
                  f"launch on the device, wrapper {at['ms']:.5f} ms, plain {at['plain_ms']:.5f} "
                  f"ms, bound {at['bound_ms']:.6f} ms ({at['bytes']} B, {at['cells']} cells) "
                  f"({card})")
    summary["viz_fields"] = fields

    # (d) the FLOP accounting, on phase 8's XECBS search, and the compile
    # seconds of the build and of a later plan.
    planner = load_planner("EnvEmptyNoWait2D", starts[0], goals[0], dev)
    cfg = planner.cfg
    forward = unet_forward_flops(planner.model, cfg.n_samples, cfg.horizon, cfg.state_dim)
    peak = gpu_peak_flops()
    evals = xecbs["unet_forwards"]
    mfu = mfu_pct(evals, forward, xecbs["plan_s"], peak)
    print(f"rest: one UNet forward at B={cfg.n_samples}: {forward} FLOPs; the card's dense "
          f"bf16 peak {peak} FLOP/s; phase 8's XECBS: unet_evals {evals}, model_gflops "
          f"{evals * forward / 1e9:.3f}, mfu_pct {mfu} over its {xecbs['plan_s']:.4f} s ({card}; "
          f"its UNet ran in bf16, against the bf16 peak)")
    if peak is None or mfu is None or not forward > 0:
        raise RuntimeError(f"FLOP accounting: forward {forward}, peak {peak}")
    summary["flops"] = {"unet_forward_flops": forward, "peak_flops": peak,
                        "xecbs_unet_evals": evals, "xecbs_model_gflops": evals * forward / 1e9,
                        "xecbs_mfu_pct": mfu, "xecbs_wall_s": xecbs["plan_s"]}
    cset, spc = planner._pack(None)
    gd = GuideData(scene=planner.scene, normalizer=planner.dataset.normalizer,
                   constraints=cset, soft_paths=spc)
    planner._plan_fresh(gd, planner.draw_noise(), planner.hard_conds)  # warm-up
    noise = planner.draw_noise()
    zero_counts()  # plan path starts
    with compile_time_monitor() as plan_compile:
        _sync_free(lambda: planner._plan_fresh(gd, noise, planner.hard_conds))
    got = counts()  # plan path ends
    launches["compile-monitored plan"] = got
    guided = cfg.n_guided_steps()
    print(f"rest: compile_time_monitor: the build {build_compile_s:.3f} s, a later plan "
          f"{plan_compile['compile_s']:.3f} s (sync-free, launches {got})")
    if not build_compile_s > 0 or plan_compile["compile_s"] != 0.0 or got != want(guided, 0, 1):
        raise RuntimeError(f"compile seconds {build_compile_s} / {plan_compile['compile_s']}, "
                           f"launches {got}")
    summary["compile_s"] = {"build": build_compile_s, "plan": plan_compile["compile_s"]}

    # (e) a profiler trace of one plan.
    zero_counts()  # traced plan path starts
    with profiler_trace(os.path.join(ROOT, "build", "chip_smoke_trace")) as prof:
        _sync_free(lambda: planner._plan_fresh(gd, noise, planner.hard_conds))
    got = counts()  # traced plan path ends
    launches["traced plan"] = got
    with open(prof.trace_path) as f:
        named = f.read().count("guide_loop_kernel")
    size = os.path.getsize(prof.trace_path)
    print(f"rest: profiler_trace of one plan, sync-free: {prof.trace_path} ({size} B), names "
          f"guide_loop_kernel {named} times; launches {got}")
    if named < guided or got != want(guided, 0, 1):
        raise RuntimeError(f"the trace names the guide loop {named} times, launches {got}")
    summary["trace"] = {"bytes": size, "guide_loop_events": named}
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"rest: phase {summary['phase_s']:.2f} s")
    return {"launches": launches, "summary": summary, "lookup_at": lookup_at,
            "lookup_err": lookup_err}


def run_sharding_phase(dev, cfg) -> dict:
    """Phase 19 (module docstring): the team sharded over ranks."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from mmd_torch.experiments.status import TrialSuccessStatus
    from mmd_torch.parallel import dryrun
    from mmd_torch.parallel.sharding import init_mesh, make_mesh, spawn
    from mmd_torch.planners.multi_agent.cbs import CBS
    from mmd_torch.planners.multi_agent.conflict_detection import count_conflicts
    from mmd_torch.tools import shard_cases

    t_phase = time.perf_counter()
    launches, summary = {}, {}
    run_dir = os.path.join(ROOT, "build")  # gitignored
    os.makedirs(run_dir, exist_ok=True)

    def xecbs(mesh, **knobs):
        """The 10-robot XECBS (bf16) of phase 8, made: its construction
        checks the starts and goals (two lookups) before its path starts."""
        planners, starts, goals = shard_cases.team_planners(dev, TEAM_AGENTS, bf16=True)
        return CBS(planners, starts, goals, is_ecbs=True, is_xcbs=True, mesh=mesh, **knobs)

    def solved(name, team, out):
        paths, n_exp, status, n_conflicts = out
        if (status != TrialSuccessStatus.SUCCESS or n_conflicts != 0
                or count_conflicts(paths, team.margin) != 0):
            raise RuntimeError(f"sharding: {name}: status {status}, {n_conflicts} conflicts")

    # (a) one rank in this process, over NCCL, against no mesh
    per_fresh, per_local = cfg.n_guided_steps(), cfg.n_guided_steps(3)
    t0 = time.perf_counter()
    store_dir = tempfile.mkdtemp(dir=run_dir)
    init_mesh("nccl", 0, 1, os.path.join(store_dir, "store"))
    try:
        mesh = make_mesh([1], axis_names=("agent",))
        init_s = time.perf_counter() - t0
        ref_team = xecbs(None)
        ref = ref_team.plan(runtime_limit=600)
        team = xecbs(mesh)
        zero_counts()  # sharding_xecbs path starts
        out = team.plan(runtime_limit=600)
        launches["sharding_xecbs"] = counts()  # sharding_xecbs path ends
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    solved("1-rank XECBS", team, out)
    same_paths = all(np.array_equal(a, b) for a, b in zip(out[0], ref[0]))
    same_nodes = torch.equal(team.final.paths_all, ref_team.final.paths_all)
    fresh, local = calls_of(team.timing)
    print(f"sharding: (a) {TEAM_AGENTS}-robot XECBS (bf16) on a 1-rank NCCL 'agent' mesh in "
          f"{team.timing['plan_s']:.3f} s (process group and mesh {init_s:.2f} s), "
          f"{out[1]} expansions; without a mesh {ref_team.timing['plan_s']:.3f} s, {ref[1]} "
          f"expansions; paths bitwise equal {same_paths and same_nodes}; launches "
          f"{launches['sharding_xecbs']}")
    if out[1] != ref[1] or not (same_paths and same_nodes):
        raise RuntimeError("sharding: the 1-rank mesh search differs from the unsharded one")
    expected = want(per_fresh * fresh + per_local * local, 0, fresh + local)
    if launches["sharding_xecbs"] != expected:
        raise RuntimeError(f"sharding: the 1-rank search launched {launches['sharding_xecbs']}, "
                           f"expected {expected}")
    summary["one_rank"] = {"plan_s": team.timing["plan_s"], "unsharded_plan_s":
                           ref_team.timing["plan_s"], "expansions": out[1]}

    # (b) two ranks on the one card over gloo, CUDA tensors
    root_team = {"n_agents": TEAM_AGENTS}
    spec = {"root": {"team": root_team, "noise_seed": SHARD_SEED, "mesh": [2],
                     "axes": ("agent",)},
            "runs": [{"team": {"n_agents": TEAM_AGENTS, "bf16": True},
                      "search": {"is_ecbs": True, "is_xcbs": True, "root_repair_rounds": 1},
                      "mesh": [2], "axes": ("agent",)},
                     {"team": {"n_agents": TEAM_AGENTS, "bf16": True},
                      "search": {"is_ecbs": True, "is_xcbs": True},
                      "mesh": [2], "axes": ("agent",)}],
            "dryrun": 2}
    t0 = time.perf_counter()
    ranks = spawn(shard_cases.chip_case, 2, "gloo", dev, spec)
    spawn_s = time.perf_counter() - t0
    root = shard_cases.team_root(dev, root_team, noise_seed=SHARD_SEED)
    got = [r["root"] for r in ranks]
    across = all(torch.equal(got[1][k], got[0][k]) for k in ("trajs", "free_mask", "ix"))
    err = float((got[0]["trajs"] - root["trajs"].cpu()).abs().max())
    root_want = want(per_fresh, 0, 1)
    print(f"sharding: (b) {TEAM_AGENTS}-robot root (f32) on 2 gloo ranks, {TEAM_AGENTS // 2} "
          f"agents each: ranks "
          f"bitwise equal {across}; max |sharded - unsharded| {err:.3e} (tolerance {CPU_TOL}); "
          f"launches by rank {[g['launches'] for g in got]}")
    if not across or not err <= CPU_TOL:
        raise RuntimeError(f"sharding: the 2-rank root: ranks equal {across}, off by {err}")
    if any(g["launches"] != root_want for g in got):
        raise RuntimeError(f"sharding: a rank of the root launched other than {root_want}")
    # Each search against the unsharded one: XECBS-R's here, XECBS's (a)'s.
    ref_r_team = xecbs(None, root_repair_rounds=1)
    ref_r = ref_r_team.plan(runtime_limit=600)
    solved("unsharded XECBS-R", ref_r_team, ref_r)
    unsharded = {"xecbs_r": (ref_r[1], ref_r_team.timing["plan_s"]),
                 "xecbs": (ref[1], ref_team.timing["plan_s"])}
    two_ranks = {}
    for k, (name, label) in enumerate((("xecbs_r", "XECBS-R (bf16, 1 repair round)"),
                                       ("xecbs", "XECBS (bf16, the serial ECBS root)"))):
        searches = [r["runs"][k] for r in ranks]
        paths_equal = torch.equal(searches[0]["paths"], searches[1]["paths"])
        print(f"sharding: (b) {label} on 2 gloo ranks: {searches[0]['status']}, "
              f"{searches[0]['n_exp']} expansions in {searches[0]['plan_s']:.3f} s (without a "
              f"mesh: {unsharded[name][0]} expansions in {unsharded[name][1]:.3f} s); ranks' "
              f"paths bitwise equal {paths_equal}; launches by rank "
              f"{[r['launches'] for r in searches]}")
        for r, sr in enumerate(searches):
            if sr["status"] != str(TrialSuccessStatus.SUCCESS) or sr["n_conflicts"]:
                raise RuntimeError(f"sharding: rank {r}'s 2-rank {label}: {sr['status']}, "
                                   f"{sr['n_conflicts']} conflicts")
            # Every call runs on every rank, on its share or whole: 14 guide
            # loops a fresh call, 4 a local one, one lookup a call.
            fresh, local = sr["calls"]
            if sr["launches"] != want(per_fresh * fresh + per_local * local, 0, fresh + local):
                raise RuntimeError(f"sharding: rank {r}'s {label} launched {sr['launches']} "
                                   f"for {fresh} fresh and {local} local sampler calls")
            launches[f"sharding_{name}_rank{r}"] = sr["launches"]
        if not paths_equal:
            raise RuntimeError(f"sharding: the ranks' {label} paths differ")
        two_ranks.update({f"{name}_expansions": searches[0]["n_exp"],
                          f"{name}_plan_s": searches[0]["plan_s"],
                          f"unsharded_{name}_expansions": unsharded[name][0],
                          f"unsharded_{name}_plan_s": unsharded[name][1]})
    for r, g in enumerate(got):
        launches[f"sharding_root_rank{r}"] = g["launches"]
    dryrun.report(2, [r["dryrun"] for r in ranks])
    phase_s = time.perf_counter() - t_phase
    print(f"sharding: the spawn, the dry run's ranks included, {spawn_s:.2f} s; the phase "
          f"took {phase_s:.1f} s (bound {SHARDING_BUDGET_S} s)")
    if phase_s > SHARDING_BUDGET_S:
        raise RuntimeError(f"sharding: the phase took {phase_s:.1f} s, over its "
                           f"{SHARDING_BUDGET_S} s")
    summary.update({"two_ranks": {"root_max_abs_err": err, "spawn_s": spawn_s, **two_ranks},
                    "phase_s": phase_s})
    return {"launches": launches, "summary": summary}


if __name__ == "__main__":
    sys.exit(main())
