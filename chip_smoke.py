#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`cpr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is not 0:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the kernels from `cpr_tpu_torch/csrc/` (nvcc, sm_90a), timed;
  2. K1 (threefry) against its plain version on the card and against the
     committed JAX fixture (tests/fixtures/torch_port_golden.npz);
  3. K3 (step_lanes) against its plain version: 4096 lanes, 128 ticks of
     numpy-seeded admit/step masks and actions, and against the fixture's
     tick trace;
  4. K2 (episode stream) against its plain version: 4096 lanes x 256
     steps, all four policies, chunked and unchunked, plus `rollout`;
     and against the fixture's per-lane stats;
  5. the main path, two paths each with the launch counters zeroed just
     before it and read just after; each kernel a path runs must have
     launched, and no other:
     - the episode stream: Nakamoto SM1 at the bench's size (131072
       lanes x 2200 steps, alpha=0.35, gamma=0.5, max_steps=2016), one
       warm call and 3 timed calls, relative revenue inside
       SM1_GUARD = (0.38, 0.45) (K1 once, K2 once per call); then the
       plain twin on the same keys, its SM1 action decoded from the
       observation as the JAX package does it, held against the kernel's
       stats, and the largest fork length it decoded held below
       DECODE_EXACT;
     - the gym step path: 100 ticks of `step_lanes` at 131072 lanes
       under SM1 actions (K1 and K2 for the two resets, K3 once per
       tick); then one more tick through K3 and its plain twin on
       copies of the carry;
  6. each kernel's device time at main-path shapes with the L2 cache
     scrubbed before each launch, its plain twin's time, and its bound;
     a time below the bound fails;
  7. K4 (Bellman sweep) and K5 (policy evaluation) against the committed
     JAX fixture (tests/fixtures/torch_port_mdp_golden.npz): FC'16 at
     maximum_fork_length 20 and the native GhostDAG compile at cutoff 6
     (alpha 0.3, gamma 0.5, PT horizon 100), each compiled here and held
     to the fixture's table digest; value iteration while and chunked
     (accel_m 0 and 3), float32 and float64; policy evaluation;
  8. the exact-analysis main path, with its own launch counts (K4 and
     K5 only): the capstone GhostDAG compile at MDP_CUTOFF, ptmdp,
     .tensor() on the card, value_iteration (while), vi_chunked with
     Anderson mixing, policy evaluation of the VI policy; the revenue
     held to MDP_REVENUE, the impls and PE to each other; one timed
     solve; then K4 and K5 against their plain twins at these shapes,
     64 sweeps each, every sweep from the same input;
  9. `measure_rows` on the default battery (fc16/aft20 at maximum_fork_
     length 20, native bitcoin/ghostdag at cutoff 7, alpha 0.25/0.33/
     0.4), its own launch counts (K4 only), every revenue at least
     alpha - 1e-4 (the honest floor);
 10. K7 (grid sweep) and K6 (RTDP walkers) against the committed JAX
     fixture (tests/fixtures/torch_port_grid_rtdp_golden.npz): the FC'16
     2 x 2 grid solve bit for bit, and each RTDP case (scan and graph
     modes, discount, small buffer, residual stop, warm start) with the
     same visits, buffer ids and steps and V/P within 1e-6;
 11. the grid path, its own launch counts (K7, and K4 for the solo
     solves): the parametric GhostDAG cutoff-8 compile (run on the host
     from the start, beside the phases before it), revalue parity with
     the capstone's compile at (0.3, 0.5), the 4 x 3 (alpha, gamma) grid
     solve (every point converged, the capstone point within 1e-5 of the
     capstone's revenue, every revenue at least alpha - 1e-4, revenue
     nondecreasing in alpha and gamma to GRID_MONOTONE_TOL, two corners
     bit-identical to solo K4 solves), the cached grid solve at cutoff 7
     (a miss, then a hit); then K7 against its twin for 64 sweeps;
 12. the RTDP path on the capstone table, its own launch counts (K6, and
     K4 for the polish): rtdp_graph and the scan walkers, 20000 steps of
     256 walkers, then the chunked solve warm-started from the graph
     walk's table against a cold one (revenues within 1e-5); then K6
     against its twin for 64 steps in both modes (visits, walker states,
     buffer ids exactly, V/P within rtol 1e-6);
 13. K4 and K5 device times at the capstone's shapes, their plain twins'
     and the library yardstick (torch.sparse.mm, cuSPARSE CSR SpMV of
     the same probability matrix with V: the expectation part only);
     K7 per grid sweep of 12 points (yardstick: 12 SpMVs) and K6 per
     launch of 256 steps, with their bounds;
 14. K8 (the block-DAG primitives, device functions of K10) through its
     check kernel: the register-machine script of core/dag.py at 4096
     lanes, a 128-slot window and 9 parent slots against the plain
     `script_plain` on the card, every result, register and DAG plane
     exactly; and the committed JAX fixture's script
     (tests/fixtures/torch_port_dag_golden.npz);
 15. K10-bk and K10-eth `step_lanes` against their plain versions at
     their gym paths' lanes (8192 bk, 4096 Ethereum), 128 ticks of
     numpy-seeded actions and admit/step masks, the
     outputs every tick and the whole carry (every DAG plane, stale rows
     included); then the fixture's tick traces;
 16. the K10 streams against their plain versions: 4096 lanes x 256
     steps, every policy of bk (k=8, constant) and Ethereum (byzantium),
     window 128, unchunked and in chunks of 100, the stats and the final
     carry; then the fixture's per-policy sums and final carries;
 17. the bk path (BASELINE.json config 2, bench.py:206-231), its launch
     counts zeroed before it and read after (K1 and K10-bk only; K8's
     device functions run inside K10, its check kernel not at all):
     BkSSZ k=8, constant, window 128, get-ahead, 8192 lanes x 128 steps,
     alpha 0.35, gamma 0.5, max_steps 120, unchunked, one warm and three
     timed calls; relative revenue inside BK_GUARD = (0.05, 0.6); the
     plain version on the same keys held to the kernel's stats; then 100
     `step_lanes` ticks at 8192 lanes (the gym path);
 18. the Ethereum path (config 3, bench.py:234-254) the same way (K1,
     K10-eth): byzantium, window 128, fn19, 4096 lanes x 4096 steps
     in chunks of 128, max_steps 120, revenue inside ETH_GUARD = (0.33,
     0.55); the plain version held to the kernel over the first 256
     steps; 100 `step_lanes` ticks at 4096 lanes;
 19. K10 device times per 128-step launch at the paths' shapes and per
     step_lanes tick, K8's check kernel per launch, the plain versions'
     times, and the bounds (the lane state read and written once per
     launch; the threefry work of every step and reset).
 20. (in phase 14) K8's second script, the vote-quorum envs' queries
     `last_by_age` and `descendants_mask`, at the same shapes against its
     plain version and against the fixture's second script;
 21. K10-ts and K10-stree `step_lanes` against their plain versions at
     4096 lanes over 128 ticks of seeded masks, then the tick traces of
     the vote-quorum fixture (tests/fixtures/torch_port_quorum_golden.npz);
 22. their streams against their plain versions: 4096 lanes x 256 steps,
     every policy (7 Tailstorm, 6 Stree) in one batched plain call,
     unchunked and in chunks of 100; then the fixture's sums and carries;
 22b. K10-ts and K10-stree under the schemes and selections the paths
     do not run (VOTE_VARIANTS: altruistic, optimal, constant, punish,
     hybrid, and a 40-slot ring at k = 4 that wraps and overflows with a
     16-position release scan), 512
     lanes x 160 steps, every policy, against their plain versions, with
     the episodes whose ring wrapped counted (`ring_peaks`);
 23. K9 (the vote quorums, device functions of K10-ts/K10-stree) through
     its check kernel: 4096 lanes of each env's plain stream carry (every
     policy on its share of the lanes, 190 steps into episodes of
     max_steps 200, window 128: the rings have wrapped), every output
     against `quorum.check_plain`, then the fixture's carries and inputs
     against cpr_tpu's outputs;
 24. the Tailstorm path (BASELINE.json config 4 without PPO,
     bench.py:257-309), its launch counts zeroed before it and read after
     (K1 and K10-ts only): tailstorm-8-discount-heuristic, window 128,
     get-ahead, 4096 lanes x 1024 steps in chunks of 128, alpha 0.35,
     gamma 0.5, max_steps 120, one warm and three timed calls; relative
     revenue within VOTE_GUARD of VOTE_REVENUE; the plain version on the
     same keys held to the kernel over the first 256 steps, its first 64
     lanes' revenue held to VOTE_REVENUE (the CPU reference's, equal to
     cpr_tpu's) and its episodes whose ring wrapped counted; 100
     `step_lanes` ticks at 4096 lanes (the gym path cpr-tailstorm-torch-
     v0);
 25. the Stree path the same way (K1, K10-stree): stree-8-constant-
     heuristic, override-catchup;
 26. K10-ts and K10-stree device times per 128-step launch and per tick,
     K9's check kernel per launch, the plain versions' times and the
     bounds (the threefry work: 9 blocks per mining draw; K9's the bytes
     its check reads, `k9_bytes`).
 27. K11-act (the actor-critic inside K2 and K10) through its check
     kernel against the plain actor: 4096 lanes, hidden 64 and 96, with
     and without extend_obs, warp mode (as K10) and thread mode (as K2),
     sampled and greedy draws: logits, value and logp within 1e-5,
     actions equal wherever the Gumbel margin exceeds NET_MARGIN (the
     lanes below it counted);
 28. the stream kernels with the net in sample mode for each env
     (Nakamoto and Tailstorm under AssumptionEnv with per-lane alphas),
     512 lanes x 64 steps: the kernel's actions replayed through the
     plain `_lane_step` give its observations, rewards, dones, info and
     final carry; the plain actor gives its logp and value within 1e-5
     and its draws above the margin; the returned carry key is the
     plain chain's;
 29. K11-gae exact against its twin at [128, 4096]; K11-loss forward
     and backward against autograd of the plain loss at B = 131072
     (each scalar within 1e-6 of the mean absolute value of its terms,
     the gradients within 1e-6 of their largest element); K11-adam
     against `train/optim.py` over 16 steps (within 1e-6 of the largest
     parameter);
 30. the JAX PPO fixture (tests/fixtures/torch_port_ppo_golden.npz)
     replayed from JAX's params: one train_step of Nakamoto under
     AssumptionEnv (per-lane alphas, sparse_relative, KL stop) and of
     Tailstorm in a 40-slot ring give JAX's actions, rewards and dones,
     logp and value within 1e-5, its metrics, params within 1e-5;
 31. the bench PPO path (BASELINE.json config 4, bench.py:257-309):
     tailstorm-8-discount-heuristic, window 128, alpha 0.35, gamma 0.5,
     max_steps 120, PPOConfig(n_envs=4096, n_steps=128) defaults; one
     warm and 3 timed train_steps with their launch counts (K1, K10-ts,
     K11 only) and env-steps/s; metrics finite, entropy in (0, ln 8];
     then 3 steps composed of the same pieces give the rollout/GAE/
     update split, and the stream with the trained net is held to the
     plain versions at this shape (4096 lanes x 128 steps) as in 28;
 32. the config path: train_from_config on the shipped nakamoto.yaml (3
     updates; K1, K2, K11), tailstorm-8-discount.yaml, spar-8.yaml and
     sdag-8-discount.yaml (2 updates each, 128-slot ring; K1, the env's
     K10, K11), eval.freq 1 and start_at_iteration
     0 so that the eval and the checkpoints run; eval rows finite,
     relative reward in [0, 1]; a policy snapshot exported and reloaded
     acts as the net; each DAG config's 128-slot ring (the reference
     sizes full mode for the episode) under the trained net, hidden 96, 512
     lanes x 160 steps from a raw reset, held to the plain versions as
     in 28, its first 64 lanes to full mode as well, and no episode
     ended by the eviction of a live block;
 33. K11's device times (the check kernel; the Tailstorm stream with the
     net against the heuristic per 128-step launch; GAE; the loss head
     forward + backward; the Adam step against torch.optim.Adam(fused=
     True)), the plain versions' times and the bounds.
 34. K1's float64 modes (the netsim's clocks: uniform and exponential
     from the 64-bit bits) against the plain version on the card and the
     committed JAX fixture (tests/fixtures/torch_port_netsim_golden.npz);
 35. K12-scan against its plain version at the netsim path's shape (96
     lanes x 10000 activations on the bench clique), and at 96 x 2000 on
     a 5-node clique with exponential link delays (lookback 32 and 40),
     and against the fixture's scan cases; the plain runs' smallest
     decision margins printed;
 36. the netsim path (bench.py:312-350 `measure_netsim`, the netsim_sweep
     config): the 10-node clique, activation delay 30, propagation 1.0,
     96 lanes x 10000 activations through `netsim.Engine.run`, one warm
     and 3 timed calls with its own launch counts (K12-scan only: the
     lane keys are made from the seeds on the host, K1's float64 draws
     run inside the kernel as device functions), the mean orphan rate
     inside NET_ORPHAN_GUARD and no capacity drop; then the sweep shape,
     8190 lanes (the JAX package's honest-network delays 30-600 x 1638
     seeds), its launches counted with the path's, its orphan rate
     falling with the delay, and every lane held to the plain version;
 37. K12-event against its plain version at the event path's shape (the
     bench clique, 96 lanes x 10000, the path's capacities), and with
     flooding on random_regular(13, 4) with exponential delays, 16 lanes
     x 60, and the fixture's event cases; then the event engine at the
     netsim path's shape (`mode="event"`, K12-event only), its orphan
     rate within NET_EVENT_GAP of the scan path's, no drop;
 38. K13 against its plain version at the attack path's shape (clique-4,
     64 lanes x 1500, its alphas, policies and ATK_QUEUE_CAP queue), and
     every scripted policy at alpha 0.3 and 0.45, 16 lanes x 300 at the
     default queue, and the fixture's attack cases;
 39. the attack path (bench.py:477-541 `measure_attack_sweep`): clique-4,
     activation delay 30, propagation 1.0, 64 lanes x 1500 activations
     over alpha (0.15, 0.25, 0.33, 0.45) x {honest, SM1}, one warm and 3
     timed calls through `AttackEngine.run` (K13 only), the honest
     attacker's relative revenue at alpha 0.33 inside ATK_GUARD, no drop
     at a queue of ATK_QUEUE_CAP entries (the JAX package's default of
     256 overflows at alpha 0.45 under SM1, in both packages: the drops
     at that size are printed); then 4096 lanes x 2000, its launches
     counted with the path's, every lane held to the plain version;
 40. K12-scan, K12-event and K13 device times at the paths' bench
     shapes, the shapes of the plain replays in 35, 37 and 38 whose times
     are the rows' plain times, with the L2 scrubbed (by CUDA events
     around each wrapper call, its small host-to-device copies
     included); the bounds (the threefry work this run's draws need and
     the lanes' inputs and outputs).
 41. K10-spar and K10-sdag `step_lanes` against their plain versions at
     4096 lanes over 128 ticks of seeded masks, then the tick traces of
     their JAX fixture (tests/fixtures/torch_port_spar_sdag_golden.npz);
 42. their streams against their plain versions: 4096 lanes x 256
     steps, every policy (2 Spar, 6 Sdag) in one batched plain call,
     unchunked and in chunks of 100; then the fixture's sums and carries;
 43. the variants the paths do not run (PAR_VARIANTS: Spar's block
     scheme; Sdag constant-altruistic, constant-heuristic and
     discount-altruistic; rings at k = 4 that wrap and overflow, Sdag's
     of 40 slots with a 16-position release scan, Spar's of 16), 512
     lanes x 160 steps, every policy, against their plain versions, the
     wrapped and the overflowed episodes counted;
 44. the Spar path: spar-8-constant (the protocol of spar-8.yaml),
     window 128, selfish, 4096 lanes x 1024 steps in chunks of 128,
     alpha 0.35, gamma 0.5, max_steps 120, its launch counts zeroed
     before it and read after (K1 and K10-spar only), one warm and three
     timed calls; relative revenue within VOTE_GUARD of the fixture's
     reference (cpr_tpu on the path's first 64 lanes x 256 steps); the
     plain version held to the kernel over the first 256 steps and its
     first 64 lanes to the reference to 1e-6; 100 `step_lanes` ticks at
     4096 lanes;
 45. the Sdag path the same way (K1, K10-sdag; K8 and K9 inside):
     sdag-8-discount-heuristic (the protocol of sdag-8-discount.yaml),
     override-catchup; both envs are in phase 28's net-policy streams,
     and phase 32 trains spar-8.yaml and sdag-8-discount.yaml for 2
     updates each (K1, their K10 with K11-act, K11-gae/-loss/-adam) with
     the ring against full mode as for Tailstorm;
 46. K10-spar and K10-sdag device times per 128-step launch and per
     tick, the plain versions' times and the bounds (9 threefry blocks a
     mining draw, the lane state read and written once).
 47. K12-event-bk, K12-event-eth and K12-event-spar against every case of
     their JAX fixture (tests/fixtures/torch_port_netsim_protocols_
     golden.npz: the sweep's seven event configurations at 2000
     activations, the block schemes at k = 2 and 1, forced window misses,
     flooding), the engine's sizes held to the fixture's;
 48. each against its plain version, exactly, on the sweep's five lanes
     (seed 0, activation delays 30 to 600): its first configuration (Bk
     k=8 constant, the whitepaper, Spar k=4 constant) at the full 10 000
     activations, the others at HN_PLAIN_ACTS; then flooding on
     random_regular(13, 4) with exponential delays (NET_FLOOD_LANES x
     NET_FLOOD_ACTS);
 49. the honest-network sweep on the card (`experiments.honest_net_rows`,
     engine="jax", the JAX package's defaults: 10-node clique, 10 000
     activations, seed 0, delays 30-600, the 8 default protocols), then
     Spar k=4 under both schemes: one warm and three timed rounds, the
     counters zeroed before each call and read after it (K12-scan,
     K12-event-eth and K12-event-bk on the first, K12-event-spar on the
     second, no other kernel); the calls' drops and window misses 0 (the
     netsim's telemetry events), the manifest on the card, 40 rows and 2
     Tailstorm error rows, every lane's 10 000 activations, Bk constant's
     rewards its progress, Spar's progress k times its height, the
     Ethereum bounds of the JAX package's invariant test, orphan rates in
     [0, 0.2] and falling from delay 30 to 600; no lane exhausted;
 50. the three kernels' device times a launch at the sweep's shape, the
     L2 scrubbed; the bounds (the threefry work of the run's steps and
     activations, the lanes' inputs and outputs).
Then the kernels line (JSON: launches summed over the main paths, the
error of the main-shape comparison, the times and the bound) and the
last line {"ok": true, "device": {...}}.

Netsim tolerances (phases 34-40): integer outputs equal; float64 times
within NET_TIME_RTOL relative of the JAX fixture (the mint times are a
running sum that XLA:CPU adds in another order, and log1p may differ by
an ULP) and equal to the plain versions'. The plain event and attack
versions replay their steps as CUDA graphs of 64 steps on the card
(`EventLedger.run`).

Tolerances: integer state, keys, actions, done and integer-valued
rewards (the DAG envs' dyadic rewards too) bit-identical; time fields rtol 1e-5 (log1pf differs from the
other implementation by ULPs and the float32 sum carries it); unit
observations atol 1e-6 (atanf); K1 exponential within 2 ULP of the plain
version on the card and 4 ULP of XLA's on the CPU. MDP: K4 and K5 sum
each segment in row order with explicit round-to-nearest arithmetic, as
the CPU twin and XLA:CPU do, but the Anderson mixing weights come from
cuBLAS dots, and a chunked solve stops at another point of its approach
than the while loop, so against the fixture values and progress hold
within atol 1e-4 + rtol 1e-5 (the float64 chunked solve is 3.3e-4 from
the while loop's at values near 50 on the CPU), revenues within 1e-5,
the policy equal wherever JAX's Q-gap exceeds 1e-4, and sweep counts
equal except with Anderson mixing, whose path follows the last bits of
the mixing weights (on the CPU, FC'16 at maximum_fork_length 20 took
1536 sweeps in the port and 3968 in JAX to the same fixpoint, values
1.1e-5 apart); every chunked solve must reach stop_delta. Against the
plain twins on the card, whose
index_add_ adds in no fixed order, each sweep's value holds within rtol
1e-5 (all terms are >= 0, so no cancellation; a max moves no more than
its arguments), and its progress and policy, which follow the argmax,
wherever the twin's Q-gap exceeds that (a near-tie may pick another
action, whose progress differs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_golden.npz"
MDP_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_mdp_golden.npz"

MAIN_LANES, MAIN_STEPS, MAIN_MAX_STEPS = 131072, 2200, 2016
MAIN_TICKS = 100
SM1_GUARD = (0.38, 0.45)
POLICIES = ("honest", "simple", "eyal-sirer-2014", "sapirshtein-2016-sm1")

# Published H100 SXM peaks: 3.35 TB/s HBM and
# 67 TFLOP/s float32 outside the tensor cores, which counts an FMA as two
# operations: 128 lanes x 2 per SM per clock. An SM issues at most 128
# 32-bit operations per clock whatever their type (4 schedulers x 32
# lanes; integer adds also run on the FMA pipe as IMAD), so the integer
# work of the kernels below is bounded by 67e12 / 2 operations per second.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12 / 2
# 32-bit operations of one threefry2x32 block, counted in
# csrc/threefry.cuh at one instruction each: 20 rounds x (add, funnel-shift
# rotate, xor), 5 key injections x 2 (the second is a 3-input add), 2
# initial adds and 1 three-input xor for the parity word. Only the
# threefry work is counted, so the bound stays below the true cost.
THREEFRY_OPS = 20 * 3 + 5 * 2 + 3
MINE_THREEFRY = 7  # split into 4, then one draw from each of 3 keys
STATE_BYTES = 17 * 4 + 8  # 17 scalar fields + the key
OBS_BYTES, INFO_BYTES = 16, 12 * 4
L2_SCRUB_BYTES = 256 << 20  # five times the H100's 50 MB L2
# The unit observation round-trips exactly (decode of encode) for counts
# below 1763 and signed values below 1696 in magnitude
# (tests/test_torch_params_obs.py). K2 computes the scripted policies
# from the integers (a, h), which agrees with the JAX package's decoded
# form only there; the main path is held below the tighter of the two.
DECODE_EXACT = 1696

# The exact-analysis main path: the capstone (docs/CAPSTONE.md round 4,
# examples/solve_ghostdag_mdp.py): GhostDAG k=2 at alpha 0.3, gamma 0.5,
# PT horizon 100, solved to stop_delta 1e-6; its exact revenue 0.3437.
MDP_ALPHA, MDP_GAMMA, MDP_HORIZON, MDP_STOP = 0.3, 0.5, 100, 1e-6
MDP_CUTOFF, MDP_REVENUE, MDP_REVENUE_TOL = 8, 0.3437, 5e-4
MDP_CHUNK = 16  # examples/solve_ghostdag_mdp.py's chunk above 1M rows
# A float32 solve with Anderson mixing can land on a limit cycle of the
# rounded sweep whose delta stays above stop_delta (FC'16 at maximum_fork_
# length 20: 1.14e-5, 1.5 ULP of its values near 100); the chunked driver
# then restarts from zero (explicit.ACCEL_STALLS). Every chunked solve must
# reach stop_delta; this cap only turns a regression into a failure
# instead of a hang.
MDP_ACCEL_CAP = 20000
MDP_TWIN_SWEEPS = 64
BATTERY_ALPHAS = (0.25, 0.33, 0.4)
GRID_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_grid_rtdp_golden.npz"
# the order of each case's options in the fixture ("r_<name>_args")
GOLDEN_ARGS = ("seed", "graph", "steps", "batch", "cap", "eps", "restart_p",
               "discount", "stop_delta", "decay", "warm")
# The grid path: the capstone's structure over a 4 x 3 (alpha, gamma) grid
# (G = 12), the paper's figure axes; the two corners are held to solo K4
# solves; the cached solve runs at cutoff 7. Where the optimum is honest
# the revenue is flat in gamma up to the solve's error, so monotonicity is
# held to GRID_MONOTONE_TOL.
GRID_ALPHAS, GRID_GAMMAS = (0.25, 0.3, 0.35, 0.4), (0.25, 0.5, 0.75)
GRID_CHUNK, GRID_CACHE_CUTOFF, GRID_MONOTONE_TOL = 64, 7, 1e-5
GRID_CORNERS = ((0.25, 0.25), (0.4, 0.75))
# The RTDP path on the capstone table: 256 walkers, a buffer of 1024.
# rtdp_graph stops once its damped residual is <= stop_delta, and a
# GhostDAG walk's first backups are all 0 (no reward before a block is
# final), so at stop_delta 0 it ends after one step, in the JAX package
# as in the port; RTDP_STOP < 0 runs the whole step budget.
RTDP_SEED, RTDP_STEPS, RTDP_TIMED_STEPS, RTDP_STOP = 0, 20000, 256, -1.0
RTDP_BATCH, RTDP_BUFFER, RTDP_EPS, RTDP_RESTART_P = 256, 1024, 0.5, 0.5
# The DAG envs (K8, K10): the checks' shapes, the two paths (BASELINE.json
# configs 2 and 3) and their revenue guards (bench.py's), the fixture.
DAG_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_dag_golden.npz"
DAG_ENVS = {"bk": ("bk-8-constant", "get-ahead"),
            "eth": ("ethereum-byzantium", "fn19"),
            "ts": ("tailstorm-8-discount-heuristic", "get-ahead"),
            "stree": ("stree-8-constant-heuristic", "override-catchup"),
            "spar": ("spar-8-constant", "selfish"),
            "sdag": ("sdag-8-discount-heuristic", "override-catchup")}
# (the step_lanes checks run at the gym paths' lanes, BK_/ETH_LANES)
DAG_WINDOW, DAG_CHECK_LANES, DAG_CHECK_STEPS, DAG_CHECK_TICKS = 128, 4096, \
    256, 128
K8_LANES, K8_OPS, K8_PARENTS = 4096, 480, 9
BK_LANES, BK_STEPS, BK_MAX_STEPS, BK_GUARD = 8192, 128, 120, (0.05, 0.6)
ETH_LANES, ETH_STEPS, ETH_CHUNK, ETH_MAX_STEPS = 4096, 4096, 128, 120
ETH_GUARD, ETH_PLAIN_STEPS = (0.33, 0.55), 256
DAG_TIME_FIELDS = ("time", "last_chain_time", "last_sim_time",
                   "vis_d_since", "born_at")
# The vote-quorum envs (K9, K10-ts, K10-stree): BASELINE.json config 4's
# env (bench.py:257-309, without PPO) and Stree at the same shape, their
# fixture and revenue guards: +-0.05 around the plain version's revenue
# (bench.py's per-lane means) on the path's first 64 lanes over the first
# VOTE_PLAIN_STEPS steps, which equals cpr_tpu's bit for bit on the CPU;
# the path checks that value too.
QUORUM_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_quorum_golden.npz"
VOTE_LANES, VOTE_STEPS, VOTE_CHUNK, VOTE_MAX_STEPS = 4096, 1024, 128, 120
VOTE_PLAIN_STEPS, VOTE_REF_LANES = 256, 64
VOTE_REVENUE = {"ts": 0.33653560280799866, "stree": 0.3744279146194458}
VOTE_GUARD = 0.05
K9_STEPS, K9_MAX_STEPS = 190, 200  # K9's carries: rings wrapped
# every scheme and selection the paths do not run, and a k = 4 ring of 40
# slots that wraps and overflows, with a release scan of 16 positions (its
# release-everything branch); 2 launches of each policy a variant
VOTE_VARIANTS = {
    "tailstorm": (dict(k=8, incentive_scheme="constant",
                       subblock_selection="altruistic"),
                  dict(k=8, incentive_scheme="punish",
                       subblock_selection="optimal"),
                  dict(k=8, incentive_scheme="hybrid",
                       subblock_selection="heuristic"),
                  dict(k=4, incentive_scheme="discount",
                       subblock_selection="optimal", window=40,
                       release_scan=16)),
    "stree": (dict(k=8, incentive_scheme="discount",
                   subblock_selection="altruistic"),
              dict(k=8, incentive_scheme="hybrid",
                   subblock_selection="optimal"),
              dict(k=8, incentive_scheme="punish",
                   subblock_selection="heuristic"),
              dict(k=4, incentive_scheme="constant",
                   subblock_selection="optimal", window=40,
                   release_scan=16))}
VARIANT_LANES, VARIANT_STEPS = 512, 160
MINE_THREEFRY5 = 9  # split into 5, then one draw from each of 4 keys
# The Spar and Sdag envs (K10-spar, K10-sdag): the vote paths' shape
# (4096 lanes x 1024 steps in chunks of 128, max_steps 120) at the shipped
# configs' k; their JAX fixture holds each path's reference revenue
# (cpr_tpu on the path's first 64 lanes x 256 steps), which the guard
# centres: +-VOTE_GUARD. The variants the paths do not run: Spar's block
# scheme, Sdag's other scheme-selection pairs, and rings at k = 4 that
# wrap and overflow: Sdag's of 40 slots with a 16-position release scan,
# Spar's of 16 (its two policies release or adopt before a fork fills 40:
# at 512 lanes x 160 steps no 40-slot episode overflows, ~3% of 16-slot
# ones do).
SPAR_SDAG_FIXTURE = ROOT / "tests" / "fixtures" / \
    "torch_port_spar_sdag_golden.npz"
PAR_VARIANTS = {
    "spar": (dict(k=8, incentive_scheme="block"), dict(k=4, window=16)),
    "sdag": (dict(k=8, incentive_scheme="constant",
                  subblock_selection="altruistic"),
             dict(k=8, incentive_scheme="constant",
                  subblock_selection="heuristic"),
             dict(k=8, incentive_scheme="discount",
                  subblock_selection="altruistic"),
             dict(k=4, incentive_scheme="discount", window=40,
                  release_scan=16))}
# the envs whose steps make one mining draw of 9 threefry blocks
MINE5_ENVS = ("ts", "stree", "spar", "sdag")
# name: (lanes, steps, chunk, max_steps, guard, plain steps) of each path;
# a vote path's guard is +-VOTE_GUARD around its reference revenue
DAG_PATHS = {
    "bk": (BK_LANES, BK_STEPS, None, BK_MAX_STEPS, BK_GUARD, BK_STEPS),
    "eth": (ETH_LANES, ETH_STEPS, ETH_CHUNK, ETH_MAX_STEPS, ETH_GUARD,
            ETH_PLAIN_STEPS),
    **{n: (VOTE_LANES, VOTE_STEPS, VOTE_CHUNK, VOTE_MAX_STEPS, None,
           VOTE_PLAIN_STEPS) for n in ("ts", "stree", "spar", "sdag")}}
# The PPO slice (K11). The bench path is bench.py:257-309's shape; the
# fixture tests/test_torch_ppo_golden.py's (16 lanes x 32 steps); the
# net-policy streams run every env, Nakamoto and Tailstorm under
# AssumptionEnv (extend_obs) with per-lane alphas, 512 lanes x 64 steps
# of 24-step episodes; a draw is decided where its Gumbel margin exceeds
# NET_MARGIN; K11-loss runs the bench path's minibatch (131072 rows).
PPO_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_ppo_golden.npz"
PPO_LANES, PPO_STEPS, PPO_MAX_STEPS = 4096, 128, 120
PPO_FIX_LANES, PPO_FIX_STEPS = 16, 32
ACT_LANES, NETPOL_LANES, NET_STEPS, NET_MAX_STEPS = 4096, 512, 64, 24
NET_MARGIN = 1e-5
NET_ENVS = (("nakamoto", None, True),
            ("bk-8-constant", DAG_WINDOW, False),
            ("ethereum-byzantium", DAG_WINDOW, False),
            ("tailstorm-8-discount-heuristic", DAG_WINDOW, True),
            ("stree-8-constant-heuristic", DAG_WINDOW, False),
            ("spar-8-constant", DAG_WINDOW, False),
            ("sdag-8-discount-heuristic", DAG_WINDOW, False))
LOSS_BATCH, ADAM_STEPS = PPO_LANES * PPO_STEPS // 4, 16
# the Tailstorm config's ring against full mode: steps from a raw reset
# (a whole 128-step episode on every lane) and lanes replayed in full mode
CONFIG_RING_STEPS, CONFIG_FULL_LANES = 160, 64
# The netsim slice (K12-scan, K12-event, K13): bench.py's netsim_sweep
# (bench.py:312-350) and attack_sweep (:477-541) shapes and guards, the
# sweep widths and the fixture. The netsim sweep runs the activation
# delays of the JAX package's honest-network sweep
# (cpr_tpu/experiments/honest_net.py:43, DEFAULT_ACTIVATION_DELAYS),
# 1638 seeds each (8190 lanes). Every kernel is held to its plain version
# at its paths' shapes; the cases the paths do not run (random link
# delays, a lookback over 32, flooding, every scripted policy) are held
# at the shorter NET_EXTRA_ACTS, NET_FLOOD_* and ATK_EXTRA_*.
NETSIM_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_netsim_golden.npz"
NET_NODES, NET_ACT_DELAY, NET_PROP = 10, 30.0, 1.0
NET_LANES, NET_ACTS, NET_ORPHAN_GUARD = 96, 10000, (0.01, 0.06)
NET_SWEEP_DELAYS = (30.0, 60.0, 120.0, 300.0, 600.0)
NET_SWEEP_SEEDS = 1638
NET_EXTRA_ACTS, NET_FLOOD_LANES, NET_FLOOD_ACTS = 2000, 16, 60
NET_EVENT_GAP, NET_TIME_RTOL = 0.02, 1e-9
ATK_NODES, ATK_LANES, ATK_ACTS, ATK_GUARD = 4, 64, 1500, (0.28, 0.39)
ATK_ALPHAS = (0.15, 0.25, 0.33, 0.45)
ATK_POLICIES = ("honest", "sapirshtein-2016-sm1")
ATK_SWEEP_LANES, ATK_SWEEP_ACTS = 4096, 2000
# a release puts 3 entries a withheld block into clique-4's queue; at
# alpha 0.45 SM1 withholds chains of over 100 blocks (351 entries at once
# in the JAX package's run of seed 7, 1500 activations), beyond its
# default max(256, 32 N) = 256
ATK_QUEUE_CAP = 2048
ATK_EXTRA_ACTS, ATK_EXTRA_LANES = 300, 16
# The netsim's protocol branches (K12-event-bk, -eth, -spar) and the
# honest-network sweep on them (`experiments.honest_net_rows`, engine="jax",
# at the JAX package's defaults, cpr_tpu/experiments/honest_net.py:30-43,
# 188-207: the 10-node clique, propagation 1.0, 10 000 activations, seed 0
# at the five activation delays, the 8 default protocols), then Spar k=4
# under both schemes at the same shape (the Spar config of
# tests/test_netsim.py:416-420). Each kernel is held to its plain version
# on the sweep's five lanes: its first configuration at the full 10 000
# activations, the others at HN_PLAIN_ACTS; and to every case of its JAX
# fixture.
PROTO_FIXTURE = ROOT / "tests" / "fixtures" / \
    "torch_port_netsim_protocols_golden.npz"
HN_NODES, HN_ACTS, HN_PROP, HN_SEED = 10, 10000, 1.0, 0
HN_DELAYS = (30.0, 60.0, 120.0, 300.0, 600.0)
HN_SPAR = (("spar", {"k": 4, "scheme": "constant"}),
           ("spar", {"k": 4, "scheme": "block"}))
HN_PLAIN_ACTS = 2000
PROTO_CONFIGS = {
    "K12-event-bk": (("bk", 8, "constant"), ("bk", 4, "constant"),
                     ("bk", 8, "block")),
    "K12-event-eth": (("ethereum-whitepaper", 1, "constant"),
                      ("ethereum-byzantium", 1, "constant")),
    "K12-event-spar": (("spar", 4, "constant"), ("spar", 4, "block")),
}
PROTO_KERNELS = tuple(PROTO_CONFIGS)
PROTO_OUT_KEYS = ("head", "head_height", "progress", "on_chain", "sim_time",
                  "n_blocks", "n_act", "node_act", "reward", "steps",
                  "drop_q", "drop_p", "drop_b", "win_miss", "exhausted")


_START = time.perf_counter()


def say(phase, **kw):
    """One phase's line; `at_s` the seconds since the script started, so
    the log gives each phase's cost."""
    kw["at_s"] = round(time.perf_counter() - _START, 1)
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def ulp_distance(a, b):
    """ULP distance of two float32 tensors of equal sign."""
    return (a.contiguous().view(torch.int32).to(torch.int64)
            - b.contiguous().view(torch.int32).to(torch.int64)).abs().max()


def cuda_ms(fn, reps):
    """Mean device time of `fn` over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps, kernel):
    """Mean device time per launch of the CUDA kernel whose name contains
    `kernel` (a string, or a tuple of strings it must all contain), from
    torch.profiler's CUPTI trace of `reps` calls of `fn`.

    Before each call a fill of L2_SCRUB_BYTES leaves the L2 cache full of
    dirty lines of another buffer: the kernel reads its inputs from HBM
    and its writes evict lines that go back to HBM, as they would for a
    caller that did other work between calls. A trace that lost a
    launch record (the profiler once reported 2 of 3 launches) is taken
    again, twice at most; raises if it still does not hold every
    launch."""
    from torch.profiler import ProfilerActivity, profile
    scrub = torch.empty(L2_SCRUB_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    parts = (kernel,) if isinstance(kernel, str) else kernel
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                scrub.fill_(float(i))
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for ev in prof.key_averages():
            if all(p in ev.key for p in parts):
                total_us += getattr(ev, "device_time_total",
                                    getattr(ev, "cuda_time_total", 0.0))
                count += ev.count
        if count == reps and total_us > 0:
            break
        say("device_ms", kernel=json.dumps(parts), traced=count,
            expected=reps, retry=True)
    check(count == reps and total_us > 0,
          f"profiler trace holds {count} launches of *{kernel}*, "
          f"expected {reps}")
    return total_us / count / 1e3


def bound_ms(n_bytes, n_ops):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def compare_state(got, want, what, time_rtol=1e-5):
    """Integer fields and keys exact, float fields within rtol."""
    from cpr_tpu_torch.envs.nakamoto import INT_FIELDS, STATE_FIELDS
    err = 0.0
    for f in STATE_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if f in INT_FIELDS or f == "key":
            check(torch.equal(g, w), f"{what}: {f} differs")
        else:
            d = (g - w).abs()
            check(bool((d <= time_rtol * w.abs()).all()),
                  f"{what}: {f} beyond rtol {time_rtol}")
            err = max(err, float(d.max()))
    return err


def compare_outputs(got, want, what):
    """(obs, reward, done, info) of step_lanes: done/reward exact, obs
    atol 1e-6, info exact for integer-valued keys; time keys within
    1e-5 of the lane's clock (a step delta is a difference of two clock
    readings, so its error scales with the clock, not with the delta)."""
    from cpr_tpu_torch.envs.base import INFO_KEYS
    obs, reward, done, info = got
    wobs, wreward, wdone, winfo = want
    check(torch.equal(done, wdone), f"{what}: done differs")
    check(torch.equal(reward, wreward), f"{what}: reward differs")
    err = float((obs - wobs).abs().max()) if obs.numel() else 0.0
    check(err <= 1e-6, f"{what}: obs beyond atol 1e-6 ({err})")
    clock = winfo["episode_sim_time"].abs()
    for k in INFO_KEYS:
        g, w = info[k], winfo[k]
        if "time" in k:
            d = (g - w).abs()
            check(bool((d <= 1e-5 * (w.abs() + clock)).all()),
                  f"{what}: {k} beyond tolerance")
            err = max(err, float(d.max()))
        else:
            check(torch.equal(g, w), f"{what}: {k} differs")
    return err


def compare_stats(got, want, what):
    err = 0.0
    for k, w in want.items():
        g = got[k]
        if "time" in k:
            d = (g - w).abs()
            check(bool((d <= 1e-5 * w.abs()).all()),
                  f"{what}: {k} beyond rtol 1e-5")
            err = max(err, float(d.max()))
        else:
            check(torch.equal(g, w), f"{what}: {k} differs")
    return err


def plain_stats(env, keys, params, policy, n_steps):
    """The unchunked stats driver over the plain twin of K2
    (`stream_plain`), on whatever device `keys` lie."""
    from cpr_tpu_torch.envs.base import EPISODE_KEYS
    state, obs = env._stream_init(keys, params)
    sums, n_done, _ = env.stream_plain(clone_carry((state, obs)), params,
                                       policy, n_steps)
    nd = torch.clamp(n_done, min=1)
    stats = {k: sums[j] / nd for j, k in enumerate(EPISODE_KEYS)}
    stats["n_episodes"] = n_done
    return stats


def clone_carry(carry):
    from cpr_tpu_torch.envs.base import map_state
    return map_state(torch.clone, carry[0]), carry[1].clone()


def fixture_state(fx, prefix, dev):
    from cpr_tpu_torch import convert
    from cpr_tpu_torch.envs.nakamoto import STATE_FIELDS
    return convert.state_from_numpy(
        {f: fx[f"{prefix}{f}"] for f in STATE_FIELDS}, dev)


def phase_k1(dev, fx, report):
    from cpr_tpu_torch import random as rnd
    key0 = rnd.PRNGKey(0, dev)
    keys = rnd.split(key0, MAIN_LANES)
    check(torch.equal(keys, rnd.threefry_plain(key0, MAIN_LANES)),
          "K1 split differs from plain")
    folded = rnd.fold_in(keys, 7)
    check(torch.equal(folded, rnd.threefry_plain(keys, 1, 7)[:, 0]),
          "K1 fold_in differs from plain")
    n = 1 << 20
    u = rnd.uniform(key0, (n,))
    check(torch.equal(u, rnd.threefry_plain(key0, n, 0, rnd.MODE_UNIFORM)),
          "K1 uniform differs from plain")
    e = rnd.exponential(key0, (n,))
    e_plain = rnd.threefry_plain(key0, n, 0, rnd.MODE_EXPONENTIAL)
    ulps = int(ulp_distance(e, e_plain))
    check(ulps <= 2, f"K1 exponential {ulps} ULP from plain")
    err = float((e - e_plain).abs().max())
    # against jax (committed fixture)
    check(np.array_equal(rnd.to_numpy_words(rnd.split(key0, 4096)),
                         fx["k1_split"]), "K1 split differs from jax")
    check(np.array_equal(rnd.to_numpy_words(rnd.fold_in(key0, 7)),
                         fx["k1_fold_in"]), "K1 fold_in differs from jax")
    check(np.array_equal(rnd.uniform(rnd.PRNGKey(1, dev), (300,)).cpu()
                         .numpy(), fx["k1_uniform"]),
          "K1 uniform differs from jax")
    e_jax = torch.from_numpy(fx["k1_exponential"])
    ulps_jax = int(ulp_distance(
        rnd.exponential(rnd.PRNGKey(2, dev), (300,)).cpu(), e_jax))
    check(ulps_jax <= 4, f"K1 exponential {ulps_jax} ULP from jax")
    report["K1"]["max_abs_err"] = err
    say("k1", split=MAIN_LANES, draws=n, exp_ulp_vs_plain=ulps,
        exp_ulp_vs_jax=ulps_jax, ok=True)


def phase_k3(dev, fx):
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.base import INFO_KEYS
    from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
    from cpr_tpu_torch.params import make_params
    env = NakamotoSSZ()
    lanes, ticks = 4096, 128
    params = make_params(alpha=0.35, gamma=0.5, max_steps=32)
    rng = np.random.default_rng(1)
    carry = env.init_lanes(rnd.split(rnd.PRNGKey(11, dev), lanes), params)
    fresh = env.init_lanes(rnd.split(rnd.PRNGKey(12, dev), lanes), params)
    # the plain prologue on the card agrees with K2's init launch
    s_plain, o_plain = env._stream_init(rnd.split(rnd.PRNGKey(11, dev),
                                                  lanes), params)
    err = compare_state(carry[0], s_plain, "init_lanes")
    check(float((carry[1] - o_plain).abs().max()) <= 1e-6, "init obs")
    plain = clone_carry(carry)
    n_done = 0
    for t in range(ticks):
        actions = torch.from_numpy(
            rng.integers(0, 4, lanes).astype(np.int32)).to(dev)
        admit = torch.from_numpy(rng.random(lanes) < 0.05).to(dev)
        step = torch.from_numpy(rng.random(lanes) < 0.8).to(dev)
        _, out = env.step_lanes(carry, actions, admit, fresh, step, params)
        _, out_p = env.step_lanes_plain(plain, actions, admit, fresh, step,
                                        params)
        err = max(err, compare_outputs(out, out_p, f"K3 tick {t}"))
        err = max(err, compare_state(carry[0], plain[0], f"K3 tick {t}"))
        n_done += int(out[2].sum())
    check(n_done > 0, "K3 check never crossed an episode end")
    # against jax (committed fixture): replay the tick trace
    p3 = make_params(alpha=0.35, gamma=0.5, max_steps=16)
    keys = rnd.from_numpy_words(fx["k3_keys"], dev)
    carry = env.init_lanes(keys, p3)
    fresh = env.init_lanes(rnd.from_numpy_words(fx["k3_fresh_keys"], dev), p3)
    for t in range(fx["k3_actions"].shape[0]):
        cvt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        _, out = env.step_lanes(carry, cvt(fx["k3_actions"][t]),
                                cvt(fx["k3_admit"][t]), fresh,
                                cvt(fx["k3_step"][t]), p3)
        want = (cvt(fx["k3_out_obs"][t]), cvt(fx["k3_out_reward"][t]),
                cvt(fx["k3_out_done"][t]),
                {k: cvt(fx["k3_out_info"][t][i])
                 for i, k in enumerate(INFO_KEYS)})
        compare_outputs(out, want, f"K3 vs jax tick {t}")
    compare_state(carry[0], fixture_state(fx, "k3_final_", dev), "K3 vs jax")
    say("k3", lanes=lanes, ticks=ticks, episodes_ended=n_done,
        max_abs_err=err, ok=True)


def phase_k2(dev, fx):
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.base import INFO_KEYS
    from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
    from cpr_tpu_torch.params import make_params
    env = NakamotoSSZ()
    lanes, steps = 4096, 256
    params = make_params(alpha=0.35, gamma=0.5, max_steps=64)
    keys = rnd.split(rnd.PRNGKey(21, dev), lanes)
    err = 0.0
    for name in POLICIES:
        want = plain_stats(env, keys, params, name, steps)
        for chunk in (None, 100):
            got = env.make_episode_stats_fn(params, env.policies[name],
                                            steps, chunk=chunk)(keys)
            err = max(err, compare_stats(got, want, f"K2 {name} {chunk}"))
        check(int(want["n_episodes"].min()) >= 3,
              "K2 check did not cross episode ends")
    # rollout: the STORE_TRAJ variant against the plain trajectory
    n_roll = 64
    traj = env.rollout(keys[:512], params, "sapirshtein-2016-sm1", n_roll)
    state, obs = env._stream_init(keys[:512], params)
    carry = (state, obs)
    _, _, want = env.stream_plain(clone_carry(carry), params,
                                  "sapirshtein-2016-sm1", n_roll,
                                  with_sums=False, store_traj=True)
    obs_k, act_k, rew_k, done_k, info_k = traj
    obs_p, act_p, rew_p, done_p, info_p = want
    check(torch.equal(act_k, act_p), "rollout actions differ")
    check(torch.equal(done_k, done_p), "rollout done differs")
    check(torch.equal(rew_k, rew_p), "rollout reward differs")
    check(float((obs_k - obs_p).abs().max()) <= 1e-6, "rollout obs")
    for k in INFO_KEYS:
        if "time" not in k:
            check(torch.equal(info_k[k], info_p[k]), f"rollout {k}")
    # against jax (committed fixture)
    p2 = make_params(alpha=0.35, gamma=0.5, max_steps=50)
    fkeys = rnd.from_numpy_words(fx["k2_keys"], dev)
    for i, name in enumerate(POLICIES):
        got = env.make_episode_stats_fn(p2, name, 300)(fkeys)
        want = {k: torch.from_numpy(fx[f"k2_p{i}_{k}"]).to(dev)
                for k in got}
        compare_stats(got, want, f"K2 {name} vs jax")
    say("k2", lanes=lanes, steps=steps, policies=len(POLICIES),
        chunked=True, rollout=n_roll, max_abs_err=err, ok=True)


def path_launches(counts, ran, path):
    """Hold a path's launch counts to the kernels it runs: each of `ran`
    launched, every other kernel not at all."""
    for k, n in counts.items():
        if k in ran:
            check(n > 0, f"{k} never launched on the {path} path")
        else:
            check(n == 0, f"{k} launched {n} times on the {path} path")


def phase_stream(dev, report):
    """The episode-stream path at the bench's size, its launch counts,
    and the plain twin at the same shapes with the policy decoded from
    the unit observation, as the JAX package computes it."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.base import EPISODE_KEYS
    from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
    from cpr_tpu_torch.params import make_params
    env = NakamotoSSZ()
    params = make_params(alpha=0.35, gamma=0.5, max_steps=MAIN_MAX_STEPS)
    sm1 = env.policies["sapirshtein-2016-sm1"]

    kernels.reset_launches()
    keys = rnd.split(rnd.PRNGKey(0, dev), MAIN_LANES)
    fn = env.make_episode_stats_fn(params, sm1, MAIN_STEPS)
    stats = fn(keys)
    torch.cuda.synchronize()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        stats = fn(keys)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = dict(kernels.launches)
    path_launches(counts, ("K1", "K2"), "stream")
    atk = float(stats["episode_reward_attacker"].mean())
    dfn = float(stats["episode_reward_defender"].mean())
    rel = atk / (atk + dfn)
    check(all(torch.isfinite(stats[k]).all() for k in EPISODE_KEYS),
          "non-finite stats")
    check(SM1_GUARD[0] < rel < SM1_GUARD[1],
          f"SM1 relative revenue {rel} outside {SM1_GUARD}")
    n_episodes = int(stats["n_episodes"].sum())
    rate = MAIN_LANES * MAIN_STEPS / min(secs)
    say("stream", lanes=MAIN_LANES, steps=MAIN_STEPS, rel_revenue=rel,
        episodes=n_episodes, env_steps_per_s=rate, call_s=secs,
        launches=json.dumps(counts))

    # The plain twin on the same keys, the SM1 action decoded from the
    # observation each step (the JAX package's form; K2 reads the
    # integers). Equal stats show the two forms agreed on every step of
    # this run; the peak decoded fork length shows it stayed inside the
    # range where the decode is exact on the JAX package's side too.
    peak = torch.zeros((), dtype=torch.int32, device=dev)

    def sm1_decoded(obs):
        h, a, _, _ = env.decode_obs(obs)
        torch.maximum(peak, torch.maximum(a, h).max(), out=peak)
        return NakamotoSSZ._policy_ints(3, a, h)

    t0 = time.perf_counter()
    want = plain_stats(env, keys, params, sm1_decoded, MAIN_STEPS)
    torch.cuda.synchronize()
    report["K2"]["plain_ms"] = (time.perf_counter() - t0) * 1e3
    err = compare_stats(stats, want, "K2 vs plain at main shapes")
    fork_peak = int(peak)
    check(fork_peak < DECODE_EXACT,
          f"fork length {fork_peak} reached the inexact decode range")
    report["K2"]["max_abs_err"] = err
    say("stream_vs_plain", max_abs_err=err, fork_peak=fork_peak, ok=True)
    return counts, n_episodes


def phase_gym(dev, report):
    """The gym step path: resident lanes, one K3 launch per tick; its
    launch counts; then one more tick through K3 and its plain twin on
    copies of the carry."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
    from cpr_tpu_torch.params import make_params
    env = NakamotoSSZ()
    params = make_params(alpha=0.35, gamma=0.5, max_steps=MAIN_MAX_STEPS)
    sm1 = env.policies["sapirshtein-2016-sm1"]

    kernels.reset_launches()
    carry = env.reset_lanes(rnd.split(rnd.PRNGKey(1, dev), MAIN_LANES),
                            params)
    fresh = env.reset_lanes(rnd.split(rnd.PRNGKey(2, dev), MAIN_LANES),
                            params)
    no_admit = torch.zeros(MAIN_LANES, dtype=torch.bool, device=dev)
    step_all = torch.ones(MAIN_LANES, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick_done = 0
    for _ in range(MAIN_TICKS):
        actions = sm1(carry[1])
        _, (obs, reward, done, info) = env.step_lanes(
            carry, actions, no_admit, fresh, step_all, params)
        tick_done += done.sum()
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    counts = dict(kernels.launches)
    path_launches(counts, ("K1", "K2", "K3"), "gym")
    check(counts["K3"] == MAIN_TICKS, f"K3 launched {counts['K3']} times "
          f"in {MAIN_TICKS} ticks")
    check(bool(torch.isfinite(obs).all()), "non-finite step_lanes obs")
    say("gym", lanes=MAIN_LANES, ticks=MAIN_TICKS,
        ticks_per_s=MAIN_TICKS / tick_s,
        lane_steps_per_s=MAIN_TICKS * MAIN_LANES / tick_s,
        episodes_ended=int(tick_done), launches=json.dumps(counts))

    actions = sm1(carry[1])
    plain = clone_carry(carry)
    _, out = env.step_lanes(carry, actions, no_admit, fresh, step_all,
                            params)
    _, out_p = env.step_lanes_plain(plain, actions, no_admit, fresh,
                                    step_all, params)
    err = compare_outputs(out, out_p, "K3 vs plain at main shapes")
    err = max(err, compare_state(carry[0], plain[0],
                                 "K3 vs plain at main shapes"))
    report["K3"]["max_abs_err"] = err
    say("gym_vs_plain", max_abs_err=err, ok=True)
    return counts


def phase_times(dev, report, main_episodes):
    """Kernel and plain times at the main path's shapes (K2's plain time
    comes from `phase_stream`)."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
    from cpr_tpu_torch.params import make_params
    env = NakamotoSSZ()
    params = make_params(alpha=0.35, gamma=0.5, max_steps=MAIN_MAX_STEPS)
    pid = env.scripted_policy_id("sapirshtein-2016-sm1")
    key0 = rnd.PRNGKey(0, dev)
    L, T = MAIN_LANES, MAIN_STEPS

    k1, call_ms = report["K1"], {}
    split = lambda: rnd.split(key0, L)  # noqa: E731
    k1["ms"] = device_ms(split, 200, "threefry_kernel")
    call_ms["K1"] = cuda_ms(split, 200)
    k1["plain_ms"] = cuda_ms(lambda: rnd.threefry_plain(key0, L), 20)
    k1["bound_ms"], k1["bound_by"] = bound_ms(8 + 8 * L, L * THREEFRY_OPS)

    keys = rnd.split(key0, L)
    carry = env._empty_carry(L, dev)
    k2 = report["K2"]
    k2["ms"] = device_ms(lambda: env._kernel_stream(
        carry, keys, 1, T, params, pid, True, False), 3, "stream_kernel")
    # keys in; state, obs, sums and counts out; threefry work of the
    # prologue (split + reset), every step and every reset this run made
    k2_bytes = L * (8 + STATE_BYTES + OBS_BYTES + 7 * 4 + 4)
    k2_ops = THREEFRY_OPS * MINE_THREEFRY * (L * T + L + main_episodes) \
        + THREEFRY_OPS * L
    k2["bound_ms"], k2["bound_by"] = bound_ms(k2_bytes, k2_ops)

    carry = env.reset_lanes(keys, params)
    fresh = env.reset_lanes(rnd.split(rnd.PRNGKey(3, dev), L), params)
    actions = env.policies["sapirshtein-2016-sm1"](carry[1])
    no_admit = torch.zeros(L, dtype=torch.bool, device=dev)
    step_all = torch.ones(L, dtype=torch.bool, device=dev)
    _, (_, _, done, _) = env.step_lanes(carry, actions, no_admit, fresh,
                                        step_all, params)
    resets = int(done.sum())
    k3 = report["K3"]
    tick = lambda: env.step_lanes(  # noqa: E731
        carry, actions, no_admit, fresh, step_all, params)
    k3["ms"] = device_ms(tick, 100, "step_lanes_kernel")
    call_ms["K3"] = cuda_ms(tick, 100)
    k3["plain_ms"] = cuda_ms(lambda: env.step_lanes_plain(
        carry, actions, no_admit, fresh, step_all, params), 10)
    # carry state + obs, actions and both masks in; state, carry obs,
    # out obs, reward, done and info out (no lane admitted here)
    k3_bytes = L * (STATE_BYTES + OBS_BYTES + 4 + 1 + 1) \
        + L * (STATE_BYTES + 2 * OBS_BYTES + 4 + 1 + INFO_BYTES)
    k3_ops = THREEFRY_OPS * MINE_THREEFRY * (L + resets)
    k3["bound_ms"], k3["bound_by"] = bound_ms(k3_bytes, k3_ops)
    # ms: the kernel on the card, L2 scrubbed before each launch;
    # call_ms: one call of its Python wrapper (validation, allocation,
    # ctypes) back to back, by CUDA events
    say("times", **{k: json.dumps(
        {**{f: report[k][f] for f in ("ms", "plain_ms", "bound_ms",
                                      "bound_by")},
         "call_ms": call_ms.get(k)})
        for k in ("K1", "K2", "K3")})


def event_ms(fn, reps):
    """Mean device time of `fn` by CUDA events around each call, with
    the L2 cache scrubbed (as in device_ms) before each; for calls that
    launch several kernels or kernels of a library."""
    scrub = torch.empty(L2_SCRUB_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for i in range(reps):
        scrub.fill_(float(i))
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def mdp_revenue(tm, value, progress):
    return tm.start_value(value) / tm.start_value(progress)


def compile_fixture_model(model):
    """The fixture's two tables, compiled by the port."""
    from cpr_tpu_torch.mdp import Compiler, ptmdp
    from cpr_tpu_torch.mdp.generic import compile_native
    from cpr_tpu_torch.mdp.models import Fc16BitcoinSM
    if model == "fc16":
        table = Compiler(Fc16BitcoinSM(alpha=MDP_ALPHA, gamma=MDP_GAMMA,
                                       maximum_fork_length=20)).mdp()
    else:
        table = compile_native("ghostdag", k=2, alpha=MDP_ALPHA,
                               gamma=MDP_GAMMA, collect_garbage="simple",
                               dag_size_cutoff=6)
    return ptmdp(table, horizon=MDP_HORIZON)


def table_digest(mdp):
    """sha256 of the compiled columns and start distribution, as
    tests/test_torch_mdp_golden.py computes it."""
    import hashlib
    h = hashlib.sha256()
    for col in mdp.arrays():
        h.update(np.ascontiguousarray(col).tobytes())
    for s in sorted(mdp.start):
        h.update(np.array([s], np.int64).tobytes())
        h.update(np.array([mdp.start[s]], np.float64).tobytes())
    return np.frombuffer(h.digest(), np.uint8)


def phase_mdp_fixture(dev, mfx):
    """K4 and K5 on the fixture's tables against JAX's results."""
    from cpr_tpu_torch.mdp.explicit import vi_chunked
    worst = {"value": 0.0, "revenue": 0.0, "pe": 0.0, "iter_diff": 0}
    sweeps = {}
    for model in ("fc16", "gd6"):
        mdp = compile_fixture_model(model)
        check(np.array_equal(table_digest(mdp), mfx[f"{model}_digest"]),
              f"{model}: the native/Python compile differs from the "
              "fixture's table")
        for dt_name, dt in (("f32", torch.float32), ("f64", torch.float64)):
            tm = mdp.tensor(dt, device=dev)
            pre = f"{model}_{dt_name}_"
            gap = mfx[pre + "gap"]
            for tag, impl, accel in (("while", "while", 0),
                                     ("chunk0", "chunked", 0),
                                     ("chunk3", "chunked", 3)):
                if impl == "while":
                    vi = tm.value_iteration(stop_delta=MDP_STOP)
                    v, p, pol, it = (vi["vi_value"], vi["vi_progress"],
                                     vi["vi_policy"], vi["vi_iter"])
                else:
                    v, p, pol, delta, it, _ = vi_chunked(
                        tm, 1.0, tm._cast(MDP_STOP), MDP_ACCEL_CAP,
                        accel_m=accel)
                    v, p, pol = (x.cpu().numpy() for x in (v, p, pol))
                    check(delta <= tm._cast(MDP_STOP),
                          f"{model} {dt_name} {tag}: delta {delta} after "
                          f"{it} sweeps, above stop_delta {MDP_STOP}")
                what = f"{model} {dt_name} {tag}"
                sweeps[f"{model}_{dt_name}_{tag}"] = it
                # JAX's chunked impl has no float64 results (the
                # fixture's docstring): hold those to its while fixpoint
                ref = tag if pre + tag + "_iter" in mfx else "while"
                want_it = int(mfx[pre + ref + "_iter"])
                # with Anderson mixing the sweep count follows the mixing
                # weights' last bits (cuBLAS dots here), so only the
                # fixpoint is held
                if ref == tag and not accel:
                    check(it == want_it, f"{what}: {it} sweeps, JAX {want_it}")
                if ref == tag:
                    worst["iter_diff"] = max(worst["iter_diff"],
                                             abs(it - want_it))
                err = 0.0
                for got, want in ((v, mfx[pre + ref + "_value"]),
                                  (p, mfx[pre + ref + "_progress"])):
                    d = np.abs(got - want)
                    check(bool((d <= 1e-4 + 1e-5 * np.abs(want)).all()),
                          f"{what}: values beyond atol 1e-4 + rtol 1e-5 "
                          f"({float(d.max())})")
                    err = max(err, float(d.max()))
                sure = gap > 1e-4
                check(np.array_equal(pol[sure],
                                     mfx[pre + ref + "_policy"][sure]),
                      f"{what}: policy differs where JAX's Q-gap > 1e-4")
                rev = mdp_revenue(tm, v, p)
                rev_jax = mdp_revenue(tm, mfx[pre + ref + "_value"],
                                      mfx[pre + ref + "_progress"])
                check(abs(rev - rev_jax) <= 1e-5,
                      f"{what}: revenue {rev} vs JAX {rev_jax}")
                worst["value"] = max(worst["value"], err)
                worst["revenue"] = max(worst["revenue"], abs(rev - rev_jax))
            pe = tm.policy_evaluation(mfx[pre + "while_policy"],
                                      theta=MDP_STOP)
            err = max(float(np.abs(pe["pe_reward"] - mfx[pre + "pe_reward"])
                            .max()),
                      float(np.abs(pe["pe_progress"]
                                   - mfx[pre + "pe_progress"]).max()))
            check(err <= 1e-4, f"{model} {dt_name} PE beyond atol 1e-4")
            check(pe["pe_iter"] == int(mfx[pre + "pe_iter"]),
                  f"{model} {dt_name} PE: {pe['pe_iter']} sweeps, JAX "
                  f"{int(mfx[pre + 'pe_iter'])}")
            worst["pe"] = max(worst["pe"], err)
    say("mdp_fixture", models="fc16,gd6", dtypes="f32,f64",
        impls="while,chunked0,chunked3",
        **{f"max_{k}": v for k, v in worst.items()},
        sweeps=json.dumps(sweeps), ok=True)


def q_planes(tm, discount, value):
    """The plain twin's qv [S, A] plane for one input."""
    S, A = tm.n_states, tm.n_actions
    seg = tm.src.to(torch.int64) * A + tm.act
    z = torch.zeros(S * A, dtype=tm.prob.dtype, device=tm.device)
    qv = z.index_add(0, seg, tm.prob * (tm.reward + discount * value[tm.dst]))
    return qv.reshape(S, A)


def sure_states(valid, qv, rtol):
    """States whose best valid action beats the second by more than
    rtol * (1 + |best|): where a rounding difference cannot flip the
    argmax."""
    q = torch.where(valid, qv, float("-inf"))
    top = torch.topk(q, min(2, q.shape[1]), dim=1).values
    second = top[:, 1] if top.shape[1] > 1 else torch.full_like(
        top[:, 0], float("-inf"))
    return (top[:, 0] - second) > rtol * (1 + top[:, 0].abs())


def hold_k4_to_plain(tm, sweeps, rtol=1e-5):
    """`sweeps` K4 sweeps from zero, each also run by the plain twin
    from the kernel's input; returns the largest difference."""
    from cpr_tpu_torch.mdp import explicit as E
    step = E._vi_chunk_cuda(tm, 1.0)
    mask = tm.valid_actions()
    z = torch.zeros(tm.n_states, dtype=tm.prob.dtype, device=tm.device)
    v, p, err = z, z.clone(), 0.0
    for j in range(sweeps):
        kv, kp, kpol, _ = step(v, p, 1)
        pv, pp, ppol = E._plain_sweep(tm, mask, 1.0, v, p)
        # V is a max over the actions' sums, so it moves no more than
        # their rounding wherever the argmax falls; progress and policy
        # follow the argmax, so they are held where no near-tie can flip it
        dv = (kv - pv).abs()
        check(bool((dv <= rtol * (1 + pv.abs())).all()),
              f"K4 sweep {j}: value beyond rtol {rtol} of its plain twin")
        sure = sure_states(mask[0], q_planes(tm, 1.0, v), rtol)
        dp = (kp - pp).abs()[sure]
        check(bool((dp <= rtol * (1 + pp[sure].abs())).all()),
              f"K4 sweep {j}: progress beyond rtol {rtol} of its plain twin")
        check(torch.equal(kpol[sure], ppol[sure]),
              f"K4 sweep {j}: policy differs from its plain twin")
        err = max(err, float(dv.max()),
                  float(dp.max()) if dp.numel() else 0.0)
        v, p = kv, kp
    return err


def hold_k5_to_plain(tm, policy, sweeps, rtol=1e-5):
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.mdp import explicit as E
    from cpr_tpu_torch.mdp.explicit import _Ctl
    S, dt, dev = tm.n_states, tm.prob.dtype, tm.device
    r, p, err = torch.zeros(S, dtype=dt, device=dev), \
        torch.zeros(S, dtype=dt, device=dev), 0.0
    for j in range(sweeps):
        c = _Ctl(dt, dev, 0)
        rb, pb = [r, torch.empty_like(r)], [p, torch.empty_like(p)]
        kernels.pe_sweeps(tm, policy, 1.0, rb, pb, c.ctl, c.delta, 0, 1,
                          theta=float("-inf"), max_iter=1 << 30)
        pr, pp = E._pe_sweep(tm, policy, 1.0, r, p)
        d = torch.maximum((rb[1] - pr).abs(), (pb[1] - pp).abs())
        check(bool((d <= rtol * (1 + pr.abs() + pp.abs())).all()),
              f"K5 sweep {j} beyond rtol {rtol} of its plain twin")
        err = max(err, float(d.max()))
        r, p = rb[1], pb[1]
    return err


def phase_mdp_main(dev, report):
    """The exact-analysis path at the capstone's size, its launch counts,
    then K4 and K5 against their plain twins at its shapes."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.mdp import ptmdp
    from cpr_tpu_torch.mdp.explicit import vi_chunked
    from cpr_tpu_torch.mdp.generic import compile_native

    kernels.reset_launches()
    t0 = time.perf_counter()
    table = compile_native("ghostdag", k=2, alpha=MDP_ALPHA, gamma=MDP_GAMMA,
                           collect_garbage="simple",
                           dag_size_cutoff=MDP_CUTOFF)
    compile_s = time.perf_counter() - t0
    mdp = ptmdp(table, horizon=MDP_HORIZON)
    pt_s = time.perf_counter() - t0 - compile_s
    t0 = time.perf_counter()
    tm = mdp.tensor(device=dev)  # host to device, then the segment sort
    torch.cuda.synchronize()
    tensor_s = time.perf_counter() - t0
    S, A, T = tm.n_states, tm.n_actions, mdp.n_transitions
    table_bytes = sum(x.nbytes for x in vars(tm).values()
                      if isinstance(x, torch.Tensor))
    say("mdp_compile", cutoff=MDP_CUTOFF, states=S, actions=A, rows=T,
        segments=tm.n_segments, compile_s=compile_s, ptmdp_s=pt_s,
        tensor_s=tensor_s, table_bytes=table_bytes)

    t0 = time.perf_counter()
    vi = tm.value_iteration(stop_delta=MDP_STOP)
    vi_s = time.perf_counter() - t0
    rev = mdp_revenue(tm, vi["vi_value"], vi["vi_progress"])
    check(np.isfinite(vi["vi_value"]).all() and
          np.isfinite(vi["vi_progress"]).all(), "non-finite VI values")
    check(abs(rev - MDP_REVENUE) <= MDP_REVENUE_TOL,
          f"revenue {rev} beyond {MDP_REVENUE_TOL} of {MDP_REVENUE}")
    t0 = time.perf_counter()
    v, p, _, delta_c, it_c, _ = vi_chunked(
        tm, 1.0, tm._cast(MDP_STOP), MDP_ACCEL_CAP, chunk=MDP_CHUNK,
        accel_m=3)
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    check(delta_c <= tm._cast(MDP_STOP),
          f"chunked solve: delta {delta_c} after {it_c} sweeps")
    rev_c = mdp_revenue(tm, v, p)
    check(abs(rev_c - rev) <= 1e-5,
          f"chunked revenue {rev_c} vs while {rev}")
    t0 = time.perf_counter()
    pe = tm.policy_evaluation(vi["vi_policy"], theta=MDP_STOP)
    pe_s = time.perf_counter() - t0
    rev_pe = mdp_revenue(tm, pe["pe_reward"], pe["pe_progress"])
    check(abs(rev_pe - rev) <= 1e-5, f"PE revenue {rev_pe} vs VI {rev}")
    t0 = time.perf_counter()
    again = tm.value_iteration(stop_delta=MDP_STOP)
    timed_s = time.perf_counter() - t0
    check(again["vi_iter"] == vi["vi_iter"] and np.array_equal(
        again["vi_value"], vi["vi_value"]), "VI is not deterministic")
    counts = dict(kernels.launches)
    path_launches(counts, ("K4", "K5"), "mdp")
    check(counts["K4"] >= 2 * vi["vi_iter"] + it_c,
          f"K4 launched {counts['K4']} times for {2 * vi['vi_iter'] + it_c}"
          " sweeps")
    say("mdp", revenue=rev, revenue_chunked=rev_c, revenue_pe=rev_pe,
        vi_iter=vi["vi_iter"], vi_delta=vi["vi_delta"], vi_s=vi_s,
        chunked_iter=it_c, chunked_delta=delta_c, chunked_s=chunked_s, pe_iter=pe["pe_iter"],
        pe_s=pe_s, timed_vi_s=timed_s,
        vi_sweeps_per_s=vi["vi_iter"] / timed_s,
        launches=json.dumps(counts))

    pol = torch.from_numpy(vi["vi_policy"]).to(dev)
    report["K4"]["max_abs_err"] = hold_k4_to_plain(tm, MDP_TWIN_SWEEPS)
    report["K5"]["max_abs_err"] = hold_k5_to_plain(tm, pol, MDP_TWIN_SWEEPS)
    say("mdp_vs_plain", sweeps=MDP_TWIN_SWEEPS,
        k4_max_abs_err=report["K4"]["max_abs_err"],
        k5_max_abs_err=report["K5"]["max_abs_err"], ok=True)
    return counts, tm, pol, table, rev


def phase_mdp_battery(dev):
    """measure_rows on the default battery; its own launch counts."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.experiments import measure_rows, model_battery
    kernels.reset_launches()
    t0 = time.perf_counter()
    rows = measure_rows(model_battery(alphas=BATTERY_ALPHAS,
                                      gamma=MDP_GAMMA),
                        horizon=MDP_HORIZON, stop_delta=MDP_STOP,
                        device=dev)
    secs = time.perf_counter() - t0
    counts = dict(kernels.launches)
    path_launches(counts, ("K4",), "measure_rows")
    for row in rows:
        print("[battery_row] " + json.dumps(row), flush=True)
        alpha = float(row["model"].rsplit("-", 1)[1])
        check("skipped" not in row, f"{row['model']} skipped")
        check(row["revenue"] >= alpha - 1e-4,
              f"{row['model']}: revenue {row['revenue']} below alpha")
    say("battery", rows=len(rows), seconds=secs,
        launches=json.dumps(counts), ok=True)


def csr_yardstick(tm, rows_mask=None, n_rows=None, row_of=None):
    """A torch CSR matrix of the rows' probabilities: [n_rows, S] with
    row index `row_of` per kept row (rows sorted by it)."""
    keep = (torch.ones_like(tm.dst, dtype=torch.bool) if rows_mask is None
            else rows_mask)
    r = row_of[keep]
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=tm.device)
    crow[1:] = torch.cumsum(torch.bincount(r, minlength=n_rows), 0)
    with warnings.catch_warnings():  # "beta" and invariant-check notes
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow.to(torch.int32),
                                       tm.dst[keep].contiguous(),
                                       tm.prob[keep].contiguous(),
                                       size=(n_rows, tm.n_states),
                                       check_invariants=False)


def phase_mdp_times(dev, report, tm, pol):
    """K4 and K5 device times at the capstone's shapes, their plain
    twins', the library yardstick and the bounds."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.mdp import explicit as E
    S, A, dt = tm.n_states, tm.n_actions, tm.prob.dtype
    T, item = int(tm.prob.shape[0]), tm.prob.element_size()
    v = [torch.rand(S, dtype=dt, device=dev), torch.empty(S, dtype=dt,
                                                          device=dev)]
    p = [torch.rand(S, dtype=dt, device=dev), torch.empty_like(v[1])]
    polbuf = torch.empty(S, dtype=torch.int32, device=dev)
    c = E._Ctl(dt, dev, 0)
    k4 = report["K4"]
    k4["ms"] = device_ms(lambda: kernels.vi_sweeps(
        tm, 1.0, v, p, polbuf, c.ctl, c.delta, None, 0, 0, 1,
        stop_delta=0.0, max_iter=1 << 62, can_stop=False), 50,
        "vi_sweep_kernel")
    mask = tm.valid_actions()
    k4["plain_ms"] = event_ms(
        lambda: E._plain_sweep(tm, mask, 1.0, v[0], p[0]), 5)
    seg = tm.src.to(torch.int64) * A + tm.act
    spmv = csr_yardstick(tm, n_rows=S * A, row_of=seg)
    k4["library_ms"] = event_ms(lambda: spmv @ v[0], 20)
    # every row once (dst + prob, reward, progress), the segment offsets
    # (state_seg, seg_ptr), V and P read once; V', P' and the policy out
    k4_bytes = (T * (4 + 3 * item) + 4 * (S + 1) + 4 * (tm.n_segments + 1)
                + 2 * S * item + 2 * S * item + 4 * S)
    k4["bound_ms"], k4["bound_by"] = bound_ms(k4_bytes, 8 * T)

    on = pol.to(torch.int64)[tm.src.to(torch.int64)] == tm.act
    t_on = int(on.sum())
    r = [torch.rand(S, dtype=dt, device=dev), torch.empty_like(v[1])]
    k5 = report["K5"]
    k5["ms"] = device_ms(lambda: kernels.pe_sweeps(
        tm, pol, 1.0, r, p, c.ctl, c.delta, 0, 1, theta=float("-inf"),
        max_iter=1 << 62), 50, "pe_sweep_kernel")
    k5["plain_ms"] = event_ms(lambda: E._pe_sweep(tm, pol, 1.0, r[0], p[0]),
                              5)
    spmv_on = csr_yardstick(tm, rows_mask=on, n_rows=S,
                            row_of=tm.src.to(torch.int64))
    k5["library_ms"] = event_ms(lambda: spmv_on @ r[0], 20)
    # the on-policy rows once, the segment offsets, the policy, R and P
    # read once; R' and P' out
    k5_bytes = (t_on * (4 + 3 * item) + 4 * (S + 1)
                + 4 * (tm.n_segments + 1) + 4 * S + 2 * S * item
                + 2 * S * item)
    k5["bound_ms"], k5["bound_by"] = bound_ms(k5_bytes, 8 * t_on)
    say("mdp_times", rows=T, on_policy_rows=t_on, **{k: json.dumps(
        {f: report[k][f] for f in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by")})
        for k in ("K4", "K5")})


# -- grid VI (K7) and RTDP (K6) ----------------------------------------------


def run_fixture_case(tm, gfx, name):
    """One RTDP case of the grid/RTDP fixture on `tm`'s device (K6 on the
    card): its options come from the fixture's "r_<name>_args"."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.mdp.explicit import _rtdp_walk
    a = dict(zip(GOLDEN_ARGS, gfx[f"r_{name}_args"].tolist()))
    graph = bool(a["graph"])
    v0 = p0 = None
    if a["warm"]:
        vi = tm.value_iteration(stop_delta=1e-3)
        v0, p0 = vi["vi_value"], vi["vi_progress"]
    return graph, _rtdp_walk(
        tm, rnd.PRNGKey(int(a["seed"]), device="cpu"), graph=graph,
        max_steps=int(a["steps"]), batch=int(a["batch"]),
        cap=int(a["cap"]) if graph else 0, eps=a["eps"],
        restart_p=a["restart_p"], discount=a["discount"],
        stop_delta=a["stop_delta"], decay=a["decay"], value0=v0, prog0=p0)


def phase_grid_fixture(dev, gfx):
    """K7 and K6 against the JAX fixture tests/fixtures/
    torch_port_grid_rtdp_golden.npz: the grid solve bit for bit, each
    RTDP case's visits, buffer ids and steps exactly and V/P within
    1e-6."""
    import hashlib

    from cpr_tpu_torch.mdp import Compiler, ptmdp
    from cpr_tpu_torch.mdp.grid import (compile_protocol,
                                        grid_value_iteration, param_ptmdp)
    from cpr_tpu_torch.mdp.models import Fc16BitcoinSM

    def digest(*arrays):
        h = hashlib.sha256()
        for x in arrays:
            h.update(np.ascontiguousarray(x).tobytes())
        return np.frombuffer(h.digest(), np.uint8)

    pm = param_ptmdp(compile_protocol("fc16", cutoff=6), horizon=30)
    check(np.array_equal(digest(*pm.mdp.arrays(), pm.coef, pm.expo,
                                pm.start_ids, pm.start_coef, pm.start_expo),
                         gfx["g_digest"]),
          "grid fixture: the port's parametric compile differs")
    vi = grid_value_iteration(pm, (0.25, 0.35), (0.25, 0.75),
                              stop_delta=MDP_STOP, chunk=64, device=dev)
    for k, want in (("grid_value", "g_value"), ("grid_progress",
                                                 "g_progress"),
                    ("grid_policy", "g_policy"), ("grid_iter", "g_iter"),
                    ("vi_residuals", "g_residuals"),
                    ("grid_revenue", "g_revenue")):
        check(np.array_equal(vi[k], gfx[want]),
              f"K7 grid solve: {k} differs from JAX's")
    check(vi["vi_iter"] == int(gfx["g_vi_iter"]), "K7: sweep count differs")
    mdp = ptmdp(Compiler(Fc16BitcoinSM(alpha=0.3, gamma=0.5,
                                       maximum_fork_length=6)).mdp(),
                horizon=20)
    check(np.array_equal(digest(*mdp.arrays()), gfx["r_digest"]),
          "RTDP fixture: the port's compile differs")
    tm = mdp.tensor(device=dev)
    err, cases = 0.0, sorted(k[2:-5] for k in gfx if k.endswith("_args"))
    for name in cases:
        graph, r = run_fixture_case(tm, gfx, name)
        pre = f"r_{name}_"
        for k in ("V", "P"):
            d = float(np.abs(r[k].cpu().numpy() - gfx[pre + k]).max())
            check(d <= 1e-6, f"K6 {name}: {k} {d} from JAX's")
            err = max(err, d)
        if graph:
            for k in ("visits", "buf_s"):
                check(np.array_equal(r[k].cpu().numpy(), gfx[pre + k]),
                      f"K6 {name}: {k} differs from JAX's")
            check(r["t"] == int(gfx[pre + "t"]), f"K6 {name}: steps differ")
    say("grid_fixture", grid_points=len(vi["grid_points"]),
        grid_sweeps=vi["vi_iter"], rtdp_cases=len(cases),
        rtdp_max_abs_err=err, ok=True)


def q_plane(tm, prob, discount, value):
    """The plain twin's qv [S, A] plane for one input and column."""
    S, A = tm.n_states, tm.n_actions
    seg = tm.src.to(torch.int64) * A + tm.act
    z = torch.zeros(S * A, dtype=prob.dtype, device=tm.device)
    qv = z.index_add(0, seg, prob * (tm.reward + discount * value[tm.dst]))
    return qv.reshape(S, A)


def hold_k7_to_plain(tm, probs, sweeps, rtol=1e-5):
    """`sweeps` K7 sweeps of every point from zero, each also run by the
    plain twin from the kernel's input: V everywhere within rtol, P and
    the policy where the twin's Q-gap exceeds it (as hold_k4_to_plain)."""
    from cpr_tpu_torch.mdp import explicit as E
    G, S = probs.shape[0], tm.n_states
    step = E._grid_chunk_cuda(tm, probs, 1.0)
    twin = E._grid_chunk_plain(tm, probs, 1.0)
    masks = [E._valid_actions(tm.src, tm.act, probs[g], S, tm.n_actions)
             for g in range(G)]
    z = torch.zeros((G, S), dtype=probs.dtype, device=tm.device)
    carry = (z, z.clone(), torch.full((G, S), -1, dtype=torch.int32,
                                      device=tm.device))
    frozen = torch.zeros(G, dtype=torch.bool, device=tm.device)
    err = 0.0
    for j in range(sweeps):
        (kv, kp, kpol), _ = step(carry, frozen, 1)
        (pv, pp, ppol), _ = twin(carry, frozen, 1)
        dv = (kv - pv).abs()
        check(bool((dv <= rtol * (1 + pv.abs())).all()),
              f"K7 sweep {j}: value beyond rtol {rtol} of its plain twin")
        for g in range(G):
            sure = sure_states(masks[g][0],
                               q_plane(tm, probs[g], 1.0, carry[0][g]), rtol)
            dp = (kp[g] - pp[g]).abs()[sure]
            check(bool((dp <= rtol * (1 + pp[g][sure].abs())).all()),
                  f"K7 sweep {j} point {g}: progress beyond rtol {rtol}")
            check(torch.equal(kpol[g][sure], ppol[g][sure]),
                  f"K7 sweep {j} point {g}: policy differs from its twin")
            if dp.numel():
                err = max(err, float(dp.max()))
        err = max(err, float(dv.max()))
        carry = (kv, kp, kpol)
    return err


def phase_grid(dev, report, pm_future, table, capstone_rev):
    """The grid path at the capstone's size: the parametric cutoff-8
    compile (started beside the other phases), its parity with the
    capstone's own compile, the 12-point grid solve on K7 and its
    checks, the corners against solo K4 solves, the cached grid solve at
    cutoff 7 (a miss, then a hit); then K7 against its plain twin."""
    import os
    import tempfile

    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.mdp.explicit import MDP, vi_chunked
    from cpr_tpu_torch.mdp.grid import (check_revalue_parity,
                                        grid_value_iteration, param_ptmdp,
                                        solve_grid_cached)

    pm0, compile_s = pm_future.result()
    kernels.reset_launches()
    check(check_revalue_parity(pm0, lambda a, g: table,
                               [(MDP_ALPHA, MDP_GAMMA)]) == 1,
          "revalue parity")
    pm = param_ptmdp(pm0, horizon=MDP_HORIZON)
    t0 = time.perf_counter()
    vi = grid_value_iteration(pm, GRID_ALPHAS, GRID_GAMMAS,
                              stop_delta=MDP_STOP, chunk=GRID_CHUNK,
                              protocol="ghostdag", cutoff=MDP_CUTOFF,
                              device=dev)
    grid_s = time.perf_counter() - t0
    rev = vi["grid_revenue"].reshape(len(GRID_ALPHAS), len(GRID_GAMMAS))
    check(bool(vi["grid_converged"].all()), "a grid point did not converge")
    check(np.isfinite(vi["grid_value"]).all(), "non-finite grid values")
    at = (GRID_ALPHAS.index(MDP_ALPHA), GRID_GAMMAS.index(MDP_GAMMA))
    check(abs(rev[at] - capstone_rev) <= 1e-5,
          f"grid revenue {rev[at]} at the capstone point vs {capstone_rev}")
    for i, a in enumerate(GRID_ALPHAS):
        check(bool((rev[i] >= a - 1e-4).all()),
              f"grid revenue below alpha {a}: {rev[i]}")
    # nondecreasing in alpha and in gamma, to GRID_MONOTONE_TOL: where
    # the optimum is honest the revenue is flat up to the solve's error
    check(bool((np.diff(rev, axis=0) >= -GRID_MONOTONE_TOL).all()
               and (np.diff(rev, axis=1) >= -GRID_MONOTONE_TOL).all()),
          f"grid revenue not monotone: {rev.tolist()}")
    src, act, dst, _, reward, progress = pm.mdp.arrays()
    corners = {}
    for a, g in GRID_CORNERS:
        gi = vi["grid_points"].index((a, g))
        tm = MDP(n_states=pm.n_states, n_actions=pm.mdp.n_actions,
                 start=dict(pm.mdp.start), src=src, act=act, dst=dst,
                 prob=pm.revalue(a, g), reward=reward,
                 progress=progress).tensor(device=dev)
        v, p, pol, _, it, _ = vi_chunked(tm, 1.0, tm._cast(MDP_STOP),
                                         1 << 30, chunk=GRID_CHUNK)
        check(np.array_equal(v.cpu().numpy(), vi["grid_value"][gi])
              and np.array_equal(p.cpu().numpy(), vi["grid_progress"][gi])
              and np.array_equal(pol.cpu().numpy(), vi["grid_policy"][gi])
              and it == int(vi["grid_iter"][gi]),
              f"grid point {(a, g)} differs from its solo K4 solve")
        corners[f"{a},{g}"] = it
        del tm
    with tempfile.TemporaryDirectory() as cache:
        os.environ["CPR_MDP_CACHE"] = cache
        kw = dict(cutoff=GRID_CACHE_CUTOFF, alphas=GRID_ALPHAS,
                  gammas=GRID_GAMMAS, horizon=MDP_HORIZON,
                  stop_delta=MDP_STOP, k=2, native=True, device=dev)
        t0 = time.perf_counter()
        miss = solve_grid_cached("ghostdag", **kw)
        miss_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hit = solve_grid_cached("ghostdag", **kw)
        hit_s = time.perf_counter() - t0
        del os.environ["CPR_MDP_CACHE"]
    check(not miss["cached"] and hit["cached"]
          and hit["integrity"] == "verified"
          and hit["revenue"] == miss["revenue"]
          and all(miss["converged"]), "cached grid solve: miss then hit")
    counts = dict(kernels.launches)
    path_launches(counts, ("K4", "K7"), "grid")
    say("grid", cutoff=MDP_CUTOFF, points=len(vi["grid_points"]),
        states=pm.n_states, rows=pm.n_transitions,
        param_compile_s=compile_s, grid_solve_s=grid_s,
        sweeps=vi["vi_iter"], conv_iter=json.dumps(
            [int(i) for i in vi["grid_iter"]]),
        revenue=json.dumps(rev.round(8).tolist()),
        corner_sweeps=json.dumps(corners),
        cache_cutoff=GRID_CACHE_CUTOFF, cache_miss_s=miss_s,
        cache_hit_s=hit_s, launches=json.dumps(counts))

    T = int(pm.mdp.n_transitions)
    tm = pm.mdp.tensor(device=dev)
    probs = tm.sort_rows(torch.from_numpy(np.stack(
        [pm.revalue(a, g) for a, g in vi["grid_points"]])).to(
            torch.float32))
    report["K7"]["max_abs_err"] = hold_k7_to_plain(tm, probs,
                                                   MDP_TWIN_SWEEPS)
    say("grid_vs_plain", sweeps=MDP_TWIN_SWEEPS, points=probs.shape[0],
        rows=T, k7_max_abs_err=report["K7"]["max_abs_err"], ok=True)
    return counts, tm, probs


def hold_k6_to_plain(tm, key, steps, graph, rtol=1e-6):
    """`steps` K6 steps at the main shapes against the plain twin from
    the same key on the card: visits, walker states and buffer ids
    exactly, V/P within rtol relative."""
    from cpr_tpu_torch.mdp import explicit as E
    args = dict(graph=graph, max_steps=steps, batch=RTDP_BATCH,
                cap=RTDP_BUFFER if graph else 0, eps=RTDP_EPS,
                restart_p=RTDP_RESTART_P, discount=1.0,
                stop_delta=RTDP_STOP, decay=0.95)
    got = E._rtdp_walk(tm, key, **args)
    z = torch.zeros(tm.n_states, dtype=torch.float32, device=tm.device)
    want = E._rtdp_plain(tm, key.reshape(2).cpu(), z, z.clone(),
                         E.start_cdf(tm), **args)
    what = f"K6 {'graph' if graph else 'scan'}"
    for k in ("visits", "s") + (("buf_s",) if graph else ()):
        check(torch.equal(got[k], want[k]),
              f"{what}: {k} differs from its plain twin")
    err = 0.0
    for k in ("V", "P"):
        d = (got[k] - want[k]).abs()
        check(bool((d <= rtol * (1 + want[k].abs())).all()),
              f"{what}: {k} beyond rtol {rtol} of its plain twin")
        err = max(err, float(d.max()))
    return err


def phase_rtdp(dev, report, tm, capstone_rev):
    """The RTDP path on the capstone table: rtdp_graph and the scan
    walkers (K6), then the chunked solve warm-started from the graph
    walk's table (K4) against a cold one; then K6 against its twin."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.mdp.explicit import make_vi_chunk, run_chunk_driver
    from cpr_tpu_torch.mdp.rtdp_graph import rtdp_graph

    def revenue(v, p):
        return tm.start_value(v) / tm.start_value(p)

    kernels.reset_launches()
    key = rnd.PRNGKey(RTDP_SEED, device="cpu")  # K6 reads its words
    t0 = time.perf_counter()
    g = rtdp_graph(tm, key, max_steps=RTDP_STEPS, batch=RTDP_BATCH,
                   buffer=RTDP_BUFFER, eps=RTDP_EPS,
                   restart_p=RTDP_RESTART_P, stop_delta=RTDP_STOP)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc = tm.rtdp(rnd.fold_in(key, 1), steps=RTDP_STEPS, batch=RTDP_BATCH,
                 eps=RTDP_EPS)
    scan_s = time.perf_counter() - t0
    for r in (g, sc):
        check(np.isfinite(r["rtdp_value"]).all()
              and np.isfinite(r["rtdp_progress"]).all(),
              "non-finite RTDP values")
    check(g["rtdp_steps"] == RTDP_STEPS
          and int(g["rtdp_visits"].sum()) == RTDP_STEPS * RTDP_BATCH,
          "rtdp_graph: steps or visits")
    step = make_vi_chunk(tm, 1.0)
    stop = tm._cast(MDP_STOP)
    warm = run_chunk_driver(step, tm.n_states, torch.float32, stop, 1 << 30,
                            chunk=GRID_CHUNK, value0=g["rtdp_value"],
                            prog0=g["rtdp_progress"], device=dev)
    cold = run_chunk_driver(step, tm.n_states, torch.float32, stop, 1 << 30,
                            chunk=GRID_CHUNK, device=dev)
    rev_warm, rev_cold = revenue(warm[0], warm[1]), revenue(cold[0], cold[1])
    check(warm[3] <= stop and cold[3] <= stop, "a polish did not converge")
    check(abs(rev_warm - rev_cold) <= 1e-5 and
          abs(rev_cold - capstone_rev) <= 1e-5,
          f"warm polish revenue {rev_warm}, cold {rev_cold}")
    counts = dict(kernels.launches)
    path_launches(counts, ("K4", "K6"), "rtdp")
    say("rtdp", steps=RTDP_STEPS, batch=RTDP_BATCH, buffer=RTDP_BUFFER,
        eps=RTDP_EPS, graph_revenue=revenue(g["rtdp_value"],
                                            g["rtdp_progress"]),
        scan_revenue=revenue(sc["rtdp_value"], sc["rtdp_progress"]),
        visited=int((g["rtdp_visits"] > 0).sum()), states=tm.n_states,
        graph_s=graph_s, graph_ms_per_step=graph_s / RTDP_STEPS * 1e3,
        scan_s=scan_s, scan_ms_per_step=scan_s / RTDP_STEPS * 1e3,
        warm_sweeps=warm[4], cold_sweeps=cold[4], revenue_warm=rev_warm,
        revenue_cold=rev_cold, launches=json.dumps(counts))
    report["K6"]["max_abs_err"] = max(
        hold_k6_to_plain(tm, key, MDP_TWIN_SWEEPS, True),
        hold_k6_to_plain(tm, key, MDP_TWIN_SWEEPS, False))
    say("rtdp_vs_plain", steps=MDP_TWIN_SWEEPS,
        k6_max_abs_err=report["K6"]["max_abs_err"], ok=True)
    return counts


def phase_grid_rtdp_times(dev, report, tm, probs):
    """K7 device time per grid sweep at G points, K6 per launch of
    RTDP_TIMED_STEPS steps (and per step), their twins', K7's library
    yardstick (G SpMVs) and both bounds."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.mdp import explicit as E
    G, S, T = probs.shape[0], tm.n_states, int(tm.prob.shape[0])
    n_seg = tm.n_segments
    valid = E.grid_valid_segments(tm, probs)
    live = torch.arange(G, dtype=torch.int32, device=dev)
    v = [torch.rand((G, S), device=dev), torch.empty((G, S), device=dev)]
    p = [torch.rand((G, S), device=dev), torch.empty((G, S), device=dev)]
    pol = torch.empty((G, S), dtype=torch.int32, device=dev)
    dbits = torch.zeros((G, 1), dtype=torch.int64, device=dev)
    k7 = report["K7"]
    k7["ms"] = device_ms(lambda: kernels.grid_vi_sweeps(
        tm, probs, valid, live, 1.0, v, p, pol, dbits, 1), 20,
        "grid_sweep_kernel")
    twin = E._grid_chunk_plain(tm, probs, 1.0)
    frozen = torch.zeros(G, dtype=torch.bool, device=dev)
    k7["plain_ms"] = event_ms(lambda: twin((v[0], p[0], pol), frozen, 1), 3)
    seg = tm.src.to(torch.int64) * tm.n_actions + tm.act
    base = csr_yardstick(tm, n_rows=S * tm.n_actions, row_of=seg)
    spmvs = [torch.sparse_csr_tensor(
        base.crow_indices(), base.col_indices(), probs[g],
        size=base.shape, check_invariants=False) for g in range(G)]
    k7["library_ms"] = event_ms(
        lambda: [m @ v[0][g] for g, m in enumerate(spmvs)], 5)
    # the shared columns (dst, reward, progress) and the segment index
    # once; each point's probability column and validity; each point's
    # V and P read, V', P' and the policy written
    k7_bytes = (3 * 4 * T + 4 * (S + 1) + 8 * (n_seg + 1)
                + G * (4 * T + n_seg) + G * S * (8 + 8 + 4) + 4 * G)
    k7["bound_ms"], k7["bound_by"] = bound_ms(k7_bytes, 8 * T * G)
    per_point = 12 * T + 4 * (S + 1) + 8 * (n_seg + 1) + 4 * T + n_seg \
        + S * 20
    k7["per_point_reread_bound_ms"] = bound_ms(G * per_point, 0)[0]

    key = rnd.PRNGKey(RTDP_SEED + 1, device="cpu")
    args = dict(graph=True, max_steps=RTDP_TIMED_STEPS, batch=RTDP_BATCH,
                cap=RTDP_BUFFER, eps=RTDP_EPS, restart_p=RTDP_RESTART_P,
                discount=1.0, stop_delta=RTDP_STOP, decay=0.95)
    k6 = report["K6"]
    k6["ms"] = device_ms(lambda: E._rtdp_walk(tm, key, **args), 3,
                         "rtdp_kernel")
    k6["ms_per_step"] = k6["ms"] / RTDP_TIMED_STEPS
    z = torch.zeros(S, device=dev)
    cdf = E.start_cdf(tm)
    k6["plain_ms"] = event_ms(lambda: E._rtdp_plain(
        tm, key.reshape(2), z.clone(), z.clone(), cdf, **args), 1)
    k6["library_ms"] = None  # no single PyTorch call computes it
    # this run's data: each visited state's segment index and rows (dst,
    # prob, reward, progress, and V/P at dst) read once, its V, P and
    # visit count written once; the threefry work is each step's key
    # split and, per visit, one draw per valid action, K successor draws
    # and two uniforms (restart draws not counted)
    r = E._rtdp_walk(tm, key, **args)
    visits = r["visits"].to(torch.int64)
    nseg = (tm.state_seg[1:] - tm.state_seg[:-1]).to(torch.int64)
    seg_rows = (tm.seg_ptr[1:] - tm.seg_ptr[:-1]).to(torch.int64)
    seg_state = torch.repeat_interleave(torch.arange(S, device=dev), nseg)
    rows = torch.zeros(S, dtype=torch.int64, device=dev).index_add_(
        0, seg_state, seg_rows)
    nvalid = torch.zeros(S, dtype=torch.int64, device=dev).index_add_(
        0, seg_state, tm.seg_valid.to(torch.int64))
    k6_bytes = int(((visits > 0) * (8 + 9 * nseg + 24 * rows + 12)).sum())
    K = tm.max_segment()
    k6_ops = THREEFRY_OPS * (7 * RTDP_TIMED_STEPS
                             + int((visits * (nvalid + K + 2)).sum()))
    k6["bound_ms"], k6["bound_by"] = bound_ms(k6_bytes, k6_ops)
    say("mdp_times", rows=T, points=G, rtdp_steps=RTDP_TIMED_STEPS,
        **{k: json.dumps({f: report[k].get(f) for f in (
            "ms", "ms_per_step", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "per_point_reread_bound_ms")})
           for k in ("K6", "K7")})


# -- the block-DAG envs: K8, K10-bk, K10-eth ----------------------------------


def dag_env(name):
    from cpr_tpu_torch.envs import registry
    return registry.get(DAG_ENVS[name][0], window=DAG_WINDOW)


def compare_dag_state(got, want, what, rtol=1e-5):
    """Two bk or Ethereum states (or DAGs), every tensor: the clock fields
    within rtol (equal infinities included), all else exactly. Returns the
    largest clock difference."""
    import dataclasses
    err = 0.0

    def walk(g, w, name):
        nonlocal err
        if dataclasses.is_dataclass(g):
            for f in dataclasses.fields(g):
                walk(getattr(g, f.name), getattr(w, f.name),
                     f"{name}.{f.name}")
        elif isinstance(g, tuple):
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{name}[{i}]")
        elif name.rsplit(".", 1)[-1] in DAG_TIME_FIELDS:
            same = g == w
            d = torch.where(same, torch.zeros_like(g), (g - w).abs())
            check(bool((same | (d <= rtol * w.abs())).all()),
                  f"{what}: {name} beyond rtol {rtol}")
            err = max(err, float(d.max()) if d.numel() else 0.0)
        else:
            check(torch.equal(g, w), f"{what}: {name} differs")

    walk(got, want, "state")
    return err


def fixture_dag_state(dfx, prefix, env, dev):
    """The DAG fixture's state under `prefix` as a port state on `dev`."""
    from cpr_tpu_torch import convert
    d = {"dag": {}}
    for k, v in dfx.items():
        if k.startswith(prefix):
            f = k[len(prefix):]
            if f.startswith("dag."):
                d["dag"][f[4:]] = list(v) if f == "dag.parents" else v
            elif f != "obs_carry":
                d[f] = v
    return convert.dag_state_from_numpy(env, d, dev)


def dag_plain_stats(env, keys, params, policy, n_steps, chunk=None,
                    timed=False):
    """The stats driver over the plain twin (`stream_plain`) on whatever
    device `keys` lie, in chunks of `chunk` steps; returns (stats, carry)
    and, if `timed`, each chunk's seconds (the first includes the stream
    prologue, as the kernel's first launch does)."""
    from cpr_tpu_torch.envs.base import EPISODE_KEYS
    secs, totals, n_done = [], 0, 0
    chunk = chunk or n_steps
    t0 = time.perf_counter()
    carry = clone_carry(env._stream_init(keys, params))
    for start in range(0, n_steps, chunk):
        sums, nd, _ = env.stream_plain(carry, params, policy,
                                       min(chunk, n_steps - start))
        totals, n_done = totals + sums, n_done + nd
        if timed:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            secs.append(t1 - t0)
            t0 = t1
    nd = torch.clamp(n_done, min=1)
    stats = {k: totals[j] / nd for j, k in enumerate(EPISODE_KEYS)}
    stats["n_episodes"] = n_done
    return (stats, carry, secs) if timed else (stats, carry)


def plain_stats_chunked(env, keys, params, policy, n_steps, chunk):
    """One plain pass (`_autoreset_body`, the step `stream_plain` loops)
    giving the stats driver's result unchunked and in chunks of `chunk`
    steps, and the final carry: the chunked driver adds each chunk's
    done-masked sums, so where episode rewards are not dyadic (Sdag's
    discount: rates of (fwd + bwd - 1)/7) its float32 totals can differ
    from the unchunked run's in the last bit, as the reference's chunked
    driver's do; each is held to the kernel run chunked the same way."""
    from cpr_tpu_torch.envs.base import EPISODE_KEYS
    carry = clone_carry(env._stream_init(keys, params))
    body = env._autoreset_body(params, policy)
    z = torch.zeros((len(EPISODE_KEYS), keys.shape[0]), device=keys.device)
    seq, part, chunked = z, z, z
    n_done = torch.zeros(keys.shape[0], dtype=torch.int32,
                         device=keys.device)
    for t in range(n_steps):
        carry, (_, _, _, done, info) = body(carry)
        e = torch.stack([torch.where(done, info[k], torch.zeros_like(info[k]))
                         for k in EPISODE_KEYS])
        seq, part = seq + e, part + e
        n_done = n_done + done.to(torch.int32)
        if (t + 1) % chunk == 0 or t + 1 == n_steps:
            chunked, part = chunked + part, z
    nd = torch.clamp(n_done, min=1)
    out = []
    for totals in (seq, chunked):
        stats = {k: totals[j] / nd for j, k in enumerate(EPISODE_KEYS)}
        stats["n_episodes"] = n_done
        out.append(stats)
    return out[0], out[1], carry


@contextlib.contextmanager
def ring_peaks(env):
    """Around a plain run of the DAG env `env`, each episode's peak ring
    count: the DAG's append count `n`, read after every step before a done
    lane resets (n > capacity: a gid past the window was handed out, the
    ring wrapped). Yields a dict that holds, after the run, the episodes
    ended (`episodes`), those of them that wrapped (`wrapped`) and each
    lane's peak `n` over the run, the episode in flight included
    (`peak`), and the episodes that a live block's eviction ended
    (`overflowed`)."""
    rec = {"episodes": 0, "wrapped": 0, "overflowed": 0, "peak": 0}
    step = env.step

    def spy(state, action, params):
        out = step(state, action, params)
        n, done = out[0].dag.n, out[3]
        rec["episodes"] = rec["episodes"] + done.sum()
        rec["wrapped"] = rec["wrapped"] + (done & (n > env.capacity)).sum()
        rec["overflowed"] = rec["overflowed"] + (done
                                                 & out[0].dag.overflow).sum()
        rec["peak"] = torch.maximum(torch.as_tensor(rec["peak"]).to(n), n)
        return out

    env.step = spy
    try:
        yield rec
    finally:
        del env.step


def ring_report(env, rec):
    """`ring_peaks`' record as the smoke's report fields."""
    peak = rec["peak"]
    return dict(episodes_ended=int(rec["episodes"]),
                episodes_wrapped=int(rec["wrapped"]),
                episodes_overflowed=int(rec["overflowed"]),
                lanes_wrapped=int((peak > env.capacity).sum()),
                ring_peak_max=int(peak.max()),
                ring_peak_mean=float(peak.float().mean()))


def phase_k8(dev, dfx, report):
    """K8's check kernel against `script_plain` at main shapes and
    against the JAX fixture's script."""
    from cpr_tpu_torch.core import dag as D
    ops, args, fargs = D.make_script(3, K8_LANES, K8_OPS, K8_PARENTS)
    a, f = torch.from_numpy(args).to(dev), torch.from_numpy(fargs).to(dev)

    def fresh(L, W, P):
        return D.empty(L, W, P, ring=True, anc_masks=True, device=dev)

    dk, rk, ok = D.dag_script(fresh(K8_LANES, DAG_WINDOW, K8_PARENTS), ops,
                              a, f)
    t0 = time.perf_counter()
    dp, rp, op = D.script_plain(fresh(K8_LANES, DAG_WINDOW, K8_PARENTS), ops,
                                a, f)
    torch.cuda.synchronize()
    report["K8"]["plain_ms"] = (time.perf_counter() - t0) * 1e3
    check(torch.equal(ok, op), "K8 script results differ from plain")
    check(torch.equal(rk, rp), "K8 script registers differ from plain")
    err = compare_dag_state(dk, dp, "K8 vs plain")
    wraps = int(dk.gid.max())
    check(wraps >= DAG_WINDOW, "K8 check did not wrap the window")
    # against jax (committed fixture)
    W, P = dfx["k8_dag.gid"].shape[1], dfx["k8_dag.parents"].shape[0]
    L = dfx["k8_dag.gid"].shape[0]
    dj, rj, oj = D.dag_script(fresh(L, W, P), dfx["k8_ops"],
                              torch.from_numpy(dfx["k8_args"]).to(dev),
                              torch.from_numpy(dfx["k8_fargs"]).to(dev))
    check(np.array_equal(oj.cpu().numpy(), dfx["k8_out"]),
          "K8 script results differ from jax")
    check(np.array_equal(rj.cpu().numpy(), dfx["k8_regs"]),
          "K8 registers differ from jax")
    check(np.array_equal(torch.stack(dj.parents).cpu().numpy(),
                         dfx["k8_dag.parents"]), "K8 parents differ from jax")
    for name in D.FIELDS[1:]:
        check(np.array_equal(getattr(dj, name).cpu().numpy(),
                             dfx[f"k8_dag.{name}"]),
              f"K8 {name} differs from jax")
    # the second script: the vote-quorum envs' last_by_age and
    # descendants_mask, at main shapes and against jax
    ops, args, fargs = D.make_script(4, K8_LANES, K8_OPS, K8_PARENTS,
                                     ops=D.RING_OPS_Q)
    a, f = torch.from_numpy(args).to(dev), torch.from_numpy(fargs).to(dev)
    dk, rk, ok = D.dag_script(fresh(K8_LANES, DAG_WINDOW, K8_PARENTS), ops,
                              a, f)
    dp, rp, op = D.script_plain(fresh(K8_LANES, DAG_WINDOW, K8_PARENTS), ops,
                                a, f)
    check(torch.equal(ok, op) and torch.equal(rk, rp),
          "K8 second script differs from plain")
    err = max(err, compare_dag_state(dk, dp, "K8 second script vs plain"))
    dj, rj, oj = D.dag_script(fresh(L, W, P), dfx["k8q_ops"],
                              torch.from_numpy(dfx["k8q_args"]).to(dev),
                              torch.from_numpy(dfx["k8q_fargs"]).to(dev))
    check(np.array_equal(oj.cpu().numpy(), dfx["k8q_out"])
          and np.array_equal(rj.cpu().numpy(), dfx["k8q_regs"]),
          "K8 second script differs from jax")
    for name in D.FIELDS[1:]:
        check(np.array_equal(getattr(dj, name).cpu().numpy(),
                             dfx[f"k8q_dag.{name}"]),
              f"K8 second script {name} differs from jax")
    report["K8"]["max_abs_err"] = err
    say("k8", lanes=K8_LANES, ops=K8_OPS, window=DAG_WINDOW,
        parents=K8_PARENTS, max_gid=wraps,
        overflowed=int(dk.overflow.sum()), fixture_lanes=L,
        second_script=True, max_abs_err=err, ok=True)


def phase_k10_lanes(dev, dfx, report, names):
    """The K10 step_lanes of the envs `names` against their plain
    versions over seeded masks at the gym paths' lanes, then the
    fixture's (`dfx`) tick traces."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.base import INFO_KEYS
    from cpr_tpu_torch.params import make_params
    for name in names:
        env = dag_env(name)
        lanes = DAG_PATHS[name][0]
        params = make_params(alpha=0.35, gamma=0.5, max_steps=32)
        rng = np.random.default_rng(1)
        carry = env.init_lanes(rnd.split(rnd.PRNGKey(11, dev), lanes), params)
        fresh = env.init_lanes(rnd.split(rnd.PRNGKey(12, dev), lanes), params)
        s_plain, o_plain = env._stream_init(
            rnd.split(rnd.PRNGKey(11, dev), lanes), params)
        err = compare_dag_state(carry[0], s_plain, f"{name} init_lanes")
        check(float((carry[1] - o_plain).abs().max()) <= 1e-6, "init obs")
        plain = clone_carry(carry)
        n_done = 0
        for t in range(DAG_CHECK_TICKS):
            actions = torch.from_numpy(rng.integers(
                0, env.n_actions, lanes).astype(np.int32)).to(dev)
            admit = torch.from_numpy(rng.random(lanes) < 0.05).to(dev)
            step = torch.from_numpy(rng.random(lanes) < 0.8).to(dev)
            _, out = env.step_lanes(carry, actions, admit, fresh, step,
                                    params)
            _, out_p = env.step_lanes_plain(plain, actions, admit, fresh,
                                            step, params)
            err = max(err, compare_outputs(out, out_p,
                                           f"{env.kernel_name} tick {t}"))
            n_done += int(out[2].sum())
        err = max(err, compare_dag_state(carry[0], plain[0],
                                         f"{env.kernel_name} ticks"))
        check(float((carry[1] - plain[1]).abs().max()) <= 1e-6, "carry obs")
        check(n_done > 0, f"{name} step_lanes check never reset a lane")
        # against jax (committed fixture): replay the tick trace
        key = DAG_ENVS[name][0]
        p3 = make_params(alpha=0.35, gamma=0.5, max_steps=12)
        carry = env.init_lanes(rnd.from_numpy_words(
            dfx[f"{name}_sl_keys"], dev), p3)
        fresh = env.init_lanes(rnd.from_numpy_words(
            dfx[f"{name}_sl_fresh_keys"], dev), p3)
        cvt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        for t in range(dfx[f"{name}_sl_actions"].shape[0]):
            _, out = env.step_lanes(carry, cvt(dfx[f"{name}_sl_actions"][t]),
                                    cvt(dfx[f"{name}_sl_admit"][t]), fresh,
                                    cvt(dfx[f"{name}_sl_step"][t]), p3)
            want = (cvt(dfx[f"{name}_sl_out_obs"][t]),
                    cvt(dfx[f"{name}_sl_out_reward"][t]),
                    cvt(dfx[f"{name}_sl_out_done"][t]),
                    {k: cvt(dfx[f"{name}_sl_out_info"][t][i])
                     for i, k in enumerate(INFO_KEYS)})
            compare_outputs(out, want, f"{key} step_lanes vs jax tick {t}")
        compare_dag_state(carry[0], fixture_dag_state(
            dfx, f"{name}_sl_final_", env, dev), f"{key} step_lanes vs jax")
        report[env.kernel_name]["lanes_err"] = err
        say(f"k10_{name}_lanes", lanes=lanes, ticks=DAG_CHECK_TICKS,
            episodes_ended=n_done, max_abs_err=err, ok=True)


def mixed_policy(env, n):
    """One policy per group of n lanes, in `scripted_policies` order, each
    read from the decoded observation as the JAX package computes it: the
    plain twin runs every policy of an env in one batched call."""
    def policy(obs):
        group = torch.arange(obs.shape[0], device=obs.device) // n
        out = torch.zeros(obs.shape[0], dtype=torch.int32, device=obs.device)
        for i, name in enumerate(env.scripted_policies):
            out = torch.where(group == i, env.policies[name](obs), out)
        return out
    return policy


def phase_k10_streams(dev, dfx, report, names):
    """The K10 streams of the envs `names` against their plain versions
    (every policy, unchunked and chunked), then against the fixture
    (`dfx`)."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.base import EPISODE_KEYS, map_state
    from cpr_tpu_torch.params import make_params
    for name in names:
        env = dag_env(name)
        params = make_params(alpha=0.35, gamma=0.5, max_steps=64)
        n = DAG_CHECK_LANES
        keys = rnd.split(rnd.PRNGKey(21, dev), n)
        err = report[env.kernel_name].pop("lanes_err")
        n_pol = len(env.scripted_policies)
        want_all, want_chunked, pcarry = plain_stats_chunked(
            env, keys.repeat(n_pol, 1), params, mixed_policy(env, n),
            DAG_CHECK_STEPS, 100)
        for i, pol in enumerate(env.scripted_policies):
            sl = slice(i * n, (i + 1) * n)
            want = {k: v[sl] for k, v in want_all.items()}
            for chunk, w in ((None, want), (100, {
                    k: v[sl] for k, v in want_chunked.items()})):
                got = env.make_episode_stats_fn(params, env.policies[pol],
                                                DAG_CHECK_STEPS,
                                                chunk=chunk)(keys)
                err = max(err, compare_stats(got, w,
                                             f"{env.kernel_name} {pol} "
                                             f"chunk {chunk}"))
            kcarry, _, _, _ = env._stream(None, keys, 1, DAG_CHECK_STEPS,
                                          params, pol, False)
            err = max(err, compare_dag_state(
                kcarry[0], map_state(lambda t: t[sl], pcarry[0]),
                f"{env.kernel_name} {pol}"))
            check(int(want["n_episodes"].min()) >= 2,
                  f"{name} check did not cross episode ends")
        # against jax (committed fixture)
        p2 = make_params(alpha=0.35, gamma=0.5, max_steps=200)
        fkeys = rnd.from_numpy_words(dfx[f"{name}_keys"], dev)
        main = DAG_ENVS[name][1]
        for i, pol in enumerate(env.scripted_policies):
            carry, sums, nd, _ = env._stream(None, fkeys, 1, 256, p2, pol,
                                             True)
            check(np.array_equal(nd.cpu().numpy(), dfx[f"{name}_p{i}_n_done"]),
                  f"{name} {pol} episodes differ from jax")
            ws = dfx[f"{name}_p{i}_sums"]
            for j, k in enumerate(EPISODE_KEYS):
                g = sums[j].cpu().numpy()
                if "time" in k:
                    check(bool((np.abs(g - ws[j]) <= 1e-5 * np.abs(ws[j]))
                               .all()), f"{name} {pol} {k} vs jax")
                else:
                    check(np.array_equal(g, ws[j]),
                          f"{name} {pol} {k} differs from jax")
            check(float(np.abs(carry[1].cpu().numpy()
                               - dfx[f"{name}_p{i}_obs"]).max()) <= 1e-6,
                  f"{name} {pol} obs vs jax")
            if pol == main:
                compare_dag_state(carry[0], fixture_dag_state(
                    dfx, f"{name}_final_", env, dev), f"{name} {pol} vs jax")
        report[env.kernel_name]["max_abs_err"] = err
        say(f"k10_{name}_streams", lanes=n, steps=DAG_CHECK_STEPS,
            policies=n_pol, plain_lanes=n * n_pol, chunked=True,
            max_abs_err=err, ok=True)


def phase_vote_variants(dev, report, table):
    """The K10 kernels of the families in `table` (VOTE_VARIANTS: K10-ts
    and K10-stree; PAR_VARIANTS: K10-spar and K10-sdag) under every
    scheme and selection the paths do not run, every policy, against
    their plain versions: the stats and the whole final carry."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.envs.base import map_state
    from cpr_tpu_torch.params import make_params
    n, steps = VARIANT_LANES, VARIANT_STEPS
    params = make_params(alpha=0.35, gamma=0.5, max_steps=64)
    keys = rnd.split(rnd.PRNGKey(41, dev), n)
    for family, variants in table.items():
        for kw in variants:
            env = registry.get(family, **{"window": DAG_WINDOW, **kw})
            n_pol = len(env.scripted_policies)
            with ring_peaks(env) as ring:
                want_all, pcarry = dag_plain_stats(
                    env, keys.repeat(n_pol, 1), params, mixed_policy(env, n),
                    steps)
            err = 0.0
            for i, pol in enumerate(env.scripted_policies):
                sl = slice(i * n, (i + 1) * n)
                carry, sums, nd, _ = env._stream(None, keys, 1, steps,
                                                 params, pol, False)
                what = f"{env.kernel_name} {json.dumps(kw)} {pol}"
                err = max(err, compare_dag_state(
                    carry[0], map_state(lambda t: t[sl], pcarry[0]), what))
                got = env.make_episode_stats_fn(params, pol, steps)(keys)
                err = max(err, compare_stats(
                    got, {k: v[sl] for k, v in want_all.items()}, what))
            r = report[env.kernel_name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            say(f"{family}_variant", **{k: v for k, v in kw.items()},
                lanes=n, steps=steps, policies=n_pol, max_abs_err=err,
                **ring_report(env, ring), ok=True)


def phase_k9(dev, qfx, report):
    """K9's check kernel against `check_plain` on 4096 lanes of each vote
    env's plain stream carry (every policy on its share of the lanes,
    K9_STEPS steps into episodes of K9_MAX_STEPS, so that rings have
    wrapped), and against the fixture's carries and inputs (jax's
    outputs). Returns the carries."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs import quorum as Q
    from cpr_tpu_torch.kernels import _CHECK_CFG
    from cpr_tpu_torch.params import make_params
    k9 = report["K9"]
    carries = {}
    for name in ("ts", "stree"):
        env = dag_env(name)
        n = DAG_CHECK_LANES
        group = -(-n // len(env.scripted_policies))
        params = make_params(alpha=0.35, gamma=0.5, max_steps=K9_MAX_STEPS)
        _, carry = dag_plain_stats(env, rnd.split(rnd.PRNGKey(31, dev), n),
                                   params, mixed_policy(env, group),
                                   K9_STEPS)
        carries[name] = carry
        state = carry[0]
        inputs = {k: v.contiguous() for k, v in
                  Q.check_inputs(env, state).items()}
        cfg = Q.check_cfg(env)
        got = Q.quorum_check(state.dag, inputs, cfg)
        want = Q.check_plain(state.dag, inputs, cfg)
        for k, w in want.items():
            check(torch.equal(got[k], w), f"K9 {name} {k} differs from plain")
        wrapped = int((state.dag.gid.max(1).values >= env.capacity).sum())
        # against jax (committed fixture)
        fcfg = {f: int(v) for f, v in zip(_CHECK_CFG,
                                           qfx[f"k9_{name}_cfg"])}
        fstate = fixture_dag_state(qfx, f"k9_{name}_state_", env, dev)
        fin = {f: torch.from_numpy(qfx[f"k9_{name}_in_{f}"]).to(dev)
               for f in ("cand", "own", "seen", "score", "stale", "pub",
                         "priv")}
        fout = Q.quorum_check(fstate.dag, fin, fcfg)
        for k, v in fout.items():
            check(np.array_equal(v.cpu().numpy(), qfx[f"k9_{name}_out_{k}"]),
                  f"K9 {name} {k} differs from jax")
        say(f"k9_{name}", lanes=n, window=env.capacity, C=cfg["C"],
            found=json.dumps(want["found"].sum(1).tolist()),
            release_flips=int(want["rfound"].sum()), lanes_wrapped=wrapped,
            fixture_lanes=int(fin["pub"].shape[0]), ok=True)
    k9["max_abs_err"] = 0.0  # every output is an integer or a bool
    return carries


def k9_bytes(dag, inputs, cfg, out):
    """The bytes K9's check must move on these lanes (csrc/quorum.cuh):
    the per-slot planes it scans whole (gid, signer, kind, vis_d and the
    inputs cand and stale), one 32-byte sector of the chain plane per slot
    (the column of `pub` that `descendants` reads), the closure row and the
    gathered values (aux, own, seen, score) of each candidate in the frame,
    the height (and for Tailstorm the auxg) of each release position and
    of `pub`, the lane scalars (n, live_floor, overflow, pub, priv), and
    every output written once. Counted at this run's data: the framed
    candidates from `cidx`, the release positions from the withheld
    non-stale slots."""
    L, W = dag.gid.shape
    framed = int((out["cidx"] >= 0).sum())
    cands = dag.exists() & ~dag.vis_d & ~inputs["stale"]
    positions = int(cands.sum(1).clamp(max=cfg["R"]).sum()) + L
    per_pos = 4 + (4 if cfg["env"] == 0 else 0)
    chain_lanes = int((inputs["pub"] >= 0).sum())
    return (L * W * (4 + 4 + 4 + 1 + 1 + 1) + chain_lanes * W * 32
            + framed * (W + 4 + 1 + 4 + 4) + positions * per_pos
            + L * (4 + 4 + 1 + 4 + 4)
            + sum(v.nbytes for v in out.values()))


def phase_k9_times(dev, report, carries):
    """K9's check kernel per launch at 4096 lanes of Tailstorm carries,
    its plain version's time (warm, the median of three calls), and its
    bound: the bytes of `k9_bytes` (no arithmetic to speak of)."""
    from cpr_tpu_torch.envs import quorum as Q
    env = dag_env("ts")
    state = carries["ts"][0]
    inputs = {k: v.contiguous() for k, v in
              Q.check_inputs(env, state).items()}
    cfg = Q.check_cfg(env)
    k9 = report["K9"]
    k9["ms"] = device_ms(lambda: Q.quorum_check(state.dag, inputs, cfg), 3,
                         "quorum_check_kernel")
    out = Q.quorum_check(state.dag, inputs, cfg)
    Q.check_plain(state.dag, inputs, cfg)
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Q.check_plain(state.dag, inputs, cfg)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    k9["plain_ms"] = sorted(secs)[1] * 1e3
    k9["bound_ms"], k9["bound_by"] = bound_ms(
        k9_bytes(state.dag, inputs, cfg, out), 0)
    k9["library_ms"] = None  # no PyTorch call computes a quorum
    say("k9_times", **{f: k9[f] for f in ("ms", "plain_ms", "bound_ms",
                                          "bound_by")})


def phase_dag_path(dev, report, name):
    """A DAG env's main path (bench.py's config 2 or 3), its launch
    counts, the plain version held to the kernel, then the gym path."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.base import EPISODE_KEYS
    from cpr_tpu_torch.params import make_params
    env = dag_env(name)
    pol = env.policies[DAG_ENVS[name][1]]
    k10 = env.kernel_name
    lanes, steps, chunk, max_steps, guard, plain_steps = DAG_PATHS[name]
    if guard is None:
        guard = (VOTE_REVENUE[name] - VOTE_GUARD,
                 VOTE_REVENUE[name] + VOTE_GUARD)
    params = make_params(alpha=0.35, gamma=0.5, max_steps=max_steps)

    kernels.reset_launches()
    keys = rnd.split(rnd.PRNGKey(0, dev), lanes)
    fn = env.make_episode_stats_fn(params, pol, steps, chunk=chunk)
    stats = fn(keys)
    torch.cuda.synchronize()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        stats = fn(keys)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = dict(kernels.launches)
    path_launches(counts, ("K1", k10), name)
    atk = float(stats["episode_reward_attacker"].mean())
    dfn = float(stats["episode_reward_defender"].mean())
    rel = atk / (atk + dfn)
    check(all(torch.isfinite(stats[k]).all() for k in EPISODE_KEYS),
          "non-finite stats")
    check(guard[0] < rel < guard[1],
          f"{name} relative revenue {rel} outside {guard}")
    # lanes with an episode that overflowed the window (ended before
    # max_steps: max_progress and max_time are unbounded here)
    short = stats["episode_n_steps"] < max_steps
    overflowed = int((short & (stats["n_episodes"] > 0)).sum())
    say(name, lanes=lanes, steps=steps, chunk=chunk, rel_revenue=rel,
        episodes=int(stats["n_episodes"].sum()),
        lanes_overflowed=overflowed,
        env_steps_per_s=lanes * steps / min(secs), call_s=secs,
        launches=json.dumps(counts))

    # the plain version on the same keys (the first plain_steps steps, in
    # 128-step chunks as the timed launch runs them; the first chunk's
    # time is the plain version's time of that launch)
    part = env.make_episode_stats_fn(params, pol, plain_steps,
                                     chunk=chunk)(keys)
    with ring_peaks(env) as ring:
        want, _, chunk_s = dag_plain_stats(env, keys, params, pol,
                                           plain_steps, chunk=128,
                                           timed=True)
    report[k10]["plain_ms"] = chunk_s[0] * 1e3
    err = compare_stats(part, want, f"{k10} vs plain at main shapes")
    report[k10]["max_abs_err"] = max(report[k10]["max_abs_err"], err)
    extra = {}
    if name in VOTE_REVENUE:
        # the guard's reference: bench.py's revenue of the plain version
        # on the first 64 lanes (the keys of split(PRNGKey(0), 64))
        r = VOTE_REF_LANES
        a = float(want["episode_reward_attacker"][:r].mean())
        d = float(want["episode_reward_defender"][:r].mean())
        check(abs(a / (a + d) - VOTE_REVENUE[name]) <= 1e-6,
              f"{name} 64-lane reference revenue {a / (a + d)}, expected "
              f"{VOTE_REVENUE[name]}")
        # the episodes of the plain run whose ring wrapped
        extra = dict(ref_revenue_64=a / (a + d), **ring_report(env, ring))
    say(f"{name}_vs_plain", steps=plain_steps, max_abs_err=err, ok=True,
        **extra)

    # the gym step path: resident lanes, one K10 launch per tick
    kernels.reset_launches()
    carry = env.reset_lanes(rnd.split(rnd.PRNGKey(1, dev), lanes), params)
    fresh = env.reset_lanes(rnd.split(rnd.PRNGKey(2, dev), lanes), params)
    no_admit = torch.zeros(lanes, dtype=torch.bool, device=dev)
    step_all = torch.ones(lanes, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick_done = 0
    for _ in range(MAIN_TICKS):
        actions = pol(carry[1])
        _, (obs, _, done, _) = env.step_lanes(carry, actions, no_admit, fresh,
                                              step_all, params)
        tick_done += done.sum()
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    gym_counts = dict(kernels.launches)
    path_launches(gym_counts, ("K1", k10), f"{name} gym")
    check(gym_counts[k10] == MAIN_TICKS + 2,
          f"{k10} launched {gym_counts[k10]} times for {MAIN_TICKS} ticks "
          "and two resets")
    check(bool(torch.isfinite(obs).all()), "non-finite step_lanes obs")
    say(f"{name}_gym", lanes=lanes, ticks=MAIN_TICKS,
        ticks_per_s=MAIN_TICKS / tick_s,
        lane_steps_per_s=MAIN_TICKS * lanes / tick_s,
        episodes_ended=int(tick_done), launches=json.dumps(gym_counts))
    return counts, gym_counts


def carry_bytes(carry):
    from cpr_tpu_torch.envs.base import map_state
    total = [0]
    map_state(lambda t: total.__setitem__(0, total[0] + t.nbytes), carry[0])
    return total[0] + carry[1].nbytes


ENV_KINDS = {"bk": "BkEnv", "eth": "EthEnv", "ts": "TailstormEnv",
             "stree": "StreeEnv", "spar": "SparEnv", "sdag": "SdagEnv"}


def phase_dag_times(dev, report, names):
    """K10 device times per 128-step launch at the paths' shapes and per
    step_lanes tick for the envs `names`, the plain versions' times and
    the bounds; with bk, K8's check kernel per launch."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.core import dag as D
    from cpr_tpu_torch.params import make_params
    times = {}
    for name in names:
        env_kind = ENV_KINDS[name]
        env = dag_env(name)
        k10 = report[env.kernel_name]
        L, _, _, max_steps, _, _ = DAG_PATHS[name]
        T = 128
        params = make_params(alpha=0.35, gamma=0.5, max_steps=max_steps)
        pid = env.scripted_policy_id(DAG_ENVS[name][1])
        keys = rnd.split(rnd.PRNGKey(0, dev), L)
        carry = env._empty_carry(L, dev)
        k10["ms"] = device_ms(lambda: env._kernel_stream(
            carry, keys, 1, T, params, pid, True, False), 3,
            ("dag_stream_kernel", env_kind))
        # keys in; the lane state (every DAG plane and scalar) read and
        # written once, obs, sums and counts out; the threefry work of
        # the prologue, every step and every reset this launch made
        # (plain_ms: the path's first plain chunk, phase_dag_path)
        sums, n_done, _ = env._kernel_stream(carry, keys, 1, T, params, pid,
                                             True, False)
        resets = int(n_done.sum())
        state_b = carry_bytes(carry)
        k10_bytes = L * 8 + 2 * state_b + L * (7 * 4 + 4)
        if name in MINE5_ENVS:
            # the threefry work of this launch's mining draws (9 blocks
            # each: the finished episodes' and the running ones')
            mines = int(sums[6].sum()) + int(carry[0].n_activations.sum())
            k10_ops = THREEFRY_OPS * (MINE_THREEFRY5 * mines + L)
        else:
            k10_ops = THREEFRY_OPS * (MINE_THREEFRY * (L * T + L + resets)
                                      + L)
        k10["bound_ms"], k10["bound_by"] = bound_ms(k10_bytes, k10_ops)
        k10["state_bytes"] = state_b
        k10["launch_steps"] = T
        # one step_lanes tick of every lane
        carry = env.reset_lanes(keys, params)
        fresh = env.reset_lanes(rnd.split(rnd.PRNGKey(3, dev), L), params)
        actions = env.policies[DAG_ENVS[name][1]](carry[1])
        no_admit = torch.zeros(L, dtype=torch.bool, device=dev)
        step_all = torch.ones(L, dtype=torch.bool, device=dev)
        tick = lambda: env.step_lanes(  # noqa: E731
            carry, actions, no_admit, fresh, step_all, params)
        k10["step_lanes_ms"] = device_ms(tick, 20,
                                         ("dag_step_lanes_kernel", env_kind))
        k10["step_lanes_plain_ms"] = event_ms(lambda: env.step_lanes_plain(
            carry, actions, no_admit, fresh, step_all, params), 3)
        k10["library_ms"] = None  # no PyTorch call computes an env step
        times[env.kernel_name] = {f: k10[f] for f in (
            "ms", "plain_ms", "bound_ms", "bound_by", "step_lanes_ms",
            "step_lanes_plain_ms", "state_bytes")}
    if "bk" not in names:
        say("dag_times", **{k: json.dumps(v) for k, v in times.items()})
        return

    ops, args, fargs = D.make_script(3, K8_LANES, K8_OPS, K8_PARENTS)
    a, f = torch.from_numpy(args).to(dev), torch.from_numpy(fargs).to(dev)
    dag = D.empty(K8_LANES, DAG_WINDOW, K8_PARENTS, ring=True, anc_masks=True,
                  device=dev)
    k8 = report["K8"]
    k8["ms"] = device_ms(lambda: D.dag_script(dag, ops, a, f), 3,
                         "dag_script_kernel")
    # the DAG read and written once, the script's arguments read, its
    # results and registers written; no arithmetic to speak of
    dag_b = carry_bytes((dag, torch.empty(0)))
    k8_bytes = 2 * dag_b + a.nbytes + f.nbytes + K8_OPS * K8_LANES * 16 \
        + K8_LANES * 32
    k8["bound_ms"], k8["bound_by"] = bound_ms(k8_bytes, 0)
    k8["library_ms"] = None
    times["K8"] = {f: k8[f] for f in ("ms", "plain_ms", "bound_ms",
                                      "bound_by")}
    say("dag_times", **{k: json.dumps(v) for k, v in times.items()})


# -- the PPO slice (K11) --------------------------------------------------------

def make_net(obs_dim, n_actions, hidden, seed, dev):
    """An ActorCritic of the port's own init, from a seed."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.train.ppo import ActorCritic
    return ActorCritic(obs_dim, n_actions, (hidden, hidden),
                       device=dev).init(rnd.PRNGKey(seed, dev))


def gumbel_margin(z):
    """Per row of `z` [L, A], the gap between its largest and second
    largest entries (a draw is decided wherever it exceeds NET_MARGIN)."""
    top = torch.topk(z, 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def phase_k11_act(dev, report):
    """K11-act's check kernel against the plain actor on the card: 4096
    lanes, hidden 64 and 96, with and without extend_obs, warp mode (A =
    8, Tailstorm's 10 fields) and thread mode (A = 4, Nakamoto's 4), a
    sampled draw and a greedy one. Logits, value and logp within 1e-5;
    actions equal wherever the draw's margin exceeds NET_MARGIN."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    rng = np.random.default_rng(11)
    L = ACT_LANES
    err, below, lanes = 0.0, 0, 0
    for hidden in (64, 96):
        for ext in (False, True):
            for warp, F, A in ((True, 10, 8), (False, 4, 4)):
                net = make_net(F + 2 * ext, A, hidden, hidden + ext, dev)
                obs = torch.from_numpy(rng.random((L, F), dtype=np.float32)
                                       ).to(dev)
                alpha = gamma = None
                x = obs
                if ext:
                    alpha = torch.from_numpy(rng.uniform(
                        0.1, 0.45, L).astype(np.float32)).to(dev)
                    gamma = torch.from_numpy(rng.uniform(
                        0.0, 0.9, L).astype(np.float32)).to(dev)
                    x = torch.cat([obs, alpha[:, None], gamma[:, None]], 1)
                with torch.no_grad():
                    pl, pv = net(x)
                k_act = rnd.fold_in(rnd.PRNGKey(5, dev), hidden + ext)
                z = pl + rnd.gumbel(k_act, (L, A))
                for kk, zz in ((k_act, z), (None, pl)):
                    logits, value, action, logp = kernels.actor_check(
                        net, obs, alpha, gamma, kk, warp=warp)
                    want = torch.argmax(zz, -1)
                    sure = gumbel_margin(zz) > NET_MARGIN
                    check(torch.equal(action.long()[sure], want[sure]),
                          f"K11-act (hidden {hidden}, ext {ext}, warp "
                          f"{warp}): actions differ")
                    plogp = torch.log_softmax(pl, -1).gather(
                        1, action.long()[:, None])[:, 0]
                    e = max(float((logits - pl).abs().max()),
                            float((value - pv).abs().max()),
                            float((logp - plogp).abs().max()))
                    check(e <= 1e-5, f"K11-act (hidden {hidden}, ext {ext}, "
                          f"warp {warp}) beyond 1e-5: {e}")
                    err = max(err, e)
                    below += int((~sure).sum())
                    lanes += L
    report["K11-act"]["max_abs_err"] = err
    say("k11_act", lanes=L, cases=lanes // L, max_abs_err=err,
        lanes_below_margin=below, of=lanes, ok=True)


def compare_step_info(info, want, t, what):
    """The kernel's info [12, T, L] at step t against a plain step's
    dict: integer-valued keys exactly, time keys within 1e-5 of the lane's
    clock (as compare_outputs)."""
    from cpr_tpu_torch.envs.base import INFO_KEYS
    clock = want["episode_sim_time"].abs()
    err = 0.0
    for i, k in enumerate(INFO_KEYS):
        g, w = info[i, t], want[k]
        if "time" in k:
            d = (g - w).abs()
            check(bool((d <= 1e-5 * (w.abs() + clock)).all()),
                  f"{what}: {k} beyond tolerance at step {t}")
            err = max(err, float(d.max()))
        else:
            check(torch.equal(g, w), f"{what}: {k} differs at step {t}")
    return err


def net_env(key, window, ext):
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.envs.assumption import AssumptionEnv
    env = registry.get(key, window=window) if window else registry.get(key)
    return AssumptionEnv(env) if ext else env


def net_params(ext, lanes, max_steps):
    """Per-lane alphas under extend_obs (the assumption schedule), scalar
    params otherwise."""
    from cpr_tpu_torch.params import make_params, stack_params
    if ext:
        return stack_params([dict(alpha=float(a), gamma=0.5,
                                  max_steps=max_steps)
                             for a in np.linspace(0.15, 0.45, lanes)])
    return make_params(alpha=0.35, gamma=0.5, max_steps=max_steps)


def net_stream_case(env, params, net, keys, T, key0, what, full_env=None,
                    full_lanes=0):
    """One stream launch with the net in sample mode (K2 or K10 with
    K11-act) over the lanes of `keys` from a raw reset, against the plain
    versions: the kernel's actions replayed through the plain
    `_lane_step` give the same observations (atol 1e-6), rewards, dones
    and info (clocks to 1e-5) every step and the same final carry; the
    plain actor on the same observations gives logp and value within
    1e-5 and the same draw wherever its margin exceeds NET_MARGIN; the
    carry key the kernel returns is the plain chain's. With `full_env`
    (the same DAG env in the reference's full mode) the first
    `full_lanes` lanes are replayed through it as well, which shows the
    ring equal to full mode there. Returns (episodes, largest error,
    draws below the margin, the ring's report or None)."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.base import _index_params
    from cpr_tpu_torch.train.ppo import NetPolicy
    dev, L = keys.device, keys.shape[0]
    carry = env.reset_lanes(keys, params)
    state, o = clone_carry(carry)
    # the plain version combines per-lane params with the lanes' state
    # on the card
    lane_params = params.replace(**{
        f.name: getattr(params, f.name).to(dev)
        for f in dataclasses.fields(params)})
    _, _, tr = env._kernel_stream(
        carry, None, 0, T, params, 0, False, True,
        net=NetPolicy(net, greedy=False, key=key0))
    obs, action, reward, done, info, logp, value, key_out = tr
    dag_env_ = getattr(env, "inner", env)
    rings = (ring_peaks(dag_env_) if hasattr(dag_env_, "capacity")
             else contextlib.nullcontext())
    k, episodes, e, below = key0, 0, 0.0, 0
    with rings as rec:
        for t in range(T):
            pair = rnd.split(k)
            k, k_act = pair[0], pair[1]
            d = float((obs[t] - o).abs().max())
            check(d <= 1e-6, f"{what}: obs beyond 1e-6 at step {t}")
            with torch.no_grad():
                pl, pv = net(o)
            z = pl + rnd.gumbel(k_act, (L, env.n_actions))
            sure = gumbel_margin(z) > NET_MARGIN
            check(torch.equal(action[t].long()[sure],
                              torch.argmax(z, -1)[sure]),
                  f"{what}: draws differ at step {t}")
            below += int((~sure).sum())
            plogp = torch.log_softmax(pl, -1).gather(
                1, action[t].long()[:, None])[:, 0]
            e = max(e, d, float((value[t] - pv).abs().max()),
                    float((logp[t] - plogp).abs().max()))
            state, o, _, r, dn, inf = env._lane_step(state, action[t],
                                                     lane_params)
            check(torch.equal(r, reward[t]) and torch.equal(dn, done[t]),
                  f"{what}: reward or done differs at step {t}")
            e = max(e, compare_step_info(info, inf, t, what))
            episodes += int(dn.sum())
    check(e <= 1e-5, f"{what}: logp/value beyond 1e-5 ({e})")
    check(torch.equal(key_out, k), f"{what}: carry key differs")
    check(float((carry[1] - o).abs().max()) <= 1e-6,
          f"{what}: final obs differs")
    if hasattr(state, "dag"):
        compare_dag_state(carry[0], state, f"{what} carry")
    else:
        compare_state(carry[0], state, f"{what} carry")
    if full_env is not None:
        m = full_lanes
        idx = torch.arange(m, device=dev)
        sub = _index_params(lane_params, idx) if lane_params.alpha.dim() \
            else lane_params
        fs, fo = full_env.reset(keys[:m], sub)
        for t in range(T):
            check(float((obs[t, :m] - fo).abs().max()) <= 1e-6,
                  f"{what} full mode: obs beyond 1e-6 at step {t}")
            fs, fo, _, r, dn, inf = full_env._lane_step(fs, action[t, :m],
                                                        sub)
            check(torch.equal(r, reward[t, :m])
                  and torch.equal(dn, done[t, :m]),
                  f"{what} full mode: reward or done differs at step {t}")
            compare_step_info(info[:, :, :m], inf, t, f"{what} full mode")
        check(float((carry[1][:m] - fo).abs().max()) <= 1e-6,
              f"{what} full mode: final obs differs")
    return (episodes, e, below,
            None if rec is None else ring_report(dag_env_, rec))


def phase_net_streams(dev, report):
    """`net_stream_case` for every env: 512 lanes x 64 steps of 24-step
    episodes, hidden 64, Nakamoto and Tailstorm under AssumptionEnv
    (extend_obs) with per-lane alphas."""
    from cpr_tpu_torch import random as rnd
    L, T = NETPOL_LANES, NET_STEPS
    err, below = 0.0, 0
    for i, (key, window, ext) in enumerate(NET_ENVS):
        env = net_env(key, window, ext)
        net = make_net(env.observation_length, env.n_actions, 64, 40 + i,
                       dev)
        episodes, e, b, rings = net_stream_case(
            env, net_params(ext, L, NET_MAX_STEPS), net,
            rnd.split(rnd.PRNGKey(21 + i, dev), L), T,
            rnd.PRNGKey(60 + i, dev), f"{key} net stream")
        check(episodes > 0, f"{key} net stream: no episode ended")
        err, below = max(err, e), below + b
        say("net_stream", env=key, extend_obs=ext, lanes=L, steps=T,
            episodes=episodes, max_abs_err=e, **(rings or {}), ok=True)
    report["K11-act"]["max_abs_err"] = max(report["K11-act"]["max_abs_err"],
                                           err)
    say("net_streams", envs=len(NET_ENVS), lanes_below_margin=below,
        of=L * T * len(NET_ENVS), ok=True)


def loss_inputs(dev, B, A, seed):
    """A minibatch for K11-loss from a numpy seed: logits, value, action,
    old_logp (of slightly perturbed logits, so ratios spread around 1
    and some clip), old_value, adv, target."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    logits = f(rng.normal(0, 1, (B, A)))
    action = torch.from_numpy(rng.integers(0, A, B).astype(np.int32)).to(dev)
    old = torch.log_softmax(logits + f(rng.normal(0, 0.2, (B, A))), -1)
    old_logp = old.gather(1, action.long()[:, None])[:, 0].contiguous()
    value = f(rng.normal(0, 1, B))
    old_value = value + f(rng.normal(0, 0.3, B))
    adv = f(rng.normal(0.1, 1.5, B))
    target = old_value + adv
    return logits, value, action, old_logp, old_value, adv, target


def loss_scales(logits, value, action, old_logp, old_value, adv, target,
                cfg):
    """The mean absolute per-sample term of each loss metric and of the
    total: the scale a float32 sum of these terms is exact to."""
    lp = torch.log_softmax(logits, -1)
    logp = lp.gather(1, action.long()[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    an = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = torch.minimum(ratio * an, torch.clamp(
        ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * an).abs().mean()
    v = ((value - target) ** 2).mean() + ((old_value - target) ** 2).mean()
    ent = (torch.exp(lp) * lp).sum(-1).abs().mean()
    lr = logp - old_logp
    kl = ((torch.exp(lr) - 1) - lr).abs().mean()
    total = pg + cfg.vf_coef * v + cfg.entropy_coef * ent
    return torch.stack([total, pg, v, ent, kl])


def phase_k11_update(dev, report):
    """K11-gae exact against its twin at [128, 4096]; K11-loss forward and
    backward against autograd of `loss_plain` at B = 131072, A = 8: each
    scalar within 1e-6 of its terms' mean absolute value (the scale of a
    float32 sum of them; pg_loss is a mean of terms that cancel), dlogits
    and dvalue within 1e-6 of their largest element; K11-adam against
    `optim.step_plain` over 16 steps (every other one clipped), the
    params within 1e-6 of their largest."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.train import optim, ppo
    rng = np.random.default_rng(12)
    T, N = PPO_STEPS, PPO_LANES
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    reward = f(np.where(rng.random((T, N)) < 0.05, rng.random((T, N)), 0))
    value = f(rng.normal(0, 1, (T, N)))
    done = torch.from_numpy(rng.random((T, N)) < 0.05).to(dev)
    last = f(rng.normal(0, 1, N))
    cfg = ppo.PPOConfig()
    adv, target = kernels.gae(reward, value, done, last, cfg.gamma,
                              cfg.gae_lambda)
    padv, ptarget = ppo.gae_plain(reward, value, done, last, cfg.gamma,
                                  cfg.gae_lambda)
    check(torch.equal(adv, padv) and torch.equal(target, ptarget),
          "K11-gae differs from its twin")
    report["K11-gae"]["max_abs_err"] = 0.0

    B, A = LOSS_BATCH, 8
    inp = loss_inputs(dev, B, A, 13)
    coefs = (cfg.clip_eps, cfg.vf_coef, cfg.entropy_coef)
    out, stats = kernels.ppo_loss_fwd(*inp, *coefs)
    one = torch.ones((), device=dev)
    dl, dv = kernels.ppo_loss_bwd(*inp, stats, one, *coefs)
    lg = inp[0].clone().requires_grad_()
    vv = inp[1].clone().requires_grad_()
    total, m = ppo.loss_plain(lg, vv, *inp[2:], *coefs)
    total.backward()
    want = torch.cat([total.detach()[None], m])
    scale = loss_scales(*inp, cfg)
    d = (out - want).abs()
    check(bool((d <= 1e-6 * scale).all()),
          f"K11-loss forward beyond 1e-6 of its scales: {d.tolist()} vs "
          f"{scale.tolist()}")
    e_l = float((dl - lg.grad).abs().max() / lg.grad.abs().max())
    e_v = float((dv - vv.grad).abs().max() / vv.grad.abs().max())
    check(e_l <= 1e-6 and e_v <= 1e-6,
          f"K11-loss backward beyond 1e-6 relative: {e_l}, {e_v}")
    report["K11-loss"]["max_abs_err"] = max(
        float(d.max()), float((dl - lg.grad).abs().max()),
        float((dv - vv.grad).abs().max()))

    n = make_net(10, 8, 64, 7, dev).n_params
    p0 = f(rng.normal(0, 0.1, n))
    tx = optim.ClipAdam(cfg.lr, max_grad_norm=cfg.max_grad_norm)
    pk, pp = p0.clone(), p0.clone()
    sk, sp = tx.init(pk), tx.init(pp)
    for i in range(ADAM_STEPS):
        g = f(rng.normal(0, 1e-2 if i % 2 else 1e-3, n))
        tx.step(pk, g, sk)  # CUDA: K11-adam
        s = tx.scalars(sp.count)
        optim.step_plain(pp, g, sp.mu, sp.nu, **s)
        sp.count += 1
    e_a = float((pk - pp).abs().max())
    check(e_a <= 1e-6 * float(pp.abs().max()),
          f"K11-adam beyond 1e-6 relative after {ADAM_STEPS} steps: {e_a}")
    report["K11-adam"]["max_abs_err"] = e_a
    say("k11_update", gae=f"[{T}, {N}] exact", loss_batch=B,
        loss_err=report["K11-loss"]["max_abs_err"], grad_rel=max(e_l, e_v),
        adam_params=n, adam_steps=ADAM_STEPS, adam_err=e_a, ok=True)


def ppo_fixture_case(fx, c, dev):
    """Case `c` of the PPO fixture: (env, params, PPOConfig, transform,
    seed), built as tests/test_torch_ppo_golden.py builds it."""
    from cpr_tpu_torch.train import config, driver, ppo
    s = {k[len(c) + 1:]: fx[k].item() for k in fx
         if k.startswith(f"{c}_") and fx[k].ndim == 0
         and not k.startswith(f"{c}_m_")}
    env = net_env(s["protocol"], s["window"], s["assumption"])
    L = PPO_FIX_LANES
    alphas = np.linspace(s["alpha_lo"], s["alpha_hi"], L)
    from cpr_tpu_torch.params import make_params, stack_params
    params = (stack_params([dict(alpha=float(a), gamma=s["gamma"],
                                 max_steps=s["max_steps"]) for a in alphas])
              if s["per_env"] else
              make_params(alpha=s["alpha_lo"], gamma=s["gamma"],
                          max_steps=s["max_steps"]))
    transform = None
    if s["transform"]:
        tc = config.TrainConfig(reward=s["transform"],
                                episode_len=s["max_steps"])
        transform = driver.make_reward_transform(tc, alphas, dev)
    cfg = ppo.PPOConfig(n_envs=L, n_steps=PPO_FIX_STEPS, update_epochs=2,
                        n_minibatches=2, hidden=(64, 64),
                        target_kl=s["target_kl"] or None)
    return env, params, cfg, transform, s


def step_trajectory(env, params, carry, n_steps, transform):
    """The trajectory `train_step(carry)` collects, from a copy of the
    carry: `ppo.rollout` from its key, then the reward transform."""
    from cpr_tpu_torch.train import ppo
    ts, state, obs, key = carry
    _, traj = ppo.rollout(env, clone_carry((state, obs)), params, ts.net,
                          key, n_steps)
    if transform is not None:
        traj.reward = transform(traj.reward, traj.info, traj.done)
    return traj


def phase_ppo_fixture(dev, pfx):
    """The JAX fixture's two train_steps (Nakamoto under AssumptionEnv
    with per-lane alphas, the sparse_relative transform and the KL stop;
    Tailstorm in a 40-slot ring) replayed from JAX's params through the
    kernels: the same actions, rewards and dones, logp and value within
    1e-5, the metrics within 1e-5 relative (1e-6 floor), params within
    1e-5."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.train import ppo
    for c in ("nak", "ts"):
        env, params, cfg, transform, s = ppo_fixture_case(pfx, c, dev)
        init_fn, train_step = ppo.make_train(
            env, params, cfg, transform, per_env_params=bool(s["per_env"]),
            device=dev)
        carry = init_fn(rnd.PRNGKey(s["seed"], dev),
                        params=torch.from_numpy(pfx[f"{c}_params0"]))
        traj = step_trajectory(env, params, carry, cfg.n_steps, transform)
        carry, metrics = train_step(carry)
        for k in ("action", "reward", "done"):
            check(np.array_equal(getattr(traj, k).cpu().numpy(),
                                 pfx[f"{c}_{k}"]),
                  f"PPO fixture {c}: {k} differs from JAX")
        e = max(float(np.abs(getattr(traj, k).cpu().numpy()
                             - pfx[f"{c}_{k}"]).max())
                for k in ("logp", "value"))
        check(e <= 1e-5, f"PPO fixture {c}: logp/value beyond 1e-5 ({e})")
        for k, v in metrics.items():
            w = float(pfx[f"{c}_m_{k}"])
            check(abs(float(v) - w) <= 1e-5 * abs(w) + 1e-6,
                  f"PPO fixture {c}: metric {k} {float(v)} vs JAX {w}")
        dp = float(np.abs(carry[0].net.flat.detach().cpu().numpy()
                          - pfx[f"{c}_params1"]).max())
        check(dp <= 1e-5, f"PPO fixture {c}: params beyond 1e-5 ({dp})")
        say("ppo_fixture", case=c, protocol=s["protocol"],
            episodes=int(traj.done.sum()), logp_value_err=e, params_err=dp,
            kl_stop=float(metrics.get("kl_stop", 0.0)), ok=True)


def phase_bench_ppo(dev, report):
    """The bench path (bench.py:257-309 measure_tailstorm_ppo): Tailstorm
    8 discount heuristic in a 128-slot ring, alpha 0.35, gamma 0.5,
    max_steps 120, PPOConfig(n_envs=4096, n_steps=128) defaults, no
    reward transform; one warm train_step, then 3 timed ones with the
    launch counts zeroed before and read after (K1, K10-ts and K11
    only); every metric finite, entropy in (0, ln 8]. Then, outside the
    counted run, 3 steps composed of the same pieces (rollout, GAE, the
    minibatch epochs) with synchronised clocks between them give the
    split, and `net_stream_case` holds the stream with the trained net
    to the plain versions at this shape from a fresh reset."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.params import make_params
    from cpr_tpu_torch.train import ppo
    env = dag_env("ts")
    params = make_params(alpha=0.35, gamma=0.5, max_steps=PPO_MAX_STEPS)
    cfg = ppo.PPOConfig(n_envs=PPO_LANES, n_steps=PPO_STEPS)
    init_fn, train_step = ppo.make_train(env, params, cfg, device=dev)
    carry = init_fn(rnd.PRNGKey(0, dev))
    carry, metrics = train_step(carry)
    torch.cuda.synchronize()
    kernels.reset_launches()
    step_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        carry, metrics = train_step(carry)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = dict(kernels.launches)
    path_launches(counts, ("K1", "K10-ts", "K11-act", "K11-gae",
                           "K11-loss", "K11-adam"), "bench PPO")
    m = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in m.values()), f"non-finite metrics {m}")
    check(0.0 < m["entropy"] <= float(np.log(8)) + 1e-6,
          f"entropy {m['entropy']} outside (0, ln 8]")
    rate = PPO_LANES * PPO_STEPS / (min(step_ms) / 1e3)

    epochs = ppo.make_minibatch_epochs(cfg)
    ts, state, obs, key = carry
    splits = []
    for _ in range(3):
        t0 = time.perf_counter()
        key, traj = ppo.rollout(env, (state, obs), params, ts.net, key,
                                cfg.n_steps)
        with torch.no_grad():
            _, last_value = ts.net(obs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        advs, targets = ppo.gae(traj.reward, traj.value, traj.done,
                                last_value, cfg.gamma, cfg.gae_lambda)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ts, key, _ = epochs(ts, traj, advs, targets, key)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        splits.append({"rollout": (t1 - t0) * 1e3, "gae": (t2 - t1) * 1e3,
                       "update": (t3 - t2) * 1e3})
    del traj
    say("bench_ppo", lanes=PPO_LANES, steps=PPO_STEPS,
        env_steps_per_s=rate, step_ms=step_ms,
        split_ms=json.dumps(splits), entropy=m["entropy"],
        episodes=int(m["n_episodes"]), launches=json.dumps(counts))

    episodes, e, below, rings = net_stream_case(
        env, params, ts.net, rnd.split(rnd.PRNGKey(70, dev), PPO_LANES),
        PPO_STEPS, rnd.PRNGKey(71, dev), "bench net stream")
    report["K11-act"]["max_abs_err"] = max(report["K11-act"]["max_abs_err"],
                                           e)
    say("net_stream", env="bench", lanes=PPO_LANES, steps=PPO_STEPS,
        max_steps=PPO_MAX_STEPS, hidden=cfg.hidden[0], episodes=episodes,
        max_abs_err=e, lanes_below_margin=below, **rings, ok=True)
    return counts, carry


TRAIN_YAMLS = {
    # cpr_tpu/train/configs/nakamoto.yaml
    "nakamoto": dict(protocol="nakamoto", alpha=dict(min=0.15, max=0.45),
                     gamma=0.5, episode_len=128, reward="sparse_relative",
                     shape="raw", n_envs=1024, total_updates=500,
                     ppo=dict(lr=0.0003, n_steps=128, n_minibatches=8,
                              update_epochs=4, n_layers=2, layer_size=64,
                              ent_coef=0.01),
                     eval=dict(freq=20, alpha_step=0.05,
                               episodes_per_alpha=128)),
    # cpr_tpu/train/configs/tailstorm-8-discount.yaml
    "tailstorm": dict(protocol="tailstorm-8-discount-heuristic",
                      alpha=dict(min=0.15, max=0.45), gamma=0.5,
                      episode_len=128, reward="sparse_per_progress",
                      shape="raw", n_envs=512, total_updates=300,
                      ppo=dict(lr=0.0003, n_steps=64, n_minibatches=4,
                               layer_size=96),
                      eval=dict(freq=25, alpha_step=0.05,
                                episodes_per_alpha=64)),
    # cpr_tpu/train/configs/spar-8.yaml and sdag-8-discount.yaml
    **{name: dict(protocol=protocol, alpha=dict(min=0.15, max=0.45),
                  gamma=0.5, episode_len=128, reward="sparse_per_progress",
                  shape="raw", n_envs=512, total_updates=300,
                  ppo=dict(lr=0.0003, n_steps=64, n_minibatches=4,
                           layer_size=96),
                  eval=dict(freq=25, alpha_step=0.05, episodes_per_alpha=64))
       for name, protocol in (("spar", "spar-8-constant"),
                              ("sdag", "sdag-8-discount-heuristic"))},
}


def config_ring_case(name, cfg, net, env, dev):
    """A DAG config's env (Tailstorm, Spar, Sdag) as `build_env` makes it
    on the card (a 128-slot ring; the reference sizes it for the episode)
    under the trained net at the config's widths (hidden 96,
    AssumptionEnv, its lane alphas, episode_len 128): `net_stream_case`
    over its lanes for CONFIG_RING_STEPS steps from a raw reset, so every
    lane runs a whole episode, with the first CONFIG_FULL_LANES lanes
    replayed through the full-mode env too; no episode may end by
    evicting a live block."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.train import driver
    params = driver._stack_params(cfg.lane_alphas(cfg.n_envs), cfg.gamma,
                                  cfg.episode_len)
    full = driver.build_env(cfg, "cpu")
    episodes, e, below, rings = net_stream_case(
        env, params, net, rnd.split(rnd.PRNGKey(80, dev), cfg.n_envs),
        CONFIG_RING_STEPS, rnd.PRNGKey(81, dev), f"{name} config ring",
        full_env=full, full_lanes=CONFIG_FULL_LANES)
    check(rings["episodes_overflowed"] == 0,
          f"{name} config: {rings['episodes_overflowed']} episodes "
          f"overflowed the {env.inner.capacity}-slot ring")
    check(episodes >= cfg.n_envs, f"{name} config: an episode unfinished")
    say("config_ring", config=name, lanes=cfg.n_envs,
        steps=CONFIG_RING_STEPS, hidden=net.hidden[0],
        window=env.inner.capacity, full_capacity=full.inner.capacity,
        full_mode_lanes=CONFIG_FULL_LANES, episodes=episodes,
        max_abs_err=e, lanes_below_margin=below, **rings, ok=True)


def phase_config_path(dev, report, tmp):
    """The config path: `train_from_config(TrainConfig.from_dict(...))`
    on the shipped nakamoto.yaml for 3 updates and tailstorm-8-
    discount.yaml, spar-8.yaml and sdag-8-discount.yaml (hidden 96, 512
    lanes x 64 steps; 128-slot ring) for 2 each, with eval.freq 1 and
    start_at_iteration 0 so that the eval and the checkpoints run; launch
    counts per config; eval rows finite, relative reward in [0, 1]; then
    a policy snapshot exported and reloaded gives the same greedy
    actions; for the DAG configs `config_ring_case` with the trained
    net."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.train import config, driver
    counts_all = []
    for name, ran, n_updates in (("nakamoto", ("K1", "K2"), 3),
                                 ("tailstorm", ("K1", "K10-ts"), 2),
                                 ("spar", ("K1", "K10-spar"), 2),
                                 ("sdag", ("K1", "K10-sdag"), 2)):
        d = dict(TRAIN_YAMLS[name])
        d["eval"] = dict(d["eval"], freq=1, start_at_iteration=0)
        cfg = config.TrainConfig.from_dict(d)
        out_dir = str(Path(tmp) / name)
        kernels.reset_launches()
        t0 = time.perf_counter()
        net, history, rows = driver.train_from_config(
            cfg, out_dir=out_dir, n_updates=n_updates, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(kernels.launches)
        path_launches(counts, ran + ("K11-act", "K11-gae", "K11-loss",
                                     "K11-adam"), f"{name} config")
        counts_all.append(counts)
        check(len(rows) == n_updates * len(cfg.eval_alphas()),
              f"{name}: {len(rows)} eval rows")
        for r in rows:
            check(all(np.isfinite(v) for v in r.values()),
                  f"{name}: non-finite eval row {r}")
            check(0.0 <= r["relative_reward"] <= 1.0,
                  f"{name}: relative reward {r['relative_reward']}")
        for f in ("last-model.msgpack", "best-model.msgpack"):
            check((Path(out_dir) / f).exists(), f"{name}: no {f}")
        # the snapshot round trip
        env = driver.build_env(cfg, dev)
        snap = str(Path(out_dir) / "snapshot-policy.msgpack")
        driver.export_policy_snapshot(
            snap, net, protocol=cfg.protocol, n_actions=env.n_actions,
            observation_length=env.observation_length,
            hidden=driver.ppo_config(cfg).hidden)
        policy, meta = driver.load_policy_snapshot(snap, dev)
        obs = torch.rand((1024, env.observation_length), device=dev)
        with torch.no_grad():
            a0 = torch.argmax(net(obs)[0], -1)
            a1 = torch.argmax(policy.net(obs)[0], -1)
        check(torch.equal(a0, a1) and torch.equal(net.flat, policy.net.flat),
              f"{name}: the reloaded snapshot acts otherwise")
        if name != "nakamoto":
            config_ring_case(name, cfg, net, env, dev)
        last = history[-1]
        say("config_path", config=name, eval_freq=1, start_at_iteration=0,
            updates=n_updates, seconds=secs,
            steps_per_sec=last.get("steps_per_sec"),
            entropy=last["entropy"],
            eval_rel=json.dumps([round(r["relative_reward"], 4)
                                 for r in rows[-len(cfg.eval_alphas()):]]),
            snapshot=meta["integrity"], launches=json.dumps(counts))
    return counts_all


def phase_k11_times(dev, report, bench_carry):
    """K11's device times with the L2 cache scrubbed, plain versions'
    and library yardsticks' times, and the bounds: K11-act's check
    kernel (4096 lanes, hidden 64, warp mode, Tailstorm's widths) and
    the Tailstorm stream with the net against the heuristic per 128-step
    launch; K11-gae at [128, 4096]; K11-loss forward and backward at
    B = 131072, A = 8; K11-adam on the bench net's parameters (library:
    torch.optim.Adam(fused=True).step() on the same flat vector)."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.params import make_params
    from cpr_tpu_torch.train import optim, ppo
    rng = np.random.default_rng(14)
    L, F, A, H = ACT_LANES, 10, 8, 64
    net = bench_carry[0].net
    obs = torch.from_numpy(rng.random((L, F), dtype=np.float32)).to(dev)
    k_act = rnd.PRNGKey(8, dev)
    act = report["K11-act"]
    act["ms"] = device_ms(lambda: kernels.actor_check(
        net, obs, None, None, k_act, warp=True), 50,
        ("actor_check_kernel", "true"))
    # obs and the weights in; logits, value, action and logp out. Per
    # lane the net's FMAs (one operation each at OPS_PER_S, the float32
    # FMA rate) and the A gumbel draws' threefry blocks
    fmas = 2 * (F * H + H * H) + H * (A + 1)
    act["bound_ms"], act["bound_by"] = bound_ms(
        L * (F * 4 + A * 4 + 4 + 4 + 4) + net.n_params * 4,
        L * (fmas + A * THREEFRY_OPS))

    def plain_act():
        with torch.no_grad():
            pl, pv = net(obs)
        z = pl + rnd.gumbel(k_act, (L, A))
        return torch.argmax(z, -1), pv
    act["plain_ms"] = cuda_ms(plain_act, 20)
    act["library_ms"] = None

    env = dag_env("ts")
    params = make_params(alpha=0.35, gamma=0.5, max_steps=PPO_MAX_STEPS)
    carry = env.reset_lanes(rnd.split(rnd.PRNGKey(30, dev), L), params)
    pid = env.scripted_policy_id(DAG_ENVS["ts"][1])
    key = rnd.PRNGKey(31, dev)
    net_pol = ppo.NetPolicy(net, greedy=False, key=key)
    stream_net = device_ms(lambda: env._kernel_stream(
        clone_carry(carry), None, 0, PPO_STEPS, params, 0, False, True,
        net=net_pol), 3, ("dag_stream_kernel", "true, true"))
    stream_plain = device_ms(lambda: env._kernel_stream(
        clone_carry(carry), None, 0, PPO_STEPS, params, pid, False, True),
        3, ("dag_stream_kernel", "true, false"))

    T, N = PPO_STEPS, PPO_LANES
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    reward = f(rng.random((T, N)))
    value = f(rng.normal(0, 1, (T, N)))
    done = torch.from_numpy(rng.random((T, N)) < 0.05).to(dev)
    last = f(rng.normal(0, 1, N))
    cfg = ppo.PPOConfig()
    g = report["K11-gae"]
    g["ms"] = device_ms(lambda: kernels.gae(reward, value, done, last,
                                            cfg.gamma, cfg.gae_lambda),
                        50, "gae_kernel")
    g["plain_ms"] = cuda_ms(lambda: ppo.gae_plain(
        reward, value, done, last, cfg.gamma, cfg.gae_lambda), 5)
    g["bound_ms"], g["bound_by"] = bound_ms(T * N * (4 + 4 + 1 + 8) + N * 4,
                                            0)
    g["library_ms"] = None

    B = LOSS_BATCH
    inp = loss_inputs(dev, B, A, 15)
    coefs = (cfg.clip_eps, cfg.vf_coef, cfg.entropy_coef)
    out, stats = kernels.ppo_loss_fwd(*inp, *coefs)
    one = torch.ones((), device=dev)
    fwd = device_ms(lambda: kernels.ppo_loss_fwd(*inp, *coefs), 50,
                    "loss_fwd_kernel")
    bwd = device_ms(lambda: kernels.ppo_loss_bwd(*inp, stats, one, *coefs),
                    50, "loss_bwd_kernel")

    def plain_loss():
        lg = inp[0].detach().requires_grad_()
        vv = inp[1].detach().requires_grad_()
        total, _ = ppo.loss_plain(lg, vv, *inp[2:], *coefs)
        total.backward()
    lo = report["K11-loss"]
    lo["ms"] = fwd + bwd
    lo["plain_ms"] = cuda_ms(plain_loss, 20)
    in_bytes = B * (A * 4 + 4 * 6)
    lo["bound_ms"], lo["bound_by"] = bound_ms(
        in_bytes + 5 * 4 + in_bytes + B * (A + 1) * 4, 0)
    lo["library_ms"] = None

    n = net.n_params
    p = f(rng.normal(0, 0.1, n))
    grad = f(rng.normal(0, 1e-2, n))
    tx = optim.ClipAdam(cfg.lr, max_grad_norm=cfg.max_grad_norm)
    st = tx.init(p)
    ad = report["K11-adam"]
    ad["ms"] = device_ms(lambda: kernels.adam(p, grad, st.mu, st.nu,
                                              **tx.scalars(0)), 50,
                         "adam_kernel")
    ad["plain_ms"] = cuda_ms(lambda: optim.step_plain(
        p, grad, st.mu, st.nu, **tx.scalars(0)), 50)
    ad["bound_ms"], ad["bound_by"] = bound_ms(n * 4 * 4 + n * 4 * 3, 0)
    lib_p = torch.nn.Parameter(p.clone())
    lib_p.grad = grad.clone()
    lib_opt = torch.optim.Adam([lib_p], lr=cfg.lr, eps=1e-5, fused=True)
    ad["library_ms"] = event_ms(lib_opt.step, 50)
    say("k11_times", **{k: json.dumps(
        {f: report[k][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")})
        for k in ("K11-act", "K11-gae", "K11-loss", "K11-adam")},
        loss_fwd_ms=fwd, loss_bwd_ms=bwd, ts_stream_net_ms=stream_net,
        ts_stream_heuristic_ms=stream_plain,
        net_in_stream_ms=stream_net - stream_plain)


# -- the netsim slice: K1's float64 modes, K12-scan, K12-event, K13 ---------

def netsim_fixture_net(nfx, name):
    """A fixture case's compiled topology (its planes as stored)."""
    from cpr_tpu_torch.netsim.compile import CompiledNet
    g = lambda f: nfx[f"{name}_net_{f}"]  # noqa: E731
    return CompiledNet(n=int(g("n")), compute=g("compute"), kind=g("kind"),
                       p0=g("p0"), p1=g("p1"),
                       activation_delay=float(g("activation_delay")),
                       flooding=bool(g("flooding")))


def netsim_fixture_cases(nfx, mode):
    return sorted(k[:-len("_mode")] for k in nfx
                  if k.endswith("_mode") and str(nfx[k]) == mode)


def netsim_fixture_run(nfx, name, dev):
    """A fixture case through the kernels (Engine/AttackEngine.lanes)."""
    from cpr_tpu_torch import netsim
    from cpr_tpu_torch.netsim import engine as E
    cn = netsim_fixture_net(nfx, name)
    A = int(nfx[f"{name}_A"])
    keys = E.lane_keys(nfx[f"{name}_seeds"].tolist(), dev)
    dl = torch.as_tensor(nfx[f"{name}_delays"], dtype=torch.float64,
                         device=dev)
    mode = str(nfx[f"{name}_mode"])
    if mode == "attack":
        eng = netsim.AttackEngine(
            cn, activations=A, device=dev,
            policies=tuple(str(p) for p in nfx["attack_policies"]))
        out = eng.lanes(keys, dl, torch.as_tensor(nfx[f"{name}_alphas"],
                                                  device=dev),
                        torch.as_tensor(nfx[f"{name}_pids"], device=dev))
    else:
        out = netsim.Engine(cn, activations=A, mode=mode,
                            device=dev).lanes(keys, dl)
    return E.finish(out)


def compare_netsim(got: dict, want: dict, what, rtol=0.0):
    """Every key of `want` but the margin: integers equal, float64 times
    within rtol (0: equal). Returns the largest absolute time error."""
    err = 0.0
    for k, w in want.items():
        if k == "margin":
            continue
        g = got[k]
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        check(g.shape == w.shape, f"{what}: {k} shape {g.shape} vs {w.shape}")
        if w.dtype == np.float64:
            check(np.allclose(g, w, rtol=rtol, atol=0),
                  f"{what}: {k} differs beyond rtol {rtol}")
            err = max(err, float(np.abs(g - w).max()))
        else:
            check(np.array_equal(g, w.astype(g.dtype)), f"{what}: {k} differs")
    return err


def check_fixture_cases(nfx, mode, dev):
    for name in netsim_fixture_cases(nfx, mode):
        got = netsim_fixture_run(nfx, name, dev)
        want = {k[len(name) + 1:]: nfx[k] for k in nfx
                if k.startswith(name + "_") and not k.startswith(
                    (name + "_net_", name + "_seeds", name + "_delays",
                     name + "_alphas", name + "_pids", name + "_A",
                     name + "_mode"))}
        compare_netsim(got, want, f"{name} vs the JAX fixture",
                       NET_TIME_RTOL)
        say("netsim_fixture", case=name, lanes=len(nfx[f"{name}_seeds"]),
            ok=True)


def bench_clique(n, prop):
    from cpr_tpu_torch import netsim, network
    return netsim.compile_network(network.symmetric_clique(
        n, activation_delay=NET_ACT_DELAY, propagation_delay=prop))


def lane_inputs(seeds, delays, dev):
    from cpr_tpu_torch.netsim import engine as E
    return (E.lane_keys(list(seeds), dev),
            torch.as_tensor(list(delays), dtype=torch.float64, device=dev))


def phase_k1_f64(dev, nfx, report):
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.netsim.compile import clamp_uniform
    key = rnd.PRNGKey(5, dev, x64=True)
    n = 1 << 20
    u = rnd.uniform(key, (n,), dtype=torch.float64)
    check(torch.equal(u, rnd.threefry_plain(key, n, 0, rnd.MODE_UNIFORM64)),
          "K1 float64 uniform differs from plain")
    e = rnd.exponential(key, (n,), dtype=torch.float64)
    e_plain = rnd.threefry_plain(key, n, 0, rnd.MODE_EXPONENTIAL64)
    rel = float(((e - e_plain).abs() / e_plain.abs().clamp(min=1e-300)).max())
    check(rel <= 1e-15, f"K1 float64 exponential {rel} from plain")
    for i, s in enumerate(nfx["k1_seeds"].tolist()):
        k = rnd.PRNGKey(s, dev, x64=True)
        u = rnd.uniform(k, (nfx["k1_uniform"].shape[1],), dtype=torch.float64)
        check(np.array_equal(u.cpu().numpy(), nfx["k1_uniform"][i]),
              f"K1 float64 uniform of seed {s} differs from jax")
        check(np.array_equal(clamp_uniform(u).cpu().numpy(),
                             nfx["k1_clamped"][i]),
              f"K1 clamped uniform of seed {s} differs from jax")
        e = rnd.exponential(k, (u.shape[0],), dtype=torch.float64)
        check(np.allclose(e.cpu().numpy(), nfx["k1_exponential"][i],
                          rtol=1e-13, atol=0),
              f"K1 float64 exponential of seed {s} differs from jax")
    say("k1_f64", draws=n, exp_rel_vs_plain=rel,
        fixture_keys=len(nfx["k1_seeds"]), ok=True)


def plain_timed(fn):
    """fn() (a plain replay) and its seconds to a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def lane_slice(out: dict, n: int) -> dict:
    """The first n lanes of every output."""
    return {k: v[:n] for k, v in out.items()}


def phase_k12_scan(dev, nfx, report):
    """K12-scan at the netsim path's shape (the bench clique, NET_LANES x
    NET_ACTS: the row's plain time and error) and on a 5-node clique with
    exponential link delays at lookback 32 and 40 (branches the path does
    not run; NET_EXTRA_ACTS), each against its plain version; then the
    JAX fixture's scan cases."""
    from cpr_tpu_torch import distributions as D
    from cpr_tpu_torch import kernels, netsim, network
    from cpr_tpu_torch.netsim import engine as E
    exp_net = network.symmetric_clique(5, activation_delay=25.0,
                                       propagation_delay=1.0)
    for nd in exp_net.nodes:
        for ln in nd.links:
            ln.delay = D.exponential(2.0)
    exp_cn = netsim.compile_network(exp_net)
    margins, secs = {}, {}
    for what, cn, L, acts in (
            ("clique10", bench_clique(NET_NODES, NET_PROP), 32, NET_ACTS),
            ("exp5", exp_cn, 32, NET_EXTRA_ACTS),
            ("exp5_lookback40", exp_cn, 40, NET_EXTRA_ACTS)):
        keys, dl = lane_inputs(range(NET_LANES), [NET_ACT_DELAY] * NET_LANES,
                               dev)
        got = kernels.netsim_scan(cn, acts, L, keys, dl)
        want, secs[what] = plain_timed(
            lambda: E.scan_plain(cn, acts, L, keys, dl))
        margins[what] = float(want["margin"].min())
        err = compare_netsim(got, want, f"K12-scan {what} vs plain")
        if what == "clique10":
            report["K12-scan"]["plain_ms"] = secs[what] * 1e3
            report["K12-scan"]["max_abs_err"] = err
    check_fixture_cases(nfx, "scan", dev)
    say("k12_scan", lanes=NET_LANES, activations=NET_ACTS,
        max_abs_err=report["K12-scan"]["max_abs_err"],
        margin=json.dumps(margins), plain_s=json.dumps(secs), ok=True)


def orphan_rate(out, acts):
    return float(np.mean(1.0 - out["progress"] / float(acts)))


def drops(out):
    return int(sum(int(np.sum(out[k])) for k in ("drop_q", "drop_p",
                                                  "drop_b", "win_miss")))


def phase_netsim_path(dev, report):
    """The netsim path at bench.py's shape through Engine.run, its own
    launch counts; then the sweep shape, held to the plain version on all
    its lanes."""
    from cpr_tpu_torch import kernels, netsim, network
    from cpr_tpu_torch.netsim import engine as E
    net = network.symmetric_clique(NET_NODES, activation_delay=NET_ACT_DELAY,
                                   propagation_delay=NET_PROP)
    eng = netsim.Engine(net, protocol="nakamoto", activations=NET_ACTS)
    check(eng.mode == "scan", "the bench clique runs the scan path")
    seeds, delays = list(range(NET_LANES)), [NET_ACT_DELAY] * NET_LANES
    kernels.reset_launches()
    out = eng.run(seeds, delays)
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = eng.run(seeds, delays)
        secs.append(time.perf_counter() - t0)
    counts = dict(kernels.launches)
    path_launches(counts, ("K12-scan",), "netsim")
    orphan = orphan_rate(out, NET_ACTS)
    check(NET_ORPHAN_GUARD[0] < orphan < NET_ORPHAN_GUARD[1],
          f"netsim orphan rate {orphan} outside {NET_ORPHAN_GUARD}")
    check(drops(out) == 0 and not out["exhausted"].any(),
          "netsim path dropped or exhausted")
    check(np.all(out["node_act"].sum(1) == NET_ACTS), "activations lost")
    check(np.allclose(out["reward"].sum(1), out["progress"]),
          "rewards do not sum to the chain")
    check(np.all(np.isfinite(out["sim_time"])), "non-finite sim_time")
    say("netsim", lanes=NET_LANES, activations=NET_ACTS, orphan=orphan,
        activations_per_s=NET_LANES * NET_ACTS / min(secs), call_s=secs,
        launches=json.dumps(counts))

    ss, dd = netsim.grid(range(NET_SWEEP_SEEDS), NET_SWEEP_DELAYS)
    kernels.reset_launches()
    t0 = time.perf_counter()
    sweep = eng.run(ss, dd)
    sweep_s = time.perf_counter() - t0
    path_launches(dict(kernels.launches), ("K12-scan",), "netsim sweep")
    counts["K12-scan"] += kernels.launches["K12-scan"]
    check(drops(sweep) == 0 and not sweep["exhausted"].any(),
          "netsim sweep dropped or exhausted")
    by_delay = (1.0 - sweep["progress"] / NET_ACTS).reshape(
        len(NET_SWEEP_DELAYS), NET_SWEEP_SEEDS).mean(1)
    check(np.all(np.diff(by_delay) < 0),
          f"sweep orphan rates not falling with the delay: {by_delay}")
    keys, dl = lane_inputs(ss, dd, dev)
    want, plain_s = plain_timed(
        lambda: E.scan_plain(eng.net, NET_ACTS, eng.lookback, keys, dl))
    err = compare_netsim(sweep, want, "the netsim sweep vs plain")
    margin = float(want["margin"].min())
    del want
    say("netsim_sweep", lanes=len(ss), activations=NET_ACTS,
        delays=json.dumps(NET_SWEEP_DELAYS), call_s=sweep_s,
        activations_per_s=len(ss) * NET_ACTS / sweep_s,
        orphan_by_delay=json.dumps([round(float(x), 6) for x in by_delay]),
        plain_s=plain_s, max_abs_err=err, margin=margin, ok=True)
    return counts, orphan


def phase_k12_event(dev, nfx, report):
    """K12-event against its plain version at the event path's shape
    (the bench clique, NET_LANES x NET_ACTS, the path's sizing: the row's
    plain time and error) and with flooding on random_regular(13, 4)
    with exponential delays (the path runs no flooding; NET_FLOOD_LANES x
    NET_FLOOD_ACTS); then the JAX fixture's event cases."""
    from cpr_tpu_torch import distributions as D
    from cpr_tpu_torch import kernels, netsim, network
    from cpr_tpu_torch.netsim import engine as E
    flood = netsim.compile_network(network.random_regular(
        13, 4, activation_delay=NET_ACT_DELAY, delay=D.exponential(2.0),
        seed=1))
    margins, secs = {}, {}
    for what, cn, lanes, acts in (
            ("clique10", bench_clique(NET_NODES, NET_PROP), NET_LANES,
             NET_ACTS),
            ("flood13", flood, NET_FLOOD_LANES, NET_FLOOD_ACTS)):
        eng = netsim.Engine(cn, activations=acts, mode="event")
        keys, dl = lane_inputs(range(lanes), [NET_ACT_DELAY] * lanes, dev)
        got = kernels.netsim_event(cn, acts, eng.B, eng.M, eng.F, eng.S,
                                   keys, dl)
        want, secs[what] = plain_timed(lambda: E.event_plain(
            cn, acts, eng.B, eng.M, eng.F, eng.S, keys, dl))
        margins[what] = float(want["margin"].min())
        err = compare_netsim(got, want, f"K12-event {what} vs plain")
        if what == "clique10":
            report["K12-event"]["plain_ms"] = secs[what] * 1e3
            report["K12-event"]["max_abs_err"] = err
    check_fixture_cases(nfx, "event", dev)
    say("k12_event", lanes=NET_LANES, activations=NET_ACTS,
        max_abs_err=report["K12-event"]["max_abs_err"],
        margin=json.dumps(margins), plain_s=json.dumps(secs), ok=True)


def phase_k12_event_path(dev, report, scan_orphan):
    """The event engine at the netsim path's shape, its own launch
    counts, its orphan rate against the scan path's."""
    from cpr_tpu_torch import kernels, netsim
    eng = netsim.Engine(bench_clique(NET_NODES, NET_PROP),
                        activations=NET_ACTS, mode="event")
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = eng.run(range(NET_LANES), [NET_ACT_DELAY] * NET_LANES)
    call_s = time.perf_counter() - t0
    counts = dict(kernels.launches)
    path_launches(counts, ("K12-event",), "netsim event")
    orphan = orphan_rate(out, NET_ACTS)
    check(abs(orphan - scan_orphan) < NET_EVENT_GAP,
          f"event orphan rate {orphan} vs scan {scan_orphan}")
    check(drops(out) == 0 and not out["exhausted"].any(),
          "netsim event path dropped or exhausted")
    check(np.all(out["node_act"].sum(1) == NET_ACTS), "activations lost")
    say("netsim_event", lanes=NET_LANES, activations=NET_ACTS, orphan=orphan,
        scan_orphan=scan_orphan, call_s=call_s,
        steps_max=int(out["steps"].max()), launches=json.dumps(counts))
    return counts, int(out["steps"].sum())


def attack_lanes(n):
    """bench.py's lane grid: alpha-major over ATK_ALPHAS x policies,
    cycled to n lanes."""
    grid = [(a, p) for a in ATK_ALPHAS for p in range(len(ATK_POLICIES))]
    lanes = [grid[i % len(grid)] for i in range(n)]
    return ([a for a, _ in lanes], [p for _, p in lanes], lanes)


def relative_revenue(out):
    atk = np.asarray(out["reward_attacker"], np.float64)
    dfn = np.asarray(out["reward_defender"], np.float64)
    return atk / np.maximum(atk + dfn, 1e-9)


def attack_engine(acts, policies=ATK_POLICIES, queue_cap=ATK_QUEUE_CAP):
    """An AttackEngine on the bench's clique-4 (bench.py:477-541)."""
    from cpr_tpu_torch import netsim
    return netsim.AttackEngine(bench_clique(ATK_NODES, NET_PROP),
                               activations=acts, policies=policies,
                               topology="clique-4", queue_cap=queue_cap)


def attack_inputs(eng, n, alphas, pids, dev):
    keys, dl = lane_inputs(range(n), [NET_ACT_DELAY] * n, dev)
    return (keys, dl, torch.tensor(alphas, dtype=torch.float32, device=dev),
            torch.tensor(pids, dtype=torch.int32, device=dev))


def attack_plain_run(eng, keys, dl, al, pi):
    """The plain version of K13 on an engine's sizing and policies."""
    from cpr_tpu_torch.netsim import attack as AT
    return AT.attack_plain(eng.net, eng.activations, eng.B, eng.M, eng.F,
                           eng.S, eng.WA, keys, dl, al, eng._branches(), pi,
                           eng.strict_match)


def phase_k13(dev, nfx, report):
    """K13 against its plain version at the attack path's shape (clique-4,
    ATK_LANES x ATK_ACTS, its alphas, policies and queue: the row's plain
    time and error) and for every scripted policy at alpha 0.3 and 0.45
    (ATK_EXTRA_LANES x ATK_EXTRA_ACTS, the default queue); then the JAX
    fixture's attack cases."""
    from cpr_tpu_torch.netsim import attack as AT
    al, pi, _ = attack_lanes(ATK_LANES)
    n = ATK_EXTRA_LANES
    margins, secs = {}, {}
    for what, eng, lanes, alphas, pids in (
            ("path", attack_engine(ATK_ACTS), ATK_LANES, al, pi),
            ("policies", attack_engine(ATK_EXTRA_ACTS, AT.SCRIPTED_POLICIES,
                                       None), n,
             [0.3 if i % 2 else 0.45 for i in range(n)],
             [i // 2 % 4 for i in range(n)])):
        args = attack_inputs(eng, lanes, alphas, pids, dev)
        got = eng.lanes(*args)
        want, secs[what] = plain_timed(lambda: attack_plain_run(eng, *args))
        margins[what] = float(want["margin"].min())
        err = compare_netsim(got, want, f"K13 {what} vs plain")
        if what == "path":
            report["K13"]["plain_ms"] = secs[what] * 1e3
            report["K13"]["max_abs_err"] = err
    check_fixture_cases(nfx, "attack", dev)
    say("k13", lanes=ATK_LANES, activations=ATK_ACTS, queue=ATK_QUEUE_CAP,
        max_abs_err=report["K13"]["max_abs_err"],
        margin=json.dumps(margins), plain_s=json.dumps(secs), ok=True)


def phase_attack_path(dev, report):
    """The attack path at bench.py's shape through AttackEngine.run, its
    own launch counts; the default queue's drops; then ATK_SWEEP_LANES x
    ATK_SWEEP_ACTS, held to the plain version on all its lanes."""
    from cpr_tpu_torch import kernels
    al, pi, lanes = attack_lanes(ATK_LANES)
    seeds, delays = list(range(ATK_LANES)), [NET_ACT_DELAY] * ATK_LANES
    d_out = attack_engine(ATK_ACTS, queue_cap=None).run(seeds, delays, al, pi)
    eng = attack_engine(ATK_ACTS)
    kernels.reset_launches()
    out = eng.run(seeds, delays, al, pi)
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = eng.run(seeds, delays, al, pi)
        secs.append(time.perf_counter() - t0)
    counts = dict(kernels.launches)
    path_launches(counts, ("K13",), "attack")
    rel = relative_revenue(out)
    hon = float(np.mean([rel[i] for i, ln in enumerate(lanes)
                         if ln == (0.33, 0)]))
    check(ATK_GUARD[0] < hon < ATK_GUARD[1],
          f"honest relative revenue at 0.33 {hon} outside {ATK_GUARD}")
    check(drops(out) == 0 and not out["exhausted"].any(),
          "attack path dropped or exhausted")
    check(np.all(out["node_act"].sum(1) == ATK_ACTS), "activations lost")
    check(np.allclose(out["reward_attacker"] + out["reward_defender"],
                      out["head_height"]), "rewards do not sum to the chain")
    sm1 = float(np.mean([rel[i] for i, ln in enumerate(lanes)
                         if ln == (0.45, 1)]))
    say("attack", lanes=ATK_LANES, activations=ATK_ACTS, rel_honest_033=hon,
        rel_sm1_045=sm1, lanes_per_s=ATK_LANES / min(secs), call_s=secs,
        queue=ATK_QUEUE_CAP, drops_at_default_queue=json.dumps(
            {k: int(np.sum(d_out[k])) for k in ("drop_q", "drop_p",
                                                "win_miss")}),
        launches=json.dumps(counts))

    al, pi, lanes = attack_lanes(ATK_SWEEP_LANES)
    big = attack_engine(ATK_SWEEP_ACTS)
    kernels.reset_launches()
    t0 = time.perf_counter()
    sweep = big.run(range(ATK_SWEEP_LANES), [NET_ACT_DELAY] * ATK_SWEEP_LANES,
                    al, pi)
    sweep_s = time.perf_counter() - t0
    path_launches(dict(kernels.launches), ("K13",), "attack sweep")
    counts["K13"] += kernels.launches["K13"]
    check(drops(sweep) == 0 and not sweep["exhausted"].any(),
          "attack sweep dropped or exhausted")
    want, plain_s = plain_timed(lambda: attack_plain_run(
        big, *attack_inputs(big, ATK_SWEEP_LANES, al, pi, dev)))
    err = compare_netsim(sweep, want, "the attack sweep vs plain")
    margin = float(want["margin"].min())
    del want
    rel = relative_revenue(sweep)
    cells = {f"{a}/{ATK_POLICIES[p]}": round(float(np.mean(
        [rel[i] for i, ln in enumerate(lanes) if ln == (a, p)])), 5)
        for a in ATK_ALPHAS for p in range(len(ATK_POLICIES))}
    say("attack_sweep", lanes=ATK_SWEEP_LANES, activations=ATK_SWEEP_ACTS,
        call_s=sweep_s, lanes_per_s=ATK_SWEEP_LANES / sweep_s,
        rel_by_cell=json.dumps(cells), plain_s=plain_s, max_abs_err=err,
        margin=margin, ok=True)
    return counts, int(out["steps"].sum())


def phase_netsim_times(dev, report, event_steps, attack_steps):
    """K12-scan, K12-event and K13 device times at the paths' bench
    shapes, the shapes of the plain replays that gave the rows' plain
    times, L2 scrubbed, by CUDA events around each wrapper call
    (`event_ms`: the window holds the wrapper's few small host-to-device
    copies of the topology planes and its output allocations beside a
    launch of 10-45 ms; the profiler's trace dropped one of three K12-scan
    launch records in three traces running); bounds from the draws each
    run needs (threefry blocks: K12-scan the gaps, the Gumbel rows and the
    key splits; K12-event and K13 a 5- or 4-way split a step, N + 1
    blocks an activation, 2 at init) and the lanes' inputs and outputs."""
    from cpr_tpu_torch import kernels, netsim
    N, L, A = NET_NODES, NET_LANES, NET_ACTS
    cn = bench_clique(N, NET_PROP)
    keys, dl = lane_inputs(range(L), [NET_ACT_DELAY] * L, dev)
    # per lane: key and delay in; nine int32 counters, the exhausted flag,
    # sim_time and node_act/reward [N] out
    io_bytes = lambda lanes, n: lanes * (16 + 9 * 4 + 1 + 8 + n * 8)  # noqa
    sc = report["K12-scan"]
    sc["ms"] = event_ms(lambda: kernels.netsim_scan(cn, A, 32, keys, dl), 5)
    sc["bound_ms"], sc["bound_by"] = bound_ms(
        io_bytes(L, N), L * THREEFRY_OPS * (5 + (A + 1) + A * N))
    sc["library_ms"] = None

    ev = report["K12-event"]
    eng = netsim.Engine(cn, activations=A, mode="event")
    ev["ms"] = event_ms(lambda: kernels.netsim_event(
        cn, A, eng.B, eng.M, eng.F, eng.S, keys, dl), 5)
    ev["bound_ms"], ev["bound_by"] = bound_ms(
        io_bytes(L, N), THREEFRY_OPS * (5 * event_steps + L * A * (N + 1)
                                        + 2 * L))
    ev["library_ms"] = None

    at = report["K13"]
    eng = attack_engine(ATK_ACTS)
    al, pi, _ = attack_lanes(ATK_LANES)
    akeys, adl, alt, pit = attack_inputs(eng, ATK_LANES, al, pi, dev)
    kpid = eng.kernel_policy_ids(pit)
    at["ms"] = event_ms(lambda: kernels.netsim_attack(
        eng.net, ATK_ACTS, eng.B, eng.M, eng.F, eng.S, eng.WA, akeys, adl,
        alt, kpid, True), 5)
    at["bound_ms"], at["bound_by"] = bound_ms(
        io_bytes(ATK_LANES, ATK_NODES) + ATK_LANES * 8,
        THREEFRY_OPS * (4 * attack_steps + ATK_LANES * ATK_ACTS
                        * (ATK_NODES + 1) + 2 * ATK_LANES))
    at["library_ms"] = None
    say("netsim_times", **{k: json.dumps(
        {f: report[k][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by")})
        for k in ("K12-scan", "K12-event", "K13")})


# -- the netsim's protocol branches and the honest-network sweep -------------

def proto_fixture_engine(prfx, name, dev):
    """A protocol fixture case's Engine, from the fixture alone."""
    from cpr_tpu_torch import netsim
    kw = dict(protocol=str(prfx[f"{name}_protocol"]),
              k=int(prfx[f"{name}_k"]), scheme=str(prfx[f"{name}_scheme"]),
              activations=int(prfx[f"{name}_A"]))
    for f in ("window", "uncle_cap"):
        if int(prfx[f"{name}_{f}"]):
            kw[f] = int(prfx[f"{name}_{f}"])
    return netsim.Engine(netsim_fixture_net(prfx, name), mode="event",
                         device=dev, **kw)


def phase_proto_fixture(dev, prfx):
    """Every case of the protocols' JAX fixture through its kernel: the
    sweep's seven event configurations at 2000 activations, the block
    schemes at k = 2 and 1, the forced window misses and flooding."""
    from cpr_tpu_torch.netsim import engine as E
    names = sorted(k[:-len("_protocol")] for k in prfx
                   if k.endswith("_protocol"))
    for name in names:
        eng = proto_fixture_engine(prfx, name, dev)
        check((eng.B, eng.W, eng.U) == tuple(int(prfx[f"{name}_{f}"])
                                             for f in ("B", "W", "U")),
              f"{name}: engine sizes differ from the JAX package's")
        keys, dl = lane_inputs(prfx[f"{name}_seeds"].tolist(),
                               prfx[f"{name}_delays"].tolist(), dev)
        got = E.finish(eng.lanes(keys, dl))
        want = {k: prfx[f"{name}_{k}"] for k in PROTO_OUT_KEYS}
        compare_netsim(got, want, f"{name} vs the JAX fixture",
                       NET_TIME_RTOL)
    say("proto_fixture", cases=len(names), ok=True)


def proto_engine(proto, k, scheme, acts, cn=None):
    from cpr_tpu_torch import netsim
    return netsim.Engine(cn if cn is not None
                         else bench_clique(HN_NODES, HN_PROP),
                         protocol=proto, k=k, scheme=scheme,
                         activations=acts)


def proto_plain(eng, keys, dl):
    from cpr_tpu_torch.netsim import engine as E
    return E.event_plain(eng.net, eng.activations, eng.B, eng.M, eng.F,
                         eng.S, keys, dl, eng.proto)


def phase_proto_plain(dev, report):
    """Each protocol kernel against its plain version, exactly: the
    kernel's first configuration (PROTO_FULL) at the path's full shape
    (the sweep's five lanes, 10 000 activations, delay 30 the most
    contended), its other configurations at HN_PLAIN_ACTS on the same
    lanes; then flooding on random_regular(13, 4) with exponential
    delays. The full shape's plain replay gives the row's plain time and
    error."""
    from cpr_tpu_torch import distributions as D
    from cpr_tpu_torch import kernels, netsim, network
    flood = netsim.compile_network(network.random_regular(
        13, 4, activation_delay=NET_ACT_DELAY, delay=D.exponential(2.0),
        seed=1))
    keys, dl = lane_inputs([HN_SEED] * len(HN_DELAYS), HN_DELAYS, dev)
    margins, secs = {}, {}
    for kern, configs in PROTO_CONFIGS.items():
        for i, (proto, k, scheme) in enumerate(configs):
            acts = HN_ACTS if i == 0 else HN_PLAIN_ACTS
            eng = proto_engine(proto, k, scheme, acts)
            what = f"{proto}-{k}-{scheme}@{acts}"
            got = eng.lanes(keys, dl)
            want, secs[what] = plain_timed(lambda: proto_plain(eng, keys, dl))
            margins[what] = float(want["margin"].min())
            err = compare_netsim(got, want, f"{kern} {what} vs plain")
            if i == 0:
                report[kern]["plain_ms"] = secs[what] * 1e3
                report[kern]["max_abs_err"] = err
                check(int(got["steps"].max()) > 0, f"{kern} ran no step")
        proto, k, scheme = configs[0]
        eng = proto_engine(proto, k, scheme, NET_FLOOD_ACTS, flood)
        fk, fd = lane_inputs(range(NET_FLOOD_LANES),
                             [NET_ACT_DELAY] * NET_FLOOD_LANES, dev)
        got = eng.lanes(fk, fd)
        what = f"{proto}-flood13"
        want, secs[what] = plain_timed(lambda: proto_plain(eng, fk, fd))
        margins[what] = float(want["margin"].min())
        compare_netsim(got, want, f"{kern} flooding vs plain")
    kernels.reset_launches()  # the comparisons' launches count nowhere
    say("proto_plain", margin=json.dumps(margins), plain_s=json.dumps(secs),
        max_abs_err=json.dumps({k: report[k]["max_abs_err"]
                                for k in PROTO_KERNELS}), ok=True)


def hn_guards(rows, spar_rows):
    """The sweep's guards on its rows: 30 rows and 2 Tailstorm error rows,
    then 10 Spar rows; every lane's activations there; Bk constant's
    rewards summing to its progress; Spar's progress k times the head's
    height; the Ethereum bounds of the JAX package's invariant test;
    orphan rates in [0, 0.2], falling from delay 30 to 600."""
    ok = [r for r in rows + spar_rows if "error" not in r]
    bad = [r for r in rows + spar_rows if "error" in r]
    check(len(ok) == 40 and len(bad) == 2, f"{len(ok)} rows, {len(bad)} "
          f"error rows, expected 40 and 2")
    check(all(r["protocol"] == "tailstorm"
              and r["reason"] == "unsupported-protocol" for r in bad),
          f"unexpected error rows: {bad}")
    orphan = {}
    for r in ok:
        what = f"{r['protocol']}-{r['k']}-{r['incentive_scheme']}"
        acts = sum(int(x) for x in r["node_activations"].split("|"))
        check(acts == HN_ACTS, f"{what}: {acts} activations")
        hh, prog = r["head_height"], r["head_progress"]
        if r["protocol"] == "bk" and r["incentive_scheme"] == "constant":
            check(abs(r["reward_total"] - prog) < 1e-6,
                  f"{what}: rewards {r['reward_total']} != progress {prog}")
        if r["protocol"] == "spar":
            check(prog == r["k"] * hh, f"{what}: progress {prog} != k*h")
        if r["protocol"].startswith("ethereum"):
            if r["protocol"] == "ethereum-byzantium":
                check(prog >= hh, f"{what}: progress below height")
            else:
                check(prog == hh, f"{what}: progress {prog} != height")
            check(hh - 1e-6 <= r["reward_total"] <= HN_ACTS + 1e-6,
                  f"{what}: rewards {r['reward_total']} out of bounds")
            check(r["on_chain"] >= hh, f"{what}: on_chain below height")
        check(0.0 <= r["orphan_rate"] <= 0.2,
              f"{what}: orphan rate {r['orphan_rate']}")
        orphan.setdefault(what, {})[r["activation_delay"]] = r["orphan_rate"]
    for what, by in orphan.items():
        check(by[30.0] > by[600.0], f"{what}: orphan rate at delay 30 "
              f"{by[30.0]} not above delay 600's {by[600.0]}")
    return orphan


def phase_honest_net(dev, report):
    """The honest-network sweep on the card (`experiments.honest_net_rows`,
    engine="jax") at the JAX package's defaults: the 8 default protocols
    (30 rows through K12-scan, K12-event-eth and K12-event-bk, and 2
    Tailstorm error rows), then Spar k=4 under both schemes at the same
    shape (K12-event-spar); one warm and three timed rounds, the launch
    counters zeroed before each call and read after it. The netsim's
    telemetry events count each call's drops and window misses; the
    lanes' outputs are read again by one Engine.run per configuration
    (exhausted), counted nowhere."""
    from cpr_tpu_torch import kernels, telemetry
    from cpr_tpu_torch.experiments import honest_net_rows
    counts = {k: 0 for k in kernels.launches}
    secs, spar_secs = [], []
    for rnd_i in range(4):
        buf = io.StringIO()
        telemetry.configure(stream=buf)
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            rows = honest_net_rows(engine="jax")
            secs.append(time.perf_counter() - t0)
            c1 = dict(kernels.launches)
            path_launches(c1, ("K12-scan", "K12-event-eth", "K12-event-bk"),
                          "honest-net")
            kernels.reset_launches()
            t0 = time.perf_counter()
            spar_rows = honest_net_rows(protocols=HN_SPAR, engine="jax")
            spar_secs.append(time.perf_counter() - t0)
            c2 = dict(kernels.launches)
            path_launches(c2, ("K12-event-spar",), "honest-net spar")
        finally:
            telemetry.configure()
        for c in (c1, c2):
            for k, n in c.items():
                counts[k] += n
        events = [json.loads(line) for line in buf.getvalue().splitlines()]
        nets = [e for e in events if e.get("name") == "netsim"
                and e.get("kind") == "event"]
        check(len(nets) == 8 and all(e["drops"] == 0 for e in nets),
              f"honest-net calls dropped or missed: {nets}")
        check(any(e.get("kind") == "manifest"
                  and e.get("backend") == "cuda" for e in events),
              "the sweep's manifest does not state the card")
        orphan = hn_guards(rows, spar_rows)
    check(all(r["backend"] == "cuda" for r in rows), "rows not on the card")
    for kern, configs in PROTO_CONFIGS.items():
        for proto, k, scheme in configs:
            out = proto_engine(proto, k, scheme, HN_ACTS).run(
                [HN_SEED] * len(HN_DELAYS), HN_DELAYS)
            check(drops(out) == 0 and not out["exhausted"].any(),
                  f"{proto}-{k}-{scheme} dropped or exhausted")
    kernels.reset_launches()
    say("honest_net", rows=len(rows) + len(spar_rows), call_s=secs,
        spar_call_s=spar_secs, orphan=json.dumps(
            {w: [round(by[d], 6) for d in HN_DELAYS]
             for w, by in orphan.items()}),
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    return counts


def phase_proto_times(dev, report):
    """Each protocol kernel's device time a launch at the path's shape (its
    first configuration, the sweep's five lanes x 10 000 activations),
    the L2 scrubbed, by CUDA events around the wrapper call; the bound:
    the threefry work of this run's steps (a 5-way split a step, N + 1
    blocks an activation and, Bk, one more for the vote's hash, 2 at
    init) and the lanes' inputs and outputs."""
    from cpr_tpu_torch import kernels
    N, L = HN_NODES, len(HN_DELAYS)
    keys, dl = lane_inputs([HN_SEED] * L, HN_DELAYS, dev)
    io_bytes = L * (16 + 9 * 4 + 1 + 8 + 2 * 8 + N * 8)
    for kern, configs in PROTO_CONFIGS.items():
        proto, k, scheme = configs[0]
        eng = proto_engine(proto, k, scheme, HN_ACTS)
        steps = int(eng.lanes(keys, dl)["steps"].sum())
        per_act = N + (2 if proto == "bk" else 1)
        r = report[kern]
        r["ms"] = event_ms(lambda: eng.lanes(keys, dl), 5)
        r["bound_ms"], r["bound_by"] = bound_ms(
            io_bytes, THREEFRY_OPS * (5 * steps + L * HN_ACTS * per_act
                                      + 2 * L))
        r["library_ms"] = None
    kernels.reset_launches()
    say("proto_times", **{k: json.dumps(
        {f: report[k][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by")})
        for k in PROTO_KERNELS})


def parametric_capstone():
    """The capstone's structure, compiled once at the probe point with
    its exponent columns; returns (ParamMDP, host seconds)."""
    from cpr_tpu_torch.mdp.grid import parametric_compile_native
    t0 = time.perf_counter()
    pm = parametric_compile_native("ghostdag", k=2,
                                   collect_garbage="simple",
                                   dag_size_cutoff=MDP_CUTOFF)
    return pm, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cpr_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("card", name=json.dumps(torch.cuda.get_device_name(0)),
        torch=torch.__version__, cuda=torch.version.cuda,
        count=torch.cuda.device_count())

    from cpr_tpu_torch import native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc processes
        gxx = pool.submit(native.build_lib,
                          native.SRC / "generic_compiler.cpp", "-O3")
        paths = kernels.build()
        kernels._load()
        host_lib = gxx.result()
    say("build", seconds=round(time.perf_counter() - t0, 2),
        libs=",".join(p.name for p in (*paths.values(), host_lib)))
    # the grid path's parametric cutoff-8 compile runs on the host (ctypes
    # releases the GIL) while the card works through the phases before it
    compiler = ThreadPoolExecutor(1)
    pm_future = compiler.submit(parametric_capstone)

    with np.load(FIXTURE) as f:
        fx = {k: f[k] for k in f.files}
    with np.load(MDP_FIXTURE) as f:
        mfx = {k: f[k] for k in f.files}
    with np.load(GRID_FIXTURE) as f:
        gfx = {k: f[k] for k in f.files}
    with np.load(DAG_FIXTURE) as f:
        dfx = {k: f[k] for k in f.files}
    with np.load(QUORUM_FIXTURE) as f:
        qfx = {k: f[k] for k in f.files}
    with np.load(PPO_FIXTURE) as f:
        pfx = {k: f[k] for k in f.files}
    with np.load(NETSIM_FIXTURE) as f:
        nfx = {k: f[k] for k in f.files}
    with np.load(SPAR_SDAG_FIXTURE) as f:
        sfx = {k: f[k] for k in f.files}
    with np.load(PROTO_FIXTURE) as f:
        prfx = {k: f[k] for k in f.files}
    for name in ("spar", "sdag"):  # the paths' reference revenues
        VOTE_REVENUE[name] = float(sfx[f"{name}_ref_revenue"])
    csrc = "cpr_tpu_torch/csrc"
    report = {
        "K1": dict(name="K1 threefry2x32", route="cuda",
                   source=f"{csrc}/random.cu",
                   replaces="cpr_tpu/envs/nakamoto.py:124"),
        "K2": dict(name="K2 nakamoto episode stream", route="cuda",
                   source=f"{csrc}/nakamoto_stream.cu",
                   replaces="cpr_tpu/envs/base.py:342"),
        "K3": dict(name="K3 nakamoto step_lanes", route="cuda",
                   source=f"{csrc}/nakamoto_stream.cu",
                   replaces="cpr_tpu/envs/base.py:259"),
        "K4": dict(name="K4 Bellman sweep", route="cuda",
                   source=f"{csrc}/mdp_sweep.cu",
                   replaces="cpr_tpu/mdp/explicit.py:352"),
        "K5": dict(name="K5 policy evaluation sweep", route="cuda",
                   source=f"{csrc}/mdp_sweep.cu",
                   replaces="cpr_tpu/mdp/explicit.py:862"),
        "K6": dict(name="K6 RTDP walkers", route="cuda",
                   source=f"{csrc}/rtdp.cu",
                   replaces="cpr_tpu/mdp/rtdp_graph.py:51"),
        "K7": dict(name="K7 grid Bellman sweep", route="cuda",
                   source=f"{csrc}/mdp_sweep.cu",
                   replaces="cpr_tpu/mdp/explicit.py:715"),
        # device functions that K10 runs inside its launches: the paths
        # hold K8's own counter (its check kernel's) at 0, and its row's
        # launches are the K10 launches of the paths
        "K8": dict(name="K8 block-DAG primitives (device functions run "
                   "inside every K10, launches theirs; ms, plain_ms "
                   "and bound_ms are its check kernel dag_script_kernel's)",
                   route="cuda",
                   source=f"{csrc}/dag.cuh",
                   replaces="cpr_tpu/core/dag.py:252"),
        "K10-bk": dict(name="K10-bk Bk withholding stream and step_lanes",
                       route="cuda", source=f"{csrc}/bk_stream.cu",
                       replaces="cpr_tpu/envs/bk.py:340", max_abs_err=0.0),
        "K10-eth": dict(name="K10-eth Ethereum withholding stream and "
                        "step_lanes", route="cuda",
                        source=f"{csrc}/ethereum_stream.cu",
                        replaces="cpr_tpu/envs/ethereum.py:327",
                        max_abs_err=0.0),
        # device functions that K10-ts/K10-stree/K10-sdag run inside their
        # launches, like K8
        "K9": dict(name="K9 vote quorums (device functions run inside "
                   "K10-ts/K10-stree/K10-sdag, launches theirs; ms, "
                   "plain_ms and bound_ms are its check kernel "
                   "quorum_check_kernel's)",
                   route="cuda", source=f"{csrc}/quorum.cuh",
                   replaces="cpr_tpu/envs/quorum.py:65"),
        "K10-ts": dict(name="K10-ts Tailstorm withholding stream and "
                       "step_lanes", route="cuda",
                       source=f"{csrc}/tailstorm_stream.cu",
                       replaces="cpr_tpu/envs/tailstorm.py:417",
                       max_abs_err=0.0),
        "K10-stree": dict(name="K10-stree Stree withholding stream and "
                          "step_lanes", route="cuda",
                          source=f"{csrc}/stree_stream.cu",
                          replaces="cpr_tpu/envs/stree.py:283",
                          max_abs_err=0.0),
        "K10-spar": dict(name="K10-spar Spar withholding stream and "
                         "step_lanes", route="cuda",
                         source=f"{csrc}/spar_stream.cu",
                         replaces="cpr_tpu/envs/spar.py:215",
                         max_abs_err=0.0),
        "K10-sdag": dict(name="K10-sdag Sdag withholding stream and "
                         "step_lanes (K9's frame, altruistic selection, "
                         "release prefixes and stale plane inside)",
                         route="cuda", source=f"{csrc}/sdag_stream.cu",
                         replaces="cpr_tpu/envs/sdag.py:201",
                         max_abs_err=0.0),
        # device functions that K2/K10 run inside their launches with
        # the net: its launches are theirs, its ms, plain and bound its
        # check kernel's (4096 lanes, warp mode)
        "K11-act": dict(name="K11-act actor-critic in the stream kernels "
                        "(device functions inside K2/K10, launches "
                        "theirs; ms, plain_ms and bound_ms are its check "
                        "kernel actor_check_kernel's)", route="cuda",
                        source=f"{csrc}/actor.cuh",
                        replaces="cpr_tpu/train/ppo.py:86"),
        "K11-gae": dict(name="K11-gae advantage scan", route="cuda",
                        source=f"{csrc}/gae.cu",
                        replaces="cpr_tpu/train/ppo.py:154"),
        "K11-loss": dict(name="K11-loss PPO loss head forward and "
                         "backward (ms: one of each)", route="cuda",
                         source=f"{csrc}/ppo_loss.cu",
                         replaces="cpr_tpu/train/ppo.py:166"),
        "K11-adam": dict(name="K11-adam clipped Adam step", route="cuda",
                         source=f"{csrc}/adam.cu",
                         replaces="cpr_tpu/train/ppo.py:323"),
        "K12-scan": dict(name="K12-scan netsim scan path (nakamoto, simple "
                         f"dissemination; {NET_LANES} lanes x {NET_ACTS} "
                         "activations)", route="cuda",
                         source=f"{csrc}/netsim_scan.cu",
                         replaces="cpr_tpu/netsim/engine.py:716"),
        "K12-event": dict(name="K12-event netsim event engine (nakamoto; "
                          f"{NET_LANES} lanes x {NET_ACTS} activations)",
                          route="cuda",
                          source=f"{csrc}/netsim_event.cu",
                          replaces="cpr_tpu/netsim/engine.py:92"),
        "K13": dict(name=f"K13 attacker in the network ({ATK_LANES} lanes "
                    f"x {ATK_ACTS} activations, queue {ATK_QUEUE_CAP})",
                    route="cuda",
                    source=f"{csrc}/netsim_attack.cu",
                    replaces="cpr_tpu/netsim/attack.py:81"),
        "K12-event-bk": dict(name="K12-event-bk netsim event engine under "
                             "Bk (the honest-net sweep: k=4 constant, k=8 "
                             "constant and block; 5 lanes x 10000 "
                             "activations a launch)", route="cuda",
                             source=f"{csrc}/netsim_event_bk.cu",
                             replaces="cpr_tpu/netsim/engine.py:409"),
        "K12-event-eth": dict(name="K12-event-eth netsim event engine under "
                              "Ethereum (the honest-net sweep: whitepaper "
                              "and Byzantium; 5 lanes x 10000 activations "
                              "a launch)", route="cuda",
                              source=f"{csrc}/netsim_event_eth.cu",
                              replaces="cpr_tpu/netsim/engine.py:311"),
        "K12-event-spar": dict(name="K12-event-spar netsim event engine "
                               "under Spar (the honest-net sweep's Spar "
                               "call: k=4 constant and block; 5 lanes x "
                               "10000 activations a launch)", route="cuda",
                               source=f"{csrc}/netsim_event_spar.cu",
                               replaces="cpr_tpu/netsim/engine.py:368"),
    }
    netsim_rows = ("K12-scan", "K12-event", "K13", *PROTO_KERNELS)
    phase_k1(dev, fx, report)
    phase_k3(dev, fx)
    phase_k2(dev, fx)
    torch.cuda.synchronize()
    stream_counts, main_episodes = phase_stream(dev, report)
    gym_counts = phase_gym(dev, report)
    phase_mdp_fixture(dev, mfx)
    phase_grid_fixture(dev, gfx)
    mdp_counts, table, policy, compiled, capstone_rev = phase_mdp_main(
        dev, report)
    phase_mdp_battery(dev)
    grid_counts, grid_table, probs = phase_grid(dev, report, pm_future,
                                                compiled, capstone_rev)
    compiler.shutdown()
    rtdp_counts = phase_rtdp(dev, report, table, capstone_rev)
    phase_k8(dev, dfx, report)
    phase_k10_lanes(dev, dfx, report, ("bk", "eth"))
    phase_k10_streams(dev, dfx, report, ("bk", "eth"))
    bk_counts, bk_gym = phase_dag_path(dev, report, "bk")
    eth_counts, eth_gym = phase_dag_path(dev, report, "eth")
    vote = ("ts", "stree")
    phase_k10_lanes(dev, qfx, report, vote)
    phase_k10_streams(dev, qfx, report, vote)
    phase_vote_variants(dev, report, VOTE_VARIANTS)
    k9_carries = phase_k9(dev, qfx, report)
    ts_counts, ts_gym = phase_dag_path(dev, report, "ts")
    stree_counts, stree_gym = phase_dag_path(dev, report, "stree")
    par = ("spar", "sdag")
    phase_k10_lanes(dev, sfx, report, par)
    phase_k10_streams(dev, sfx, report, par)
    phase_vote_variants(dev, report, PAR_VARIANTS)
    spar_counts, spar_gym = phase_dag_path(dev, report, "spar")
    sdag_counts, sdag_gym = phase_dag_path(dev, report, "sdag")
    phase_k11_act(dev, report)
    phase_net_streams(dev, report)
    phase_k11_update(dev, report)
    phase_ppo_fixture(dev, pfx)
    ppo_counts, bench_carry = phase_bench_ppo(dev, report)
    with tempfile.TemporaryDirectory(dir=kernels.build_dir()) as tmp:
        config_counts = phase_config_path(dev, report, tmp)
    for k, r in report.items():
        if k in netsim_rows:
            continue
        r["launches"] = sum(c[k] for c in (stream_counts, gym_counts,
                                           mdp_counts, grid_counts,
                                           rtdp_counts, bk_counts, bk_gym,
                                           eth_counts, eth_gym, ts_counts,
                                           ts_gym, stree_counts, stree_gym,
                                           spar_counts, spar_gym,
                                           sdag_counts, sdag_gym,
                                           ppo_counts, *config_counts))
    report["K8"]["launches"] = sum(report[k]["launches"] for k in (
        "K10-bk", "K10-eth", "K10-ts", "K10-stree", "K10-spar", "K10-sdag"))
    report["K9"]["launches"] = sum(report[k]["launches"] for k in (
        "K10-ts", "K10-stree", "K10-sdag"))
    phase_times(dev, report, main_episodes)
    phase_mdp_times(dev, report, table, policy)
    phase_grid_rtdp_times(dev, report, grid_table, probs)
    phase_dag_times(dev, report, ("bk", "eth"))
    phase_dag_times(dev, report, vote)
    phase_dag_times(dev, report, par)
    phase_k9_times(dev, report, k9_carries)
    phase_k11_times(dev, report, bench_carry)
    phase_k1_f64(dev, nfx, report)
    phase_k12_scan(dev, nfx, report)
    net_counts, scan_orphan = phase_netsim_path(dev, report)
    phase_k12_event(dev, nfx, report)
    event_counts, event_steps = phase_k12_event_path(dev, report,
                                                     scan_orphan)
    phase_k13(dev, nfx, report)
    attack_counts, attack_steps = phase_attack_path(dev, report)
    phase_netsim_times(dev, report, event_steps, attack_steps)
    phase_proto_fixture(dev, prfx)
    phase_proto_plain(dev, report)
    hn_counts = phase_honest_net(dev, report)
    for k in netsim_rows:
        report[k]["launches"] = sum(c[k] for c in (net_counts, event_counts,
                                                   attack_counts, hn_counts))
    phase_proto_times(dev, report)
    for k, v in report.items():
        check(v["ms"] >= v["bound_ms"],
              f"{k} measured {v['ms']} ms, below its bound of "
              f"{v['bound_ms']} ms: the bound is wrong")

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(card, flush=True)  # again, beside the numbers at the end
    for k in ("K1", "K2", "K3"):
        report[k]["library_ms"] = None  # no PyTorch call computes these
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in report.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
