#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`cpr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is not 0:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the kernels from `cpr_tpu_torch/csrc/` (nvcc, sm_90a), timed:
     K1 first, then the rest while a child process runs the netsim
     kernels' plain replays of phases 35, 37 and 48 on the idle card
     (`plain_ahead`: CUDA graphs of small launches, bound by the card's
     latency; their plain times are taken there);
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
  8. (phases 8-12 run after 46, while their host compiles finish beside
     the card's work) the exact-analysis main path, with its own launch
     counts (K4 and K5 only): the capstone GhostDAG compile at
     MDP_CUTOFF (run on the host from the build's end), ptmdp,
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
     their gym paths' lanes (8192 bk, 4096 Ethereum), 64 ticks of
     numpy-seeded actions and admit/step masks, the
     outputs every tick and the whole carry (every DAG plane, stale rows
     included); then the fixture's tick traces;
 16. the K10 streams against their plain versions: 4096 lanes x 128
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
     4096 lanes over 64 ticks of seeded masks, then the tick traces of
     the vote-quorum fixture (tests/fixtures/torch_port_quorum_golden.npz);
 22. their streams against their plain versions: 4096 lanes x 128 steps,
     every policy (7 Tailstorm, 6 Stree) in one batched plain call,
     unchunked and in chunks of 100; then the fixture's sums and carries;
 22b. K10-ts and K10-stree under the schemes and selections the paths
     do not run (VOTE_VARIANTS: altruistic, optimal, constant, punish,
     hybrid, and a 40-slot ring at k = 4 that wraps and overflows with a
     16-position release scan), 512
     lanes x 96 steps, every policy, against their plain versions, with
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
     `step_lanes` ticks at 4096 lanes (the gym step path, in the ring;
     the gym id itself builds full mode: phase 60);
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
     sdag-8-discount.yaml (2 updates each, full mode as the reference
     sizes it: 264 or 136 slots; K1, the env's K10-<env>-full, K11),
     eval.freq 1 and start_at_iteration 0 so that the eval and the
     checkpoints run; eval rows finite, relative reward in [0, 1]; a
     policy snapshot exported and reloaded acts as the net; each DAG
     config's env under the trained net, hidden 96, 512 lanes x 160 steps
     from a raw reset, held to the plain versions as in 28, no episode
     filling its capacity;
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
     at that size are printed); then 4096 lanes x 1000, its launches
     counted with the path's, every lane held to the plain version;
 40. K12-scan, K12-event and K13 device times at the paths' bench
     shapes, the shapes of the plain replays in 35, 37 and 38 whose times
     are the rows' plain times, with the L2 scrubbed (by CUDA events
     around each wrapper call, its small host-to-device copies
     included); the bounds (the threefry work this run's draws need and
     the lanes' inputs and outputs).
 41. K10-spar and K10-sdag `step_lanes` against their plain versions at
     4096 lanes over 64 ticks of seeded masks, then the tick traces of
     their JAX fixture (tests/fixtures/torch_port_spar_sdag_golden.npz);
 42. their streams against their plain versions: 4096 lanes x 128
     steps, every policy (2 Spar, 6 Sdag) in one batched plain call,
     unchunked and in chunks of 100; then the fixture's sums and carries;
 43. the variants the paths do not run (PAR_VARIANTS: Spar's block
     scheme; Sdag constant-altruistic, constant-heuristic and
     discount-altruistic; rings at k = 4 that wrap and overflow, Sdag's
     of 40 slots with a 16-position release scan, Spar's of 16), 512
     lanes x 96 steps, every policy, against their plain versions, the
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
     k=8 constant, the whitepaper, Spar k=4 constant) at the path's
     HN_ACTS activations, the others at HN_PLAIN_ACTS; then flooding on
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
 51. the serve engine at the main path's width, in two runs each with its
     own launch counts: `ResidentEngine` (Nakamoto, alpha 0.35, gamma
     0.5, max_steps 2016) over 131072 lanes, every lane spliced and run
     under SM1 for SERVE_BURSTS bursts of 256 steps (K2, K3, K14; with
     the experience rings at capacity 256 also K1 and K15); ms a burst,
     env-steps/s, the relative revenue of the first-done registers
     inside SM1_GUARD; the burst the episodes end in run again from a
     copy of its carry and held to the plain twin (`_burst_plain`; with
     the rings on, the kernel's recorded actions replayed through the
     plain `_lane_step`, every recorded field checked), its plain time;
     then K14's admission: from copies, a numpy-seeded eighth of the
     lanes admitted with a burst over a seeded seven eighths (some
     admitted lanes run, some are held), held to the plain splice then
     the plain burst, and the card's splice (K2's prologue, then K3)
     held to the plain splice; then the K2 stream over the same lanes
     and steps and the ratio;
 52. the mixed table at 4096 lanes, burst 256, max_steps 256, the rings
     on: lanes cycled over the four scripted policies, a loaded greedy
     net, the swap net `ppo` and `ppo#sample` ((64, 64), seeded), two
     bursts each held to the plain version as in 51 (draws below
     NET_MARGIN counted and printed), the first drained into
     `Learner.ingest` at n_envs 4096, n_steps 256 (one update, every
     metric finite), its own launch counts (K1, K2, K3, K11-*, K14,
     K15); then a mid-run swap, after which the scripted lanes are bit
     for bit those of an unswapped engine;
 53. K15's check kernel against its plain version at 131072 lanes and
     C = 256 over numpy-seeded live masks (the rings wrap), the step
     keys; then the device ms of K15 (a step) and K14 (a burst at full
     width, rings on; rings off printed), L2 scrubbed, and their bounds;
 54. the wire path: `python -m cpr_tpu_torch.serve.server` as a child
     at its defaults (32 lanes, burst 256, max_steps 256) with a policy
     snapshot; 32 concurrent clients (scripted and `ppo` episode.run,
     interactive episodes stepped to their end, a netsim.query at the
     default 10 nodes and one at 64, path (d));
     then tools/serve_smoke.py's flood: FLOOD_EPISODES honest episodes
     over 128 persistent connections from 2 client processes, the steps
     per busy dispatch second of the server's stats over a batch
     `rollout()` at the server's width (32 lanes x 256 steps, honest,
     alpha 0.25) timed here after it, printed beside the reference's
     floor SERVE_MIN_FRAC (0.8; not held: ROADMAP §3.4); SIGTERM: a
     drain report with 0 <
     p50 <= p99 < the traffic's wall, exit 0; the child's launch counts
     (printed at its exit: K2, K3, K14, K11-act, K12-scan,
     K12-scan-n256, and K1 allowed);
 55. the learning loop: `python -m cpr_tpu_torch.learn.learner` and a
     server with `--learner` and `--learn-watch` at tools/learn_smoke.
     py's shape (16 lanes, burst 64, max_steps 64, --n-envs 16 --n-steps
     64, alpha 0.45), flooded with `ppo#sample`, `honest` and `ppo`
     sessions until the fingerprints in the replies have rotated through
     LEARN_MIN_SWAPS published swaps and the LEARN_TAIL newest greedy
     episodes, all after a swap, beat the untrained snapshot's baseline
     wave by LEARN_MIN_GAIN (0.01, tools/learn_smoke.py's floor), no
     session refused; both children exit 0 on SIGTERM, with their launch
     counts.
 56. (after 46) full mode, every DAG env as the reference sizes it:
     K8-full's check kernel, both full modes (walks, binary lifting, the
     chain and closure releases), 2048 lanes x 320 ops of FULL_OPS at
     520 slots against `script_plain`, then the full-mode JAX fixture's
     scripts (tests/fixtures/torch_port_fullmode_golden.npz);
 57. K9-full's check kernel (the log-doubling frame, the release
     prefixes and the stale walk without planes) on 4096 lanes of
     Tailstorm's and Stree's full-mode plain carries against
     `check_plain`, then the fixture's carries against cpr_tpu's outputs;
 58. each K10-<env>-full `step_lanes` (bk, Ethereum lifted, Tailstorm,
     Stree, Spar, Sdag, TailstormJune on K10-stree-full) against its
     plain version over 64 ticks of seeded masks at 512 lanes, then the
     fixture's tick traces;
 59. each env's full-mode stream path, `registry.get(key)` with no
     window (520 slots for bk and Tailstorm, 264 for the rest), 4096
     lanes x 256 steps in chunks of 128, max_steps 128, its own launch
     counts (K1 and its K10-<env>-full only), relative revenue within
     VOTE_GUARD of cpr_tpu's on the fixture's lanes, no episode filling
     its capacity; every policy on the first 64 lanes over 128 steps
     against one batched plain replay; every policy on the fixture's keys
     against cpr_tpu (the sums, done counts and obs; the main policy's
     whole final carry);
 60. `cpr-tailstorm-torch-v0` at its defaults (the env its factory
     builds: 264 slots, max_steps 128): one lane, 100 ticks of
     K10-ts-full, its own launch counts;
 61. each K10-<env>-full's device time per 128-step launch at the
     stream path's shape and per step_lanes tick, the plain versions'
     times and the bounds; K8-full's and K9-full's check kernels.
 62. (after 55; its cases in child processes beside 63's)
     K14-dag, the serve burst over the DAG envs, against the
     plain splice and `_burst_plain` on the card: every DAG env (bk,
     Ethereum lifted, Tailstorm, Stree, Spar, Sdag, TailstormJune) in
     full mode at `get_sized(key, 64)` and every K10 library's build in
     the 128-slot ring (bk, Ethereum, Tailstorm, Stree, Spar, Sdag),
     512 lanes, burst 64, max_steps 64, a numpy-seeded table
     cycling every scripted policy; two bursts back to back from copies
     of the carry, each admitting a seeded eighth of the lanes (some
     live, some held) and holding a seeded eighth: registers, obs and
     the whole carry (every DAG plane, stale rows included) equal; then
     the committed JAX fixture's bursts
     (tests/fixtures/torch_port_serve_dag_golden.npz) held the same way;
 63. the mixed table on Tailstorm at the server's sizing
     (`get_sized("tailstorm-8-discount-heuristic", 256)`: 520 slots),
     4096 lanes, burst 256, the rings on: the seven scripted policies, a
     loaded greedy net, `ppo` and `ppo#sample` ((64, 64), seeded), two
     bursts, the first drained into `Learner.ingest`, its own launch
     counts (K1, K10-ts-full, K14-dag-ts-full, K15, K11-*); each burst
     held to the plain version as in 52 (draws below NET_MARGIN counted)
     in a child process of its own that runs the same seeded engine to
     it, its registers, carry and rings first equal to this run's; then a
     mid-run swap, after which the scripted lanes are bit for bit those
     of an unswapped engine;
 64. the DAG serve path at full width, in two runs each with its own
     launch counts: `ResidentEngine` over that env, 4096 lanes (BASELINE
     config 4's), alpha 0.35, gamma 0.5, max_steps 256, every lane
     spliced with its own seed, DAG_SERVE_BURSTS bursts of 256 under
     get-ahead (K10-ts-full, K14-dag-ts-full; with the rings at capacity
     256 also K1 and K15); ms a burst and env-steps/s; each lane's
     first-done registers equal to the first episode of the K10 stream
     (`rollout`) from its seed; the relative revenue within VOTE_GUARD
     of the K10 stream's over the same lanes and steps, and the ratio
     of the two times;
 65. the wire on a DAG protocol: `python -m cpr_tpu_torch.serve.server
     --protocol tailstorm-8-discount-heuristic` as a child at its
     defaults with a seeded net's policy snapshot exported under that
     protocol; 16 concurrent clients (scripted and `ppo` episode.run,
     interactive episodes stepped to their end), every reply ok;
     SIGTERM: a drain report with 0 < p50 <= p99 < the traffic's wall,
     exit 0; the child's launch counts (K10-ts-full, K14-dag-ts-full,
     K11-act, and K1 allowed);
 66. K14-dag's device ms per 256-step burst at 64's shape, rings off and
     on, the L2 scrubbed, its bound (the carry read and written once,
     the ring rows, the threefry work of the steps and resets), the
     plain version's time of one such burst, and every phase 62 case's
     device ms a burst at its shape.
 67. K17 (the device-metrics fold, csrc/metrics.cu) on every crafted
     case of the committed JAX fixture (tests/fixtures/torch_port_
     metrics_golden.npz: NaN and +-inf, values on histogram edges, empty
     and all-masked cells, int masks, row sentinels, transposed views,
     inputs of several blocks) against its plain fold on the card and
     cpr_tpu's summaries, two folds bit for bit; then the fixture's short
     paths with the metrics on (Nakamoto SM1 unchunked and chunked, the
     Tailstorm ring chunked, a batch rollout, one tiny PPO step from
     JAX's params) against cpr_tpu's cells;
 68. the main path with `collect_metrics=True` (bench.py:139-166's
     measure under CPR_DEVICE_METRICS=1: 131072 lanes x 2200 SM1 steps,
     unchunked): first beside the metrics-off call on the same keys (the
     stats bit for bit, the same count of synchronizing operations under
     torch.cuda.set_sync_debug_mode("warn")), then one warm and three
     timed calls with their own launch counts (K1, K2, K17), the
     accumulators merged on the card, one readback and one `emit`:
     env_steps 865,075,200, the cells against the plain fold of the
     same per-lane tensors; K17's device time (L2 scrubbed) beside the
     stream's, its plain fold's time and its bound;
 69. the Tailstorm path (phase 24's shape, chunks of 128) the same way:
     K1, K10-ts eight times a call, K17 once a chunk;
 70. `rollout(with_metrics=True)`, Nakamoto SM1, 4096 lanes x 256 steps
     (K1, K2, K17): the trajectory the metrics-off call's, no added
     synchronizing operation, the cells against the plain
     `update_rollout` over the same trajectory;
 71. the serve engines under CPR_DEVICE_METRICS=1: Nakamoto at phase
     51's shape (rings off; K2, K3, K14, K17) and Tailstorm in full mode
     at phase 62's (K10-ts-full, K14-dag-ts-full, K17): `emit_metrics`
     gives the bursts without the warm-up, env_steps and episodes the
     registers' sums;
 72. two bench PPO train_steps (phase 31's shape) with the variable on,
     each beside the metrics-off step from a copy of its carry: every
     other metric and the params bit for bit, the cells finite with the
     config's counts (16 minibatches a step; K17 once a step);
 73. `netsim.Engine.run` at bench.py's clique with the variable on: one
     `device_metrics` event of scope netsim equal to the outputs' sums;
     `AttackEngine.run` runs with it set (K12-scan, K13).
 74. the netsim past 32 nodes (node n on thread n % 32 in slot n / 32 of
     2, 4 or 8; counters `<kernel>-n64`, `-n128`, `-n256`): every case of
     the wide JAX fixture (tests/fixtures/torch_port_netsim_wide_golden.npz:
     40-node cliques under Nakamoto scan and event, Bk k=4 and Spar k=4,
     Byzantium on 64 nodes, flooding on preferential_attachment(40, 2),
     the attacker at gamma 0.97 with 34 defenders, at the default queue
     and at queue 64 (every lane dropping), 100- and 130-node cliques)
     through the widened kernels;
 75. path (a): `honest_net_rows(engine="jax", n_nodes=64)` at the
     reference's defaults, then Spar k=4 under both schemes, a warm and a
     timed round, each call with its own launch counts (K12-scan-n256,
     K12-event-eth-n64, K12-event-bk-n64; K12-event-spar-n64), phase 49's
     guards; each kernel's first configuration held to its plain version
     on the sweep's five lanes at WIDE_HN_PLAIN_ACTS activations;
 76. path (b): flooding on preferential_attachment(100, 2, exponential,
     seed 42) through Engine.run, Nakamoto PA_LANES x PA_ACTS and Bk k=8
     PA_BK_LANES x PA_BK_ACTS (K12-event-n128, K12-event-bk-n128): no
     drop or exhausted lane, rewards summing to the progress; all lanes
     held to the plain version at PA_PLAIN_ACTS and PA_BK_PLAIN_ACTS;
 77. path (c): the attacker on selfish_mining(alpha 0.25, gamma 0.99, 100
     defenders, activation delay 60, propagation 1), 101 nodes, alpha in
     ATK_ALPHAS x {honest, SM1}, the default queue: AttackEngine.run
     SM_LANES x SM_ACTS, then `attack_sweep` at SM_SWEEP_LANES x
     SM_SWEEP_ACTS (K13-n128); the drops printed; the path's lanes held at
     SM_PLAIN_ACTS, its alpha 0.45 SM1 lanes at SM_DEEP_ACTS, where the
     plain version drops queue entries and parked blocks, the sweep's at
     SM_SWEEP_PLAIN_ACTS;
 78. path (e): a 256-node clique, scan and event, WIDE_MAX_LANES x
     WIDE_MAX_ACTS (K12-scan-n256, K12-event-n256), held to the plain
     versions at that depth; 257 nodes refused by name (the limit and
     ROADMAP item 11b) by Engine and AttackEngine before any launch;
 79. each widened kernel's device time at its path's shape, L2 scrubbed,
     and its bound. Path (d), the server's netsim.query at 64 nodes
     (K12-scan-n256), runs in phase 54's wire child. K12-scan has one
     build past 32 nodes, the 8-slot one: its row counts paths (a), (d)
     and (e), its times are path (a)'s shape (path (e)'s printed).
The sharded solvers and lanes of cpr_tpu_torch.parallel (K16), over a
mesh of shards on the card (several shards on cuda:0, as the reference's
tests run on virtual devices):
 80. each K16 kernel on the fixture's tables (tests/fixtures/
     torch_port_shard_golden.npz, cpr_tpu's): the state-sharded solve at
     4 shards (padded) and the grid x state solve at 2 x 2 bit for bit,
     the transition-sharded while and chunked solves at 4 shards within
     rtol 1e-6, atol 1e-7, the policy equal where the Q-gap > 1e-4;
 81. the capstone state-sharded at full width:
     `sharded_state_value_iteration(tm, 4 shards, stop_delta=1e-6,
     pad_states=True, chunk=MDP_CHUNK)` converges, equals the K4 chunked
     solve at that chunk and the same solve at 1 shard bit for bit, its
     revenue within 1e-5 of phase 8's, its `mdp_solve` event with
     state_shards 4 and halo_bytes; 3 shards without padding refused,
     naming both values; sweeps/s printed;
 82. the capstone transition-sharded: `sharded_value_iteration` while and
     chunked with accel_m 3, revenues within 1e-5 of phase 8's, values
     within rtol 1e-6, atol 1e-7 of phase 8's while solve, the policy
     equal where the Q-gap decides (ties printed); one `measure_rows(
     mesh=)` row against phase 9's;
 83. grid x state at phase 10's shape (12 points, 2 x 2 mesh
     ("g", "s")) bit for bit against phase 10's K7 solve, then the 1-D
     mesh over G at 4 shards (K7 a shard), bit for bit;
 84. `rtdp_sharded_polish` on the capstone: K6 then K16-state from its
     warm start, converged, revenue within 1e-5, warm sweeps beside 81's
     cold ones;
 85. lanes at full width: `make_sharded_lane_fns` over 4 shards, 131072
     lanes, 64 ticks with holds and admission bit for bit against the
     unsharded chain; `make_sharded_rollout_fn` at the SM1 shape,
     unchunked and chunked, per-lane stats bit for bit against the
     unsharded K2 call, metrics on equal to off (the accumulator the
     unsharded one's), revenue in SM1_GUARD;
 86. each K16 kernel's device time a sweep at the capstone's shapes (L2
     scrubbed), its bound, its plain twin's and cuSPARSE's times, and
     the kernel held to its plain twin for MDP_TWIN_SWEEPS sweeps;
 87. with two or more cards, phase 81 over distinct cards; on one card a
     line that says it did not run.
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

import atexit
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
# (the step_lanes checks run at the gym paths' lanes, BK_/ETH_LANES; 64
# ticks and 128 steps leave room in the smoke's time for full mode's
# phases, and still cross episode ends at max_steps 32 and 64)
DAG_WINDOW, DAG_CHECK_LANES, DAG_CHECK_STEPS, DAG_CHECK_TICKS = 128, 4096, \
    128, 64
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
# (96 steps leave room for full mode's phases, cross an episode end at
# max_steps 64 and wrap the 40- and 16-slot rings)
VARIANT_LANES, VARIANT_STEPS = 512, 96
MINE_THREEFRY5 = 9  # split into 5, then one draw from each of 4 keys
# The Spar and Sdag envs (K10-spar, K10-sdag): the vote paths' shape
# (4096 lanes x 1024 steps in chunks of 128, max_steps 120) at the shipped
# configs' k; their JAX fixture holds each path's reference revenue
# (cpr_tpu on the path's first 64 lanes x 256 steps), which the guard
# centres: +-VOTE_GUARD. The variants the paths do not run: Spar's block
# scheme, Sdag's other scheme-selection pairs, and rings at k = 4 that
# wrap and overflow: Sdag's of 40 slots with a 16-position release scan,
# Spar's of 16 (its two policies release or adopt before a fork fills 40:
# at 512 lanes x 160 steps no 40-slot episode overflowed, ~3% of 16-slot
# ones did).
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
# the DAG configs' nets in full mode: steps from a raw reset (a whole
# 128-step episode on every lane)
CONFIG_FULL_STEPS = 160
# Full mode (K8-full, K9-full, K10-<env>-full): every DAG env as the
# reference sizes it. The stream paths take `registry.get(key)` (no window,
# the default hint of 256: 520 slots for Bₖ and Tailstorm, 264 for the
# rest) at the vote paths' shape; the checks and the JAX fixture
# (tests/test_torch_fullmode_golden.py) take `registry.get_sized(key,
# 128)`, the training configs' sizing. A path's revenue guard is
# +-VOTE_GUARD around cpr_tpu's on the fixture's 64 lanes (full mode's
# episodes end alike at any capacity that holds them). The gym path is
# `cpr-tailstorm-torch-v0` at its defaults, built as its factory builds
# it (the card has no gymnasium): one lane, FULL_GYM_TICKS ticks.
FULL_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_fullmode_golden.npz"
FULL_ENVS = {**DAG_ENVS, "june": ("tailstormjune-8-block", "override-catchup")}
FULL_LIB = {"bk": "bk", "eth": "eth", "ts": "ts", "stree": "stree",
            "spar": "spar", "sdag": "sdag", "june": "stree"}
FULL_HINT, FULL_MAX_STEPS, FULL_REF_LANES = 128, 128, 64
FULL_LANES, FULL_STEPS, FULL_CHUNK = 4096, 256, 128
FULL_REPLAY_STEPS = 128  # the plain replay's depth (the fixture's: 256)
FULL_CHECK_LANES, FULL_CHECK_TICKS, FULL_CHECK_MAX_STEPS = 512, 64, 32
K8F_LANES, K8F_OPS, K8F_CAP, K8F_PARENTS = 2048, 320, 520, 9
K9F_STEPS, K9F_MAX_STEPS = 120, 200
FULL_GYM_TICKS = 100
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
ATK_SWEEP_LANES, ATK_SWEEP_ACTS = 4096, 1000
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
# on the sweep's five lanes: its first configuration at the path's
# HN_ACTS activations, the others at HN_PLAIN_ACTS; and to every case of
# its JAX fixture. The plain replays run ahead, during the build
# (`plain_ahead`).
PROTO_FIXTURE = ROOT / "tests" / "fixtures" / \
    "torch_port_netsim_protocols_golden.npz"
HN_NODES, HN_ACTS, HN_PROP, HN_SEED = 10, 10000, 1.0, 0
HN_DELAYS = (30.0, 60.0, 120.0, 300.0, 600.0)
HN_SPAR = (("spar", {"k": 4, "scheme": "constant"}),
           ("spar", {"k": 4, "scheme": "block"}))
HN_PLAIN_ACTS = 250
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

# The netsim past 32 nodes (phases 74-79): the widened kernels, node n on
# thread n % 32 in slot n / 32 (2, 4 or 8 slots: the `-n64`, `-n128`,
# `-n256` counters). Path (a) the honest-network sweep on a 64-node clique
# at the reference's defaults; (b) flooding on the simulate-topology
# generator's network at 100 nodes (cpr_tpu/network.py:123-175,
# exponential link delays; ~400 delivery steps an activation over its 394
# directed links, so max_steps PA_STEPS_PER_ACT an activation, and depth
# cut for time: on an H100 a launch of 96 lanes x 250 takes ~0.77 s and
# one of 5 x 1000 under Bk ~4 s, so 10 000 activations would take 30-40
# s a launch; Nakamoto at PA_ACTS, ~200 blocks a lane, Bk k=8 at
# PA_BK_ACTS, ~125 blocks of 8 votes a lane); (c) the attacker at gamma
# 0.99 (cpr_tpu/params.py:81-84: ceil(1 / (1 - gamma)) = 100
# defenders), the default queue; (d) the server's netsim.query at 64
# nodes (phase 54); (e) a 256-node clique, and one node more refused. Every widened kernel is held to its plain version
# (the replays in `plain_ahead`'s child, at the *_PLAIN_ACTS depths: Bk
# k=8 deep enough for 10 blocks a lane, path (c)'s alpha 0.45 SM1 lanes
# deep enough to drop; the sweep's lanes SM_SWEEP_CHUNK a replay) and to
# the wide JAX fixture.
WIDE_FIXTURE = ROOT / "tests" / "fixtures" / \
    "torch_port_netsim_wide_golden.npz"
WIDE_HN_NODES, WIDE_HN_PLAIN_ACTS = 64, 1000
WIDE_QUERY_NODES = 64
PA_NODES, PA_M, PA_SEED = 100, 2, 42
PA_LANES, PA_ACTS, PA_PLAIN_ACTS = 96, 250, 15
PA_BK_LANES, PA_BK_ACTS, PA_BK_PLAIN_ACTS = 5, 1000, 80
PA_STEPS_PER_ACT = 800
PA_RUNS = (("nakamoto", 1, PA_LANES, PA_ACTS, "K12-event-n128"),
           ("bk", 8, PA_BK_LANES, PA_BK_ACTS, "K12-event-bk-n128"))
SM_ALPHA, SM_GAMMA, SM_DEFENDERS = 0.25, 0.99, 100
SM_DELAY, SM_PROP = 60.0, 1.0
SM_LANES, SM_ACTS, SM_PLAIN_ACTS, SM_DEEP_ACTS = 64, 1500, 100, 300
SM_SWEEP_REPS, SM_SWEEP_ACTS, SM_SWEEP_PLAIN_ACTS = 128, 1000, 10
SM_SWEEP_LANES = 8 * SM_SWEEP_REPS  # ATK_ALPHAS x ATK_POLICIES x reps
SM_SWEEP_CHUNK = 128
WIDE_DROP_HOLDS = ("c-deep",)
WIDE_MAX_NODES, WIDE_MAX_LANES, WIDE_MAX_ACTS = 256, 4, 1000
WIDE_KERNELS = ("K12-event-eth-n64", "K12-event-bk-n64",
                "K12-event-spar-n64", "K12-event-n128", "K12-event-bk-n128",
                "K13-n128", "K12-scan-n256", "K12-event-n256")

# The serve paths (phases 51-55). Nine bursts of 256 cover an episode of
# 2016 steps; it ends in burst 7, the one held to the plain version.
SERVE_BURST, SERVE_BURSTS, SERVE_COMPARE_BURST = 256, 9, 7
MIX_LANES, MIX_BURST, MIX_MAX_STEPS = 4096, 256, 256
WIRE_CLIENTS, WIRE_MAX_STEPS = 32, 256
WIRE_LANES = 32  # the server's defaults: 32 lanes, burst and max_steps 256
LEARN_LANES, LEARN_STEPS = 16, 64  # tools/learn_smoke.py's shape
LEARN_MIN_SWAPS, LEARN_MAX_WAVES, LEARN_WALL_S = 2, 30, 240.0
# tools/learn_smoke.py's gain floor (CPR_LEARN_MIN_GAIN): the TAIL_WINDOW
# newest greedy episodes, all after a swap, beat the untrained snapshot's
# baseline wave (6 greedy episodes a worker) by LEARN_MIN_GAIN
LEARN_MIN_GAIN, LEARN_TAIL, LEARN_BASE_EPISODES = 0.01, 32, 6
# tools/serve_smoke.py's throughput floor (CPR_SERVE_MIN_FRAC): a full
# occupancy flood of FLOOD_EPISODES honest episodes over FLOOD_CLIENTS
# connections from FLOOD_PROCS asyncio client processes at the lowest
# priority (a burst of 32 lanes x 256 steps takes well under a
# millisecond on the card, and one process of client threads answers
# too slowly to keep the lanes full: at the reference's twice the lanes,
# bursts ran half full; busier clients take the host's cores from the
# server), steps per busy dispatch second from the server's stats,
# against a batch rollout() at the server's width: printed beside the
# reference's floor SERVE_MIN_FRAC, which the port meets in some runs and
# not in others (ROADMAP §3.4)
FLOOD_EPISODES, FLOOD_CLIENTS, FLOOD_PROCS = 2048, 128, 2
SERVE_MIN_FRAC = 0.8
CHILD_READY_S, CHILD_STOP_S = 180.0, 120.0
# K14-dag (phases 62-66). Phase 62: every DAG env in full mode at the
# engine's sizing for DAGB_MAX_STEPS and Tailstorm in the 128-slot ring,
# the kernel against the plain splice and burst, then the committed JAX
# fixture's bursts (tests/test_torch_serve_dag_a.py writes it at its
# shape, DAGB_FX_*). Phases 63-66: Tailstorm at the server's sizing
# (`get_sized(key, 256)`: 520 slots), the protocol of cpr_tpu/train/
# configs/tailstorm-8-discount.yaml, at BASELINE config 4's 4096 lanes:
# the mixed table (phase 52's shape), the serve path, the wire at the
# server's defaults, and the times.
DAGB_LANES, DAGB_BURST, DAGB_MAX_STEPS = 512, 64, 64
# phase 62's cases: every DAG env in full mode, then each K10 library's
# ring build (Tailstorm's first, the case the JAX fixture also holds)
DAGB_CASES = {**{n: (key, 0) for n, (key, _) in FULL_ENVS.items()},
              "ts_ring": (FULL_ENVS["ts"][0], DAG_WINDOW),
              **{f"{n}_ring": (key, DAG_WINDOW)
                 for n, (key, _) in DAG_ENVS.items() if n != "ts"}}
DAGB_FX_CASES = (*FULL_ENVS, "ts_ring")  # the fixture's cases
# phase 62's cases by child process (balanced by their plain replays'
# time) and the time limit of a child of phases 62-63
DAGB_GROUPS = (("eth", "spar", "bk_ring"), ("ts", "stree", "spar_ring"),
               ("ts_ring", "sdag", "eth_ring"),
               ("bk", "june", "stree_ring", "sdag_ring"))
DAGB_CHILD_S = 600.0
DAGB_FIXTURE = ROOT / "tests" / "fixtures" / \
    "torch_port_serve_dag_golden.npz"
DAGB_FX_LANES, DAGB_FX_BURST, DAGB_FX_MAX_STEPS, DAGB_FX_ALPHA = \
    16, 8, 16, 0.33
DAG_SERVE_KEY, DAG_SERVE_POLICY = "tailstorm-8-discount-heuristic", \
    "get-ahead"
DAG_SERVE_LANES, DAG_SERVE_BURST, DAG_SERVE_MAX_STEPS = 4096, 256, 256
DAG_SERVE_BURSTS = SERVE_BURSTS
DAG_WIRE_CLIENTS = 16


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


def device_ms(fn, reps, kernel, per_call=1):
    """Mean device time per call of `fn`'s launches of the CUDA kernel
    whose name contains `kernel` (a string, or a tuple of strings it must
    all contain), `per_call` launches a call (one by default: the time
    per launch), from torch.profiler's CUPTI trace of `reps` calls.

    Before each call a fill of L2_SCRUB_BYTES leaves the L2 cache full of
    dirty lines of another buffer: the kernel reads its inputs from HBM
    and its writes evict lines that go back to HBM, as they would for a
    caller that did other work between calls. A trace that lost a
    launch record (the profiler once reported 2 of 3 launches) is taken
    again, twice at most; if every one of them lost records, each call
    is traced alone (three tries a call); once a call's launch is
    missing from all three of its traces (the profiler has returned
    none at all), the calls left are timed by CUDA events around each
    scrubbed call: the call's whole span on the stream."""
    from torch.profiler import ProfilerActivity, profile
    scrub = torch.empty(L2_SCRUB_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    parts = (kernel,) if isinstance(kernel, str) else kernel

    def traced(n):
        """(device us, launches) of the kernel over n scrubbed calls."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                scrub.fill_(float(i))
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for ev in prof.key_averages():
            if all(p in ev.key for p in parts):
                total_us += getattr(ev, "device_time_total",
                                    getattr(ev, "cuda_time_total", 0.0))
                count += ev.count
        return total_us, count

    for _ in range(3):
        total_us, count = traced(reps)
        if count == reps * per_call and total_us > 0:
            return total_us / reps / 1e3
        say("device_ms", kernel=json.dumps(parts), traced=count,
            expected=reps * per_call, retry=True)
    total_ms, alone = 0.0, 0
    while alone < reps:
        for _ in range(3):
            us, n = traced(1)
            if n == per_call and us > 0:
                break
        if n != per_call or us <= 0:
            break
        total_ms += us / 1e3
        alone += 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(reps - alone):
        scrub.fill_(float(i))
        start.record()
        fn()
        end.record()
        end.synchronize()
        total_ms += start.elapsed_time(end)
    say("device_ms", kernel=json.dumps(parts), one_call_a_trace=alone,
        cuda_events=reps - alone)
    return total_ms / reps


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


def event_ms(fn, reps, warm=True):
    """Mean device time of `fn` by CUDA events around each call, with
    the L2 cache scrubbed (as in device_ms) before each, after a warm
    call unless `warm` is false (a shape that ran before); for calls
    that launch several kernels or kernels of a library."""
    scrub = torch.empty(L2_SCRUB_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    if warm:
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


def capstone_table():
    """The capstone's table, compiled natively on the host; returns
    (table, host seconds)."""
    from cpr_tpu_torch.mdp.generic import compile_native
    t0 = time.perf_counter()
    table = compile_native("ghostdag", k=2, alpha=MDP_ALPHA, gamma=MDP_GAMMA,
                           collect_garbage="simple",
                           dag_size_cutoff=MDP_CUTOFF)
    return table, time.perf_counter() - t0


def phase_mdp_main(dev, report, table_future):
    """The exact-analysis path at the capstone's size (its table from
    `table_future`: `capstone_table` on the host), its
    launch counts, then K4 and K5 against their plain twins at its
    shapes."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.mdp import ptmdp
    from cpr_tpu_torch.mdp.explicit import vi_chunked

    kernels.reset_launches()
    table, compile_s = table_future.result()
    t0 = time.perf_counter()
    mdp = ptmdp(table, horizon=MDP_HORIZON)
    pt_s = time.perf_counter() - t0
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
    return counts, tm, pol, table, rev, vi


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
    return rows


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
    return counts, tm, probs, vi, pm


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
# the K10 library's env struct of each phase 62 case (K14-dag's kernel
# name in a trace)
DAGB_KINDS = {**{n: ENV_KINDS[FULL_LIB[n]] for n in FULL_ENVS},
              **{f"{n}_ring": ENV_KINDS[n] for n in DAG_ENVS}}


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


# -- full mode (K8-full, K9-full, K10-<env>-full) ---------------------------------

def full_env(name, sized=True):
    """A DAG env in full mode: the checks' and the fixture's sizing
    (`get_sized(key, FULL_HINT)`), or the registry's default (the stream
    paths)."""
    from cpr_tpu_torch.envs import registry
    key = FULL_ENVS[name][0]
    return registry.get_sized(key, FULL_HINT) if sized else registry.get(key)


def full_kernel(name):
    return f"K10-{FULL_LIB[name]}-full"


def full_revenue(ffx, name):
    """cpr_tpu's relative revenue of the main policy on the fixture's
    lanes: the per-lane episode means (bench.py's), averaged."""
    env = full_env(name)
    i = env.scripted_policies.index(FULL_ENVS[name][1])
    sums, nd = ffx[f"{name}_p{i}_sums"], ffx[f"{name}_p{i}_n_done"]
    per = sums / np.maximum(nd, 1)[None, :]
    a, d = float(per[0].mean()), float(per[1].mean())
    return a / (a + d)


def phase_k8_full(dev, ffx, report):
    """K8-full's check kernel (both full modes) against `script_plain` at
    main shapes (a capacity that holds every append) and against the JAX
    fixture's scripts."""
    from cpr_tpu_torch.core import dag as D
    k8 = report["K8-full"]
    err, walks = 0.0, {}
    for lift in (False, True):
        ops, args, fargs = D.make_script(5 + int(lift), K8F_LANES, K8F_OPS,
                                         K8F_PARENTS, ops=D.FULL_OPS,
                                         lift=lift)
        a, f = torch.from_numpy(args).to(dev), torch.from_numpy(fargs).to(dev)

        def fresh(L, W, P):
            return D.empty(L, W, P, lift=lift, device=dev)

        dk, rk, ok = D.dag_script(fresh(K8F_LANES, K8F_CAP, K8F_PARENTS), ops,
                                  a, f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp, rp, op = D.script_plain(fresh(K8F_LANES, K8F_CAP, K8F_PARENTS),
                                    ops, a, f)
        torch.cuda.synchronize()
        if not lift:
            k8["plain_ms"] = (time.perf_counter() - t0) * 1e3
        what = f"K8-full{' lifted' if lift else ''}"
        check(torch.equal(ok, op), f"{what} script results differ from plain")
        check(torch.equal(rk, rp), f"{what} registers differ from plain")
        err = max(err, compare_dag_state(dk, dp, f"{what} vs plain"))
        check(not bool(dk.overflow.any()), f"{what}: the script overflowed")
        walks[what] = int(np.isin(ops, (D.OP_RELEASE_CHAIN,
                                        D.OP_RELEASE_CLOSURE,
                                        D.OP_BLOCK_AT_HEIGHT,
                                        D.OP_CA_HEIGHT)).sum())
        # against jax (committed fixture)
        pre = "k8lift" if lift else "k8full"
        L = ffx[f"{pre}_args"].shape[1]
        W = ffx[f"{pre}_dag.height"].shape[1]
        P = ffx[f"{pre}_dag.parents"].shape[0]
        dj, rj, oj = D.dag_script(fresh(L, W, P), ffx[f"{pre}_ops"],
                                  torch.from_numpy(ffx[f"{pre}_args"]).to(dev),
                                  torch.from_numpy(ffx[f"{pre}_fargs"]).to(dev))
        check(np.array_equal(oj.cpu().numpy(), ffx[f"{pre}_out"])
              and np.array_equal(rj.cpu().numpy(), ffx[f"{pre}_regs"]),
              f"{what} script differs from jax")
        check(np.array_equal(torch.stack(dj.parents).cpu().numpy(),
                             ffx[f"{pre}_dag.parents"]),
              f"{what} parents differ from jax")
        for g in D.FIELDS[1:]:
            check(np.array_equal(getattr(dj, g).cpu().numpy(),
                                 ffx[f"{pre}_dag.{g}"]),
                  f"{what} {g} differs from jax")
    k8["max_abs_err"] = err
    say("k8_full", lanes=K8F_LANES, ops=K8F_OPS, capacity=K8F_CAP,
        parents=K8F_PARENTS, walk_ops=json.dumps(walks),
        fixture_lanes=int(ffx["k8full_args"].shape[1]), max_abs_err=err,
        ok=True)


def phase_k9_full(dev, ffx, report):
    """K9-full's check kernel against `check_plain` on FULL_LANES lanes of
    each vote env's full-mode plain stream carry (every policy on its
    share of the lanes, K9F_STEPS steps into episodes of K9F_MAX_STEPS)
    and against the fixture's carries and inputs (jax's outputs).
    Returns the carries."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs import quorum as Q
    from cpr_tpu_torch.kernels import _CHECK_CFG
    from cpr_tpu_torch.params import make_params
    carries = {}
    for name in ("ts", "stree"):
        env = full_env(name)
        n = FULL_LANES
        group = -(-n // len(env.scripted_policies))
        params = make_params(alpha=0.35, gamma=0.5, max_steps=K9F_MAX_STEPS)
        _, carry = dag_plain_stats(env, rnd.split(rnd.PRNGKey(31, dev), n),
                                   params, mixed_policy(env, group),
                                   K9F_STEPS)
        carries[name] = carry
        state = carry[0]
        check(not bool(state.dag.overflow.any()), f"K9-full {name} overflow")
        inputs = {k: v.contiguous() for k, v in
                  Q.check_inputs(env, state).items()}
        cfg = Q.check_cfg(env)
        got = Q.quorum_check(state.dag, inputs, cfg)
        want = Q.check_plain(state.dag, inputs, cfg)
        for k, w in want.items():
            check(torch.equal(got[k], w),
                  f"K9-full {name} {k} differs from plain")
        fcfg = {f: int(v) for f, v in zip(_CHECK_CFG,
                                           ffx[f"k9_{name}_cfg"])}
        fstate = fixture_dag_state(ffx, f"k9_{name}_state_", env, dev)
        fin = {f: torch.from_numpy(ffx[f"k9_{name}_in_{f}"]).to(dev)
               for f in ("cand", "own", "seen", "score", "stale", "pub",
                         "priv")}
        fout = Q.quorum_check(fstate.dag, fin, fcfg)
        for k, v in fout.items():
            check(np.array_equal(v.cpu().numpy(), ffx[f"k9_{name}_out_{k}"]),
                  f"K9-full {name} {k} differs from jax")
        say(f"k9_full_{name}", lanes=n, capacity=env.capacity, C=cfg["C"],
            found=json.dumps(want["found"].sum(1).tolist()),
            release_flips=int(want["rfound"].sum()),
            framed=int(want["cvalid"].sum()),
            fixture_lanes=int(fin["pub"].shape[0]), ok=True)
    report["K9-full"]["max_abs_err"] = 0.0  # integers and bools only
    return carries


def phase_full_lanes(dev, ffx, report):
    """Each K10-<env>-full step_lanes against its plain version over
    seeded actions and admit and step masks, then the fixture's tick
    trace (jax's)."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.base import INFO_KEYS
    from cpr_tpu_torch.params import make_params
    for name in FULL_ENVS:
        env = full_env(name)
        k10 = report[full_kernel(name)]
        lanes = FULL_CHECK_LANES
        params = make_params(alpha=0.35, gamma=0.5,
                             max_steps=FULL_CHECK_MAX_STEPS)
        rng = np.random.default_rng(2)
        carry = env.init_lanes(rnd.split(rnd.PRNGKey(11, dev), lanes), params)
        fresh = env.init_lanes(rnd.split(rnd.PRNGKey(12, dev), lanes), params)
        s_plain, o_plain = env._stream_init(
            rnd.split(rnd.PRNGKey(11, dev), lanes), params)
        err = compare_dag_state(carry[0], s_plain, f"{name} full init_lanes")
        plain = clone_carry(carry)
        n_done = 0
        for t in range(FULL_CHECK_TICKS):
            actions = torch.from_numpy(rng.integers(
                0, env.n_actions, lanes).astype(np.int32)).to(dev)
            admit = torch.from_numpy(rng.random(lanes) < 0.05).to(dev)
            step = torch.from_numpy(rng.random(lanes) < 0.8).to(dev)
            _, out = env.step_lanes(carry, actions, admit, fresh, step,
                                    params)
            _, out_p = env.step_lanes_plain(plain, actions, admit, fresh,
                                            step, params)
            err = max(err, compare_outputs(out, out_p,
                                           f"{name} full tick {t}"))
            n_done += int(out[2].sum())
        err = max(err, compare_dag_state(carry[0], plain[0],
                                         f"{name} full ticks"))
        check(float((carry[1] - plain[1]).abs().max()) <= 1e-6,
              f"{name} full carry obs")
        check(n_done > 0, f"{name} full step_lanes check reset no lane")
        # against jax (committed fixture)
        p3 = make_params(alpha=0.35, gamma=0.5, max_steps=12)
        carry = env.init_lanes(rnd.from_numpy_words(
            ffx[f"{name}_sl_keys"], dev), p3)
        fresh = env.init_lanes(rnd.from_numpy_words(
            ffx[f"{name}_sl_fresh_keys"], dev), p3)
        cvt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        for t in range(ffx[f"{name}_sl_actions"].shape[0]):
            _, out = env.step_lanes(carry, cvt(ffx[f"{name}_sl_actions"][t]),
                                    cvt(ffx[f"{name}_sl_admit"][t]), fresh,
                                    cvt(ffx[f"{name}_sl_step"][t]), p3)
            want = (cvt(ffx[f"{name}_sl_out_obs"][t]),
                    cvt(ffx[f"{name}_sl_out_reward"][t]),
                    cvt(ffx[f"{name}_sl_out_done"][t]),
                    {k: cvt(ffx[f"{name}_sl_out_info"][t][i])
                     for i, k in enumerate(INFO_KEYS)})
            compare_outputs(out, want, f"{name} full step_lanes vs jax "
                            f"tick {t}")
        compare_dag_state(carry[0], fixture_dag_state(
            ffx, f"{name}_sl_final_", env, dev), f"{name} full step_lanes "
            "vs jax")
        k10["max_abs_err"] = max(k10["max_abs_err"], err)
        say(f"{name}_full_lanes", kernel=full_kernel(name),
            capacity=env.capacity, lanes=lanes, ticks=FULL_CHECK_TICKS,
            episodes_ended=n_done, max_abs_err=err, ok=True)


def phase_full_streams(dev, ffx, report):
    """Each env's full-mode stream path (`registry.get(key)`: no window,
    the default sizing) at FULL_LANES x FULL_STEPS in chunks of
    FULL_CHUNK under the main policy, its launch counts and revenue
    guard, every policy on the first FULL_REF_LANES lanes over
    FULL_REPLAY_STEPS steps against one batched plain replay (its time is
    the row's plain time), and every policy on the fixture's keys against jax
    (the main policy's whole final carry at the fixture's sizing).
    Returns the paths' launch counts and each env's plain chunk ms."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.base import EPISODE_KEYS
    from cpr_tpu_torch.params import make_params
    counts_all, plain_ms = [], {}
    for name in FULL_ENVS:
        env, fenv = full_env(name, sized=False), full_env(name)
        main = FULL_ENVS[name][1]
        k10n = full_kernel(name)
        k10 = report[k10n]
        check(not env.ring and env.kernel_name == k10n,
              f"{name}: registry.get gives {env.kernel_name}")
        params = make_params(alpha=0.35, gamma=0.5, max_steps=FULL_MAX_STEPS)
        kernels.reset_launches()
        keys = rnd.split(rnd.PRNGKey(0, dev), FULL_LANES)
        fn = env.make_episode_stats_fn(params, env.policies[main], FULL_STEPS,
                                       chunk=FULL_CHUNK)
        stats = fn(keys)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = fn(keys)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(kernels.launches)
        path_launches(counts, ("K1", k10n), f"{name} full")
        counts_all.append(counts)
        check(all(torch.isfinite(stats[k]).all() for k in EPISODE_KEYS),
              f"{name} full: non-finite stats")
        short = (stats["episode_n_steps"] < FULL_MAX_STEPS) \
            & (stats["n_episodes"] > 0)
        check(not bool(short.any()), f"{name} full: an episode overflowed")
        atk = float(stats["episode_reward_attacker"].mean())
        dfn = float(stats["episode_reward_defender"].mean())
        rel, ref = atk / (atk + dfn), full_revenue(ffx, name)
        check(abs(rel - ref) < VOTE_GUARD,
              f"{name} full relative revenue {rel} outside {ref} +- "
              f"{VOTE_GUARD}")
        # every policy on the first lanes against one batched plain replay
        n, n_pol = FULL_REF_LANES, len(env.scripted_policies)
        want, _, chunk_s = dag_plain_stats(
            env, keys[:n].repeat(n_pol, 1), params, mixed_policy(env, n),
            FULL_REPLAY_STEPS, timed=True)
        plain_ms[name] = chunk_s[0] * 1e3
        err = 0.0
        for i, pol in enumerate(env.scripted_policies):
            sl = slice(i * n, (i + 1) * n)
            w = {k: v[sl] for k, v in want.items()}
            got = env.make_episode_stats_fn(params, env.policies[pol],
                                            FULL_REPLAY_STEPS)(keys[:n])
            err = max(err, compare_stats(got, w, f"{k10n} {pol} vs plain"))
        # against jax (committed fixture)
        fkeys = rnd.from_numpy_words(ffx[f"{name}_keys"], dev)
        for i, pol in enumerate(fenv.scripted_policies):
            carry, sums, nd, _ = fenv._stream(None, fkeys, 1, FULL_STEPS, params,
                                              pol, True)
            check(np.array_equal(nd.cpu().numpy(), ffx[f"{name}_p{i}_n_done"]),
                  f"{name} full {pol} episodes differ from jax")
            ws = ffx[f"{name}_p{i}_sums"]
            for j, k in enumerate(EPISODE_KEYS):
                g = sums[j].cpu().numpy()
                if "time" in k:
                    check(bool((np.abs(g - ws[j]) <= 1e-5 * np.abs(ws[j]))
                               .all()), f"{name} full {pol} {k} vs jax")
                else:
                    check(np.array_equal(g, ws[j]),
                          f"{name} full {pol} {k} differs from jax")
            check(float(np.abs(carry[1].cpu().numpy()
                               - ffx[f"{name}_p{i}_obs"]).max()) <= 1e-6,
                  f"{name} full {pol} obs vs jax")
            if pol == main:
                compare_dag_state(carry[0], fixture_dag_state(
                    ffx, f"{name}_final_", fenv, dev),
                    f"{name} full {pol} vs jax")
        k10["max_abs_err"] = max(k10["max_abs_err"], err)
        say(f"{name}_full", kernel=k10n, capacity=env.capacity,
            lanes=FULL_LANES, steps=FULL_STEPS, chunk=FULL_CHUNK,
            rel_revenue=rel, ref_revenue=ref,
            episodes=int(stats["n_episodes"].sum()),
            env_steps_per_s=FULL_LANES * FULL_STEPS / secs, call_s=secs,
            plain_lanes=n * n_pol, plain_chunk_ms=plain_ms[name],
            fixture_policies=n_pol, max_abs_err=err,
            launches=json.dumps(counts), ok=True)
    return counts_all, plain_ms


def phase_full_gym(dev, report):
    """`cpr-tailstorm-torch-v0` at its defaults on the card: the env its
    factory builds (gym.env_fn: Tailstorm k=8, discount, heuristic,
    `get_sized` to episode_len 128, alpha 0.45 at the schedule's default),
    one resident lane as gym.envs.Core steps it (K1 splits its key),
    FULL_GYM_TICKS ticks of K10-ts-full; launch counts. Returns them."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.params import make_params
    env = registry.get_sized("tailstorm", 128, k=8,
                             incentive_scheme="discount",
                             subblock_selection="heuristic")
    check(not env.ring and env.kernel_name == "K10-ts-full",
          f"the gym's env runs {env.kernel_name}")
    params = make_params(alpha=0.45, gamma=0.5, max_steps=128)
    pol = env.policies["get-ahead"]
    kernels.reset_launches()
    k = rnd.split(rnd.PRNGKey(0, dev))[1][None]
    fresh = env.reset_lanes(k, params)
    carry = env.reset_lanes(k, params)
    no_admit = torch.zeros(1, dtype=torch.bool, device=dev)
    step_all = torch.ones(1, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    episodes, reward = 0, 0.0
    for _ in range(FULL_GYM_TICKS):
        _, (obs, r, done, _) = env.step_lanes(carry, pol(carry[1]), no_admit,
                                              fresh, step_all, params)
        episodes += int(done[0])
        reward += float(r[0])
    tick_s = time.perf_counter() - t0
    counts = dict(kernels.launches)
    path_launches(counts, ("K1", "K10-ts-full"), "gym full")
    check(counts["K10-ts-full"] == FULL_GYM_TICKS + 2,
          f"K10-ts-full launched {counts['K10-ts-full']} times for "
          f"{FULL_GYM_TICKS} ticks and two resets")
    check(bool(torch.isfinite(obs).all()) and np.isfinite(reward),
          "gym full: non-finite obs or reward")
    say("gym_full", id="cpr-tailstorm-torch-v0", capacity=env.capacity,
        ticks=FULL_GYM_TICKS, ticks_per_s=FULL_GYM_TICKS / tick_s,
        episodes_ended=episodes, launches=json.dumps(counts), ok=True)
    return counts


def phase_full_times(dev, report, k9_carries, plain_ms):
    """Each K10-<env>-full's device time per FULL_CHUNK-step launch at the
    stream path's shape and per step_lanes tick, and the bound (as
    phase_dag_times counts it; the Stree row's numbers are Stree's,
    TailstormJune's are printed beside them), with the plain version's
    time of FULL_REPLAY_STEPS (= FULL_CHUNK) steps at its replay's lanes
    (`plain_ms`, phase_full_streams); K8-full's and K9-full's check
    kernels at main shapes."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.core import dag as D
    from cpr_tpu_torch.envs import quorum as Q
    from cpr_tpu_torch.params import make_params
    times = {}
    for name in FULL_ENVS:
        env = full_env(name, sized=False)
        env_kind = ENV_KINDS[FULL_LIB[name]]
        row = f"{full_kernel(name)}" + (" june" if name == "june" else "")
        L, T = FULL_LANES, FULL_CHUNK
        params = make_params(alpha=0.35, gamma=0.5, max_steps=FULL_MAX_STEPS)
        pol = FULL_ENVS[name][1]
        pid = env.scripted_policy_id(pol)
        keys = rnd.split(rnd.PRNGKey(0, dev), L)
        carry = env._empty_carry(L, dev)
        t = {}
        t["ms"] = device_ms(lambda: env._kernel_stream(
            carry, keys, 1, T, params, pid, True, False), 3,
            ("dag_stream_kernel", env_kind))
        sums, n_done, _ = env._kernel_stream(carry, keys, 1, T, params, pid,
                                             True, False)
        resets = int(n_done.sum())
        state_b = carry_bytes(carry)
        k10_bytes = L * 8 + 2 * state_b + L * (7 * 4 + 4)
        if FULL_LIB[name] in MINE5_ENVS:
            mines = int(sums[6].sum()) + int(carry[0].n_activations.sum())
            k10_ops = THREEFRY_OPS * (MINE_THREEFRY5 * mines + L)
        else:
            k10_ops = THREEFRY_OPS * (MINE_THREEFRY * (L * T + L + resets)
                                      + L)
        t["bound_ms"], t["bound_by"] = bound_ms(k10_bytes, k10_ops)
        t["state_bytes"] = state_b
        t["plain_ms"] = plain_ms[name]
        c2 = env.reset_lanes(keys, params)
        fresh = env.reset_lanes(rnd.split(rnd.PRNGKey(3, dev), L), params)
        actions = env.policies[pol](c2[1])
        no_admit = torch.zeros(L, dtype=torch.bool, device=dev)
        step_all = torch.ones(L, dtype=torch.bool, device=dev)
        t["step_lanes_ms"] = device_ms(lambda: env.step_lanes(
            c2, actions, no_admit, fresh, step_all, params), 20,
            ("dag_step_lanes_kernel", env_kind))
        t["capacity"] = env.capacity
        times[row] = t
        if name != "june":
            r = report[full_kernel(name)]
            r.update({f: t[f] for f in ("ms", "bound_ms", "bound_by",
                                        "plain_ms")})
            r["library_ms"] = None  # no PyTorch call computes an env step
    # K8-full: the non-lifted script at main shapes
    ops, args, fargs = D.make_script(5, K8F_LANES, K8F_OPS, K8F_PARENTS,
                                     ops=D.FULL_OPS)
    a, f = torch.from_numpy(args).to(dev), torch.from_numpy(fargs).to(dev)
    dag = D.empty(K8F_LANES, K8F_CAP, K8F_PARENTS, device=dev)
    k8 = report["K8-full"]
    k8["ms"] = device_ms(lambda: D.dag_script(dag, ops, a, f), 3,
                         "dag_script_kernel")
    dag_b = carry_bytes((dag, torch.empty(0)))
    k8["bound_ms"], k8["bound_by"] = bound_ms(
        2 * dag_b + a.nbytes + f.nbytes + K8F_OPS * K8F_LANES * 16
        + K8F_LANES * 32, 0)
    k8["library_ms"] = None
    # K9-full on the Tailstorm carries of phase_k9_full
    env = full_env("ts")
    state = k9_carries["ts"][0]
    inputs = {k: v.contiguous() for k, v in
              Q.check_inputs(env, state).items()}
    cfg = Q.check_cfg(env)
    k9 = report["K9-full"]
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
        k9_full_bytes(state.dag, inputs, cfg, out), 0)
    k9["library_ms"] = None
    for k in ("K8-full", "K9-full"):
        times[k] = {f: report[k][f] for f in ("ms", "plain_ms", "bound_ms",
                                              "bound_by")}
    say("full_times", **{k: json.dumps(v) for k, v in times.items()})


def k9_full_bytes(dag, inputs, cfg, out):
    """The bytes K9-full's check must move on these lanes: the per-slot
    planes it scans whole (signer, kind, vis_d and the inputs cand and
    stale), for each framed candidate its parent slot, the kind of that
    parent and its gathered values (aux, own, seen, score), the height
    (and for Tailstorm the auxg) of each release position and of `pub`,
    for each of the first R withheld its block's STALE_WALK steps of the
    previous-block pointer, the lane scalars, and every output written
    once; counted at this run's data."""
    from cpr_tpu_torch.envs import quorum as Q
    L, W = dag.height.shape
    framed = int((out["cidx"] >= 0).sum())
    cands = dag.exists() & ~dag.vis_d & ~inputs["stale"]
    positions = int(cands.sum(1).clamp(max=cfg["R"]).sum()) + L
    per_pos = 4 + (4 if cfg["env"] == 0 else 0)
    withheld = dag.exists() & ~dag.vis_d & ~inputs["stale"]
    walked = int(withheld.sum(1).clamp(max=cfg["R"]).sum())
    return (L * W * (4 + 4 + 1 + 1 + 1) + framed * (4 + 4 + 4 + 1 + 4 + 4)
            + positions * per_pos + walked * 4 * (1 + Q.STALE_WALK)
            + L * (4 + 1 + 4 + 4) + sum(v.nbytes for v in out.values()))


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


def config_full_case(name, cfg, net, env, dev):
    """A DAG config's env (Tailstorm, Spar, Sdag) as `build_env` makes it
    on the card (full mode at the reference's sizing: K10-<env>-full)
    under the trained net at the config's widths (hidden 96,
    AssumptionEnv, its lane alphas, episode_len 128): `net_stream_case`
    over its lanes for CONFIG_FULL_STEPS steps from a raw reset, so every
    lane runs a whole episode; no episode may fill the capacity."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.train import driver
    params = driver._stack_params(cfg.lane_alphas(cfg.n_envs), cfg.gamma,
                                  cfg.episode_len)
    episodes, e, below, rings = net_stream_case(
        env, params, net, rnd.split(rnd.PRNGKey(80, dev), cfg.n_envs),
        CONFIG_FULL_STEPS, rnd.PRNGKey(81, dev), f"{name} config full")
    check(not env.inner.ring, f"{name} config: not in full mode")
    check(rings["episodes_overflowed"] == 0,
          f"{name} config: {rings['episodes_overflowed']} episodes filled "
          f"the {env.inner.capacity}-slot DAG")
    check(episodes >= cfg.n_envs, f"{name} config: an episode unfinished")
    say("config_full", config=name, lanes=cfg.n_envs,
        steps=CONFIG_FULL_STEPS, hidden=net.hidden[0],
        capacity=env.inner.capacity, episodes=episodes, max_abs_err=e,
        lanes_below_margin=below, peak_n_max=rings["ring_peak_max"],
        ok=True)


def phase_config_path(dev, report, tmp):
    """The config path: `train_from_config(TrainConfig.from_dict(...))`
    on the shipped nakamoto.yaml for 3 updates and tailstorm-8-
    discount.yaml, spar-8.yaml and sdag-8-discount.yaml (hidden 96, 512
    lanes x 64 steps; full mode, K10-<env>-full) for 2 each, with eval.freq
    1 and
    start_at_iteration 0 so that the eval and the checkpoints run; launch
    counts per config; eval rows finite, relative reward in [0, 1]; then
    a policy snapshot exported and reloaded gives the same greedy
    actions; for the DAG configs `config_full_case` with the trained
    net."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.train import config, driver
    counts_all = []
    for name, ran, n_updates in (("nakamoto", ("K1", "K2"), 3),
                                 ("tailstorm", ("K1", "K10-ts-full"), 2),
                                 ("spar", ("K1", "K10-spar-full"), 2),
                                 ("sdag", ("K1", "K10-sdag-full"), 2)):
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
            config_full_case(name, cfg, net, env, dev)
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


def plain_ahead(dev, out_dir):
    """The netsim kernels' plain holds (phases 35-39, 48 and 75-78:
    `k12_scan_holds` and the netsim sweep's, `k12_event_holds`,
    `proto_holds`, `k13_holds`, `wide_holds`), in a child process started
    while the main process builds the other kernels:
    these plain versions replay CUDA graphs of small launches, bound by
    the card's latency, and the card is idle during the build; their one
    kernel is K1 (their draws), built first (`kernels.load_random`).
    Each hold's outputs go to out_dir; returns {hold: [file, seconds]}."""
    from cpr_tpu_torch import kernels, netsim
    from cpr_tpu_torch.netsim import engine as E
    kernels.load_random()
    out = {}

    def hold(name, fn):
        want, sec = plain_timed(fn)
        file = f"plain{len(out)}.npz"
        np.savez(Path(out_dir) / file,
                 **{k: v.cpu().numpy() for k, v in want.items()})
        out[name] = [file, sec]

    keys, dl = lane_inputs(range(NET_LANES), [NET_ACT_DELAY] * NET_LANES, dev)
    for what, cn, L, acts in k12_scan_holds():
        hold(f"K12-scan {what}",
             lambda: E.scan_plain(cn, acts, L, keys, dl))
    sk, sd = lane_inputs(*netsim.grid(range(NET_SWEEP_SEEDS),
                                      NET_SWEEP_DELAYS), dev)
    hold("K12-scan sweep", lambda: E.scan_plain(
        bench_clique(NET_NODES, NET_PROP), NET_ACTS, 32, sk, sd))
    for what, cn, lanes, acts in k12_event_holds():
        eng = netsim.Engine(cn, activations=acts, mode="event")
        ek, ed = lane_inputs(range(lanes), [NET_ACT_DELAY] * lanes, dev)
        hold(f"K12-event {what}", lambda: E.event_plain(
            cn, acts, eng.B, eng.M, eng.F, eng.S, ek, ed))
    for kern, what, cfg, acts, flooding in proto_holds():
        eng, pk, pd = proto_hold_inputs(cfg, acts, flooding, dev)
        hold(f"{kern} {what}", lambda: proto_plain(eng, pk, pd))
    for what, eng, lanes, alphas, pids in k13_holds():
        args = attack_inputs(eng, lanes, alphas, pids, dev)
        hold(f"K13 {what}", lambda: attack_plain_run(eng, *args))
    for name, _, spec in wide_holds():
        eng, inputs = wide_hold_inputs(spec, dev)
        hold(f"wide {name}", lambda: wide_plain(eng, inputs))
    return out


def ahead_plain(ahead, name):
    """A hold's plain outputs (numpy) and seconds from `plain_ahead`'s
    child (`ahead`: its Popen, output and directory), waiting for the
    child the first time."""
    if "result" not in ahead:
        ahead["result"] = collect_calls(ahead["proc"], ahead["out"],
                                        "the plain replays'")[0]
    file, sec = ahead["result"][name]
    with np.load(Path(ahead["dir"]) / file) as f:
        return {k: f[k] for k in f.files}, sec


def k12_scan_holds():
    """K12-scan's plain holds: (name, network, lookback, activations): the
    netsim path's shape (the bench clique, NET_LANES x NET_ACTS: the
    row's plain time and error) and a 5-node clique with exponential
    link delays at lookback 32 and 40 (branches the path does not run;
    NET_EXTRA_ACTS)."""
    from cpr_tpu_torch import distributions as D
    from cpr_tpu_torch import netsim, network
    exp_net = network.symmetric_clique(5, activation_delay=25.0,
                                       propagation_delay=1.0)
    for nd in exp_net.nodes:
        for ln in nd.links:
            ln.delay = D.exponential(2.0)
    exp_cn = netsim.compile_network(exp_net)
    return (("clique10", bench_clique(NET_NODES, NET_PROP), 32, NET_ACTS),
            ("exp5", exp_cn, 32, NET_EXTRA_ACTS),
            ("exp5_lookback40", exp_cn, 40, NET_EXTRA_ACTS))


def phase_k12_scan(dev, nfx, report, ahead):
    """K12-scan against its plain version at `k12_scan_holds`' shapes (the
    plain outputs and times from `plain_ahead`'s child: `ahead`); then
    the JAX fixture's scan cases."""
    from cpr_tpu_torch import kernels
    margins, secs = {}, {}
    for what, cn, L, acts in k12_scan_holds():
        keys, dl = lane_inputs(range(NET_LANES), [NET_ACT_DELAY] * NET_LANES,
                               dev)
        got = kernels.netsim_scan(cn, acts, L, keys, dl)
        want, secs[what] = ahead_plain(ahead, f"K12-scan {what}")
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


def phase_netsim_path(dev, report, ahead):
    """The netsim path at bench.py's shape through Engine.run, its own
    launch counts; then the sweep shape, held to the plain version on all
    its lanes (its replay from `plain_ahead`'s child: `ahead`)."""
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
    check(eng.lookback == 32, "the sweep's hold runs lookback 32")
    want, plain_s = ahead_plain(ahead, "K12-scan sweep")
    err = compare_netsim(sweep, want, "the netsim sweep vs plain")
    margin = float(want["margin"].min())
    del want
    say("netsim_sweep", lanes=len(ss), activations=NET_ACTS,
        delays=json.dumps(NET_SWEEP_DELAYS), call_s=sweep_s,
        activations_per_s=len(ss) * NET_ACTS / sweep_s,
        orphan_by_delay=json.dumps([round(float(x), 6) for x in by_delay]),
        plain_s=plain_s, max_abs_err=err, margin=margin, ok=True)
    return counts, orphan


def k12_event_holds():
    """K12-event's plain holds: (name, network, lanes, activations): the
    event path's shape (the bench clique, NET_LANES x NET_ACTS, the
    path's sizing: the row's plain time and error) and flooding on
    random_regular(13, 4) with exponential delays (the path runs no
    flooding; NET_FLOOD_LANES x NET_FLOOD_ACTS)."""
    from cpr_tpu_torch import distributions as D
    from cpr_tpu_torch import netsim, network
    flood = netsim.compile_network(network.random_regular(
        13, 4, activation_delay=NET_ACT_DELAY, delay=D.exponential(2.0),
        seed=1))
    return (("clique10", bench_clique(NET_NODES, NET_PROP), NET_LANES,
             NET_ACTS),
            ("flood13", flood, NET_FLOOD_LANES, NET_FLOOD_ACTS))


def phase_k12_event(dev, nfx, report, ahead):
    """K12-event against its plain version at `k12_event_holds`' shapes
    (the plain outputs and times from `plain_ahead`'s child: `ahead`);
    then the JAX fixture's event cases."""
    from cpr_tpu_torch import kernels, netsim
    margins, secs = {}, {}
    for what, cn, lanes, acts in k12_event_holds():
        eng = netsim.Engine(cn, activations=acts, mode="event")
        keys, dl = lane_inputs(range(lanes), [NET_ACT_DELAY] * lanes, dev)
        got = kernels.netsim_event(cn, acts, eng.B, eng.M, eng.F, eng.S,
                                   keys, dl)
        want, secs[what] = ahead_plain(ahead, f"K12-event {what}")
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


def k13_holds():
    """K13's plain holds: (name, engine, lanes, alphas, policy ids): the
    attack path's shape (clique-4, ATK_LANES x ATK_ACTS, its alphas,
    policies and queue: the row's plain time and error), every scripted
    policy at alpha 0.3 and 0.45 (ATK_EXTRA_LANES x ATK_EXTRA_ACTS, the
    default queue) and the attack sweep (ATK_SWEEP_LANES x
    ATK_SWEEP_ACTS)."""
    from cpr_tpu_torch.netsim import attack as AT
    al, pi, _ = attack_lanes(ATK_LANES)
    sal, spi, _ = attack_lanes(ATK_SWEEP_LANES)
    n = ATK_EXTRA_LANES
    return (("path", attack_engine(ATK_ACTS), ATK_LANES, al, pi),
            ("policies", attack_engine(ATK_EXTRA_ACTS, AT.SCRIPTED_POLICIES,
                                       None), n,
             [0.3 if i % 2 else 0.45 for i in range(n)],
             [i // 2 % 4 for i in range(n)]),
            ("sweep", attack_engine(ATK_SWEEP_ACTS), ATK_SWEEP_LANES, sal,
             spi))


def phase_k13(dev, nfx, report, ahead):
    """K13 against its plain version at `k13_holds`' path and policy
    shapes (the plain outputs and times from `plain_ahead`'s child:
    `ahead`); then the JAX fixture's attack cases."""
    margins, secs = {}, {}
    for what, eng, lanes, alphas, pids in k13_holds()[:2]:
        args = attack_inputs(eng, lanes, alphas, pids, dev)
        got = eng.lanes(*args)
        want, secs[what] = ahead_plain(ahead, f"K13 {what}")
        margins[what] = float(want["margin"].min())
        err = compare_netsim(got, want, f"K13 {what} vs plain")
        if what == "path":
            report["K13"]["plain_ms"] = secs[what] * 1e3
            report["K13"]["max_abs_err"] = err
    check_fixture_cases(nfx, "attack", dev)
    say("k13", lanes=ATK_LANES, activations=ATK_ACTS, queue=ATK_QUEUE_CAP,
        max_abs_err=report["K13"]["max_abs_err"],
        margin=json.dumps(margins), plain_s=json.dumps(secs), ok=True)


def phase_attack_path(dev, report, ahead):
    """The attack path at bench.py's shape through AttackEngine.run, its
    own launch counts; the default queue's drops; then ATK_SWEEP_LANES x
    ATK_SWEEP_ACTS, held to the plain version on all its lanes (its
    replay from `plain_ahead`'s child: `ahead`)."""
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
    want, plain_s = ahead_plain(ahead, "K13 sweep")
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


def proto_holds():
    """Phase 48's holds: (kernel, name, (protocol, k, scheme),
    activations, flooding). Each kernel's first configuration on the
    path's lanes (the sweep's five lanes, delay 30 the most contended) at
    the path's HN_ACTS activations (the row's plain time and error), its
    others at HN_PLAIN_ACTS on the same lanes, then flooding on
    random_regular(13, 4) with exponential delays."""
    out = []
    for kern, configs in PROTO_CONFIGS.items():
        for i, (proto, k, scheme) in enumerate(configs):
            acts = HN_ACTS if i == 0 else HN_PLAIN_ACTS
            out.append((kern, f"{proto}-{k}-{scheme}@{acts}",
                        (proto, k, scheme), acts, False))
        out.append((kern, f"{configs[0][0]}-flood13", configs[0],
                    NET_FLOOD_ACTS, True))
    return out


def proto_hold_inputs(cfg, acts, flooding, dev):
    """A phase 48 hold's engine and lane inputs."""
    from cpr_tpu_torch import distributions as D
    from cpr_tpu_torch import netsim, network
    proto, k, scheme = cfg
    if not flooding:
        return (proto_engine(proto, k, scheme, acts),
                *lane_inputs([HN_SEED] * len(HN_DELAYS), HN_DELAYS, dev))
    flood = netsim.compile_network(network.random_regular(
        13, 4, activation_delay=NET_ACT_DELAY, delay=D.exponential(2.0),
        seed=1))
    return (proto_engine(proto, k, scheme, acts, flood),
            *lane_inputs(range(NET_FLOOD_LANES),
                         [NET_ACT_DELAY] * NET_FLOOD_LANES, dev))


def phase_proto_plain(dev, report, ahead):
    """Phase 48: each protocol kernel against its plain version, exactly,
    at `proto_holds`' shapes (the plain outputs and times from
    `plain_ahead`'s child: `ahead`); the first configuration's hold
    gives the row's plain time and error."""
    from cpr_tpu_torch import kernels
    margins, secs = {}, {}
    for kern, what, cfg, acts, flooding in proto_holds():
        eng, keys, dl = proto_hold_inputs(cfg, acts, flooding, dev)
        got = eng.lanes(keys, dl)
        want, secs[what] = ahead_plain(ahead, f"{kern} {what}")
        margins[what] = float(want["margin"].min())
        err = compare_netsim(got, want, f"{kern} {what} vs plain")
        if acts == HN_ACTS:
            report[kern]["plain_ms"] = secs[what] * 1e3
            report[kern]["max_abs_err"] = err
            check(int(got["steps"].max()) > 0, f"{kern} ran no step")
    kernels.reset_launches()  # the comparisons' launches count nowhere
    say("proto_plain", margin=json.dumps(margins), plain_s=json.dumps(secs),
        max_abs_err=json.dumps({k: report[k]["max_abs_err"]
                                for k in PROTO_KERNELS}), ok=True)


def hn_guards(rows, spar_rows, none_ok=False):
    """The sweep's guards on its rows: 30 rows and 2 Tailstorm error rows,
    then 10 Spar rows; every lane's activations there; Bk constant's
    rewards summing to its progress; Spar's progress k times the head's
    height; the Ethereum bounds of the JAX package's invariant test;
    orphan rates in [0, 0.2], falling from delay 30 to 600 (or, with
    `none_ok`, none at either: on 64 nodes every Byzantium orphan but the
    newest becomes an uncle, as cpr_tpu's run of the case ethbyz_clique64
    in tests/test_torch_netsim_wide.py shows)."""
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
        check(by[30.0] > by[600.0]
              or (none_ok and by[30.0] == by[600.0] == 0.0),
              f"{what}: orphan rate at delay 30 {by[30.0]} not above delay "
              f"600's {by[600.0]}")
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


# -- phases 51-55: the serve engine (K14, K15) and the learning loop ----------

def serve_env(max_steps):
    from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
    from cpr_tpu_torch.params import make_params
    return NakamotoSSZ(), make_params(alpha=0.35, gamma=0.5,
                                      max_steps=max_steps)


def exp_clone(exp):
    return {k: v.clone() for k, v in exp.items()}


def net_margins(eng, o, pol, live, exp_key, t):
    """Per lane, the gap between the two largest (perturbed) logits of
    its net entry at this step (inf for scripted lanes): a net's draw is
    decided wherever it exceeds NET_MARGIN."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.learn import buffer
    margin = torch.full(pol.shape, float("inf"), device=o.device)
    for i, (kind, arg, _) in enumerate(eng._entries):
        sel = (pol == i) & live
        if kind == 0 or not bool(sel.any()):
            continue
        net, flat = eng._slots[arg]
        with torch.no_grad():
            z = net(o, flat)[0]
        if kind == 2:  # the per-lane categorical of `#sample`
            keys = buffer.step_keys_plain(exp_key, t)
            x0, x1 = rnd.threefry_words(
                keys[:, None, :], torch.arange(z.shape[-1],
                                               device=o.device)[None, :])
            z = z + rnd.gumbel_of_bits(rnd.from_words(x0 ^ x1))
        margin = torch.where(sel, gumbel_margin(z), margin)
    return margin


def replay_burst(eng, carry0, exp0, pol, live, regs, what,
                 compare=compare_state):
    """K14 with the rings on against the plain version on the card: the
    actions the kernel recorded replayed through the plain `_lane_step`
    from a copy of the pre-burst carry. Every step the plain table
    (`_actions_plain`) picks the recorded action wherever its margin
    exceeds NET_MARGIN, and the recorded observation, reward, done,
    episode rewards and policy are the plain ones; then the carry, the
    cursors and counters and the first-done registers (the carry by
    `compare`: `compare_dag_state` for a DAG env). Returns (largest float
    error, draws below the margin, smallest net margin)."""
    from cpr_tpu_torch.envs.base import _lane_where, map_state
    from cpr_tpu_torch.serve.engine import CAPTURE_FIELDS
    ring = eng._exp
    C = ring["action"].shape[1]
    n, dev = pol.shape[0], pol.device
    lanes = torch.arange(n, device=dev)
    state, o = clone_carry(carry0)
    got = torch.zeros(n, dtype=torch.bool, device=dev)
    idx = torch.zeros(n, dtype=torch.int32, device=dev)
    caps = {k: torch.zeros(n, device=dev) for k in CAPTURE_FIELDS}
    err, below, low = 0.0, 0, float("inf")
    for i in range(eng.burst):
        slot = ((exp0["cursor"].long() + i) % C)
        t = exp0["t"] + i
        d = float((ring["obs"][lanes, slot][live] - o[live]).abs().max())
        check(d <= 1e-6, f"{what}: recorded obs beyond 1e-6 at step {i}")
        err = max(err, d)
        act = ring["action"][lanes, slot]
        choice = eng._actions_plain(state, o, pol, live,
                                    {"key": exp0["key"], "t": t})
        m = net_margins(eng, o, pol, live, exp0["key"], t)
        sure = live & (m > NET_MARGIN)
        check(torch.equal(act[sure], choice[sure]),
              f"{what}: actions differ at step {i}")
        below += int((live & ~sure).sum())
        if bool(torch.isfinite(m).any()):
            low = min(low, float(m[torch.isfinite(m)].min()))
        new, o2, _, reward, done, info = eng.env._lane_step(state, act,
                                                            eng.params)
        done = done & live
        for f, v in (("reward", reward), ("done", done),
                     ("era", info["episode_reward_attacker"]),
                     ("erd", info["episode_reward_defender"]),
                     ("policy", pol)):
            check(torch.equal(ring[f][lanes, slot][live], v[live].to(
                ring[f].dtype)), f"{what}: recorded {f} differs at {i}")
        state = map_state(lambda a, b: _lane_where(live, a, b), new, state)
        o = _lane_where(live, o2, o)
        newly = done & ~got
        idx = torch.where(newly, torch.full_like(idx, i), idx)
        caps = {k: torch.where(newly, info[k], v) for k, v in caps.items()}
        got = got | done
    err = max(err, compare(eng._carry[0], state, f"{what} carry"))
    check(float((eng._carry[1] - o).abs().max()) <= 1e-6,
          f"{what}: final obs differs")
    live_i = live.to(torch.int32)
    check(torch.equal(ring["t"], exp0["t"] + eng.burst * live_i)
          and torch.equal(ring["cursor"],
                          exp0["cursor"] + eng.burst * live_i),
          f"{what}: cursors or counters differ")
    check(np.array_equal(regs["done"], got.cpu().numpy())
          and np.array_equal(regs["done_step"], idx.cpu().numpy()),
          f"{what}: first-done registers differ")
    for k in CAPTURE_FIELDS:
        check(np.array_equal(regs[k], caps[k].cpu().numpy()),
              f"{what}: register {k} differs")
    return err, below, low


def plain_splice(eng, carry, exp, lane_seeds):
    """The engine's admission on the plain path, over copies: the fresh
    states of `init_lanes` (the stream prologue's plain version) spliced
    over the given lanes by `step_lanes_plain`, then the rings' re-key
    (`exp`, or None). Returns the admitted lanes' observations."""
    from cpr_tpu_torch.serve.engine import _lane_keys
    n, dev = carry[1].shape[0], carry[1].device
    seeds, mask = np.zeros(n, np.uint32), np.zeros(n, bool)
    for ln, sd in lane_seeds.items():
        seeds[ln], mask[ln] = sd, True
    fresh = eng.env._stream_init(_lane_keys(seeds, dev), eng.params)
    zero_m = torch.zeros(n, dtype=torch.bool, device=dev)
    _, (obs, _, _, _) = eng.env.step_lanes_plain(
        carry, torch.zeros(n, dtype=torch.int32, device=dev),
        torch.from_numpy(mask).to(dev), fresh, zero_m, eng.params)
    if exp is not None:
        kept = eng._exp
        eng._exp = exp
        eng._rekey(lane_seeds)
        eng._exp = kept
    return obs.cpu().numpy()


def hold_admission(eng, lane_policy, seed, what, compare=compare_state):
    """K14's admission and the card's splice against the plain path:
    from copies of the engine's carry (and rings), a numpy-seeded eighth
    of the lanes admitted with a burst over a seeded seven eighths (so
    some admitted lanes run and some are held), held to `plain_splice`
    then the plain burst; then a splice on the card held to
    `plain_splice`; the carry by `compare` (`compare_dag_state` for a DAG
    env: every plane, stale rows included). Returns (largest float error,
    admitted lanes run, admitted lanes held, episodes the burst ended)."""
    L, dev = eng.n_lanes, eng._carry[1].device
    rng = np.random.default_rng(seed)
    lanes = rng.choice(L, L // 8, replace=False)
    admit = dict(zip(lanes.tolist(),
                     rng.integers(1, 1 << 31, len(lanes)).tolist()))
    live_np = rng.random(L) < 7 / 8
    burst_policy = {ln: p for ln, p in lane_policy.items() if live_np[ln]}
    pol = torch.tensor([lane_policy[ln] for ln in range(L)],
                       dtype=torch.int32, device=dev)
    live = torch.from_numpy(live_np).to(dev)
    carry0 = clone_carry(eng._carry)
    exp0 = None if eng._exp is None else exp_clone(eng._exp)
    regs = eng.burst_run(burst_policy, admit=admit)
    carry_p = clone_carry(carry0)
    exp_p = None if exp0 is None else exp_clone(exp0)
    plain_splice(eng, carry_p, exp_p, admit)
    if exp0 is not None:
        err = replay_burst(eng, carry_p, exp_p, pol, live, regs, what,
                           compare)[0]
    else:
        regs_p = eng._burst_plain(carry_p, None, pol, live)
        for k, v in regs_p.items():
            check(np.array_equal(regs[k], v.cpu().numpy()),
                  f"{what}: register {k} differs")
        err = compare(eng._carry[0], carry_p[0], f"{what} carry")
        d = float((eng._carry[1] - carry_p[1]).abs().max())
        check(d <= 1e-6, f"{what}: obs differs")
        err = max(err, d)
    # the card's splice (K2's prologue, then K3) over other lanes
    more = dict(zip(rng.choice(L, L // 8, replace=False).tolist(),
                    rng.integers(1, 1 << 31, L // 8).tolist()))
    carry_p = clone_carry(eng._carry)
    exp_p = None if eng._exp is None else exp_clone(eng._exp)
    got = eng.splice(more)
    want = plain_splice(eng, carry_p, exp_p, more)
    d = max(float(np.abs(got[ln] - want[ln]).max()) for ln in more)
    check(d <= 1e-6, f"{what}: splice obs differs")
    err = max(err, d, compare(eng._carry[0], carry_p[0],
                              f"{what} splice carry"))
    check(float((eng._carry[1] - carry_p[1]).abs().max()) <= 1e-6,
          f"{what}: splice carry obs differs")
    if exp_p is not None:
        for k in exp_p:
            check(torch.equal(eng._exp[k], exp_p[k]),
                  f"{what}: splice rings' {k} differs")
    run = sum(bool(live_np[ln]) for ln in admit)
    check(0 < run < len(admit), f"{what}: {run} of {len(admit)} admitted "
          "lanes run")
    return err, run, len(admit) - run, int(regs["done"].sum())


def phase_serve_full(dev, report):
    """Phase 51: the serve engine at the main path's width, SM1 on every
    lane, rings off then on; each run its own launch counts."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.serve.engine import ResidentEngine
    env, params = serve_env(MAIN_MAX_STEPS)
    L, B = MAIN_LANES, SERVE_BURST
    counts, out = [], {}
    for cap in (0, SERVE_BURST):
        kernels.reset_launches()
        eng = ResidentEngine(env, params, n_lanes=L, burst=B,
                             experience=cap)
        eng.start()
        eng.splice({ln: ln for ln in range(L)})
        sm1 = eng.policy_ids["sapirshtein-2016-sm1"]
        lane_policy = dict.fromkeys(range(L), sm1)
        atk = dfn = 0.0
        secs, done = [], 0
        for b in range(SERVE_BURSTS):
            if b == SERVE_COMPARE_BURST:  # the burst the episodes end in:
                # a copy of its carry to hold the kernel against
                carry0 = clone_carry(eng._carry)
                exp0 = None if eng._exp is None else exp_clone(eng._exp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            regs = eng.burst_run(lane_policy)
            secs.append(time.perf_counter() - t0)
            m = regs["done"]
            atk += float(regs["episode_reward_attacker"][m].sum())
            dfn += float(regs["episode_reward_defender"][m].sum())
            done += int(m.sum())
        counts.append(dict(kernels.launches))
        path_launches(counts[-1], ("K2", "K3", "K14")
                      + (("K1", "K15") if cap else ()),
                      f"serve (rings {cap})")
        rel = atk / (atk + dfn)
        check(done >= L, f"serve: {done} episodes in {SERVE_BURSTS} "
              f"bursts of {L} lanes")
        check(SM1_GUARD[0] < rel < SM1_GUARD[1],
              f"serve SM1 relative revenue {rel} outside {SM1_GUARD}")
        ms = 1e3 * float(np.median(secs[1:]))
        out[cap] = ms
        say("serve", lanes=L, burst=B, rings=cap, rel_revenue=rel,
            episodes=done, burst_ms=ms,
            env_steps_per_s=L * B / (ms / 1e3),
            launches=json.dumps(counts[-1]))
        # that burst again from the copies, outside the counted path:
        # the kernel against the plain twin
        pol = torch.full((L,), sm1, dtype=torch.int32, device=dev)
        live = torch.ones(L, dtype=torch.bool, device=dev)
        eng._carry = clone_carry(carry0)
        if cap:
            eng._exp = exp_clone(exp0)
        regs = eng.burst_run(lane_policy)
        check(int(regs["done"].sum()) == L,
              "the compared burst ends every lane's episode")
        if cap:
            err, below, _ = replay_burst(eng, carry0, exp0, pol, live, regs,
                                         "K14 full width, rings on")
            check(below == 0, "K14 full width: scripted lanes tied")
            report["K14"]["max_abs_err"] = max(
                report["K14"].get("max_abs_err", 0.0), err)
            carry_p, exp_p = clone_carry(carry0), exp_clone(exp0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._burst_plain(carry_p, exp_p, pol, live)
            torch.cuda.synchronize()
            report["K14"]["plain_ms"] = (time.perf_counter() - t0) * 1e3
            say("serve_vs_plain", lanes=L, burst=B, rings=cap,
                max_abs_err=err, plain_ms=report["K14"]["plain_ms"],
                ok=True)
        else:
            carry_p = clone_carry(carry0)
            regs_p = eng._burst_plain(carry_p, None, pol, live)
            for k, v in regs_p.items():
                check(np.array_equal(regs[k], v.cpu().numpy()),
                      f"K14 full width rings off: register {k} differs")
            compare_state(eng._carry[0], carry_p[0], "K14 rings off carry")
            check(float((eng._carry[1] - carry_p[1]).abs().max()) <= 1e-6,
                  "K14 rings off: obs differs")
        err, run, held, _ = hold_admission(eng, lane_policy, 510 + cap,
                                           f"K14 admission, rings {cap}")
        report["K14"]["max_abs_err"] = max(
            report["K14"].get("max_abs_err", 0.0), err)
        say("serve_admission", lanes=L, rings=cap, admitted_run=run,
            admitted_held=held, max_abs_err=err, ok=True)
    # the K2 stream over the same lanes and steps, for the ratio
    fn = env.make_episode_stats_fn(params, "sapirshtein-2016-sm1",
                                   B * SERVE_BURSTS)
    keys = rnd.split(rnd.PRNGKey(0, dev), L)
    fn(keys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(keys)
    torch.cuda.synchronize()
    stream_ms = (time.perf_counter() - t0) * 1e3 / SERVE_BURSTS
    say("serve_ratio", stream_ms_per_256_steps=stream_ms,
        serve_over_stream=stream_ms / out[0],
        serve_rings_over_stream=stream_ms / out[SERVE_BURST])
    return counts


def mixed_engine(dev, nets):
    from cpr_tpu_torch.serve.engine import ResidentEngine
    from cpr_tpu_torch.train.ppo import NetPolicy
    env, params = serve_env(MIX_MAX_STEPS)
    loaded, ppo = nets
    eng = ResidentEngine(env, params, n_lanes=MIX_LANES, burst=MIX_BURST,
                         extra_policies={"loaded": NetPolicy(loaded)},
                         swap_policies={"ppo": (ppo, ppo.flat.detach()
                                                .clone(), "fp0")},
                         sample_policies=("ppo",), experience=MIX_BURST)
    eng.start()
    eng.splice({ln: 5000 + ln for ln in range(MIX_LANES)})
    return eng


def phase_serve_mixed(dev, report, tmp):
    """Phase 52: the seven-entry table at 4096 lanes, K14 held to the
    plain version; a mid-run swap; drain -> Learner.ingest."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.learn.learner import Learner
    from cpr_tpu_torch.train.ppo import PPOConfig
    nets = (make_net(4, 4, 64, 71, dev), make_net(4, 4, 64, 72, dev))
    kernels.reset_launches()
    eng = mixed_engine(dev, nets)
    names = eng.policy_names
    check(len(names) == 7, f"table {names}")
    lane_policy = {ln: ln % len(names) for ln in range(MIX_LANES)}
    pol = torch.tensor([lane_policy[ln] for ln in range(MIX_LANES)],
                       dtype=torch.int32, device=dev)
    live = torch.ones(MIX_LANES, dtype=torch.bool, device=dev)
    err, below, low, episodes = 0.0, 0, float("inf"), 0
    for b in range(2):
        carry0, exp0 = clone_carry(eng._carry), exp_clone(eng._exp)
        regs = eng.burst_run(lane_policy)
        e, n_below, m = replay_burst(eng, carry0, exp0, pol, live, regs,
                                     f"K14 mixed burst {b}")
        err, below, low = max(err, e), below + n_below, min(low, m)
        episodes += int(regs["done"].sum())
        if b == 0:
            batch = eng.drain_experience()
    check(err <= 1e-5, f"K14 mixed: error {err}")
    report["K14"]["max_abs_err"] = max(report["K14"].get("max_abs_err",
                                                         0.0), err)
    cfg = PPOConfig(n_envs=MIX_LANES, n_steps=MIX_BURST, hidden=(64, 64))
    lr = Learner(eng.env, cfg, protocol="nakamoto", publish_dir=tmp)
    reply = lr.ingest(batch)
    metrics = lr.last_metrics
    check(reply["updated"] >= 1 and metrics
          and all(np.isfinite(v) for v in metrics.values()),
          f"learner update: {reply} {metrics}")
    counts = dict(kernels.launches)
    path_launches(counts, ("K1", "K2", "K3", "K14", "K15", "K11-act",
                           "K11-gae", "K11-loss", "K11-adam"), "serve mixed")
    say("serve_mixed", lanes=MIX_LANES, burst=MIX_BURST, table=len(names),
        episodes=episodes, max_abs_err=err, draws_below_margin=below,
        smallest_margin=low, windows=int(len(batch["lanes"])),
        updates=lr.updates, pg_loss=metrics.get("pg_loss"),
        launches=json.dumps(counts))

    # a mid-run swap: the scripted lanes stay bit for bit those of an
    # unswapped engine (outside the counted path)
    a, bb = mixed_engine(dev, nets), mixed_engine(dev, nets)
    ids = {ln: ln % 4 if ln % 2 else 4 + ln % 3 for ln in range(MIX_LANES)}
    a.burst_run(ids), bb.burst_run(ids)
    swapped = bb.swap_policy("ppo", make_net(4, 4, 64, 73, dev),
                             fingerprint="fp1")
    check(swapped["swapped"], "swap refused")
    ra, rb = a.burst_run(ids), bb.burst_run(ids)
    scripted = np.array([ln % 2 == 1 for ln in range(MIX_LANES)])
    for k in ra:
        check(np.array_equal(ra[k][scripted], rb[k][scripted]),
              f"swap perturbed scripted lanes' {k}")
    sl = torch.from_numpy(scripted).to(dev)
    for f in ("a", "h", "steps", "key", "time"):
        check(torch.equal(getattr(a._carry[0], f)[sl],
                          getattr(bb._carry[0], f)[sl]),
              f"swap perturbed scripted lanes' {f}")
    say("serve_swap", lanes=MIX_LANES, scripted_lanes=int(scripted.sum()),
        identical=True)
    return counts


def phase_exp_check(dev, report):
    """Phase 53: K15's check kernel against its plain version at 131072
    lanes and C = 256, live masks from a numpy seed; then the device
    times of K14 and K15, their plain times and bounds."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.learn import buffer
    from cpr_tpu_torch.serve.engine import ResidentEngine
    L, C = MAIN_LANES, SERVE_BURST
    exp = buffer.init_buffer(rnd.split(rnd.PRNGKey(9, dev), L), C, 4)
    rng = np.random.default_rng(15)

    def step_inputs():
        g = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return (g(rng.random(L) < 0.8),
                g(rng.random((L, 4), dtype=np.float32)),
                g(rng.integers(0, 4, L).astype(np.int32)),
                g(rng.random(L, dtype=np.float32)),
                g(rng.random(L) < 0.05),
                g(rng.random(L, dtype=np.float32)),
                g(rng.random(L, dtype=np.float32)),
                g(rng.integers(0, 7, L).astype(np.int32)))

    plain = exp_clone(exp)
    for s in range(C + 3):  # the rings wrap
        live, o, a, r, d, era, erd, pid = step_inputs()
        kernels.exp_record(exp, live, o, a, r, d, era, erd, pid)
        buffer.record_plain(plain, live, o, a, r, d, era, erd, pid)
    for k in exp:
        check(torch.equal(exp[k], plain[k]), f"K15 vs plain: {k} differs")
    check(torch.equal(buffer.step_keys(exp),
                      buffer.step_keys_plain(exp["key"], exp["t"])),
          "K15 step keys differ")
    report["K15"]["max_abs_err"] = 0.0
    live, o, a, r, d, era, erd, pid = step_inputs()
    k15 = report["K15"]
    k15["ms"] = device_ms(lambda: kernels.exp_record(
        exp, live, o, a, r, d, era, erd, pid), 50, "record_kernel")
    k15["plain_ms"] = cuda_ms(lambda: buffer.record_plain(
        plain, live, o, a, r, d, era, erd, pid), 10)
    n_live = int(live.sum())
    # inputs read once (live, obs, action, reward, done, era, erd,
    # policy; cursor, t), a live lane's row slots and counters written
    k15_bytes = L * (1 + 16 + 4 + 4 + 1 + 4 + 4 + 4 + 8) + n_live * (37 + 8)
    k15["bound_ms"], k15["bound_by"] = bound_ms(k15_bytes, 0)

    env, params = serve_env(MAIN_MAX_STEPS)
    out = {}
    for cap in (0, C):
        eng = ResidentEngine(env, params, n_lanes=L, burst=C,
                             experience=cap)
        eng.start()
        eng.splice({ln: ln for ln in range(L)})
        sm1 = eng.policy_ids["sapirshtein-2016-sm1"]
        lanes, pids = np.arange(L), np.full(L, sm1, np.int32)
        ended, calls = [0], [0]

        def burst():
            calls[0] += 1
            ended[0] += int(eng._burst_staged(lanes, pids, {sm1})["done"]
                            .sum())

        out[cap] = device_ms(burst, 9, "burst_kernel")
        if cap:  # episodes end at most once a lane a burst here
            resets = ended[0] / calls[0]
    k14 = report["K14"]
    k14["ms"] = out[C]
    # per lane: the state and obs read and written, policy, live and the
    # six params read, the registers written; a lane-step's ring row
    # (37 bytes); the threefry work of every step and reset
    k14_bytes = L * (2 * (STATE_BYTES + OBS_BYTES) + 4 + 1 + 6 * 4
                     + 1 + 4 + 16 + 3 * 8) + L * C * 37
    k14_ops = THREEFRY_OPS * MINE_THREEFRY * (L * C + resets)
    k14["bound_ms"], k14["bound_by"] = bound_ms(k14_bytes, k14_ops)
    say("serve_times", K14=json.dumps({f: k14[f] for f in (
        "ms", "plain_ms", "bound_ms", "bound_by")}), K14_rings_off_ms=out[0],
        K15=json.dumps({f: k15[f] for f in ("ms", "plain_ms", "bound_ms",
                                            "bound_by")}),
        resets=resets)


CHILD_MAIN = """
import atexit, json, runpy, sys
from cpr_tpu_torch import kernels
atexit.register(lambda: print("LAUNCHES " + json.dumps(kernels.launches),
                              flush=True))
mod = sys.argv[1]
sys.argv = [mod] + sys.argv[2:]
runpy.run_module(mod, run_name="__main__", alter_sys=True)
"""


def spawn_child(module, args, tmp, name):
    """`python -m module args` as a child whose launch counts print at
    its exit; its output in tmp/name.out, its telemetry in
    tmp/name.jsonl. Returns the Popen."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "CPR_TELEMETRY": str(Path(tmp) / f"{name}.jsonl")}
    out = open(Path(tmp) / f"{name}.out", "w")
    proc = subprocess.Popen([sys.executable, "-c", CHILD_MAIN, module,
                             *map(str, args)], cwd=ROOT, env=env,
                            stdout=out, stderr=subprocess.STDOUT)
    out.close()
    return proc


def wait_ready(path, proc, what):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < CHILD_READY_S:
        if Path(path).exists():
            return json.loads(Path(path).read_text())
        check(proc.poll() is None, f"{what} exited early ({proc.poll()})")
        time.sleep(0.1)
    raise AssertionError(f"{what} not ready in {CHILD_READY_S} s")


def stop_child(proc, tmp, name, required, allowed=()):
    """SIGTERM, exit 0 within the limit; the child's launch counts hold
    `required` (each launched) and nothing outside `required + allowed`."""
    import signal
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=CHILD_STOP_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"{name} did not exit on SIGTERM") from None
    text = (Path(tmp) / f"{name}.out").read_text()
    check(rc == 0, f"{name} exited {rc}: {text[-3000:]}")
    line = [x for x in text.splitlines() if x.startswith("LAUNCHES ")]
    check(line, f"{name} printed no launch counts")
    counts = json.loads(line[-1][len("LAUNCHES "):])
    for k, n in counts.items():
        if k in required:
            check(n > 0, f"{k} never launched in {name}")
        elif k not in allowed:
            check(n == 0, f"{k} launched {n} times in {name}")
    return counts


def serve_events(tmp, name, action):
    path = Path(tmp) / f"{name}.jsonl"
    out = []
    for line in path.read_text().splitlines():
        e = json.loads(line)
        if e.get("name") == "serve" and e.get("action") == action:
            out.append(e)
    return out


def phase_wire(dev, report, tmp):
    """Phase 54: `python -m cpr_tpu_torch.serve.server` as a child at its
    defaults with a policy snapshot; 32 concurrent clients; SIGTERM."""
    from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
    from cpr_tpu_torch.serve.protocol import ServeClient
    from cpr_tpu_torch.train.driver import export_policy_snapshot
    honest = NakamotoSSZ().policies["honest"]

    def honest_action(obs):
        return int(honest(torch.tensor([obs], dtype=torch.float32))[0])

    snap = str(Path(tmp) / "wire-ppo.msgpack")
    export_policy_snapshot(snap, make_net(4, 4, 64, 81, dev),
                           protocol="nakamoto", n_actions=4,
                           observation_length=4, hidden=[64, 64])
    ready = str(Path(tmp) / "wire-ready.json")
    proc = spawn_child("cpr_tpu_torch.serve.server",
                       ["--protocol", "nakamoto", "--policy-snapshot", snap,
                        "--ready-file", ready, "--heartbeat-s", 0.5], tmp,
                       "wire")
    try:
        port = wait_ready(ready, proc, "server")["port"]

        def client(i):
            with ServeClient("127.0.0.1", port, timeout=CHILD_STOP_S) as c:
                if i == 0:
                    r = c.request("netsim.query", seed=1)
                    check(r["ok"] and sum(r["activations"]) == 1000,
                          f"netsim.query: {r}")
                    # path (d): past 32 nodes (K12-scan at 2 node slots)
                    r = c.request("netsim.query", seed=1,
                                  n_nodes=WIDE_QUERY_NODES)
                    check(r["ok"] and sum(r["activations"]) == 1000
                          and len(r["activations"]) == WIDE_QUERY_NODES,
                          f"netsim.query at {WIDE_QUERY_NODES} nodes: {r}")
                    return "netsim"
                if i % 3 == 1:  # interactive to the episode's end
                    o = c.request("episode.open", seed=i)
                    check(o["ok"], f"episode.open: {o}")
                    obs = o["obs"]
                    for _ in range(WIRE_MAX_STEPS + 1):
                        s = c.request("episode.step", session=o["session"],
                                      action=honest_action(obs))
                        check(s["ok"], f"episode.step: {s}")
                        if s["done"]:
                            return "interactive"
                        obs = s["obs"]
                    raise AssertionError("interactive episode never ended")
                policy = ("ppo" if i % 3 == 2
                          else POLICIES[i % len(POLICIES)])
                r = c.request("episode.run", policy=policy, seed=i)
                check(r["ok"] and r["episode"]["n_steps"] > 0,
                      f"episode.run {policy}: {r}")
                return "ppo" if policy == "ppo" else "scripted"

        t0 = time.perf_counter()
        with ThreadPoolExecutor(WIRE_CLIENTS) as pool:
            kinds = list(pool.map(client, range(WIRE_CLIENTS)))
        wall = time.perf_counter() - t0
        flood = wire_flood(port)
    finally:
        counts = stop_child(proc, tmp, "wire",
                            ("K2", "K3", "K14", "K11-act", "K12-scan",
                             "K12-scan-n256"), ("K1",))
    base_sps = rollout_baseline(dev)
    serve_sps = flood["steps_per_busy_s"]
    frac = serve_sps / base_sps
    # printed beside the reference's floor, not held: the port's serve
    # path measured 0.67-1.27 of the rollout on an H100 (ROADMAP §3.4)
    say("wire_flood", episodes=FLOOD_EPISODES, clients=FLOOD_CLIENTS,
        rollout_steps_per_s=base_sps, serve_rollout_frac=frac,
        reference_floor=SERVE_MIN_FRAC,
        meets_floor=frac >= SERVE_MIN_FRAC, **flood)
    reports = serve_events(tmp, "wire", "report")
    check(len(reports) == 1, "no drain report")
    rep = reports[0]["detail"]
    check(0 < rep["p50_s"] <= rep["p99_s"] < wall,
          f"drain report p50 {rep['p50_s']} p99 {rep['p99_s']} wall {wall}")
    say("wire", clients=WIRE_CLIENTS,
        kinds=json.dumps({k: kinds.count(k) for k in set(kinds)}),
        wall_s=wall, p50_s=rep["p50_s"], p99_s=rep["p99_s"],
        steps=rep["steps"], episodes=rep["episodes"],
        serve_rollout_frac=frac, launches=json.dumps(counts))
    return counts


FLOOD_MAIN = """
import asyncio, os, sys
os.nice(19)  # load generators yield the host's cores to the server
from cpr_tpu_torch.serve.protocol import pack_frame, read_frame
port, first, per, n, timeout = map(int, sys.argv[1:6])
bad = []
async def main():
    conns = [await asyncio.open_connection("127.0.0.1", port)
             for _ in range(n)]
    print("READY", flush=True)  # imported and connected: wait for go
    await asyncio.get_running_loop().run_in_executor(None,
                                                     sys.stdin.readline)
    async def worker(w):
        reader, writer = conns[w]
        for sd in range(first + w * per, first + (w + 1) * per):
            writer.write(pack_frame(dict(op="episode.run", policy="honest",
                                         seed=sd)))
            r = await asyncio.wait_for(read_frame(reader), timeout)
            if not (r or {}).get("ok"):
                bad.append((sd, r))
        writer.close()
    await asyncio.gather(*(worker(w) for w in range(n)))
asyncio.run(main())
print("FLOOD", "OK" if not bad else bad[:3], flush=True)
sys.exit(1 if bad else 0)
"""


def wire_flood(port):
    """tools/serve_smoke.py's flood: FLOOD_CLIENTS persistent connections
    (FLOOD_PROCS asyncio processes) each running its share of
    FLOOD_EPISODES seeded honest episodes, so every burst backfills from
    a non-empty queue; the sustained device throughput is the server's
    stats delta, steps over busy dispatch seconds. Returns it with the
    flood's bursts, admissions and mean occupancy (the stats deltas)."""
    import os
    from cpr_tpu_torch.serve.protocol import ServeClient

    def stats():
        with ServeClient("127.0.0.1", port, timeout=CHILD_STOP_S) as c:
            r = c.request("stats")
            check(r.get("ok"), f"stats: {r}")
            return dict(r["report"], latencies={
                k: v for k, v in r["latencies"].items()
                if k.startswith("device.")})

    per = FLOOD_EPISODES // FLOOD_CLIENTS
    threads = FLOOD_CLIENTS // FLOOD_PROCS
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", FLOOD_MAIN, str(port),
         str(1000 + i * threads * per), str(per), str(threads),
         str(int(CHILD_STOP_S))], cwd=ROOT, env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(FLOOD_PROCS)]
    for p in procs:  # every client imported and connected before the window
        line = p.stdout.readline()
        check(line.strip() == "READY", f"flood client not ready: {line}")
    before = stats()
    for p in procs:
        p.stdin.write("go\n")
        p.stdin.flush()
    for p in procs:
        out, _ = p.communicate(timeout=CHILD_STOP_S * 4)
        check(p.returncode == 0, f"flood client failed: {out[-2000:]}")
    after = stats()
    d = {k: after[k] - before[k] for k in ("steps", "busy_s", "bursts",
                                            "admitted")}
    check(d["steps"] > 0 and d["busy_s"] > 0,
          f"flood measured nothing ({d['steps']} steps, {d['busy_s']} s)")
    occ = (after["occupancy"] * after["bursts"]
           - before["occupancy"] * before["bursts"]) / max(d["bursts"], 1)
    return dict(steps_per_busy_s=d["steps"] / d["busy_s"], occupancy=occ,
                device_latencies=json.dumps(after["latencies"]), **d)


def rollout_baseline(dev):
    """tools/serve_smoke.py's baseline: a batch `rollout()` at the
    server's defaults (its lanes, max_steps and alpha; honest), the best
    of three timed calls, in env-steps/s."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.params import make_params
    env = registry.get_sized("nakamoto", WIRE_MAX_STEPS)
    params = make_params(alpha=0.25, gamma=0.5, max_steps=WIRE_MAX_STEPS)
    policy = env.policies["honest"]
    keys = rnd.split(rnd.PRNGKey(0, dev), WIRE_LANES)
    env.rollout(keys, params, policy, WIRE_MAX_STEPS)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        env.rollout(keys, params, policy, WIRE_MAX_STEPS)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return WIRE_LANES * WIRE_MAX_STEPS / best


def phase_learn_loop(dev, report, tmp):
    """Phase 55: learner child + server child with --learner and
    --learn-watch at tools/learn_smoke.py's shape; flood until the
    fingerprint in the replies has rotated through LEARN_MIN_SWAPS
    published swaps and the LEARN_TAIL newest greedy episodes, all after
    a swap, beat the untrained baseline by LEARN_MIN_GAIN (the
    reference's floor); both children exit 0 on SIGTERM."""
    from cpr_tpu_torch.serve.protocol import ServeClient
    pub = Path(tmp) / "published"
    lready, sready = (str(Path(tmp) / "learner-ready.json"),
                      str(Path(tmp) / "learn-server-ready.json"))
    shape = ["--max-steps", LEARN_STEPS, "--protocol", "nakamoto"]
    learner = spawn_child(
        "cpr_tpu_torch.learn.learner",
        [*shape, "--publish-dir", pub, "--ready-file", lready, "--n-envs",
         LEARN_LANES, "--n-steps", LEARN_STEPS], tmp, "learner")
    server = None
    counts = {}
    try:
        lport = wait_ready(lready, learner, "learner")["port"]
        server = spawn_child(
            "cpr_tpu_torch.serve.server",
            [*shape, "--lanes", LEARN_LANES, "--burst", LEARN_STEPS,
             "--alpha", 0.45, "--policy-snapshot",
             pub / "snapshot-000000.msgpack",
             "--learner", f"127.0.0.1:{lport}", "--learn-watch", pub,
             "--heartbeat-s", 0.5, "--staleness-slo-s", 60,
             "--ready-file", sready], tmp, "learn-server")
        port = wait_ready(sready, server, "server")["port"]

        def worker(policies):
            out = []
            with ServeClient("127.0.0.1", port, timeout=CHILD_STOP_S) as c:
                for policy in policies:
                    r = c.request("episode.run", policy=policy)
                    check(r.get("ok"), f"episode.run {policy}: {r}")
                    if policy == "ppo":
                        out.append((r["policy_fingerprint"],
                                    r["episode"]["relative_reward"]))
            return out

        def wave(policies):
            with ThreadPoolExecutor(LEARN_LANES) as pool:
                jobs = [pool.submit(worker, policies)
                        for _ in range(LEARN_LANES)]
                return [x for j in jobs for x in j.result()]

        t0 = time.perf_counter()
        measured = wave(("ppo",) * LEARN_BASE_EPISODES)
        base_fp = measured[0][0]
        base = [r for fp, r in measured if fp == base_fp]
        waves = 0

        def improved():
            tail = measured[-LEARN_TAIL:]
            return (len({fp for fp, _ in measured}) >= LEARN_MIN_SWAPS + 1
                    and len(tail) >= LEARN_TAIL
                    and all(fp != base_fp for fp, _ in tail)
                    and np.mean([r for _, r in tail])
                    >= np.mean(base) + LEARN_MIN_GAIN)

        while not improved():
            check(waves < LEARN_MAX_WAVES
                  and time.perf_counter() - t0 < LEARN_WALL_S,
                  f"no {LEARN_MIN_SWAPS} swaps with a greedy gain of "
                  f"{LEARN_MIN_GAIN} over {np.mean(base)} in {waves} waves")
            measured.extend(wave(("ppo#sample", "honest", "ppo",
                                  "ppo#sample")))
            waves += 1
        fps = list(dict.fromkeys(fp for fp, _ in measured))
        tail = [r for _, r in measured[-LEARN_TAIL:]]
        wall = time.perf_counter() - t0
    finally:
        try:
            if server is not None:
                counts["server"] = stop_child(
                    server, tmp, "learn-server",
                    ("K1", "K2", "K3", "K14", "K15", "K11-act"))
        finally:
            counts["learner"] = stop_child(
                learner, tmp, "learner",
                ("K1", "K11-gae", "K11-loss", "K11-adam"))
    rep = serve_events(tmp, "learn-server", "report")[0]["detail"]
    check(rep["learn"]["swaps"] >= LEARN_MIN_SWAPS,
          f"drain report swaps {rep['learn']['swaps']}")
    say("learn_loop", lanes=LEARN_LANES, burst=LEARN_STEPS, waves=waves,
        wall_s=wall, fingerprints=len(fps), swaps=rep["learn"]["swaps"],
        samples=rep["learn"]["samples"],
        greedy_rel_before=float(np.mean(base)),
        greedy_rel_after=float(np.mean(tail)), min_gain=LEARN_MIN_GAIN,
        launches=json.dumps(counts))
    return counts


# -- phases 62-66: K14-dag, the serve burst over the DAG envs -----------------

def dagb_env(name):
    from cpr_tpu_torch.envs import registry
    key, window = DAGB_CASES[name]
    return (registry.get(key, window=window) if window
            else registry.get_sized(key, DAGB_MAX_STEPS))


def dagb_engine(dev, name):
    """A phase 62 case's started engine, every lane spliced, and its
    numpy-seeded table (every scripted policy, cycled over the lanes)."""
    from cpr_tpu_torch.params import make_params
    from cpr_tpu_torch.serve.engine import ResidentEngine
    params = make_params(alpha=0.35, gamma=0.5, max_steps=DAGB_MAX_STEPS)
    eng = ResidentEngine(dagb_env(name), params, n_lanes=DAGB_LANES,
                         burst=DAGB_BURST, device=dev)
    eng.start()
    eng.splice({ln: 6200 + ln for ln in range(DAGB_LANES)})
    rng = np.random.default_rng(620 + list(DAGB_CASES).index(name))
    lane_policy = dict(enumerate(rng.permutation(
        np.arange(DAGB_LANES) % len(eng.policy_names)).tolist()))
    return eng, lane_policy


def dag_burst_case(dev, name):
    """One phase 62 case: two bursts back to back, each from copies of
    the carry, with a seeded eighth of the lanes admitted (some live,
    some held) and a seeded eighth held (`hold_admission`: registers, obs
    and the whole carry, every plane and stale row). Returns its largest
    float error."""
    from cpr_tpu_torch import kernels
    eng, lane_policy = dagb_engine(dev, name)
    i = list(DAGB_CASES).index(name)
    err, run, held, ended = 0.0, 0, 0, 0
    for b in range(2):
        e, r, h, d = hold_admission(eng, lane_policy, 6200 + 10 * i + b,
                                    f"K14-dag {name} burst {b}",
                                    compare_dag_state)
        err, run, held, ended = max(err, e), run + r, held + h, ended + d
    check(ended > 0, f"K14-dag {name}: no episode ended")
    say("dag_burst", env=name, kernel=kernels.dag_burst_name(eng.env),
        capacity=eng.env.capacity, ring=eng.env.ring, lanes=DAGB_LANES,
        burst=DAGB_BURST, table=len(eng.policy_names), episodes=ended,
        admitted_run=run, admitted_held=held, max_abs_err=err, ok=True)
    return err


CALL_MAIN = """
import json, sys
import torch
import chip_smoke as cs
torch.set_num_threads(1)
dev = torch.device(sys.argv[1])
fn = getattr(cs, sys.argv[2])
out = [fn(dev, *json.loads(a)) for a in sys.argv[3:]]
print("RESULT " + json.dumps(out), flush=True)
"""


_CALLS = []  # every `spawn_calls` child, stopped at exit if still running


@atexit.register
def _stop_calls():
    for proc in _CALLS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def spawn_calls(dev, tmp, name, fn, calls):
    """A child process that runs `fn(dev, *args)` of this script for each
    `args` of `calls` in turn (the host-bound plain holds, a core each,
    beside the card's work), its output in tmp/name.out; its launches
    count nowhere. Returns (Popen, output path)."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    path = Path(tmp) / f"{name}.out"
    with open(path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", CALL_MAIN, str(dev), fn,
             *(json.dumps(list(a)) for a in calls)], cwd=ROOT, env=env,
            stdout=out, stderr=subprocess.STDOUT)
    _CALLS.append(proc)
    return proc, path


def collect_calls(proc, path, what):
    """Wait for a `spawn_calls` child (DAGB_CHILD_S at most), print its
    output, hold its exit 0; returns its results, one a call."""
    try:
        rc = proc.wait(timeout=DAGB_CHILD_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"{what} child over {DAGB_CHILD_S} s") from None
    text = Path(path).read_text()
    print(text, end="", flush=True)
    check(rc == 0, f"{what} child exited {rc}")
    line = [x for x in text.splitlines() if x.startswith("RESULT ")]
    check(line, f"{what} child printed no result")
    return json.loads(line[-1][len("RESULT "):])


def spawn_holds(dev, tmp):
    """The host-bound holds of phases 62 and 63, each group in a child
    process, all started together before phase 62 (`collect_dag_burst`
    and phase 63 wait for them): phase 62's cases (DAGB_GROUPS) and
    phase 63's two held bursts."""
    return dict(
        dagb=[spawn_calls(dev, tmp, f"dagb{k}", "dag_burst_case",
                          [[n] for n in group])
              for k, group in enumerate(DAGB_GROUPS)],
        mixed=[spawn_calls(dev, tmp, f"mixed{b}", "dag_mixed_hold", [[b]])
               for b in range(2)])


def collect_dag_burst(procs, report):
    """Phase 62's children: every case passed; their errors go into the
    K14-dag row."""
    errs = {}
    for (proc, path), group in zip(procs, DAGB_GROUPS):
        errs.update(zip(group, collect_calls(proc, path, "phase 62")))
    check(sorted(errs) == sorted(DAGB_CASES), f"phase 62 cases {errs}")
    row = report["K14-dag"]
    row["max_abs_err"] = max(row["max_abs_err"], *errs.values())


def phase_dag_burst_fixture(dev, dbfx, report):
    """K14-dag against cpr_tpu's engine: the committed fixture's
    three-burst schedules (every family in full mode, Tailstorm in the
    ring; admissions live and held) replayed through the card's engine,
    every burst's registers and the final carry held to JAX's."""
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.params import make_params
    from cpr_tpu_torch.serve.engine import BURST_FIELDS, ResidentEngine
    row = report["K14-dag"]
    cases = sorted(k[:-len("_window")] for k in dbfx
                   if k.endswith("_window"))
    check(sorted(cases) == sorted(DAGB_FX_CASES), f"fixture cases {cases}")
    for case in cases:
        key, window = str(dbfx[f"{case}_key"]), int(dbfx[f"{case}_window"])
        env = (registry.get(key, window=window) if window
               else registry.get_sized(key, DAGB_FX_MAX_STEPS))
        params = make_params(alpha=DAGB_FX_ALPHA, gamma=0.5,
                             max_steps=DAGB_FX_MAX_STEPS)
        eng = ResidentEngine(env, params, n_lanes=DAGB_FX_LANES,
                             burst=DAGB_FX_BURST)
        eng.start()
        b, ended = 0, 0
        while f"{case}_b{b}_policy" in dbfx:
            pol, mask = dbfx[f"{case}_b{b}_policy"], dbfx[f"{case}_b{b}_admit"]
            seeds = dbfx[f"{case}_b{b}_seeds"]
            regs = eng.burst_run(
                {int(ln): int(pol[ln]) for ln in np.nonzero(pol >= 0)[0]},
                admit={int(ln): int(seeds[ln])
                       for ln in np.nonzero(mask)[0]})
            for k in BURST_FIELDS:
                check(np.array_equal(regs[k], dbfx[f"{case}_b{b}_{k}"]),
                      f"K14-dag {case} vs jax: burst {b} register {k}")
            ended += int(regs["done"].sum())
            b += 1
        err = compare_dag_state(eng._carry[0], fixture_dag_state(
            dbfx, f"{case}_final_", env, dev), f"K14-dag {case} vs jax")
        d = float((eng._carry[1] - torch.from_numpy(
            dbfx[f"{case}_final_obs_carry"]).to(dev)).abs().max())
        check(d <= 1e-6, f"K14-dag {case} vs jax: obs")
        row["max_abs_err"] = max(row["max_abs_err"], err, d)
        say("dag_burst_fixture", case=case, key=key, window=window,
            bursts=b, episodes=ended, max_abs_err=max(err, d), ok=True)


def dag_serve_env(max_steps):
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.params import make_params
    return (registry.get_sized(DAG_SERVE_KEY, max_steps),
            make_params(alpha=0.35, gamma=0.5, max_steps=max_steps))


def dag_mixed_engine(dev, nets):
    from cpr_tpu_torch.serve.engine import ResidentEngine
    from cpr_tpu_torch.train.ppo import NetPolicy
    env, params = dag_serve_env(DAG_SERVE_MAX_STEPS)
    loaded, ppo = nets
    eng = ResidentEngine(env, params, n_lanes=DAG_SERVE_LANES,
                         burst=DAG_SERVE_BURST,
                         extra_policies={"loaded": NetPolicy(loaded)},
                         swap_policies={"ppo": (ppo, ppo.flat.detach()
                                                .clone(), "fp0")},
                         sample_policies=("ppo",),
                         experience=DAG_SERVE_BURST)
    eng.start()
    eng.splice({ln: 6300 + ln for ln in range(DAG_SERVE_LANES)})
    return eng


def dag_mixed_nets(dev):
    env, _ = dag_serve_env(DAG_SERVE_MAX_STEPS)
    F, A = env.observation_length, env.n_actions
    return make_net(F, A, 64, 631, dev), make_net(F, A, 64, 632, dev)


def dag_mixed_policy(eng):
    """Phase 63's table over the lanes: lane ln runs entry ln mod size."""
    L, n = eng.n_lanes, len(eng.policy_names)
    lane_policy = {ln: ln % n for ln in range(L)}
    pol = torch.tensor([lane_policy[ln] for ln in range(L)],
                       dtype=torch.int32, device=eng._carry[1].device)
    return lane_policy, pol


def burst_digest(eng, regs):
    """A digest of a burst's registers and the engine's carry and rings
    after it: a child that runs the same seeded engine to the same burst
    must give the same."""
    import hashlib
    from cpr_tpu_torch.envs.base import map_state
    h = hashlib.sha256()
    for k in sorted(regs):
        h.update(np.ascontiguousarray(regs[k]).tobytes())
    ts = []
    map_state(ts.append, eng._carry[0])
    ts += [eng._carry[1], *(eng._exp[k] for k in sorted(eng._exp))]
    for t in ts:
        h.update(t.detach().cpu().contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def dag_mixed_hold(dev, b):
    """Phase 63's burst `b` (0 or 1) held to the plain version, in a child
    process: the phase's seeded engine run to it (burst 0 drained, as
    the phase drains it), then `replay_burst` from copies of the carry
    and rings. Returns {"digest" (`burst_digest` after the burst), "err",
    "below", "low"}."""
    eng = dag_mixed_engine(dev, dag_mixed_nets(dev))
    lane_policy, pol = dag_mixed_policy(eng)
    live = torch.ones(eng.n_lanes, dtype=torch.bool, device=dev)
    for i in range(b + 1):
        if i == b:
            carry0, exp0 = clone_carry(eng._carry), exp_clone(eng._exp)
        regs = eng.burst_run(lane_policy)
        if i == b:
            digest = burst_digest(eng, regs)
            err, below, low = replay_burst(
                eng, carry0, exp0, pol, live, regs,
                f"K14-dag mixed burst {b}", compare_dag_state)
        if i == 0:
            eng.drain_experience()
    return {"digest": digest, "err": err, "below": below, "low": low}


def phase_dag_serve_mixed(dev, report, tmp, holds):
    """Phase 63: phase 52 on Tailstorm at the server's sizing: the table
    of its seven scripted policies, a loaded greedy net, `ppo` and
    `ppo#sample` at 4096 lanes x 256 steps with the rings, two bursts,
    the first drained into `Learner.ingest`, each held to the plain
    version (`replay_burst`, every recorded field and the whole carry)
    by a child of `spawn_holds` (`dag_mixed_hold`) whose run to it gave
    the same registers, carry and rings; a mid-run swap leaves the
    scripted lanes bit for bit those of an unswapped engine."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.envs.base import map_state
    from cpr_tpu_torch.learn.learner import Learner
    from cpr_tpu_torch.train.ppo import PPOConfig
    env, _ = dag_serve_env(DAG_SERVE_MAX_STEPS)
    F, A = env.observation_length, env.n_actions
    nets = dag_mixed_nets(dev)
    L = DAG_SERVE_LANES
    kernels.reset_launches()
    eng = dag_mixed_engine(dev, nets)
    names = eng.policy_names
    n_scripted = len(env.scripted_policies)
    check(len(names) == n_scripted + 3, f"table {names}")
    lane_policy, _ = dag_mixed_policy(eng)
    digests, episodes = [], 0
    for b in range(2):
        regs = eng.burst_run(lane_policy)
        digests.append(burst_digest(eng, regs))
        episodes += int(regs["done"].sum())
        if b == 0:
            batch = eng.drain_experience()
    cfg = PPOConfig(n_envs=L, n_steps=DAG_SERVE_BURST, hidden=(64, 64))
    lr = Learner(eng.env, cfg, protocol=DAG_SERVE_KEY, publish_dir=tmp)
    reply = lr.ingest(batch)
    metrics = lr.last_metrics
    check(reply["updated"] >= 1 and metrics
          and all(np.isfinite(v) for v in metrics.values()),
          f"learner update: {reply} {metrics}")
    name = kernels.dag_burst_name(env)
    counts = dict(kernels.launches)
    path_launches(counts, ("K1", env.kernel_name, name, "K15", "K11-act",
                           "K11-gae", "K11-loss", "K11-adam"),
                  "DAG serve mixed")
    windows, updates = int(len(batch["lanes"])), lr.updates
    del eng, lr, batch

    # a mid-run swap (outside the counted path)
    a, bb = dag_mixed_engine(dev, nets), dag_mixed_engine(dev, nets)
    ids = {ln: (ln // 2) % n_scripted if ln % 2 else n_scripted + ln % 3
           for ln in range(L)}
    a.burst_run(ids), bb.burst_run(ids)
    swapped = bb.swap_policy("ppo", make_net(F, A, 64, 633, dev),
                             fingerprint="fp1")
    check(swapped["swapped"], "swap refused")
    ra, rb = a.burst_run(ids), bb.burst_run(ids)
    scripted = np.array([ln % 2 == 1 for ln in range(L)])
    for k in ra:
        check(np.array_equal(ra[k][scripted], rb[k][scripted]),
              f"K14-dag swap perturbed scripted lanes' {k}")
    sl = torch.from_numpy(scripted).to(dev)
    compare_dag_state(map_state(lambda t: t[sl], a._carry[0]),
                      map_state(lambda t: t[sl], bb._carry[0]),
                      "K14-dag swap: scripted lanes' carry", rtol=0.0)
    say("dag_serve_swap", lanes=L, scripted_lanes=int(scripted.sum()),
        identical=True)
    del a, bb

    held = [collect_calls(proc, path, "phase 63")[0] for proc, path in holds]
    for b, h in enumerate(held):
        check(h["digest"] == digests[b], f"phase 63: the held burst {b} "
              "is not this run's (registers, carry or rings differ)")
    err = max(h["err"] for h in held)
    row = report["K14-dag"]
    row["max_abs_err"] = max(row["max_abs_err"], err)
    say("dag_serve_mixed", protocol=DAG_SERVE_KEY, capacity=env.capacity,
        lanes=L, burst=DAG_SERVE_BURST, table=len(names), episodes=episodes,
        max_abs_err=err, draws_below_margin=sum(h["below"] for h in held),
        smallest_margin=min(h["low"] for h in held), windows=windows,
        updates=updates, pg_loss=metrics.get("pg_loss"),
        launches=json.dumps(counts))
    return counts


def phase_dag_serve(dev, report):
    """Phase 64: the DAG serve path at full width: `ResidentEngine` over
    Tailstorm at the server's sizing, 4096 lanes, every lane spliced with
    its own seed, DAG_SERVE_BURSTS bursts of 256 under DAG_SERVE_POLICY,
    rings off then at capacity 256, each run its own launch counts; each
    lane's first-done registers equal the first episode of the K10
    stream (`rollout`) from its seed; the relative revenue within
    VOTE_GUARD of the stream's over the same lanes and steps, and the
    ratio of the two times."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.serve.engine import (CAPTURE_FIELDS, ResidentEngine,
                                            _lane_keys)
    env, params = dag_serve_env(DAG_SERVE_MAX_STEPS)
    L, B = DAG_SERVE_LANES, DAG_SERVE_BURST
    name = kernels.dag_burst_name(env)
    seeds = np.arange(L, dtype=np.uint32) + 6400
    counts, out, first = [], {}, None
    for cap in (0, B):
        kernels.reset_launches()
        eng = ResidentEngine(env, params, n_lanes=L, burst=B,
                             experience=cap)
        eng.start()
        eng.splice({ln: int(sd) for ln, sd in enumerate(seeds)})
        pid = eng.policy_ids[DAG_SERVE_POLICY]
        lane_policy = dict.fromkeys(range(L), pid)
        atk = dfn = 0.0
        secs, done = [], 0
        for b in range(DAG_SERVE_BURSTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            regs = eng.burst_run(lane_policy)
            secs.append(time.perf_counter() - t0)
            if b == 0 and first is None:
                first = regs
            m = regs["done"]
            atk += float(regs["episode_reward_attacker"][m].sum())
            dfn += float(regs["episode_reward_defender"][m].sum())
            done += int(m.sum())
        counts.append(dict(kernels.launches))
        path_launches(counts[-1], (env.kernel_name, name)
                      + (("K1", "K15") if cap else ()),
                      f"DAG serve (rings {cap})")
        check(done >= L, f"DAG serve: {done} episodes in "
              f"{DAG_SERVE_BURSTS} bursts of {L} lanes")
        rel = atk / (atk + dfn)
        ms = 1e3 * float(np.median(secs[1:]))
        out[cap] = (ms, rel)
        say("dag_serve", protocol=DAG_SERVE_KEY, capacity=env.capacity,
            lanes=L, burst=B, rings=cap, rel_revenue=rel, episodes=done,
            burst_ms=ms, env_steps_per_s=L * B / (ms / 1e3),
            launches=json.dumps(counts[-1]))
        del eng
    # a session admitted with seed S replays rollout(PRNGKey(S)): the
    # first burst's registers are the stream's first episode
    keys = _lane_keys(seeds, dev)
    _, _, _, done_t, info = env.rollout(keys, params, DAG_SERVE_POLICY, B)
    check(bool(done_t.any(1).all()), "a lane's first episode outlasted "
          "the first burst")
    idx = torch.argmax(done_t.to(torch.int32), 1)
    lanes = torch.arange(L, device=dev)
    check(bool(first["done"].all())
          and np.array_equal(first["done_step"], idx.cpu().numpy()),
          "DAG serve: first-done steps differ from the K10 stream's")
    for k in CAPTURE_FIELDS:
        check(np.array_equal(first[k], info[k][lanes, idx].cpu().numpy()),
              f"DAG serve: register {k} differs from the K10 stream's")
    # the K10 stream over the same lanes and steps
    fn = env.make_episode_stats_fn(params, DAG_SERVE_POLICY,
                                   B * DAG_SERVE_BURSTS)
    stats = fn(keys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = fn(keys)
    torch.cuda.synchronize()
    stream_ms = (time.perf_counter() - t0) * 1e3 / DAG_SERVE_BURSTS
    sa = float(stats["episode_reward_attacker"].mean())
    sd = float(stats["episode_reward_defender"].mean())
    stream_rel = sa / (sa + sd)
    check(abs(out[0][1] - stream_rel) < VOTE_GUARD,
          f"DAG serve relative revenue {out[0][1]} not within "
          f"{VOTE_GUARD} of the stream's {stream_rel}")
    say("dag_serve_ratio", stream_rel_revenue=stream_rel,
        stream_ms_per_256_steps=stream_ms,
        serve_over_stream=stream_ms / out[0][0],
        serve_rings_over_stream=stream_ms / out[B][0],
        first_episodes_equal_stream=L)
    return counts


def phase_dag_wire(dev, report, tmp):
    """Phase 65: `python -m cpr_tpu_torch.serve.server --protocol
    DAG_SERVE_KEY` as a child at its defaults (32 lanes, burst and
    max_steps 256) with a seeded net's policy snapshot exported under
    that protocol; DAG_WIRE_CLIENTS concurrent clients (scripted and
    `ppo` episode.run, interactive episodes stepped to their end), every
    reply ok; SIGTERM, a drain report with 0 < p50 <= p99 < wall, exit 0;
    the child's launch counts hold K14-dag."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.serve.protocol import ServeClient
    from cpr_tpu_torch.train.driver import export_policy_snapshot
    env, _ = dag_serve_env(WIRE_MAX_STEPS)
    honest = env.policies["honest"]

    def honest_action(obs):
        return int(honest(torch.tensor([obs], dtype=torch.float32))[0])

    snap = str(Path(tmp) / "dag-wire-ppo.msgpack")
    export_policy_snapshot(
        snap, make_net(env.observation_length, env.n_actions, 64, 651, dev),
        protocol=DAG_SERVE_KEY, n_actions=env.n_actions,
        observation_length=env.observation_length, hidden=[64, 64])
    ready = str(Path(tmp) / "dag-wire-ready.json")
    proc = spawn_child("cpr_tpu_torch.serve.server",
                       ["--protocol", DAG_SERVE_KEY, "--policy-snapshot",
                        snap, "--ready-file", ready, "--heartbeat-s", 0.5],
                       tmp, "dag-wire")
    try:
        port = wait_ready(ready, proc, "DAG server")["port"]

        def client(i):
            with ServeClient("127.0.0.1", port, timeout=CHILD_STOP_S) as c:
                if i % 3 == 0:  # interactive to the episode's end
                    o = c.request("episode.open", seed=i)
                    check(o["ok"], f"episode.open: {o}")
                    obs = o["obs"]
                    for _ in range(WIRE_MAX_STEPS + 1):
                        s = c.request("episode.step", session=o["session"],
                                      action=honest_action(obs))
                        check(s["ok"], f"episode.step: {s}")
                        if s["done"]:
                            return "interactive"
                        obs = s["obs"]
                    raise AssertionError("interactive episode never ended")
                policy = ("ppo" if i % 3 == 2 else env.scripted_policies[
                    i % len(env.scripted_policies)])
                r = c.request("episode.run", policy=policy, seed=i)
                check(r["ok"] and r["episode"]["n_steps"] > 0,
                      f"episode.run {policy}: {r}")
                return "ppo" if policy == "ppo" else "scripted"

        t0 = time.perf_counter()
        with ThreadPoolExecutor(DAG_WIRE_CLIENTS) as pool:
            kinds = list(pool.map(client, range(DAG_WIRE_CLIENTS)))
        wall = time.perf_counter() - t0
    finally:
        counts = stop_child(proc, tmp, "dag-wire",
                            (env.kernel_name, kernels.dag_burst_name(env),
                             "K11-act"), ("K1",))
    reports = serve_events(tmp, "dag-wire", "report")
    check(len(reports) == 1, "no drain report")
    rep = reports[0]["detail"]
    check(0 < rep["p50_s"] <= rep["p99_s"] < wall,
          f"drain report p50 {rep['p50_s']} p99 {rep['p99_s']} wall {wall}")
    say("dag_wire", protocol=DAG_SERVE_KEY, clients=DAG_WIRE_CLIENTS,
        kinds=json.dumps({k: kinds.count(k) for k in set(kinds)}),
        wall_s=wall, p50_s=rep["p50_s"], p99_s=rep["p99_s"],
        steps=rep["steps"], episodes=rep["episodes"],
        launches=json.dumps(counts))
    return counts


def phase_dag_burst_times(dev, report):
    """Phase 66: K14-dag's device time per 256-step burst at phase 64's
    shape, rings off and at capacity 256, L2 scrubbed; its bound (the
    lanes' carry read and written once, the staging and registers, the
    ring rows, and the threefry work of the steps and the resets), the
    plain version's time of one such burst, and the device time per
    burst of every phase 62 case at its shape."""
    from cpr_tpu_torch.serve.engine import ResidentEngine
    env, params = dag_serve_env(DAG_SERVE_MAX_STEPS)
    L, B = DAG_SERVE_LANES, DAG_SERVE_BURST
    F = env.observation_length
    kind = ("dag_burst_kernel", "TailstormEnv")
    out = {}
    for cap in (0, B):
        eng = ResidentEngine(env, params, n_lanes=L, burst=B,
                             experience=cap)
        eng.start()
        eng.splice({ln: 6600 + ln for ln in range(L)})
        pid = eng.policy_ids[DAG_SERVE_POLICY]
        lanes, pids = np.arange(L), np.full(L, pid, np.int32)
        ended, calls = [0], [0]

        def burst():
            calls[0] += 1
            ended[0] += int(eng._burst_staged(lanes, pids, {pid})["done"]
                            .sum())

        out[cap] = device_ms(burst, 5, kind)
        if cap:
            resets = ended[0] / calls[0]
            state_bytes = carry_bytes(eng._carry)
            # the plain version of one burst, from a copy of the carry
            carry_p, exp_p = clone_carry(eng._carry), exp_clone(eng._exp)
            pol = torch.full((L,), pid, dtype=torch.int32, device=dev)
            live = torch.ones(L, dtype=torch.bool, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._burst_plain(carry_p, exp_p, pol, live)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        del eng
    row = report["K14-dag"]
    row["ms"], row["plain_ms"] = out[B], plain_ms
    # per lane: the carry read and written once, policy, live, admit and
    # the six params read, the registers written; a step's ring row
    # (4 F + 21 bytes); a mining draw (5 keys, 4 draws: 9 threefry
    # blocks) every step and every reset
    lane_in = 4 + 1 + 1 + 8 + 6 * 4
    k_bytes = 2 * state_bytes + L * (lane_in + 1 + 4 + 16) \
        + L * B * (4 * F + 21)
    k_ops = THREEFRY_OPS * 9 * (L * B + resets)
    row["bound_ms"], row["bound_by"] = bound_ms(k_bytes, k_ops)
    others = {}
    for name in DAGB_CASES:
        eng, lane_policy = dagb_engine(dev, name)
        env_kind = ("dag_burst_kernel", DAGB_KINDS[name])
        others[name] = device_ms(lambda: eng.burst_run(lane_policy), 3,
                                 env_kind)
        del eng
    say("dag_burst_times", K14_dag=json.dumps({f: row[f] for f in (
        "ms", "plain_ms", "bound_ms", "bound_by")}), rings_off_ms=out[0],
        resets=resets, phase62_ms=json.dumps(others),
        phase62_shape=f"{DAGB_LANES}x{DAGB_BURST}")


# K17, the device-metrics fold (phases 67-73): the crafted cases and short
# paths of tests/fixtures/torch_port_metrics_golden.npz (written by
# tests/test_torch_device_metrics.py from cpr_tpu), then the paths with
# the metrics on: the main stream, the chunked Tailstorm stream, a batch
# rollout, the serve engines, the bench PPO step and the netsim.
METRICS_FIXTURE = ROOT / "tests" / "fixtures" / \
    "torch_port_metrics_golden.npz"
METRICS_SUM_RTOL = 1e-5  # float32 sums in K17's order, not XLA's or torch's
METRICS_PATH_RTOL = 1e-5  # a path's float inputs (clocks) against cpr_tpu's
METRICS_PPO_ATOL = 1e-5  # approx_kl from K11-loss against XLA's
METRICS_ROLLOUT_LANES, METRICS_ROLLOUT_STEPS = 4096, 256
METRICS_ROLLOUT_MAX_STEPS = 128  # episodes end inside the rollout
METRICS_TIME_REPS = 20


@contextlib.contextmanager
def metrics_on():
    """CPR_DEVICE_METRICS=1 around a producer's build (or the netsim's
    run, which reads it then)."""
    import os
    old = os.environ.get("CPR_DEVICE_METRICS")
    os.environ["CPR_DEVICE_METRICS"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["CPR_DEVICE_METRICS"]
        else:
            os.environ["CPR_DEVICE_METRICS"] = old


def sync_warnings(fn):
    """(fn(), the synchronizing CUDA operations it ran as
    torch.cuda.set_sync_debug_mode("warn") reports them, and where: the
    Python lines that ran them). The garbage collector waits until the
    call ends, so that no earlier object's teardown lands in it."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    gc.disable()
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        gc.enable()
    sites = [f"{Path(w.filename).name}:{w.lineno}" for w in seen
             if "synchroniz" in str(w.message)]
    return out, len(sites), sites


def hold_no_added_syncs(off, on, what):
    """Run the metrics-off and -on calls in turns (off, on, on, off) and
    hold that the metrics add no synchronizing operation: the fewest a
    metrics-on call ran is at most the fewest a metrics-off call ran
    (a sync that an earlier object's teardown or the allocator lands in
    one call is not the call's own), and none ran in device_metrics.py.
    Returns (the metrics-on call's result, (off counts, on counts))."""
    n_off, n_on, sites = [], [], []
    for fn, ns in ((off, n_off), (on, n_on), (on, n_on), (off, n_off)):
        out, n, at = sync_warnings(fn)
        ns.append(n)
        sites += at
        if fn is on:
            res = out
    check(min(n_on) <= min(n_off)
          and not any(a.startswith("device_metrics.py") for a in sites),
          f"{what}: the metrics added synchronizing operations (off "
          f"{n_off}, on {n_on}; at {sites})")
    return res, (n_off, n_on)


def nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def _same_float(a, b):
    return a == b or (a is not None and b is not None
                      and np.isnan(a) and np.isnan(b))


def compare_metrics(got, want, what, rtol=0.0, atol=0.0):
    """Two summaries: counters, hist counts and stats counts exact; min
    and max exact, or within rtol/atol where the cells' inputs come from
    other arithmetic; sums within METRICS_SUM_RTOL (and the same rtol/
    atol). Returns the largest finite sum difference."""
    check(list(got) == list(want), f"{what}: cells {list(got)}")
    err = 0.0
    for k, w in want.items():
        g = got[k]
        if not isinstance(w, dict) or "counts" in w:
            check(g == w, f"{what}: {k} is {g}, expected {w}")
            continue
        check(g["count"] == w["count"], f"{what}: {k} count {g} vs {w}")
        for f, tol in (("min", rtol), ("max", rtol),
                       ("sum", max(rtol, METRICS_SUM_RTOL))):
            a, b = g[f], w[f]
            ok = _same_float(a, b) or (
                a is not None and b is not None and np.isfinite(b)
                and abs(a - b) <= tol * abs(b) + atol)
            check(ok, f"{what}: {k}.{f} is {a}, expected {b}")
        if g["sum"] is not None and np.isfinite(w["sum"]):
            err = max(err, abs(g["sum"] - w["sum"]))
    return err


def metrics_gen(a):
    """tests/test_torch_device_metrics.py `_gen`: a fixture array made by
    integer arithmetic."""
    n = int(np.prod(a["shape"]))
    i = np.arange(n, dtype=np.int64)
    if a["gen"] == "mask":
        out = (i % a["mod"]) != 0
    elif a["gen"] == "i32":
        out = ((i * a["mul"]) % a["mod"]).astype(np.int32)
    else:
        out = ((i * a["mul"]) % a["mod"]).astype(np.float32) \
            / np.float32(a["div"])
        if a.get("nan_every"):
            out[::a["nan_every"]] = np.nan
        if a.get("inf_every"):
            out[1::a["inf_every"]] = np.inf
    return out.reshape(a["shape"])


def metrics_case(mfx, name, dev):
    """A crafted fixture case on `dev`: (spec, ops, cpr_tpu's summary);
    its transposed and column arrays are views, as the producers fold
    them."""
    from cpr_tpu_torch import device_metrics as dm
    t = {}
    for k, a in json.loads(str(mfx[f"{name}__arrays"])).items():
        if "file" in a:
            t[k] = torch.from_numpy(mfx[a["file"]]).to(dev)
        elif "of" in a:
            base = t[a["of"]]
            t[k] = base[:, a["col"]] if "col" in a else \
                base[:, a["cols"][0]:a["cols"][1]]
        else:
            v = torch.from_numpy(metrics_gen(a)).to(dev)
            t[k] = v.T if a.get("transpose") else v
    spec = dm.MetricsSpec()
    for c in json.loads(str(mfx[f"{name}__cells"])):
        getattr(spec, c[0])(*c[1:])
    ops = []
    for o in json.loads(str(mfx[f"{name}__ops"])):
        x = None if o["x"] is None else t[o["x"]]
        w = None if o["where"] is None else t[o["where"]]
        if o["op"] == "count":
            ops.append(dm.count_op(o["name"], o["n"] if x is None else x,
                                   o["scale"]))
        elif o["op"] == "nonfinite":
            ops.append(dm.nonfinite_op(o["name"], x, rows=o["rows"]))
        elif o["op"] == "observe":
            ops.append(dm.observe_op(o["name"], o["value"] if x is None
                                     else x, w, nonfinite=o["nonfinite"]))
        else:
            ops.append(dm.hist_op(o["name"], x, w))
    return spec, ops, json.loads(str(mfx[f"{name}__want"]))


def fold_bytes(ops, acc):
    """The bytes a fold must move: each input tensor read once (a tensor
    two cells read counted once), the accumulator read and written."""
    seen, total = set(), 2 * acc.numel() * 4
    for op in ops:
        for t in (op.x, op.where):
            if t is not None and (t.data_ptr(), t.numel()) not in seen:
                seen.add((t.data_ptr(), t.numel()))
                total += t.numel() * t.element_size()
    return total


def phase_metrics_fixture(dev, mfx, report):
    """Phase 67: K17 on every crafted case of the fixture against its
    plain fold on the card and against cpr_tpu's summary (counters, bins,
    min, max and count exact, sums within METRICS_SUM_RTOL), two folds
    bit for bit; then the fixture's short paths on the card with the
    metrics on (Nakamoto SM1 unchunked and chunked, the Tailstorm ring
    chunked, a batch rollout, one tiny PPO step from JAX's params)
    against cpr_tpu's cells."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.params import make_params
    from cpr_tpu_torch.train import ppo
    row, err = report["K17"], 0.0
    cases = json.loads(str(mfx["cases"]))
    for name in cases:
        spec, ops, want = metrics_case(mfx, name, dev)
        acc = spec.fold(spec.init(dev), ops)
        again = spec.fold(spec.init(dev), ops)
        got = spec.summarize(acc)
        check(torch.equal(acc, again), f"K17 {name}: two folds differ")
        err = max(err, compare_metrics(got, want, f"K17 {name} vs cpr_tpu"),
                  compare_metrics(got, spec.summarize(spec.fold_plain(
                      spec.init(dev), ops)), f"K17 {name} vs plain"))
    paths = json.loads(str(mfx["paths"]))
    for name, (key, window, pol, max_steps, lanes, steps, chunk) in \
            paths.items():
        env = registry.get(key, **({"window": window} if window else {}))
        params = make_params(alpha=0.35, gamma=0.5, max_steps=max_steps)
        fn = env.make_episode_stats_fn(params, pol, steps, chunk=chunk,
                                       collect_metrics=True)
        _, acc = fn(rnd.split(rnd.PRNGKey(0, dev), lanes))
        compare_metrics(fn.metrics_spec.summarize(acc),
                        json.loads(str(mfx[f"path_{name}__want"])),
                        f"{name} with metrics vs cpr_tpu",
                        rtol=METRICS_PATH_RTOL)
    env = registry.get("nakamoto")
    params = make_params(alpha=0.35, gamma=0.5, max_steps=16)
    _, acc = env.rollout(rnd.split(rnd.PRNGKey(3, dev), 4), params,
                         "sapirshtein-2016-sm1", 48, with_metrics=True)
    from cpr_tpu_torch import device_metrics as dm
    compare_metrics(dm.rollout_spec().summarize(acc),
                    json.loads(str(mfx["path_rollout__want"])),
                    "rollout with metrics vs cpr_tpu",
                    rtol=METRICS_PATH_RTOL)
    pc = json.loads(str(mfx["ppo_config"]))
    with metrics_on():
        init_fn, step = ppo.make_train(
            env, make_params(alpha=pc["alpha"], gamma=pc["gamma"],
                             max_steps=pc["max_steps"]),
            ppo.PPOConfig(n_envs=pc["n_envs"], n_steps=pc["n_steps"],
                          hidden=tuple(pc["hidden"]),
                          update_epochs=pc["update_epochs"],
                          n_minibatches=pc["n_minibatches"]))
    carry = init_fn(rnd.PRNGKey(pc["seed"], dev),
                    params=torch.from_numpy(mfx["path_ppo__flat"]))
    _, m = step(carry)
    compare_metrics(step.metrics_spec.summarize(m["device_metrics"]),
                    json.loads(str(mfx["path_ppo__want"])),
                    "PPO step with metrics vs cpr_tpu",
                    atol=METRICS_PPO_ATOL)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    say("metrics_fixture", cases=len(cases), paths=len(paths) + 2,
        max_abs_err=err, ok=True)


def metrics_stream_case(dev, env, params, pol, lanes, steps, chunk, name,
                        ran):
    """Phases 68-69: a stats path with collect_metrics against the same
    path with it off (same keys): the stats bit for bit, the same count
    of synchronizing operations under set_sync_debug_mode("warn"); then
    one warm and three timed calls with the launch counts zeroed before
    and read after, their accumulators merged on the card, one readback
    and one `emit`; the cells against the plain fold of the last call's
    per-lane tensors. Returns (counts, that fold's ops, the spec)."""
    from cpr_tpu_torch import device_metrics as dm
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.base import EPISODE_KEYS
    keys = rnd.split(rnd.PRNGKey(0, dev), lanes)
    fn_off = env.make_episode_stats_fn(params, pol, steps, chunk=chunk)
    fn_on = env.make_episode_stats_fn(params, pol, steps, chunk=chunk,
                                      collect_metrics=True)
    spec = fn_on.metrics_spec
    fn_off(keys)  # warm, both: a first call may sync once (allocation)
    fn_on(keys)
    torch.cuda.synchronize()
    (on, _), syncs = hold_no_added_syncs(lambda: fn_off(keys),
                                         lambda: fn_on(keys), name)
    off = fn_off(keys)
    for k, v in off.items():
        check(torch.equal(on[k], v), f"{name}: metrics on changed {k}")
    kernels.reset_launches()
    keys = rnd.split(rnd.PRNGKey(0, dev), lanes)  # K1, as on the path
    fn_on(keys)
    torch.cuda.synchronize()
    secs, accs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        stats, acc = fn_on(keys)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        accs.append(acc)
    merged = spec.merge(spec.merge(accs[0], accs[1]), accs[2])
    summary = dm.emit(name, spec, merged, reps=3)
    counts = dict(kernels.launches)
    path_launches(counts, ran, f"{name} with metrics")
    n_chunks = 1 if chunk is None else -(-steps // chunk)
    check(counts["K17"] == 4 * n_chunks, f"{name}: K17 launched "
          f"{counts['K17']} times in 4 calls of {n_chunks} chunks")
    check(summary["env_steps"] == 3 * lanes * steps,
          f"{name}: env_steps {summary['env_steps']}")
    check(summary["episodes"] == 3 * int(stats["n_episodes"].sum()),
          f"{name}: episodes {summary['episodes']}")
    check(summary["nonfinite_stats"] == 0
          and summary["nonfinite_obs_boundary"] == 0,
          f"{name}: nonfinite cells {summary}")
    stat_keys = tuple(sorted(EPISODE_KEYS))
    ops = [dm.count_op("env_steps", lanes, steps)] + dm.episode_stats_ops(
        stats=stats, n_episodes=stats["n_episodes"], stat_keys=stat_keys)
    err = compare_metrics(spec.summarize(accs[-1]), spec.summarize(
        spec.fold_plain(spec.init(dev), ops)), f"K17 {name} vs plain")
    say(f"metrics_{name}", lanes=lanes, steps=steps, chunk=chunk,
        env_steps=summary["env_steps"], episodes=summary["episodes"],
        episode_n_steps=json.dumps(summary["episode_n_steps"]),
        call_s=secs, sync_ops_off_on=json.dumps(syncs),
        max_abs_err=err, launches=json.dumps(nonzero(counts)))
    return counts, ops, spec, err


def phase_metrics_stream(dev, report):
    """Phase 68: the main path (bench.py:139-166's episode measure with
    CPR_DEVICE_METRICS=1: Nakamoto SM1 at 131072 lanes x 2200 steps,
    unchunked; K1, K2, K17), `env_steps` 865,075,200; then K17's device
    time on this fold (L2 scrubbed) beside the stream's (phase 6), its
    plain fold's time and its bound (the per-lane inputs read once)."""
    from cpr_tpu_torch import device_metrics as dm
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
    from cpr_tpu_torch.params import make_params
    env = NakamotoSSZ()
    params = make_params(alpha=0.35, gamma=0.5, max_steps=MAIN_MAX_STEPS)
    counts, ops, spec, err = metrics_stream_case(
        dev, env, params, "sapirshtein-2016-sm1", MAIN_LANES, MAIN_STEPS,
        None, "nakamoto_sm1", ("K1", "K2", "K17"))
    check(3 * MAIN_LANES * MAIN_STEPS == 865_075_200, "the bench's span")
    obs = env.init_lanes(rnd.split(rnd.PRNGKey(0, dev), MAIN_LANES),
                         params)[1]
    ops = ops + [dm.nonfinite_op("nonfinite_obs_boundary", obs)]
    row = report["K17"]
    acc = spec.init(dev)
    row["ms"] = device_ms(lambda: spec.fold(acc, ops), METRICS_TIME_REPS,
                          "metrics_fold_kernel")
    acc_p = spec.init(dev)
    row["plain_ms"] = cuda_ms(lambda: spec.fold_plain(acc_p, ops), 5)
    row["bound_ms"], row["bound_by"] = bound_ms(fold_bytes(ops, acc), 0)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    stream_ms = report["K2"]["ms"]
    say("metrics_times", K17=json.dumps({f: row[f] for f in (
        "ms", "plain_ms", "bound_ms", "bound_by")}),
        bytes=fold_bytes(ops, acc), stream_ms=stream_ms,
        overhead=row["ms"] / stream_ms)
    return counts


def phase_metrics_chunked(dev, report):
    """Phase 69: the Tailstorm path (config 4's shape, phase 24) with
    collect_metrics, in chunks of 128: K1, K10-ts eight times a call,
    K17 once a chunk."""
    from cpr_tpu_torch.params import make_params
    env = dag_env("ts")
    params = make_params(alpha=0.35, gamma=0.5, max_steps=VOTE_MAX_STEPS)
    counts, _, _, err = metrics_stream_case(
        dev, env, params, env.policies[DAG_ENVS["ts"][1]], VOTE_LANES,
        VOTE_STEPS, VOTE_CHUNK, "tailstorm", ("K1", "K10-ts", "K17"))
    report["K17"]["max_abs_err"] = max(report["K17"]["max_abs_err"], err)
    return counts


def phase_metrics_rollout(dev, report):
    """Phase 70: `rollout(with_metrics=True)`, Nakamoto SM1, 4096 lanes x
    256 steps (K1, K2, K17): the trajectory that of the metrics-off
    call, no added synchronizing operation, the cells against the plain
    `update_rollout` over the same trajectory."""
    from cpr_tpu_torch import device_metrics as dm
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
    from cpr_tpu_torch.params import make_params
    env = NakamotoSSZ()
    params = make_params(alpha=0.35, gamma=0.5,
                         max_steps=METRICS_ROLLOUT_MAX_STEPS)
    L, T = METRICS_ROLLOUT_LANES, METRICS_ROLLOUT_STEPS
    keys = rnd.split(rnd.PRNGKey(7, dev), L)
    sm1 = "sapirshtein-2016-sm1"
    env.rollout(keys, params, sm1, T, with_metrics=True)  # warm
    torch.cuda.synchronize()
    _, syncs = hold_no_added_syncs(
        lambda: env.rollout(keys, params, sm1, T),
        lambda: env.rollout(keys, params, sm1, T, with_metrics=True),
        "rollout")
    off = env.rollout(keys, params, sm1, T)
    key = rnd.PRNGKey(7, dev)
    kernels.reset_launches()
    traj, acc = env.rollout(rnd.split(key, L), params, sm1, T,
                            with_metrics=True)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    path_launches(counts, ("K1", "K2", "K17"), "rollout with metrics")
    for a, b, f in zip(traj[:4], off[:4], ("obs", "action", "reward",
                                           "done")):
        check(torch.equal(a, b), f"rollout with metrics: {f} differs")
    obs, _, reward, done, info = traj
    spec = dm.rollout_spec()
    s = spec.summarize(acc)
    plain = spec.summarize(spec.fold_plain(spec.init(dev), dm.rollout_ops(
        reward=reward, done=done, ep_len=info["episode_n_steps"], obs=obs)))
    err = compare_metrics(s, plain, "K17 rollout vs plain")
    check(s["env_steps"] == L * T and s["episodes"] == int(done.sum()) > 0,
          f"rollout cells {s}")
    report["K17"]["max_abs_err"] = max(report["K17"]["max_abs_err"], err)
    say("metrics_rollout", lanes=L, steps=T, episodes=s["episodes"],
        reward=json.dumps(s["reward"]), sync_ops_off_on=json.dumps(syncs),
        max_abs_err=err,
        launches=json.dumps(nonzero(counts)))
    return counts


def phase_metrics_serve(dev, report):
    """Phase 71: the serve engines under CPR_DEVICE_METRICS=1: Nakamoto at
    phase 51's shape (131072 lanes, SERVE_BURSTS bursts of 256, rings
    off; K2, K3, K14, K17) and Tailstorm in full mode at phase 62's
    (K10-ts-full, K14-dag-ts-full, K17); `emit_metrics` gives the bursts
    without the warm-up, env_steps and episodes the registers' sums."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.serve.engine import ResidentEngine
    counts = []
    env, params = serve_env(MAIN_MAX_STEPS)
    for name in ("nakamoto", "ts"):
        kernels.reset_launches()
        with metrics_on():
            if name == "nakamoto":
                L, B, n_bursts = MAIN_LANES, SERVE_BURST, SERVE_BURSTS
                eng = ResidentEngine(env, params, n_lanes=L, burst=B)
                eng.start()
                eng.splice({ln: ln for ln in range(L)})
                sm1 = eng.policy_ids["sapirshtein-2016-sm1"]
                lane_policy = dict.fromkeys(range(L), sm1)
            else:
                L, B, n_bursts = DAGB_LANES, DAGB_BURST, 2
                eng, lane_policy = dagb_engine(dev, "ts")
        done = 0
        for _ in range(n_bursts):
            done += int(eng.burst_run(lane_policy)["done"].sum())
        s = eng.emit_metrics()
        counts.append(dict(kernels.launches))
        ran = (("K2", "K3", "K14") if name == "nakamoto" else
               (eng.env.kernel_name, kernels.dag_burst_name(eng.env)))
        path_launches(counts[-1], ran + ("K17",), f"serve {name} metrics")
        check(counts[-1]["K17"] == n_bursts + 1,
              f"serve {name}: K17 launched {counts[-1]['K17']} times")
        check(s["bursts"] == n_bursts and s["env_steps"] == n_bursts * L * B
              and s["episodes"] == done and s["occupancy"]["count"] ==
              n_bursts and s["burst_s"]["count"] == n_bursts
              and sum(s["burst_s_hist"]["counts"]) == n_bursts,
              f"serve {name} cells {s}")
        say("metrics_serve", env=name, lanes=L, burst=B, bursts=n_bursts,
            episodes=done, burst_s=json.dumps(s["burst_s"]),
            launches=json.dumps(nonzero(counts[-1])), ok=True)
        del eng
    return counts


def phase_metrics_ppo(dev, report):
    """Phase 72: two bench train_steps (phase 31's shape: Tailstorm,
    config 4, 4096 lanes x 128 steps) with CPR_DEVICE_METRICS=1, each
    beside the metrics-off step from a copy of the same carry: every
    other metric and the params bit for bit, the cells finite with the
    config's counts (K1, K10-ts, K11-*, K17 once a step)."""
    import copy
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.base import map_state
    from cpr_tpu_torch.params import make_params
    from cpr_tpu_torch.train import ppo
    env = dag_env("ts")
    params = make_params(alpha=0.35, gamma=0.5, max_steps=PPO_MAX_STEPS)
    cfg = ppo.PPOConfig(n_envs=PPO_LANES, n_steps=PPO_STEPS)
    init_fn, step_off = ppo.make_train(env, params, cfg)
    with metrics_on():
        _, step_on = ppo.make_train(env, params, cfg)
    carry = init_fn(rnd.PRNGKey(72, dev))
    kernels.reset_launches()
    n_mb = cfg.update_epochs * cfg.n_minibatches
    for i in range(2):
        ts, state, obs, key = carry
        twin = (copy.deepcopy(ts), map_state(torch.clone, state),
                obs.clone(), key.clone())
        carry, m = step_on(carry)
        twin, m_off = step_off(twin)
        s = step_on.metrics_spec.summarize(m.pop("device_metrics"))
        check(set(m) == set(m_off), "PPO metrics keys differ")
        for k, v in m_off.items():
            check(torch.equal(m[k], v), f"PPO step {i}: metric {k} differs "
                  "with the metrics on")
        check(torch.equal(carry[0].net.flat, twin[0].net.flat),
              f"PPO step {i}: params differ with the metrics on")
        check(s["minibatches"] == n_mb and s["approx_kl"]["count"] == n_mb
              and s["nonfinite_advantages"] == 0
              and s["nonfinite_loss"] == 0
              and s["minibatches_skipped"] == 0
              and np.isfinite(s["approx_kl"]["sum"]), f"PPO cells {s}")
    counts = dict(kernels.launches)
    check(counts["K17"] == 2, f"PPO: K17 launched {counts['K17']} times")
    path_launches(counts, ("K1", "K10-ts", "K11-act", "K11-gae",
                           "K11-loss", "K11-adam", "K17"),
                  "bench PPO with metrics")
    say("metrics_ppo", lanes=PPO_LANES, steps=PPO_STEPS, minibatches=n_mb,
        approx_kl=json.dumps(s["approx_kl"]),
        launches=json.dumps(nonzero(counts)), ok=True)
    # the metrics-off steps ran the same kernels: only K17 is theirs
    return {"K17": counts["K17"]}


def phase_metrics_netsim(dev, report):
    """Phase 73: `netsim.Engine.run` at bench.py's clique (96 lanes x
    10000, scan) with CPR_DEVICE_METRICS=1 emits one device_metrics
    event of scope netsim equal to the outputs' sums (a host fold: the
    outputs are numpy arrays, as the reference's); `AttackEngine.run`
    runs with the variable set and emits none (K12-scan, K13)."""
    from cpr_tpu_torch import kernels, netsim, network, telemetry
    net = network.symmetric_clique(NET_NODES, activation_delay=NET_ACT_DELAY,
                                   propagation_delay=NET_PROP)
    eng = netsim.Engine(net, protocol="nakamoto", activations=NET_ACTS)
    atk = attack_engine(ATK_ACTS)
    alphas, pids, _ = attack_lanes(ATK_LANES)
    buf = io.StringIO()
    telemetry.configure(stream=buf)
    kernels.reset_launches()
    try:
        with metrics_on():
            out = eng.run(list(range(NET_LANES)), [NET_ACT_DELAY] * NET_LANES)
            aout = atk.run(range(ATK_LANES), [NET_ACT_DELAY] * ATK_LANES,
                           alphas, pids)
    finally:
        telemetry.configure()
    counts = dict(kernels.launches)
    path_launches(counts, ("K12-scan", "K13"), "netsim with metrics")
    ev = [e for e in map(json.loads, buf.getvalue().splitlines())
          if e.get("name") == "device_metrics"]
    check(len(ev) == 1 and ev[0]["scope"] == "netsim",
          f"netsim device_metrics events: {ev}")
    m = ev[0]["metrics"]
    for cell, k in (("steps", "steps"), ("queue_drops", "drop_q"),
                    ("pending_drops", "drop_p"), ("ledger_drops", "drop_b")):
        check(m[cell] == int(np.asarray(out[k], np.int64).sum()),
              f"netsim cell {cell} {m[cell]}")
    check(drops(aout) == 0, "attack path with metrics dropped")
    say("metrics_netsim", lanes=NET_LANES, steps=m["steps"],
        attack_lanes=ATK_LANES, launches=json.dumps(nonzero(counts)),
        ok=True)


# -- phases 74-79: the netsim past 32 nodes (the widened K12/K13) -------------

def wide_rows(report):
    """The kernels line's rows of the widened launches, one a kernel and
    node bucket the paths run (`netsim.engine.kernel_name`)."""
    csrc = "cpr_tpu_torch/csrc"
    rows = {
        "K12-event-eth-n64": ("netsim_event_eth.cu",
                              "cpr_tpu/netsim/engine.py:311",
                              f"K12-event-eth at 2 node slots (the sweep's "
                              f"whitepaper and Byzantium on "
                              f"{WIDE_HN_NODES} nodes)"),
        "K12-event-bk-n64": ("netsim_event_bk.cu",
                             "cpr_tpu/netsim/engine.py:409",
                             f"K12-event-bk at 2 node slots (the sweep's "
                             f"three Bk configurations on {WIDE_HN_NODES} "
                             f"nodes)"),
        "K12-event-spar-n64": ("netsim_event_spar.cu",
                               "cpr_tpu/netsim/engine.py:368",
                               f"K12-event-spar at 2 node slots (the "
                               f"sweep's Spar call on {WIDE_HN_NODES} "
                               f"nodes)"),
        "K12-event-n128": ("netsim_event.cu", "cpr_tpu/netsim/engine.py:92",
                           f"K12-event at 4 node slots (flooding on "
                           f"preferential_attachment({PA_NODES}, {PA_M}), "
                           f"{PA_LANES} lanes x {PA_ACTS})"),
        "K12-event-bk-n128": ("netsim_event_bk.cu",
                              "cpr_tpu/netsim/engine.py:409",
                              f"K12-event-bk at 4 node slots (Bk k=8 "
                              f"flooding on preferential_attachment("
                              f"{PA_NODES}, {PA_M}), {PA_BK_LANES} lanes x "
                              f"{PA_BK_ACTS})"),
        "K13-n128": ("netsim_attack.cu", "cpr_tpu/netsim/attack.py:81",
                     f"K13 at 4 node slots (selfish_mining gamma "
                     f"{SM_GAMMA}, {SM_DEFENDERS} defenders, {SM_LANES} "
                     f"lanes x {SM_ACTS}, the default queue; the sweep "
                     f"{SM_SWEEP_LANES} x {SM_SWEEP_ACTS})"),
        "K12-scan-n256": ("netsim_scan.cu", "cpr_tpu/netsim/engine.py:716",
                          f"K12-scan at 8 node slots, its one build past 32 "
                          f"nodes (the honest-net sweep's Nakamoto on the "
                          f"{WIDE_HN_NODES}-node clique, 5 lanes x "
                          f"{HN_ACTS}, the row's times; the server's "
                          f"netsim.query at {WIDE_QUERY_NODES} nodes; a "
                          f"{WIDE_MAX_NODES}-node clique, {WIDE_MAX_LANES} "
                          f"lanes x {WIDE_MAX_ACTS})"),
        "K12-event-n256": ("netsim_event.cu", "cpr_tpu/netsim/engine.py:92",
                           f"K12-event at 8 node slots (a {WIDE_MAX_NODES}-"
                           f"node clique, {WIDE_MAX_LANES} lanes x "
                           f"{WIDE_MAX_ACTS})"),
    }
    for k, (src, at, name) in rows.items():
        report[k] = dict(name=f"{k}: {name}", route="cuda",
                         source=f"{csrc}/{src}", replaces=at,
                         library_ms=None, max_abs_err=0.0)


def pa_net():
    """Path (b)'s topology: the simulate-topology generator's attributes
    at PA_NODES nodes, flooding."""
    from cpr_tpu_torch import netsim, network
    return netsim.compile_network(network.preferential_attachment(
        PA_NODES, PA_M, distribution="exponential", seed=PA_SEED))


def sm_net():
    """Path (c)'s topology: selfish_mining at gamma SM_GAMMA, the
    attacker at node 0 and SM_DEFENDERS defenders."""
    from cpr_tpu_torch import netsim, network
    return netsim.compile_network(network.selfish_mining(
        alpha=SM_ALPHA, gamma=SM_GAMMA, defenders=SM_DEFENDERS,
        activation_delay=SM_DELAY, propagation_delay=SM_PROP))


def pa_engine(cn, proto, k, acts):
    from cpr_tpu_torch import netsim
    return netsim.Engine(cn, protocol=proto, k=k, activations=acts,
                         max_steps=PA_STEPS_PER_ACT * acts + 4096)


def sm_engine(cn, acts):
    from cpr_tpu_torch import netsim
    return netsim.AttackEngine(cn, activations=acts, policies=ATK_POLICIES,
                               topology="selfish-mining-gamma0.99")


def sm_inputs(seeds, alphas, pids, dev):
    """Path (c)'s lane inputs: keys, delays SM_DELAY, alphas, policy ids."""
    keys, dl = lane_inputs(seeds, [SM_DELAY] * len(seeds), dev)
    return (keys, dl, torch.tensor(alphas, dtype=torch.float32, device=dev),
            torch.tensor(pids, dtype=torch.int32, device=dev))


def sweep_lanes():
    """attack_sweep's lane order at path (c)'s grid: (seeds, alphas,
    policy ids), a grid point's SM_SWEEP_REPS reps together."""
    pts = [(a, p) for a in ATK_ALPHAS for p in range(len(ATK_POLICIES))]
    seeds = list(range(len(pts) * SM_SWEEP_REPS))
    return (seeds, [pts[i // SM_SWEEP_REPS][0] for i in seeds],
            [pts[i // SM_SWEEP_REPS][1] for i in seeds])


def wide_holds():
    """The widened kernels' holds: (name, kernel row, what builds the
    engine and lane inputs). Path (a): each kernel's first configuration
    on the sweep's five lanes at WIDE_HN_PLAIN_ACTS activations; (b) all
    lanes of both runs at PA_PLAIN_ACTS and PA_BK_PLAIN_ACTS; (c) all
    lanes of the path at SM_PLAIN_ACTS, its alpha 0.45 SM1 lanes at
    SM_DEEP_ACTS (`WIDE_DROP_HOLDS`: their plain version drops queue
    entries, and parked blocks on every lane), and the sweep's lanes
    (SM_SWEEP_CHUNK a hold) at SM_SWEEP_PLAIN_ACTS; (e) both runs at the
    path's depth."""
    out = [(f"a-{proto}-{k}-{scheme}", row, ("hn", proto, k, scheme))
           for row, (proto, k, scheme) in (
               ("K12-scan-n256", ("nakamoto", 1, "constant")),
               *((f"{kern}-n64", cfgs[0])
                 for kern, cfgs in PROTO_CONFIGS.items()))]
    out += [("b-nakamoto", "K12-event-n128", ("pa", "nakamoto", 1)),
            ("b-bk-8", "K12-event-bk-n128", ("pa", "bk", 8)),
            ("c-path", "K13-n128", ("sm", None, None)),
            ("c-deep", "K13-n128", ("smdeep", None, None))]
    out += [(f"c-sweep{i}", "K13-n128", ("smsweep", i, None))
            for i in range(SM_SWEEP_LANES // SM_SWEEP_CHUNK)]
    out += [("e-scan", "K12-scan-n256", ("max", "scan", None)),
            ("e-event", "K12-event-n256", ("max", "event", None))]
    return out


def wide_hold_inputs(spec, dev):
    """(engine, lane inputs) of a `wide_holds` entry."""
    from cpr_tpu_torch import netsim
    kind, a, b = spec[0], spec[1], spec[2]
    if kind == "hn":
        eng = proto_engine(a, b, spec[3], WIDE_HN_PLAIN_ACTS,
                           bench_clique(WIDE_HN_NODES, HN_PROP))
        return eng, lane_inputs([HN_SEED] * len(HN_DELAYS), HN_DELAYS, dev)
    if kind == "pa":
        cn = pa_net()
        n, acts = ((PA_LANES, PA_PLAIN_ACTS) if a == "nakamoto"
                   else (PA_BK_LANES, PA_BK_PLAIN_ACTS))
        return (pa_engine(cn, a, b, acts),
                lane_inputs(range(n), [cn.activation_delay] * n, dev))
    if kind == "max":
        cn = bench_clique(WIDE_MAX_NODES, NET_PROP)
        eng = netsim.Engine(cn, activations=WIDE_MAX_ACTS, mode=a)
        return eng, lane_inputs(range(WIDE_MAX_LANES),
                                [NET_ACT_DELAY] * WIDE_MAX_LANES, dev)
    if kind == "sm":
        al, pi, _ = attack_lanes(SM_LANES)
        return (sm_engine(sm_net(), SM_PLAIN_ACTS),
                sm_inputs(range(SM_LANES), al, pi, dev))
    if kind == "smdeep":
        _, _, grid = attack_lanes(SM_LANES)
        seeds = [i for i, g in enumerate(grid) if g == (0.45, 1)]
        return (sm_engine(sm_net(), SM_DEEP_ACTS),
                sm_inputs(seeds, [0.45] * len(seeds), [1] * len(seeds), dev))
    seeds, al, pi = sweep_lanes()
    part = slice(a * SM_SWEEP_CHUNK, (a + 1) * SM_SWEEP_CHUNK)
    return (sm_engine(sm_net(), SM_SWEEP_PLAIN_ACTS),
            sm_inputs(seeds[part], al[part], pi[part], dev))


def wide_plain(eng, inputs):
    """A wide hold's plain version."""
    from cpr_tpu_torch.netsim import engine as E
    if len(inputs) == 4:
        return attack_plain_run(eng, *inputs)
    keys, dl = inputs
    if eng.mode == "scan":
        return E.scan_plain(eng.net, eng.activations, eng.lookback, keys, dl)
    return E.event_plain(eng.net, eng.activations, eng.B, eng.M, eng.F,
                         eng.S, keys, dl, eng.proto)


def wide_fixture_run(wfx, name, dev):
    """A wide fixture case through the kernels, from the fixture alone."""
    from cpr_tpu_torch import netsim
    from cpr_tpu_torch.netsim import engine as E
    cn = netsim_fixture_net(wfx, name)
    A = int(wfx[f"{name}_A"])
    keys, dl = lane_inputs(wfx[f"{name}_seeds"].tolist(),
                           wfx[f"{name}_delays"].tolist(), dev)
    mode = str(wfx[f"{name}_mode"])
    if mode == "attack":
        eng = netsim.AttackEngine(
            cn, activations=A, device=dev,
            policies=tuple(str(p) for p in wfx["attack_policies"]),
            queue_cap=int(wfx[f"{name}_queue"]) or None)
        out = eng.lanes(keys, dl, torch.as_tensor(wfx[f"{name}_alphas"],
                                                  device=dev),
                        torch.as_tensor(wfx[f"{name}_pids"], device=dev))
    else:
        out = netsim.Engine(cn, activations=A, mode=mode, device=dev,
                            protocol=str(wfx[f"{name}_protocol"]),
                            k=int(wfx[f"{name}_k"])).lanes(keys, dl)
    return E.finish(out)


def phase_wide_fixture(dev, wfx):
    """Phase 74: every case of the wide JAX fixture (40- and 64-node
    cliques under each protocol branch, flooding on
    preferential_attachment(40, 2), the attacker at gamma 0.97 with 34
    defenders, at its default queue and at one that drops, 100- and
    130-node cliques) through its widened kernel: integers exact, times
    within NET_TIME_RTOL. Their launches count nowhere."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.netsim import engine as E
    names = sorted(k[:-len("_mode")] for k in wfx if k.endswith("_mode"))
    kernels.reset_launches()
    for name in names:
        got = wide_fixture_run(wfx, name, dev)
        skip = ("_net_", "_seeds", "_delays", "_alphas", "_pids", "_A",
                "_mode", "_protocol", "_k", "_queue")
        # attack_sm35's keys, not attack_sm35_q64's
        longer = [m + "_" for m in names if m.startswith(name + "_")]
        want = {k[len(name) + 1:]: wfx[k] for k in wfx
                if k.startswith(name + "_")
                and not any(k.startswith(m) for m in longer)
                and not any(k == name + s or k.startswith(name + s)
                            for s in skip)}
        compare_netsim(got, want, f"{name} vs the wide JAX fixture",
                       NET_TIME_RTOL)
    buckets = sorted({E.kernel_name("K", int(wfx[f"{n}_net_n"]))
                      for n in names})
    ran = nonzero(kernels.launches)
    kernels.reset_launches()
    dropped = {n: int(wfx[f"{n}_drop_q"].sum() + wfx[f"{n}_drop_p"].sum())
               for n in names if wfx[f"{n}_drop_q"].sum()}
    check(dropped, "no wide fixture case drops")
    say("wide_fixture", cases=len(names), buckets=json.dumps(buckets),
        dropped=json.dumps(dropped), launches=json.dumps(ran), ok=True)


def hold_wide(dev, report, ahead, prefix):
    """The `wide_holds` entries whose name starts with `prefix`: each
    kernel on the hold's inputs against the plain outputs from
    `plain_ahead`'s child, exactly; the rows' plain ms (the first hold a
    row, the sweep's chunks apart) and errors; the `WIDE_DROP_HOLDS`
    drop queue entries and parked blocks. Launches count nowhere."""
    from cpr_tpu_torch import kernels
    secs = {}
    for name, row, spec in wide_holds():
        if not name.startswith(prefix):
            continue
        eng, inputs = wide_hold_inputs(spec, dev)
        got = eng.lanes(*inputs)
        want, secs[name] = ahead_plain(ahead, f"wide {name}")
        err = compare_netsim(got, want, f"{row} {name} vs plain")
        r = report[row]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if "plain_ms" not in r:
            r["plain_ms"] = secs[name] * 1e3
            r["plain_shape"] = name
        check(int(want["steps"].max()) > 0, f"{name} ran no step")
        if name in WIDE_DROP_HOLDS:  # the queue full, every lane parking
            check(want["drop_q"].sum() > 0 and np.all(want["drop_p"] > 0),
                  f"{name}: no queue drop or a lane without parked-block "
                  f"drops: {want['drop_q']}, {want['drop_p']}")
            secs[f"{name}_drops"] = [int(want["drop_q"].sum()),
                                     int(want["drop_p"].sum())]
    kernels.reset_launches()
    return secs


def phase_wide_honest_net(dev, report, ahead):
    """Phase 75, path (a): `honest_net_rows(engine="jax", n_nodes=64)` at
    the reference's defaults, then Spar k=4 under both schemes, a warm
    and a timed round with the counters zeroed before each call and read
    after it (K12-scan at 8 node slots, -eth, -bk at 2; -spar); the sweep's
    guards; then each kernel's first configuration held to its plain
    version (`wide_holds`)."""
    from cpr_tpu_torch import kernels, telemetry
    from cpr_tpu_torch.experiments import honest_net_rows
    counts = {k: 0 for k in kernels.launches}
    secs, spar_secs = [], []
    for _ in range(2):
        buf = io.StringIO()
        telemetry.configure(stream=buf)
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            rows = honest_net_rows(engine="jax", n_nodes=WIDE_HN_NODES)
            secs.append(time.perf_counter() - t0)
            c1 = dict(kernels.launches)
            path_launches(c1, ("K12-scan-n256", "K12-event-eth-n64",
                               "K12-event-bk-n64"), "wide honest-net")
            kernels.reset_launches()
            t0 = time.perf_counter()
            spar_rows = honest_net_rows(protocols=HN_SPAR, engine="jax",
                                        n_nodes=WIDE_HN_NODES)
            spar_secs.append(time.perf_counter() - t0)
            c2 = dict(kernels.launches)
            path_launches(c2, ("K12-event-spar-n64",),
                          "wide honest-net spar")
        finally:
            telemetry.configure()
        for c in (c1, c2):
            for k, n in c.items():
                counts[k] += n
        events = [json.loads(line) for line in buf.getvalue().splitlines()]
        nets = [e for e in events if e.get("name") == "netsim"
                and e.get("kind") == "event"]
        check(len(nets) == 8 and all(e["drops"] == 0 for e in nets),
              f"wide honest-net calls dropped or missed: {nets}")
        orphan = hn_guards(rows, spar_rows, none_ok=True)
    check(all(r["backend"] == "cuda" and r["network"]
              == f"honest_clique_{WIDE_HN_NODES}" for r in rows),
          "wide rows not on the card or not the 64-node clique")
    check(all(len(r["node_activations"].split("|")) == WIDE_HN_NODES
              for r in rows + spar_rows if "error" not in r),
          "wide rows without 64 nodes' activations")
    hold = hold_wide(dev, report, ahead, "a-")
    say("wide_honest_net", nodes=WIDE_HN_NODES,
        rows=len(rows) + len(spar_rows), call_s=secs, spar_call_s=spar_secs,
        orphan=json.dumps({w: [round(by[d], 6) for d in HN_DELAYS]
                           for w, by in orphan.items()}),
        plain_s=json.dumps(hold),
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    return counts


def phase_wide_flood(dev, report, ahead):
    """Phase 76, path (b): flooding on preferential_attachment(100, 2,
    distribution="exponential", seed=42) through Engine.run: Nakamoto
    PA_LANES x PA_ACTS, then Bk k=8 constant PA_BK_LANES x PA_BK_ACTS, each
    with its own launch counts (K12-event, -bk at 4 node slots); no
    drop, miss or exhausted lane, every activation counted, rewards
    summing to the progress; then both held to their plain versions on
    all their lanes (`wide_holds`)."""
    from cpr_tpu_torch import kernels
    cn = pa_net()
    counts = {k: 0 for k in kernels.launches}
    res = {}
    for proto, k, lanes, acts, row in PA_RUNS:
        eng = pa_engine(cn, proto, k, acts)
        check(eng.mode == "event", "flooding runs the event engine")
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = eng.run(range(lanes), [cn.activation_delay] * lanes)
        call_s = time.perf_counter() - t0
        c = dict(kernels.launches)
        path_launches(c, (row,), f"wide flood {proto}")
        for kk, n in c.items():
            counts[kk] += n
        check(drops(out) == 0 and not out["exhausted"].any(),
              f"wide flood {proto} dropped or exhausted")
        check(np.all(out["node_act"].sum(1) == acts), "activations lost")
        check(np.allclose(out["reward"].sum(1), out["progress"]),
              f"wide flood {proto}: rewards do not sum to the progress")
        check(np.all(np.isfinite(out["sim_time"])), "non-finite sim_time")
        res[proto] = dict(call_s=call_s, orphan=orphan_rate(out, acts),
                          steps_max=int(out["steps"].max()),
                          head_height_mean=float(out["head_height"].mean()))
        report[row]["steps"] = int(out["steps"].sum())
    hold = hold_wide(dev, report, ahead, "b-")
    say("wide_flood", nodes=cn.n, links=int((cn.kind >= 0).sum()),
        activation_delay=cn.activation_delay, runs=json.dumps(res),
        plain_s=json.dumps(hold),
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    return counts


def phase_wide_attack(dev, report, ahead):
    """Phase 77, path (c): the attacker on selfish_mining at gamma 0.99
    (100 defenders, 101 nodes), alpha in ATK_ALPHAS x {honest, SM1},
    the default queue: AttackEngine.run SM_LANES x SM_ACTS, then
    `attack_sweep` at SM_SWEEP_LANES x SM_SWEEP_ACTS, each with its own
    launch counts (K13 at 4 node slots); every activation counted, the
    rewards summing to the chain, the drops printed; then the path's and
    the sweep's lanes held to the plain version (`wide_holds`)."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.netsim import attack_sweep
    cn = sm_net()
    check(cn.n == SM_DEFENDERS + 1, f"{cn.n} nodes")
    eng = sm_engine(cn, SM_ACTS)
    al, pi, lanes = attack_lanes(SM_LANES)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = eng.run(range(SM_LANES), [SM_DELAY] * SM_LANES, al, pi)
    call_s = time.perf_counter() - t0
    counts = dict(kernels.launches)
    path_launches(counts, ("K13-n128",), "wide attack")
    check(np.all(out["node_act"].sum(1) == SM_ACTS), "activations lost")
    check(np.allclose(out["reward_attacker"] + out["reward_defender"],
                      out["head_height"]), "rewards do not sum to the chain")
    check(not out["exhausted"].any(), "wide attack exhausted")
    report["K13-n128"]["steps"] = int(out["steps"].sum())
    rel = relative_revenue(out)
    cells = {f"{a}/{ATK_POLICIES[p]}": round(float(np.mean(
        [rel[i] for i, ln in enumerate(lanes) if ln == (a, p)])), 5)
        for a in ATK_ALPHAS for p in range(len(ATK_POLICIES))}
    path_drops = {k: int(np.sum(out[k])) for k in ("drop_q", "drop_p",
                                                   "drop_b", "win_miss")}
    kernels.reset_launches()
    t0 = time.perf_counter()
    rows = attack_sweep([("selfish-mining-gamma0.99", cn)],
                        policies=ATK_POLICIES, alphas=ATK_ALPHAS,
                        activation_delays=(SM_DELAY,),
                        activations=SM_SWEEP_ACTS, reps=SM_SWEEP_REPS)
    sweep_s = time.perf_counter() - t0
    c = dict(kernels.launches)
    path_launches(c, ("K13-n128",), "wide attack sweep")
    counts["K13-n128"] += c["K13-n128"]
    check(len(rows) == len(ATK_ALPHAS) * len(ATK_POLICIES)
          and not any("error" in r for r in rows)
          and all(r["n_nodes"] == cn.n for r in rows),
          f"wide attack sweep rows: {rows[:2]}")
    check(all(0.0 <= r["relative_reward"] <= 1.0 for r in rows),
          "relative rewards outside [0, 1]")
    hold = hold_wide(dev, report, ahead, "c-")
    say("wide_attack", nodes=cn.n, lanes=SM_LANES, activations=SM_ACTS,
        call_s=call_s, rel_by_cell=json.dumps(cells),
        drops_at_default_queue=json.dumps(path_drops), queue=eng.M,
        sweep_lanes=SM_SWEEP_LANES, sweep_activations=SM_SWEEP_ACTS,
        sweep_s=sweep_s, sweep_rel=json.dumps(
            {r["attack"] + "@" + str(r["alpha"]): round(r["relative_reward"],
                                                        5) for r in rows}),
        plain_s=json.dumps(hold), launches=json.dumps(nonzero(counts)))
    return counts


def phase_wide_limit(dev, report, ahead):
    """Phase 78, path (e): a WIDE_MAX_NODES-node clique through Engine.run
    in scan and event mode, WIDE_MAX_LANES x WIDE_MAX_ACTS, each with its
    own launch counts (K12-scan, K12-event at 8 node slots), held to
    their plain versions; then one node more, refused by name, naming
    the limit and item 11b, by Engine and AttackEngine before any launch
    (every counter 0)."""
    from cpr_tpu_torch import kernels, netsim
    from cpr_tpu_torch.netsim import engine as E
    cn = bench_clique(WIDE_MAX_NODES, NET_PROP)
    counts = {k: 0 for k in kernels.launches}
    for mode, row in (("scan", "K12-scan-n256"), ("event", "K12-event-n256")):
        eng = netsim.Engine(cn, activations=WIDE_MAX_ACTS, mode=mode)
        kernels.reset_launches()
        out = eng.run(range(WIDE_MAX_LANES), [NET_ACT_DELAY] * WIDE_MAX_LANES)
        c = dict(kernels.launches)
        path_launches(c, (row,), f"wide limit {mode}")
        for k, n in c.items():
            counts[k] += n
        check(drops(out) == 0 and not out["exhausted"].any(),
              f"{WIDE_MAX_NODES}-node {mode} dropped or exhausted")
        check(np.all(out["node_act"].sum(1) == WIDE_MAX_ACTS),
              "activations lost")
        check(np.allclose(out["reward"].sum(1), out["progress"]),
              "rewards do not sum to the chain")
        report[row]["steps"] = int(out["steps"].sum())
    over = bench_clique(WIDE_MAX_NODES + 1, NET_PROP)
    kernels.reset_launches()
    refused = []
    for make in (lambda: netsim.Engine(over, activations=10, mode="scan"),
                 lambda: netsim.Engine(over, activations=10, mode="event"),
                 lambda: netsim.Engine(over, protocol="bk", k=2,
                                       activations=10),
                 lambda: netsim.AttackEngine(over, activations=10)):
        try:
            make()
        except NotImplementedError as e:
            refused.append(str(e))
        else:
            raise AssertionError(f"{over.n} nodes accepted on the card")
    check(all("item 11b" in r and f"at most {E.KERNEL_MAX_NODES}" in r
              and r.startswith("K1") for r in refused),
          f"refusals: {refused}")
    check(not nonzero(kernels.launches), "a refused network launched")
    hold = hold_wide(dev, report, ahead, "e-")
    say("wide_limit", nodes=WIDE_MAX_NODES, refused_nodes=over.n,
        refusal=json.dumps(refused[0]), plain_s=json.dumps(hold),
        launches=json.dumps(nonzero(counts)))
    return counts


def phase_wide_times(dev, report):
    """Phase 79: each widened kernel's device time a launch at its path's
    shape, the L2 scrubbed, by CUDA events around the wrapper call (3
    calls); the bound: the threefry work of the run's steps (a 5- or
    4-way split a step, N + 1 blocks an activation and, Bk, one more for
    the vote's hash, 2 at init; K12-scan the gaps, the Gumbel rows and
    the key splits) and the lanes' inputs and outputs."""
    from cpr_tpu_torch import kernels, netsim
    hn = lane_inputs([HN_SEED] * len(HN_DELAYS), HN_DELAYS, dev)
    c64 = bench_clique(WIDE_HN_NODES, HN_PROP)
    # per lane: key and delay in; nine int32 counters, exhausted,
    # sim_time, node_act and reward [N] out
    io_bytes = lambda lanes, n: lanes * (61 + n * 8)  # noqa: E731

    def event_bound(eng, inputs, split, per_act, steps=None):
        lanes = inputs[0].shape[0]
        if steps is None:
            steps = int(eng.lanes(*inputs)["steps"].sum())
        return bound_ms(io_bytes(lanes, eng.net.n), THREEFRY_OPS * (
            split * steps + lanes * eng.activations * per_act + 2 * lanes))

    cases = []
    eng = proto_engine("nakamoto", 1, "constant", HN_ACTS, c64)
    cases.append(("K12-scan-n256", eng, hn, bound_ms(
        io_bytes(5, c64.n), 5 * THREEFRY_OPS * (5 + (HN_ACTS + 1)
                                                + HN_ACTS * c64.n))))
    for kern, cfgs in PROTO_CONFIGS.items():
        proto, k, scheme = cfgs[0]
        eng = proto_engine(proto, k, scheme, HN_ACTS, c64)
        cases.append((f"{kern}-n64", eng, hn, event_bound(
            eng, hn, 5, c64.n + (2 if proto == "bk" else 1))))
    cn = pa_net()
    # paths (b), (c) and (e): the steps of the path's own run
    for proto, k, lanes, acts, row in PA_RUNS:
        eng = pa_engine(cn, proto, k, acts)
        inputs = lane_inputs(range(lanes), [cn.activation_delay] * lanes, dev)
        cases.append((row, eng, inputs, event_bound(
            eng, inputs, 5, cn.n + (2 if proto == "bk" else 1),
            report[row]["steps"])))
    eng = sm_engine(sm_net(), SM_ACTS)
    al, pi, _ = attack_lanes(SM_LANES)
    inputs = sm_inputs(range(SM_LANES), al, pi, dev)
    cases.append(("K13-n128", eng, inputs, event_bound(
        eng, inputs, 4, eng.net.n + 1, report["K13-n128"]["steps"])))
    cm = bench_clique(WIDE_MAX_NODES, NET_PROP)
    mi = lane_inputs(range(WIDE_MAX_LANES), [NET_ACT_DELAY] * WIDE_MAX_LANES,
                     dev)
    eng = netsim.Engine(cm, activations=WIDE_MAX_ACTS, mode="scan")
    cases.append(("K12-scan-n256@256", eng, mi, bound_ms(
        io_bytes(WIDE_MAX_LANES, cm.n), WIDE_MAX_LANES * THREEFRY_OPS
        * (5 + (WIDE_MAX_ACTS + 1) + WIDE_MAX_ACTS * cm.n))))
    eng = netsim.Engine(cm, activations=WIDE_MAX_ACTS, mode="event")
    cases.append(("K12-event-n256", eng, mi, event_bound(
        eng, mi, 5, cm.n + 1, report["K12-event-n256"]["steps"])))
    side = {}  # K12-scan-n256 at path (e)'s shape, printed beside its row
    for row, eng, inputs, (bound, by) in cases:
        r = report[row] if row in report else side.setdefault(row, {})
        # the paths ran these shapes: Bk's 4 s launch once, unwarmed
        heavy = row == "K12-event-bk-n128"
        r["ms"] = event_ms(lambda: eng.lanes(*inputs), 1 if heavy else 3,
                           warm=not heavy)
        r["bound_ms"], r["bound_by"] = bound, by
    kernels.reset_launches()
    say("wide_times", **{k: json.dumps(
        {f: (report[k] if k in report else side[k]).get(f)
         for f in ("ms", "plain_ms", "plain_shape", "bound_ms", "bound_by")})
        for k, *_ in cases})


# -- the sharded solvers and lanes (K16, phases 80-87) ---------------------------

SHARD_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_shard_golden.npz"
SHARDS = 4  # the mesh's shards, all on the card
# the transition-sharded solves' tolerance against cpr_tpu and the
# single-device solve: the reference's own (tests/test_mdp.py:105-129)
SHARD_RTOL, SHARD_ATOL, SHARD_GAP = 1e-6, 1e-7, 1e-4
SHARD_TICKS = 64
SHARD_STREAM_CHUNK = 550  # 4 chunks of the SM1 stream
SHARD_FX_TABLES = ("fc16", "aft20", "gd5")
SHARD_FX_PSUM = ("fc16_25", "gd5")
SHARD_FX_GRID = ((0.3, 0.4), (0.25, 0.75))


def card_mesh(dev, n=SHARDS):
    from cpr_tpu_torch.parallel import default_mesh
    return default_mesh(devices=[dev] * n)


def grid_mesh(dev):
    """The 2 x 2 ("g", "s") mesh of grid x state shards on one card."""
    from cpr_tpu_torch.parallel import Mesh
    return Mesh(np.array([[dev] * 2] * 2, dtype=object), ("g", "s"))


def fixture_table(fx, pre, dev):
    from cpr_tpu_torch import convert
    S, A = (int(x) for x in fx[f"{pre}_shape"])
    return convert.tensor_mdp(S, A, *(fx[f"{pre}_{f}"] for f in (
        "start", "src", "act", "dst", "prob", "reward", "progress")),
        device=dev)


def arrays_digest(*arrays):
    import hashlib
    h = hashlib.sha256()
    for x in arrays:
        h.update(np.ascontiguousarray(x).tobytes())
    return np.frombuffer(h.digest(), np.uint8)


def k16_rows(report):
    csrc = "cpr_tpu_torch/csrc/shard_sweep.cu"
    report["K16-state"] = dict(
        name=f"K16-state state-sharded Bellman sweep ({SHARDS} shards on "
             "one card, one launch a shard a sweep; ms: a sweep of the "
             "capstone's blocks, padded to 1,188,252 states)",
        route="cuda", source=csrc,
        replaces="cpr_tpu/parallel/state_shard.py:195", max_abs_err=0.0)
    report["K16-psum"] = dict(
        name=f"K16-psum transition-sharded sweep ({SHARDS} shards' partial "
             "Q planes, then their sum in shard order and the backup; ms: "
             "a sweep of the capstone, 5 launches)",
        route="cuda", source=csrc,
        replaces="cpr_tpu/parallel/__init__.py:196", max_abs_err=0.0)
    report["K16-grid"] = dict(
        name="K16-grid grid x state sweep (2 x 2 shards; ms: a sweep of "
             "the 12-point grid over the capstone's structure, 4 launches)",
        route="cuda", source=csrc,
        replaces="cpr_tpu/parallel/state_shard.py:319", max_abs_err=0.0)


def phase_shard_fixture(dev, fx):
    """Phase 80: each K16 kernel on the fixture's tables against
    cpr_tpu's results (tests/fixtures/torch_port_shard_golden.npz)."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.mdp.grid import (compile_protocol,
                                        grid_value_iteration, param_ptmdp)
    from cpr_tpu_torch.parallel import (sharded_state_value_iteration,
                                        sharded_value_iteration)
    kernels.reset_launches()
    mesh = card_mesh(dev)
    sweeps, err, ties = {}, 0.0, 0
    for name in SHARD_FX_TABLES:
        tm = fixture_table(fx, name, dev)
        got = sharded_state_value_iteration(tm, mesh, stop_delta=MDP_STOP,
                                            pad_states=True)
        for k in ("value", "progress", "policy", "residuals"):
            check(np.array_equal(got[f"vi_{k}"], fx[f"{name}_state_{k}"]),
                  f"K16-state {name}: {k} differs from cpr_tpu's")
        check(got["vi_iter"] == int(fx[f"{name}_state_iter"]),
              f"K16-state {name}: {got['vi_iter']} sweeps, cpr_tpu "
              f"{int(fx[f'{name}_state_iter'])}")
        sweeps[f"state_{name}"] = got["vi_iter"]
    pm = param_ptmdp(compile_protocol("aft20", cutoff=6), horizon=20)
    check(np.array_equal(arrays_digest(
        *pm.mdp.arrays(), pm.coef, pm.expo, pm.start_ids, pm.start_coef,
        pm.start_expo), fx["grid_digest"]),
        "shard fixture: the port's parametric compile differs")
    vi = grid_value_iteration(pm, *SHARD_FX_GRID, stop_delta=MDP_STOP,
                              mesh=grid_mesh(dev), axis="g", state_axis="s")
    for k in ("grid_value", "grid_progress", "grid_policy", "grid_iter",
              "vi_residuals"):
        check(np.array_equal(vi[k], fx[f"grid_{k}"]),
              f"K16-grid: {k} differs from cpr_tpu's")
    check(vi["vi_iter"] == int(fx["grid_vi_iter"]), "K16-grid: sweeps")
    sweeps["grid"] = vi["vi_iter"]
    for name in SHARD_FX_PSUM:
        pre = f"psum_{name}"
        tm = fixture_table(fx, pre, dev)
        sure = fx[f"{pre}_gap"] > SHARD_GAP
        for impl in ("while", "chunked"):
            got = sharded_value_iteration(tm, mesh, stop_delta=MDP_STOP,
                                          impl=impl)
            for k in ("value", "progress"):
                want = fx[f"{pre}_{impl}_{k}"]
                d = np.abs(got[f"vi_{k}"] - want)
                check(bool((d <= SHARD_ATOL + SHARD_RTOL
                            * np.abs(want)).all()),
                      f"K16-psum {name} {impl}: {k} beyond rtol "
                      f"{SHARD_RTOL} of cpr_tpu's ({float(d.max())})")
                err = max(err, float(d.max()))
            check(np.array_equal(got["vi_policy"][sure],
                                 fx[f"{pre}_{impl}_policy"][sure]),
                  f"K16-psum {name} {impl}: policy differs where the "
                  "Q-gap decides")
            ties += int((~sure).sum())
            sweeps[f"psum_{name}_{impl}"] = [
                got["vi_iter"], int(fx[f"{pre}_{impl}_iter"])]
    counts = dict(kernels.launches)
    path_launches(counts, ("K16-state", "K16-grid", "K16-psum"),
                  "shard fixture")
    say("shard_fixture", shards=SHARDS, psum_max_abs_err=err,
        psum_policy_ties=ties, sweeps=json.dumps(sweeps), ok=True)


def phase_shard_capstone(dev, tm, capstone_rev):
    """Phase 81: the capstone state-sharded at full width, against the
    K4 chunked solve at the same chunk and the 1-shard solve, bit for
    bit; its event; the uneven refusal."""
    from cpr_tpu_torch import kernels, telemetry
    from cpr_tpu_torch.mdp.explicit import vi_chunked
    from cpr_tpu_torch.parallel import (sharded_state_value_iteration,
                                        state_halo_bytes)
    S = tm.n_states
    stop = tm._cast(MDP_STOP)
    t0 = time.perf_counter()
    v, p, pol, _, it, _ = vi_chunked(tm, 1.0, stop, 1 << 30,
                                     chunk=MDP_CHUNK)
    torch.cuda.synchronize()
    k4_s = time.perf_counter() - t0
    want = dict(vi_value=v.cpu().numpy(), vi_progress=p.cpu().numpy(),
                vi_policy=pol.cpu().numpy())
    buf = io.StringIO()
    telemetry.configure(stream=buf)
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = sharded_state_value_iteration(
            tm, card_mesh(dev), stop_delta=MDP_STOP, pad_states=True,
            chunk=MDP_CHUNK, protocol="ghostdag", cutoff=MDP_CUTOFF)
        solve_s = time.perf_counter() - t0
        counts = dict(kernels.launches)
    finally:
        telemetry.configure()
    path_launches(counts, ("K16-state",), "state-sharded capstone")
    check(got["vi_delta"] <= stop, f"state-sharded capstone: delta "
          f"{got['vi_delta']} after {got['vi_iter']} sweeps")
    for k in want:
        check(np.array_equal(got[k], want[k]),
              f"state-sharded capstone: {k} differs from K4's chunked solve")
    check(got["vi_iter"] == it, f"state-sharded capstone: {got['vi_iter']} "
          f"sweeps, K4 {it}")
    S_pad = S + (-S % SHARDS)
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    solves = [e for e in events if e.get("name") == "mdp_solve"]
    check(len(solves) == 1 and solves[0]["state_shards"] == SHARDS
          and solves[0]["halo_bytes"] == state_halo_bytes(
              S_pad, SHARDS, torch.float32) > 0,
          f"state-sharded capstone: its mdp_solve event {solves}")
    one = sharded_state_value_iteration(tm, card_mesh(dev, 1),
                                        stop_delta=MDP_STOP,
                                        chunk=MDP_CHUNK)
    check(all(np.array_equal(one[k], got[k]) for k in want)
          and one["vi_iter"] == got["vi_iter"],
          "state-sharded capstone: 1 shard differs from 4")
    rev = mdp_revenue(tm, got["vi_value"], got["vi_progress"])
    check(abs(rev - capstone_rev) <= 1e-5
          and abs(rev - MDP_REVENUE) <= MDP_REVENUE_TOL,
          f"state-sharded revenue {rev} vs {capstone_rev}")
    try:
        sharded_state_value_iteration(tm, card_mesh(dev, 3),
                                      stop_delta=MDP_STOP)
        refused = ""
    except ValueError as e:
        refused = str(e)
    check(f"cannot shard {S} states" in refused and "3 devices" in refused,
          f"3 shards without padding not refused by name: {refused!r}")
    say("shard_state", states=S, padded=S_pad, shards=SHARDS,
        sweeps=got["vi_iter"], solve_s=solve_s,
        sweeps_per_s=got["vi_iter"] / solve_s, k4_chunked_s=k4_s,
        revenue=rev, halo_bytes=solves[0]["halo_bytes"],
        refused=json.dumps(refused), launches=json.dumps(nonzero(counts)), ok=True)
    return counts, got["vi_iter"]


def phase_shard_psum(dev, tm, capstone_vi, capstone_rev, battery_rows):
    """Phase 82: the capstone transition-sharded, while and chunked with
    Anderson mixing, against phase 8's while solve; one measure_rows row
    over the mesh against phase 9's."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.experiments import measure_rows, model_battery
    from cpr_tpu_torch.parallel import sharded_value_iteration
    mesh = card_mesh(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    w = sharded_value_iteration(tm, mesh, stop_delta=MDP_STOP)
    while_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = sharded_value_iteration(tm, mesh, stop_delta=MDP_STOP,
                                impl="chunked", accel_m=3, chunk=MDP_CHUNK)
    chunked_s = time.perf_counter() - t0
    counts = dict(kernels.launches)
    path_launches(counts, ("K16-psum",), "transition-sharded capstone")
    stop = tm._cast(MDP_STOP)
    revs = {}
    for tag, r in (("while", w), ("chunked", c)):
        check(r["vi_delta"] <= stop, f"psum {tag}: delta {r['vi_delta']}")
        revs[tag] = mdp_revenue(tm, r["vi_value"], r["vi_progress"])
        check(abs(revs[tag] - capstone_rev) <= 1e-5,
              f"psum {tag} revenue {revs[tag]} vs {capstone_rev}")
    err = 0.0
    for k in ("vi_value", "vi_progress"):
        want = capstone_vi[k]
        d = np.abs(w[k] - want)
        check(bool((d <= SHARD_ATOL + SHARD_RTOL * np.abs(want)).all()),
              f"psum while: {k} beyond rtol {SHARD_RTOL} of the single "
              f"device's ({float(d.max())})")
        err = max(err, float(d.max()))
    mask = tm.valid_actions()
    qv = q_planes(tm, 1.0, torch.from_numpy(capstone_vi["vi_value"]).to(dev))
    sure = sure_states(mask[0], qv, SHARD_GAP).cpu().numpy()
    check(np.array_equal(w["vi_policy"][sure],
                         capstone_vi["vi_policy"][sure]),
          "psum while: policy differs where the Q-gap decides")
    chunked_rel = float(np.max(np.abs(c["vi_value"] - capstone_vi["vi_value"])
                               / (1 + np.abs(capstone_vi["vi_value"]))))
    kernels.reset_launches()
    entry = model_battery(alphas=(0.33,), gamma=MDP_GAMMA)[0]
    t0 = time.perf_counter()
    (row,) = measure_rows([entry], horizon=MDP_HORIZON, stop_delta=MDP_STOP,
                          mesh=mesh)
    row_s = time.perf_counter() - t0
    rc = dict(kernels.launches)
    path_launches(rc, ("K16-psum",), "measure_rows(mesh=)")
    (base,) = [r for r in battery_rows if r["model"] == row["model"]]
    check(abs(row["revenue"] - base["revenue"]) <= 1e-5,
          f"measure_rows(mesh=) {row['model']}: {row['revenue']} vs "
          f"{base['revenue']}")
    for k, n in rc.items():
        counts[k] += n
    say("shard_psum", shards=SHARDS, while_sweeps=w["vi_iter"],
        while_s=while_s, chunked_sweeps=c["vi_iter"], chunked_s=chunked_s,
        revenue=json.dumps(revs), while_max_abs_err=err,
        chunked_max_rel_vs_while=chunked_rel,
        policy_ties=int((~sure).sum()), row=json.dumps(row), row_s=row_s,
        launches=json.dumps(nonzero(counts)), ok=True)
    return counts, err


def phase_shard_grid(dev, grid_vi, grid_pm):
    """Phase 83: the grid x state 2-D mesh at phase 10's shape against
    phase 10's K7 solve, then the 1-D mesh over G, bit for bit."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.mdp.grid import grid_value_iteration
    keys = ("grid_value", "grid_progress", "grid_policy", "grid_iter",
            "vi_residuals")
    out, secs = [], {}
    for tag, kw, ran in (
            ("grid_x_state", dict(mesh=grid_mesh(dev), axis="g",
                                  state_axis="s"), "K16-grid"),
            ("grid_1d", dict(mesh=card_mesh(dev)), "K7")):
        kernels.reset_launches()
        t0 = time.perf_counter()
        vi = grid_value_iteration(grid_pm, GRID_ALPHAS, GRID_GAMMAS,
                                  stop_delta=MDP_STOP, chunk=GRID_CHUNK,
                                  **kw)
        secs[tag] = time.perf_counter() - t0
        counts = dict(kernels.launches)
        path_launches(counts, (ran,), tag)
        for k in keys:
            check(np.array_equal(vi[k], grid_vi[k]),
                  f"{tag}: {k} differs from the K7 grid solve")
        check(vi["vi_iter"] == grid_vi["vi_iter"], f"{tag}: sweeps")
        out.append(counts)
    say("shard_grid", points=len(GRID_ALPHAS) * len(GRID_GAMMAS),
        sweeps=grid_vi["vi_iter"], solve_s=json.dumps(secs),
        launches=json.dumps([{k: v for k, v in c.items() if v}
                             for c in out]), ok=True)
    return out


def phase_shard_rtdp(dev, tm, capstone_rev, cold_sweeps):
    """Phase 84: `rtdp_sharded_polish` on the capstone (K6, then
    K16-state from its warm start)."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.mdp.rtdp_graph import rtdp_sharded_polish
    kernels.reset_launches()
    t0 = time.perf_counter()
    vi = rtdp_sharded_polish(
        tm, card_mesh(dev), rnd.PRNGKey(RTDP_SEED, device="cpu"),
        rtdp_steps=RTDP_STEPS, batch=RTDP_BATCH, buffer=RTDP_BUFFER,
        eps=RTDP_EPS, restart_p=RTDP_RESTART_P, rtdp_stop_delta=RTDP_STOP,
        stop_delta=MDP_STOP, pad_states=True, chunk=MDP_CHUNK)
    secs = time.perf_counter() - t0
    counts = dict(kernels.launches)
    path_launches(counts, ("K6", "K16-state"), "rtdp_sharded_polish")
    check(vi["vi_delta"] <= tm._cast(MDP_STOP), "polish did not converge")
    rev = mdp_revenue(tm, vi["vi_value"], vi["vi_progress"])
    check(abs(rev - capstone_rev) <= 1e-5,
          f"polished revenue {rev} vs {capstone_rev}")
    say("shard_rtdp", rtdp_steps=vi["rtdp_steps"], warm_sweeps=vi["vi_iter"],
        cold_sweeps=cold_sweeps, revenue=rev, seconds=secs,
        launches=json.dumps(nonzero(counts)), ok=True)
    return counts


def phase_shard_lanes(dev):
    """Phase 85: the sharded lanes and the sharded SM1 streams at full
    width against the unsharded chains, bit for bit."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.base import EPISODE_KEYS, map_state
    from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
    from cpr_tpu_torch.params import make_params
    from cpr_tpu_torch.parallel import (make_sharded_lane_fns,
                                        make_sharded_rollout_fn)
    env = NakamotoSSZ()
    params = make_params(alpha=0.35, gamma=0.5, max_steps=MAIN_MAX_STEPS)
    sm1 = env.policies["sapirshtein-2016-sm1"]
    L, mesh = MAIN_LANES, card_mesh(dev)
    keys = rnd.split(rnd.PRNGKey(5, dev), L)
    fkeys = rnd.split(rnd.PRNGKey(6, dev), L)
    gen = torch.Generator(device=dev)
    gen.manual_seed(85)
    ticks = [(torch.randint(0, env.n_actions, (L,), generator=gen,
                            device=dev, dtype=torch.int32),
              torch.rand(L, generator=gen, device=dev) < 0.1,
              torch.rand(L, generator=gen, device=dev) < 0.7)
             for _ in range(SHARD_TICKS)]
    torch.cuda.synchronize()
    kernels.reset_launches()
    fns = make_sharded_lane_fns(env, mesh)
    t0 = time.perf_counter()
    carry = fns.init_lanes(keys, params)
    fresh = fns.init_lanes(fkeys, params)
    outs = [fns.step_lanes(carry, a, ad, fresh, st, params)[1]
            for a, ad, st in ticks]
    torch.cuda.synchronize()
    lanes_s = time.perf_counter() - t0
    lane_counts = dict(kernels.launches)
    path_launches(lane_counts, ("K2", "K3"), "sharded lanes")
    check(lane_counts["K3"] == SHARDS * SHARD_TICKS,
          f"K3 launched {lane_counts['K3']} times for {SHARD_TICKS} ticks "
          f"of {SHARDS} shards")
    single = env.init_lanes(keys, params)
    fresh1 = env.init_lanes(fkeys, params)
    for t, (a, ad, st) in enumerate(ticks):
        _, o1 = env.step_lanes(single, a, ad, fresh1, st, params)
        o = outs[t]
        check(all(torch.equal(x, y) for x, y in zip(o[:3], o1[:3]))
              and all(torch.equal(o[3][k], o1[3][k]) for k in o1[3]),
              f"sharded step_lanes tick {t}: outputs differ")
    same = []
    map_state(lambda x, y: same.append(torch.equal(x, y)),
              fns.gather(carry), single)
    check(all(same), "sharded lanes: the carry differs after "
          f"{SHARD_TICKS} ticks")
    held = int(sum(int((~ad & ~st).sum()) for _, ad, st in ticks))
    del outs, ticks

    kernels.reset_launches()
    secs = {}
    runs = {}
    for tag, kw in (("whole", {}), ("chunked", dict(chunk=SHARD_STREAM_CHUNK)),
                    ("metrics", dict(collect_metrics=True))):
        fn = make_sharded_rollout_fn(env, mesh, params, sm1, MAIN_STEPS, **kw)
        t0 = time.perf_counter()
        runs[tag] = fn(keys)
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t0
        if tag == "metrics":
            spec = fn.metrics_spec
    stream_counts = dict(kernels.launches)
    path_launches(stream_counts, ("K2", "K17"), "sharded streams")
    s4m, acc4 = runs["metrics"]
    base = {"whole": env.make_episode_stats_fn(params, sm1, MAIN_STEPS)(keys),
            "chunked": env.make_episode_stats_fn(
                params, sm1, MAIN_STEPS, chunk=SHARD_STREAM_CHUNK)(keys)}
    s1m, acc1 = env.make_episode_stats_fn(params, sm1, MAIN_STEPS,
                                          collect_metrics=True)(keys)
    for tag in ("whole", "chunked"):
        check(all(torch.equal(runs[tag][k], base[tag][k])
                  for k in base[tag]),
              f"sharded stream ({tag}): per-lane stats differ from the "
              "unsharded K2 call")
    check(all(torch.equal(s4m[k], runs["whole"][k]) for k in s4m)
          and torch.equal(acc4, acc1),
          "sharded stream with metrics: stats or accumulator differ")
    st = runs["whole"]
    atk = float(st["episode_reward_attacker"].mean())
    dfn = float(st["episode_reward_defender"].mean())
    rel = atk / (atk + dfn)
    check(SM1_GUARD[0] < rel < SM1_GUARD[1] and all(
        torch.isfinite(st[k]).all() for k in EPISODE_KEYS),
        f"sharded SM1 revenue {rel} outside {SM1_GUARD}")
    say("shard_lanes", lanes=L, shards=SHARDS, ticks=SHARD_TICKS,
        held_lane_ticks=held, lanes_s=lanes_s, stream_s=json.dumps(secs),
        env_steps_per_s=L * MAIN_STEPS / secs["whole"], rel_revenue=rel,
        metrics=json.dumps(spec.summarize(acc4)["env_steps"]),
        launches=json.dumps([nonzero(lane_counts), nonzero(stream_counts)]), ok=True)
    return [lane_counts, stream_counts]


def block_csr(block, n_vec):
    """cuSPARSE's yardstick of a state block: its real rows' probabilities
    as a [s_blk * A, n_vec] CSR matrix (a row a segment key)."""
    t, r = block.table, slice(0, block.n_real)
    seg = t.src[r].to(torch.int64) * t.n_actions + t.act[r]
    n_rows = t.n_states * t.n_actions
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=t.device)
    crow[1:] = torch.cumsum(torch.bincount(seg, minlength=n_rows), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow.to(torch.int32),
                                       t.dst[r].contiguous(),
                                       t.prob[r].contiguous(),
                                       size=(n_rows, n_vec),
                                       check_invariants=False)


def hold_sweeps(kernel, plain, tm, S, sweeps, rtol=1e-5):
    """`sweeps` sweeps of `kernel(v, p) -> (v, p, pol)` from zero, each
    also run by `plain` from the kernel's input: the value within rtol,
    the progress and policy where the Q-gap over `tm` exceeds it (as
    hold_k4_to_plain); the largest difference."""
    mask = tm.valid_actions()
    z = torch.zeros(S, dtype=tm.prob.dtype, device=tm.device)
    v, p, err = z, z.clone(), 0.0
    for j in range(sweeps):
        kv, kp, kpol = kernel(v, p)
        pv, pp, ppol = plain(v, p)
        dv = (kv - pv).abs()
        check(bool((dv <= rtol * (1 + pv.abs())).all()),
              f"sweep {j}: value beyond rtol {rtol} of the plain twin")
        n = tm.n_states
        sure = sure_states(mask[0], q_planes(tm, 1.0, v[:n]), rtol)
        dp = (kp[:n] - pp[:n]).abs()[sure]
        check(bool((dp <= rtol * (1 + pp[:n][sure].abs())).all()),
              f"sweep {j}: progress beyond rtol {rtol} of the plain twin")
        check(torch.equal(kpol[:n][sure], ppol[:n][sure]),
              f"sweep {j}: policy differs from the plain twin")
        err = max(err, float(dv.max()), float(dp.max()) if dp.numel()
                  else 0.0)
        v, p = kv, kp
    return err


def phase_shard_times(dev, report, tm, grid_table, probs):
    """Phase 86: each K16 kernel's device time a sweep at the capstone's
    shapes, L2 scrubbed; the bound, the plain twin's and cuSPARSE's
    times; then each kernel against its plain twin for MDP_TWIN_SWEEPS
    sweeps (launches count nowhere)."""
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.mdp import explicit as E
    from cpr_tpu_torch.parallel import (partition_by_state_block,
                                        psum_ranges)
    from cpr_tpu_torch.parallel import state_shard as SS
    from cpr_tpu_torch.parallel import _PsumPlain
    S, A, dt = tm.n_states, tm.n_actions, tm.prob.dtype
    T, item = int(tm.prob.shape[0]), tm.prob.element_size()
    n = SHARDS
    S_pad = S + (-S % n)
    cols, _, t_blk = partition_by_state_block(tm, n, S_pad)
    blocks = SS.make_blocks(cols, n, t_blk, S_pad // n, A, [dev] * n)
    masks = [SS._block_mask(b) for b in blocks]
    v = [torch.rand(S_pad, dtype=dt, device=dev),
         torch.empty(S_pad, dtype=dt, device=dev)]
    p = [torch.rand(S_pad, dtype=dt, device=dev), torch.empty_like(v[1])]
    pol = torch.empty(S_pad, dtype=torch.int32, device=dev)
    dbits = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    ks = report["K16-state"]
    ks["ms"] = device_ms(lambda: kernels.state_block_sweeps(
        blocks, 1.0, v, p, pol, dbits, 0, 1), 20, "state_block_kernel",
        per_call=n)
    ks["plain_ms"] = event_ms(lambda: [SS._state_block_sweep_plain(
        b, m, 1.0, v[0], p[0]) for b, m in zip(blocks, masks)], 5)
    spmvs = [block_csr(b, S_pad) for b in blocks]
    ks["library_ms"] = event_ms(lambda: [m @ v[0] for m in spmvs], 20)
    seg_index = sum(4 * (b.n_states + 1) + 8 * (b.table.n_segments + 1)
                    + b.table.n_segments for b in blocks)
    # every real row once (dst, prob, reward, progress), the blocks'
    # segment index, V and P read once; V', P' and the policy written
    ks_bytes = T * (4 + 3 * item) + seg_index + 2 * S_pad * item \
        + 2 * S_pad * item + 4 * S_pad
    ks["bound_ms"], ks["bound_by"] = bound_ms(ks_bytes, 8 * T)

    def state_kernel(v0, p0):
        vb = [v0.contiguous().clone(), torch.empty_like(v0)]
        pb = [p0.contiguous().clone(), torch.empty_like(p0)]
        po = torch.empty(S_pad, dtype=torch.int32, device=dev)
        kernels.state_block_sweeps(blocks, 1.0, vb, pb, po, torch.zeros(
            (n, 1), dtype=torch.int64, device=dev), 0, 1)
        return vb[1], pb[1], po

    def state_plain(v0, p0):
        v2, p2 = torch.empty_like(v0), torch.empty_like(p0)
        po = torch.empty(S_pad, dtype=torch.int32, device=dev)
        for b, m in zip(blocks, masks):
            s = slice(b.off, b.off + b.n_states)
            v2[s], p2[s], po[s] = SS._state_block_sweep_plain(b, m, 1.0, v0,
                                                              p0)
        return v2, p2, po

    ks["max_abs_err"] = hold_sweeps(state_kernel, state_plain, tm, S_pad,
                                    MDP_TWIN_SWEEPS)

    rows, ranges = psum_ranges(tm, n)
    n_seg = tm.n_segments
    qv = [torch.zeros(n_seg, dtype=dt, device=dev) for _ in range(n)]
    qp = [torch.zeros(n_seg, dtype=dt, device=dev) for _ in range(n)]
    vs = [v[0][:S].contiguous(), torch.empty(S, dtype=dt, device=dev)]
    ps = [p[0][:S].contiguous(), torch.empty(S, dtype=dt, device=dev)]
    pols = torch.empty(S, dtype=torch.int32, device=dev)
    c = E._Ctl(dt, dev, 0)
    kp = report["K16-psum"]

    def psum_launch(vb=vs, pb=ps, po=pols):
        kernels.psum_sweeps(tm, ranges, True, rows, 1.0, qv, qp, vb, pb, po,
                            c.ctl, c.delta, None, 0, 0, 1, stop_delta=0.0,
                            max_iter=1 << 62, can_stop=False)

    kp["ms"] = device_ms(psum_launch, 20, "psum_", per_call=n + 1)
    twin = _PsumPlain(tm, ranges)
    kp["plain_ms"] = event_ms(lambda: twin.sweep(1.0, vs[0], ps[0]), 5)
    row_seg = twin.row_seg
    libs = []
    for _, r0, r1, k0, k1 in ranges:
        local = row_seg[r0:r1] - k0
        crow = torch.zeros(k1 - k0 + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(local, minlength=k1 - k0), 0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            libs.append(torch.sparse_csr_tensor(
                crow.to(torch.int32), tm.dst[r0:r1].contiguous(),
                tm.prob[r0:r1].contiguous(), size=(k1 - k0, S),
                check_invariants=False))
    kp["library_ms"] = event_ms(lambda: [m @ vs[0] for m in libs], 20)
    touched = sum(k1 - k0 for *_, k0, k1 in ranges)
    # every row once, the segment index, V and P read once, each shard's
    # partial planes of the segments its rows touch written and read
    # once, V', P' and the policy written
    kp_bytes = (T * (4 + 3 * item) + 4 * (S + 1) + 8 * (n_seg + 1) + n_seg
                + 2 * S * item + 4 * touched * item + 2 * S * item + 4 * S)
    kp["bound_ms"], kp["bound_by"] = bound_ms(kp_bytes, 8 * T)

    def psum_kernel(v0, p0):
        vb = [v0.contiguous().clone(), torch.empty_like(v0)]
        pb = [p0.contiguous().clone(), torch.empty_like(p0)]
        po = torch.empty(S, dtype=torch.int32, device=dev)
        c.reset()
        psum_launch(vb, pb, po)
        return vb[1], pb[1], po

    kp["max_abs_err"] = hold_sweeps(
        psum_kernel, lambda v0, p0: twin.sweep(1.0, v0, p0), tm, S,
        MDP_TWIN_SWEEPS)

    G = probs.shape[0]
    shards, G_blk, _ = SS.grid_shards(grid_table, G, probs, grid_mesh(dev),
                                      "g", "s")
    Sg, Tg = grid_table.n_states, int(grid_table.prob.shape[0])
    live = torch.arange(G_blk, dtype=torch.int32, device=dev)
    vg = [torch.rand((G, Sg), device=dev), torch.empty((G, Sg), device=dev)]
    pg = [torch.rand((G, Sg), device=dev), torch.empty((G, Sg), device=dev)]
    polg = torch.empty((G, Sg), dtype=torch.int32, device=dev)

    def grid_launch(vb=vg, pb=pg, po=polg):
        kernels.grid_block_sweeps(
            [(sh.block.table, sh.probs, sh.valid, live, sh.g0, sh.block.off,
              torch.zeros((G_blk, 1), dtype=torch.int64, device=dev))
             for sh in shards], 1.0, vb, pb, po, 0, 1, 1)

    kg = report["K16-grid"]
    kg["ms"] = device_ms(grid_launch, 20, "grid_block_kernel",
                         per_call=len(shards))
    gmasks = {(k, g): SS._block_mask(sh.block, sh.probs[g])
              for k, sh in enumerate(shards) for g in range(G_blk)}

    def grid_plain(vb, pb):
        v2, p2 = torch.empty_like(vb), torch.empty_like(pb)
        po = torch.empty(vb.shape, dtype=torch.int32, device=dev)
        for k, sh in enumerate(shards):
            b = sh.block
            s = slice(b.off, b.off + b.n_states)
            for g in range(G_blk):
                gi = sh.g0 + g
                v2[gi, s], p2[gi, s], po[gi, s] = SS._state_block_sweep_plain(
                    b, gmasks[(k, g)], 1.0, vb[gi], pb[gi], prob=sh.probs[g])
        return v2, p2, po

    kg["plain_ms"] = event_ms(lambda: grid_plain(vg[0], pg[0]), 3)
    gcsr = [(g, block_csr(dataclasses.replace(
        sh.block, table=dataclasses.replace(sh.block.table,
                                            prob=sh.probs[g])), Sg))
            for sh in shards for g in range(G_blk)]
    kg["library_ms"] = event_ms(lambda: [m @ vg[0][0] for _, m in gcsr], 5)
    seg_g = sum(4 * (sh.block.n_states + 1) + 8 * (sh.block.table.n_segments
                                                   + 1) for sh in shards)
    nseg_g = sum(sh.block.table.n_segments for sh in shards) // 2
    # each grid slice reads the shared columns (dst, reward, progress) of
    # every block once and their segment index; each point's probability
    # column and validity; each point's V and P read, V', P' and the
    # policy written
    kg_bytes = (2 * 12 * Tg + seg_g + G * (4 * Tg + nseg_g)
                + G * Sg * (8 + 8 + 4))
    kg["bound_ms"], kg["bound_by"] = bound_ms(kg_bytes, 8 * Tg * G)
    err = 0.0
    vz = torch.zeros((G, Sg), device=dev)
    v0, p0 = vz, vz.clone()
    gmask = [E._valid_actions(grid_table.src, grid_table.act, probs[g], Sg,
                              grid_table.n_actions) for g in range(G)]
    for j in range(MDP_TWIN_SWEEPS):
        vb, pb = [v0.clone(), torch.empty_like(v0)], [p0.clone(),
                                                      torch.empty_like(p0)]
        po = torch.empty((G, Sg), dtype=torch.int32, device=dev)
        grid_launch(vb, pb, po)
        pv, pp, ppol = grid_plain(v0, p0)
        dv = (vb[1] - pv).abs()
        check(bool((dv <= 1e-5 * (1 + pv.abs())).all()),
              f"K16-grid sweep {j}: value beyond rtol 1e-5 of its plain twin")
        for g in range(G):
            sure = sure_states(gmask[g][0], q_plane(grid_table, probs[g], 1.0,
                                                    v0[g]), 1e-5)
            dp = (pb[1][g] - pp[g]).abs()[sure]
            check(bool((dp <= 1e-5 * (1 + pp[g][sure].abs())).all())
                  and torch.equal(po[g][sure], ppol[g][sure]),
                  f"K16-grid sweep {j} point {g}: progress or policy "
                  "differ from its plain twin")
            if dp.numel():
                err = max(err, float(dp.max()))
        err = max(err, float(dv.max()))
        v0, p0 = vb[1], pb[1]
    kg["max_abs_err"] = err
    kernels.reset_launches()
    say("shard_times", shards=n, grid_points=G,
        hold_sweeps=MDP_TWIN_SWEEPS, **{k: json.dumps(
            {f: report[k].get(f) for f in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by",
                                           "max_abs_err")})
            for k in ("K16-state", "K16-psum", "K16-grid")})


def phase_shard_cards(dev, tm):
    """Phase 87: phase 81's solve over distinct cards, where the process
    sees two or more (the cross-card exchange); on one card a line that
    says it did not run."""
    from cpr_tpu_torch.mdp.explicit import vi_chunked
    from cpr_tpu_torch.parallel import (default_mesh,
                                        sharded_state_value_iteration)
    n = torch.cuda.device_count()
    if n < 2:
        say("shard_cards", ran=False,
            why=json.dumps(f"{n} card visible: the cross-card exchange "
                           "needs two or more"))
        return
    mesh = default_mesh(devices=[torch.device("cuda", i)
                                 for i in range(min(n, SHARDS))])
    v, p, pol, _, it, _ = vi_chunked(tm, 1.0, tm._cast(MDP_STOP), 1 << 30,
                                     chunk=MDP_CHUNK)
    got = sharded_state_value_iteration(tm, mesh, stop_delta=MDP_STOP,
                                        pad_states=True, chunk=MDP_CHUNK)
    check(np.array_equal(got["vi_value"], v.cpu().numpy())
          and np.array_equal(got["vi_policy"], pol.cpu().numpy())
          and got["vi_iter"] == it,
          "state-sharded capstone over distinct cards differs from K4's")
    say("shard_cards", ran=True, cards=mesh.size, sweeps=got["vi_iter"],
        ok=True)


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
    # K1 first, then the netsim kernels' plain replays (phases 35, 37, 48)
    # in a child on the otherwise idle card while the rest builds
    kernels.build_dir().mkdir(parents=True, exist_ok=True)
    ahead_dir = tempfile.TemporaryDirectory(dir=kernels.build_dir())
    kernels.build(("random.cu",))
    proc, out = spawn_calls(dev, ahead_dir.name, "plain_ahead", "plain_ahead",
                            [[ahead_dir.name]])
    ahead = dict(proc=proc, out=out, dir=ahead_dir.name)
    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc processes
        gxx = pool.submit(native.build_lib,
                          native.SRC / "generic_compiler.cpp", "-O3")
        paths = kernels.build()
        kernels._load()
        host_lib = gxx.result()
    say("build", seconds=round(time.perf_counter() - t0, 2),
        nvcc_cpu_s=round(sum(kernels.nvcc_cpu_s.values()), 1),
        nvcc_cpu_s_by_source=json.dumps(
            {k: round(v, 1) for k, v in sorted(
                kernels.nvcc_cpu_s.items(), key=lambda kv: -kv[1])}),
        libs=",".join(p.name for p in (*paths.values(), host_lib)))
    # the exact-analysis paths' host compiles (the capstone and its
    # parametric cutoff-8 structure; ctypes releases the GIL) run on the
    # host while the card works through the phases before them (beside
    # nvcc they would slow the build)
    from cpr_tpu_torch.mdp import generic, grid  # noqa: F401 (two
    # threads importing a module at once can deadlock on its lock)
    compiler = ThreadPoolExecutor(2)
    table_future = compiler.submit(capstone_table)
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
    with np.load(FULL_FIXTURE) as f:
        ffx = {k: f[k] for k in f.files}
    with np.load(DAGB_FIXTURE) as f:
        dbfx = {k: f[k] for k in f.files}
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
        # full mode: K8-full and K9-full are device functions of the
        # K10-<env>-full launches, as K8 and K9 of the ring's
        "K8-full": dict(name="K8-full block-DAG primitives in full mode, "
                        "lifted or not: the walks, binary lifting, chain "
                        "and closure releases (device functions run inside "
                        "every K10-<env>-full, launches theirs; ms, plain_ms "
                        "and bound_ms are its check kernel "
                        "dag_script_kernel's)", route="cuda",
                        source=f"{csrc}/dag.cuh",
                        replaces="cpr_tpu/core/dag.py:596"),
        "K9-full": dict(name="K9-full vote quorums without planes: the "
                        "log-doubling frame, the release prefixes and the "
                        "stale walk (device functions inside "
                        "K10-ts-full/-stree-full/-sdag-full, launches "
                        "theirs; ms, plain_ms and bound_ms are its check "
                        "kernel quorum_check_kernel's)", route="cuda",
                        source=f"{csrc}/quorum.cuh",
                        replaces="cpr_tpu/envs/quorum.py:124"),
        **{f"K10-{lib}-full": dict(
            name=f"K10-{lib}-full {what} withholding stream and step_lanes "
                 "in full mode (registry.get's default sizing)",
            route="cuda", source=f"{csrc}/{src}", replaces=at,
            max_abs_err=0.0)
           for lib, what, src, at in (
               ("bk", "Bk", "bk_stream.cu", "cpr_tpu/envs/bk.py:336"),
               ("eth", "Ethereum (lifted)", "ethereum_stream.cu",
                "cpr_tpu/envs/ethereum.py:294"),
               ("ts", "Tailstorm", "tailstorm_stream.cu",
                "cpr_tpu/envs/tailstorm.py:206"),
               ("stree", "Stree and TailstormJune", "stree_stream.cu",
                "cpr_tpu/envs/stree.py:167"),
               ("spar", "Spar", "spar_stream.cu",
                "cpr_tpu/envs/spar.py:140"),
               ("sdag", "Sdag", "sdag_stream.cu",
                "cpr_tpu/envs/sdag.py:155"))},
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
        "K14": dict(name="K14 serve burst (Nakamoto: 131072 lanes x 256 "
                    "steps under SM1, the experience rings on; the policy "
                    "table's scripted, greedy-net and per-lane sampled "
                    "entries)", route="cuda",
                    source=f"{csrc}/nakamoto_stream.cu",
                    replaces="cpr_tpu/serve/engine.py:215"),
        # device functions that K14 runs inside its launches with the
        # rings on: its launches are those, its ms, plain and bound its
        # check kernel's (one step of 131072 lanes, C = 256)
        "K15": dict(name="K15 experience rings (device functions inside "
                    "K14, launches its launches with the rings; ms, "
                    "plain_ms and bound_ms are its check kernel "
                    "record_kernel's)", route="cuda",
                    source=f"{csrc}/exp_ring.cuh",
                    replaces="cpr_tpu/learn/buffer.py:82"),
        "K17": dict(name="K17 device-metrics fold (the cells of the "
                    "episode drivers, rollout, serve bursts and PPO "
                    "updates; ms: the main path's stats fold, "
                    f"{MAIN_LANES} lanes)", route="cuda",
                    source=f"{csrc}/metrics.cu",
                    replaces="cpr_tpu/device_metrics.py:56",
                    max_abs_err=0.0),
        "K14-dag": dict(name="K14-dag serve burst over the DAG envs "
                        "(dag_burst_kernel in every K10 library, ring and "
                        "full; ms: Tailstorm at the server's sizing, 520 "
                        f"slots, {DAG_SERVE_LANES} lanes x "
                        f"{DAG_SERVE_BURST} steps under "
                        f"{DAG_SERVE_POLICY}, the rings on)", route="cuda",
                        source=f"{csrc}/dag_env.cuh",
                        replaces="cpr_tpu/serve/engine.py:215",
                        max_abs_err=0.0),
    }
    netsim_rows = ("K12-scan", "K12-event", "K13", *PROTO_KERNELS)
    wide_rows(report)
    phase_k1(dev, fx, report)
    phase_k3(dev, fx)
    phase_k2(dev, fx)
    torch.cuda.synchronize()
    stream_counts, main_episodes = phase_stream(dev, report)
    gym_counts = phase_gym(dev, report)
    phase_mdp_fixture(dev, mfx)
    phase_grid_fixture(dev, gfx)
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
    mdp_counts, table, policy, compiled, capstone_rev, capstone_vi = \
        phase_mdp_main(dev, report, table_future)
    battery_rows = phase_mdp_battery(dev)
    grid_counts, grid_table, probs, grid_vi, grid_pm = phase_grid(
        dev, report, pm_future, compiled, capstone_rev)
    compiler.shutdown()
    rtdp_counts = phase_rtdp(dev, report, table, capstone_rev)
    phase_k8_full(dev, ffx, report)
    k9_full_carries = phase_k9_full(dev, ffx, report)
    phase_full_lanes(dev, ffx, report)
    full_counts, full_plain_ms = phase_full_streams(dev, ffx, report)
    full_gym = phase_full_gym(dev, report)
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
        r["launches"] = sum(c.get(k, 0) for c in (
            stream_counts, gym_counts, mdp_counts, grid_counts, rtdp_counts,
            bk_counts, bk_gym, eth_counts, eth_gym, ts_counts, ts_gym,
            stree_counts, stree_gym, spar_counts, spar_gym, sdag_counts,
            sdag_gym, *full_counts, full_gym, ppo_counts, *config_counts))
    report["K8"]["launches"] = sum(report[k]["launches"] for k in (
        "K10-bk", "K10-eth", "K10-ts", "K10-stree", "K10-spar", "K10-sdag"))
    report["K9"]["launches"] = sum(report[k]["launches"] for k in (
        "K10-ts", "K10-stree", "K10-sdag"))
    report["K8-full"]["launches"] = sum(
        report[f"K10-{lib}-full"]["launches"]
        for lib in ("bk", "eth", "ts", "stree", "spar", "sdag"))
    report["K9-full"]["launches"] = sum(
        report[f"K10-{lib}-full"]["launches"]
        for lib in ("ts", "stree", "sdag"))
    phase_times(dev, report, main_episodes)
    phase_mdp_times(dev, report, table, policy)
    phase_grid_rtdp_times(dev, report, grid_table, probs)
    phase_dag_times(dev, report, ("bk", "eth"))
    phase_dag_times(dev, report, vote)
    phase_dag_times(dev, report, par)
    phase_k9_times(dev, report, k9_carries)
    phase_full_times(dev, report, k9_full_carries, full_plain_ms)
    phase_k11_times(dev, report, bench_carry)
    phase_k1_f64(dev, nfx, report)
    phase_k12_scan(dev, nfx, report, ahead)
    net_counts, scan_orphan = phase_netsim_path(dev, report, ahead)
    phase_k12_event(dev, nfx, report, ahead)
    event_counts, event_steps = phase_k12_event_path(dev, report,
                                                     scan_orphan)
    phase_k13(dev, nfx, report, ahead)
    attack_counts, attack_steps = phase_attack_path(dev, report, ahead)
    phase_netsim_times(dev, report, event_steps, attack_steps)
    phase_proto_fixture(dev, prfx)
    phase_proto_plain(dev, report, ahead)
    hn_counts = phase_honest_net(dev, report)
    for k in netsim_rows:
        report[k]["launches"] = sum(c[k] for c in (net_counts, event_counts,
                                                   attack_counts, hn_counts))
    phase_proto_times(dev, report)
    serve_counts = phase_serve_full(dev, report)
    with tempfile.TemporaryDirectory(dir=kernels.build_dir()) as tmp:
        serve_counts.append(phase_serve_mixed(dev, report, tmp))
        phase_exp_check(dev, report)
        serve_counts.append(phase_wire(dev, report, tmp))
        serve_counts.extend(phase_learn_loop(dev, report, tmp).values())
        holds = spawn_holds(dev, tmp)
        phase_dag_burst_fixture(dev, dbfx, report)
        serve_counts.append(phase_dag_serve_mixed(dev, report, tmp,
                                                  holds["mixed"]))
        collect_dag_burst(holds["dagb"], report)
        serve_counts.extend(phase_dag_serve(dev, report))
        serve_counts.append(phase_dag_wire(dev, report, tmp))
        phase_dag_burst_times(dev, report)
    # K17 (phases 67-73), each path with the metrics on
    with np.load(METRICS_FIXTURE) as f:
        metrics_fx = {k: f[k] for k in f.files}
    phase_metrics_fixture(dev, metrics_fx, report)
    serve_counts.append(phase_metrics_stream(dev, report))
    serve_counts.append(phase_metrics_chunked(dev, report))
    serve_counts.append(phase_metrics_rollout(dev, report))
    serve_counts.extend(phase_metrics_serve(dev, report))
    serve_counts.append(phase_metrics_ppo(dev, report))
    phase_metrics_netsim(dev, report)
    # the netsim past 32 nodes (phases 74-79)
    with np.load(WIDE_FIXTURE) as f:
        wfx = {k: f[k] for k in f.files}
    phase_wide_fixture(dev, wfx)
    wide_counts = (phase_wide_honest_net(dev, report, ahead),
                   phase_wide_flood(dev, report, ahead),
                   phase_wide_attack(dev, report, ahead),
                   phase_wide_limit(dev, report, ahead))
    phase_wide_times(dev, report)
    for k in WIDE_KERNELS:
        report[k]["launches"] = sum(c.get(k, 0) for c in wide_counts)
    # the sharded solvers and lanes (phases 80-87)
    t_shard = time.perf_counter()
    k16_rows(report)
    with np.load(SHARD_FIXTURE) as f:
        shard_fx = {k: f[k] for k in f.files}
    phase_shard_fixture(dev, shard_fx)
    state_counts, cold_sweeps = phase_shard_capstone(dev, table,
                                                     capstone_rev)
    psum_counts, _ = phase_shard_psum(dev, table, capstone_vi, capstone_rev,
                                      battery_rows)
    serve_counts += [state_counts, psum_counts,
                     *phase_shard_grid(dev, grid_vi, grid_pm),
                     phase_shard_rtdp(dev, table, capstone_rev, cold_sweeps),
                     *phase_shard_lanes(dev)]
    phase_shard_times(dev, report, table, grid_table, probs)
    say("shard_phases", phases="80-86",
        seconds=round(time.perf_counter() - t_shard, 2))
    phase_shard_cards(dev, table)
    for k, r in report.items():
        r["launches"] = r.get("launches", 0) + sum(c.get(k, 0)
                                                   for c in serve_counts)
    report["K14-dag"]["launches"] = sum(
        n for c in serve_counts for k, n in c.items()
        if k.startswith("K14-dag-"))
    for k, v in report.items():
        check(v["ms"] >= v["bound_ms"],
              f"{k} measured {v['ms']} ms, below its bound of "
              f"{v['bound_ms']} ms: the bound is wrong")

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(card, flush=True)  # again, beside the numbers at the end
    # no PyTorch call computes these (K17: several masked reductions)
    for k in ("K1", "K2", "K3", "K14", "K15", "K14-dag", "K17"):
        report[k]["library_ms"] = None
    ahead_dir.cleanup()
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in report.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
