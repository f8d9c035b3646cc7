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
     a time below the bound fails.
Then the kernels line (JSON: launches summed over the two paths, the
error of the main-shape comparison, the times and the bound) and the
last line {"ok": true, "device": {...}}.

Tolerances: integer state, keys, actions, done and integer-valued
rewards bit-identical; time fields rtol 1e-5 (log1pf differs from the
other implementation by ULPs and the float32 sum carries it); unit
observations atol 1e-6 (atanf); K1 exponential within 2 ULP of the plain
version on the card and 4 ULP of XLA's on the CPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_golden.npz"

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


def say(phase, **kw):
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
    `kernel`, from torch.profiler's CUPTI trace of `reps` calls of `fn`.

    Before each call a fill of L2_SCRUB_BYTES leaves the L2 cache full of
    dirty lines of another buffer: the kernel reads its inputs from HBM
    and its writes evict lines that go back to HBM, as they would for a
    caller that did other work between calls. Raises if the trace holds
    no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    scrub = torch.empty(L2_SCRUB_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            scrub.fill_(float(i))
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
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
        {**{f: v[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "call_ms": call_ms.get(k)})
        for k, v in report.items()})
    for k, v in report.items():
        check(v["ms"] >= v["bound_ms"],
              f"{k} measured {v['ms']} ms, below its bound of "
              f"{v['bound_ms']} ms: the bound is wrong")


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

    t0 = time.perf_counter()
    paths = kernels.build()
    kernels._load()
    say("build", seconds=round(time.perf_counter() - t0, 2),
        libs=",".join(p.name for p in paths.values()))

    with np.load(FIXTURE) as f:
        fx = {k: f[k] for k in f.files}
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
    }
    phase_k1(dev, fx, report)
    phase_k3(dev, fx)
    phase_k2(dev, fx)
    torch.cuda.synchronize()
    stream_counts, main_episodes = phase_stream(dev, report)
    gym_counts = phase_gym(dev, report)
    for k, r in report.items():
        r["launches"] = stream_counts[k] + gym_counts[k]
    phase_times(dev, report, main_episodes)

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for r in report.values():
        r["library_ms"] = None  # no single PyTorch call computes these
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in report.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
