"""The experience plane: per-lane ring buffers for the sampler half of
the always-on learning loop (port of cpr_tpu/learn/buffer.py; kernel
K15).

The rings ride inside the serve burst: on the card K14
(csrc/nakamoto_stream.cu) records every live lane's step with K15's
device functions (csrc/exp_ring.cuh) inside its launch, and the
engine's plain burst calls `record` once a step. Each lane owns its
ring and a write cursor; a step is written for live lanes only, at slot
`cursor % capacity`, so ragged episode boundaries and idle lanes cost
nothing. `consolidate` (host numpy, at a burst boundary) packs only the
lanes whose window filled into a dense [K, capacity] batch for the
feed; partial lanes are counted, not padded.

Key streams: each lane's action-sampling stream is `fold_in` of its
admission key with the stream tag (`experience_stream`), and the
per-step key folds the monotone counter `t` in (`step_keys`), which
survives drains, so no step key is reused.

The rings are a dict of tensors with the reference's lane-major layout
(`init_buffer`), so `consolidate` returns the reference's arrays.
`record` and `step_keys` launch K15's check kernel (csrc/exp_check.cu)
on CUDA tensors and run their plain versions on CPU tensors; the
port updates the rings in place and returns them.
"""

from __future__ import annotations

import numpy as np
import torch

from cpr_tpu_torch import random

# the fold_in stream tag separating sampler-side keys from every other
# consumer of a lane key ("EXP")
EXPERIENCE_STREAM = 0x455850

# per-step ring fields, all lane-major [n_lanes, capacity, ...]
FIELDS = ("obs", "action", "reward", "done", "era", "erd", "policy")


def experience_stream(key: torch.Tensor) -> torch.Tensor:
    """The sampler-side stream of a lane key: fold_in with the stream
    tag, never `split`, so it cannot collide with the key the lane
    spends on env dynamics."""
    return random.fold_in(key, EXPERIENCE_STREAM)


def init_buffer(keys: torch.Tensor, capacity: int, obs_dim: int) -> dict:
    """Fresh rings on the device of `keys`, the [n_lanes, 2] per-lane
    sampler keys (already `experience_stream`-derived); `capacity` the
    ring length in steps."""
    n, cap, dev = keys.shape[0], int(capacity), keys.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(
        obs=torch.zeros((n, cap, int(obs_dim)), **f32),
        action=torch.zeros((n, cap), **i32),
        reward=torch.zeros((n, cap), **f32),
        done=torch.zeros((n, cap), dtype=torch.bool, device=dev),
        # episode aggregates at the recorded step: what the learner's
        # reward transform needs at done rows
        era=torch.zeros((n, cap), **f32),
        erd=torch.zeros((n, cap), **f32),
        policy=torch.zeros((n, cap), **i32),
        cursor=torch.zeros((n,), **i32),
        t=torch.zeros((n,), **i32),
        key=keys.contiguous().clone(),
    )


def step_keys_plain(key: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Plain twin of K15's step keys: fold_in(key[i], t[i]) a lane."""
    x0, x1 = random.threefry_words(key, t.to(torch.int64))
    return random.from_words(torch.stack((x0, x1), dim=-1))


def step_keys(exp: dict) -> torch.Tensor:
    """Per-lane action keys for this step: the lane stream folded by its
    monotone step counter `t` (never reset, unlike the cursor)."""
    if exp["key"].is_cuda:
        from cpr_tpu_torch import kernels
        return kernels.exp_step_keys(exp["key"], exp["t"])
    return step_keys_plain(exp["key"], exp["t"])


def record_plain(exp: dict, live, obs, action, reward, done, era, erd,
                 policy_ids) -> dict:
    """Plain twin of K15's record: each live lane's step at slot
    cursor % capacity, then cursor and t advance on live lanes."""
    cap = exp["action"].shape[1]
    lanes = live.nonzero().squeeze(1)
    idx = exp["cursor"][lanes].to(torch.int64) % cap
    for f, v in (("obs", obs), ("action", action), ("reward", reward),
                 ("done", done), ("era", era), ("erd", erd),
                 ("policy", policy_ids)):
        exp[f][lanes, idx] = v[lanes].to(exp[f].dtype)
    live_i = live.to(torch.int32)
    exp["cursor"] += live_i
    exp["t"] += live_i
    return exp


def record(exp: dict, live, obs, action, reward, done, info,
           policy_ids) -> dict:
    """Record one burst step for every live lane (the pre-step obs, the
    action taken from it, the step's reward and done, the episode
    rewards of `info` at the step, each lane's policy id). K15's check
    kernel on CUDA tensors, `record_plain` on CPU tensors; `exp` is
    updated in place and returned."""
    era = info["episode_reward_attacker"].to(torch.float32)
    erd = info["episode_reward_defender"].to(torch.float32)
    if live.is_cuda:
        from cpr_tpu_torch import kernels
        return kernels.exp_record(
            exp, live, obs.to(torch.float32).contiguous(),
            action.to(torch.int32).contiguous(),
            reward.to(torch.float32).contiguous(), done.contiguous(),
            era.contiguous(), erd.contiguous(),
            policy_ids.to(torch.int32).contiguous())
    return record_plain(exp, live, obs, action, reward, done, era, erd,
                        policy_ids)


def consolidate(host: dict, last_obs: np.ndarray) -> dict:
    """Pack host-fetched rings (numpy) into a dense feed batch.

    Only lanes whose window filled (cursor >= capacity) are packed; a
    wrapped ring is unrolled oldest-first so each window is in time
    order. Partial lanes are dropped and counted (`partial`,
    `dropped_steps`), never padded. `last_obs` is the [n_lanes, obs_dim]
    current lane observation, the bootstrap observation after each full
    window. The reference loops over lanes; this gathers all full lanes
    at once and returns the same arrays.

    Returns {lanes, obs, action, reward, done, era, erd, policy,
    last_obs, steps, partial, dropped_steps} with leading axis K = the
    number of full lanes."""
    cursor = np.asarray(host["cursor"])
    cap = np.asarray(host["action"]).shape[1]
    full = np.nonzero(cursor >= cap)[0]
    part = cursor[(cursor > 0) & (cursor < cap)]
    # row k of `order`: lane full[k]'s slots, oldest first
    order = (np.arange(cap)[None, :] + cursor[full, None]) % cap
    batch = {}
    for k in FIELDS:
        rows = np.asarray(host[k])[full]
        idx = order.reshape(order.shape + (1,) * (rows.ndim - 2))
        batch[k] = np.take_along_axis(rows, idx, axis=1)
    batch["lanes"] = full.astype(np.int32)
    last_obs = np.asarray(last_obs)
    batch["last_obs"] = (last_obs[full] if full.size
                         else np.zeros((0,) + last_obs.shape[1:],
                                       np.float32))
    batch["steps"] = int(full.size) * cap
    batch["partial"] = int(part.size)
    batch["dropped_steps"] = int(part.sum())
    return batch
