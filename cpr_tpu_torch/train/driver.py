"""Config-driven PPO training: schedules, per-alpha eval, checkpoints
(port of cpr_tpu/train/driver.py).

Reference counterpart: experiments/train/ppo.py — alpha schedules
(:105-141), reward shaping raw/cut/exp (:217-244), the per-alpha
EvalCallback aggregation (:296-374), and model / best-model / last-model
checkpoints (:429-453). The lanes of one env batch carry the schedule
(`make_train(per_env_params=True)`); the eval runs the greedy net
through the stats driver (K2/K10 with K11-act on the card); checkpoints
and policy snapshots are flax's msgpack bytes in the sealed envelope,
so a file from either package loads in both.

Left for later, raising NotImplementedError with their ROADMAP item:
resumable train snapshots and preemption (`resume`, `snapshot_freq`:
item 6), the live metrics endpoint (`metrics_port`: item 12), the mesh
(item 13).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Callable

import numpy as np
import torch

from cpr_tpu_torch import (_device, convert, device_metrics, random,
                           resilience, telemetry)
from cpr_tpu_torch.envs.assumption import AssumptionEnv
from cpr_tpu_torch.envs.registry import get_sized
from cpr_tpu_torch.params import FIELDS as PARAM_FIELDS
from cpr_tpu_torch.params import stack_params
from cpr_tpu_torch.train import serialization
from cpr_tpu_torch.train.config import TrainConfig
from cpr_tpu_torch.train.ppo import (ActorCritic, NetPolicy, PPOConfig,
                                     make_train, maybe_checkify)

# Dense per-progress episodes terminate at target *progress*; max_steps
# is only a runaway guard, 4x the target (the reference's reasons,
# driver.py:36-43)
DENSE_RUNAWAY_FACTOR = 4

def _stack_params(alphas, gamma, episode_len, *, dense=False):
    if dense:
        return stack_params([dict(alpha=float(a), gamma=gamma,
                                  max_steps=(DENSE_RUNAWAY_FACTOR
                                             * episode_len),
                                  max_progress=float(episode_len))
                             for a in alphas])
    return stack_params([dict(alpha=float(a), gamma=gamma,
                              max_steps=episode_len) for a in alphas])


def make_reward_transform(cfg: TrainConfig, lane_alphas,
                          device=None) -> Callable:
    """Sparse objective + shaping + 1/alpha normalization
    (ppo.py:217-244; wrappers.py:8-51), elementwise over a trajectory
    [T, N] or a step [N].

    The reference divides by the lanes' alphas and by the episode length,
    constants of its compiled program, and XLA's algebraic simplifier
    turns a division by a constant into a product with the constant's
    float32 reciprocal; so here the shaped reward is multiplied by
    `1 / alphas` and `1 / h`, rounded to float32, which gives its bits."""
    alphas = torch.as_tensor(np.asarray(lane_alphas), dtype=torch.float32,
                             device=_device.resolve(device))
    inv_alphas = 1.0 / alphas
    inv_h = float(np.float32(1.0) / np.float32(cfg.episode_len))

    def transform(reward, info, done):
        a = info["episode_reward_attacker"]
        d = info["episode_reward_defender"]
        p = info["episode_progress"]
        zero = torch.zeros_like(a)
        one = torch.ones_like(a)
        if cfg.reward == "dense_per_progress":
            step = info["step_reward_attacker"] * inv_h
            corr = torch.where(done, a / torch.where(p != 0, p, one)
                               - a * inv_h, zero)
            return (step + corr) * inv_alphas
        if cfg.reward == "sparse_relative":
            s = a + d
            base = torch.where(s != 0, a / torch.where(s != 0, s, one),
                               zero)
        else:  # sparse_per_progress
            base = torch.where(p != 0, a / torch.where(p != 0, p, one),
                               zero)
        if cfg.shape == "cut":
            # punish honest-looking behaviour (ppo.py:224-236)
            orphans = torch.where(p > 0, info["episode_n_activations"] / p,
                                  torch.full_like(a, math.inf))
            base = torch.where((base > 0) & (orphans <= 1.05), base * 0.9,
                               base)
        elif cfg.shape == "exp":
            base = torch.where(base > 0, torch.exp(base - 1.0), zero)
        return torch.where(done, base * inv_alphas, zero)

    return transform


def ppo_config(cfg: TrainConfig) -> PPOConfig:
    p = cfg.ppo
    return PPOConfig(
        n_envs=cfg.n_envs, n_steps=p.n_steps, lr=p.lr, gamma=p.gamma,
        gae_lambda=p.gae_lambda, clip_eps=p.clip_eps,
        entropy_coef=p.ent_coef, vf_coef=p.vf_coef,
        update_epochs=p.update_epochs, n_minibatches=p.n_minibatches,
        hidden=tuple([p.layer_size] * p.n_layers),
        anneal_lr=p.anneal_lr, total_updates=cfg.total_updates,
        target_kl=p.target_kl)


def build_env(cfg: TrainConfig, device=None):
    """The config's env, sized for its episodes as the reference's driver
    sizes it (a DAG env in full mode, which K10-<env>-full runs on CUDA),
    wrapped in `AssumptionEnv` when alpha is scheduled. The env is the
    same on every device; `device` is taken for the callers' symmetry."""
    del device
    hint = cfg.episode_len * (
        DENSE_RUNAWAY_FACTOR if cfg.reward == "dense_per_progress" else 1)
    env = get_sized(cfg.protocol, hint)
    if cfg.alpha_is_scheduled():
        env = AssumptionEnv(env)
    return env


def _lane_params(params, reps: int):
    """Each field's lane axis repeated `reps` times, lane by lane."""
    return params.replace(**{
        f: torch.repeat_interleave(getattr(params, f), reps)
        for f in PARAM_FIELDS})


def evaluate_per_alpha(env, cfg: TrainConfig, net: ActorCritic, *,
                       episodes_per_alpha=None, seed=1):
    """Greedy-policy evaluation on the eval alpha grid, one stats-driver
    call over (alphas x episodes) lanes (ppo.py:296-374; the reference's
    driver.py:150-179). The lanes run on the net's device. Returns one
    row per alpha."""
    dev = net.flat.device
    alphas = cfg.eval_alphas()
    reps = episodes_per_alpha or cfg.eval.episodes_per_alpha
    dense = cfg.reward == "dense_per_progress"
    params = _lane_params(
        _stack_params(alphas, cfg.gamma, cfg.episode_len, dense=dense), reps)
    n_steps = cfg.episode_len * (DENSE_RUNAWAY_FACTOR if dense else 1) + 8
    keys = random.split(random.PRNGKey(seed, dev), len(alphas) * reps)
    stats = env.make_episode_stats_fn(params, NetPolicy(net, greedy=True),
                                      n_steps)(keys)
    grid = {k: stats[k].reshape(len(alphas), reps).cpu().numpy()
            for k in ("episode_reward_attacker", "episode_reward_defender",
                      "episode_progress")}
    rows = []
    for i, a in enumerate(alphas):
        atk = float(grid["episode_reward_attacker"][i].mean())
        dfn = float(grid["episode_reward_defender"][i].mean())
        prg = float(grid["episode_progress"][i].mean())
        rows.append({
            "alpha": float(a),
            "gamma": cfg.gamma,
            "relative_reward": atk / (atk + dfn) if atk + dfn else 0.0,
            "reward_per_progress": atk / prg if prg else 0.0,
            "episode_progress": prg,
        })
    return rows


def _net_bytes(net: ActorCritic) -> bytes:
    return serialization.to_bytes(convert.actor_critic_to_flax(
        net.flat, net.obs_dim, net.n_actions, net.hidden))


def save_checkpoint(path: str, net: ActorCritic, meta: dict | None = None,
                    *, site: str = "checkpoint"):
    """Sealed atomic params checkpoint: flax's msgpack of the params
    tree in the checksummed envelope; the meta sidecar (with the
    payload's sha256) lands before the model."""
    data = _net_bytes(net)
    if meta is not None:
        meta = dict(meta, payload_sha256=hashlib.sha256(data).hexdigest())
        resilience.atomic_write_json(path + ".json", meta)
    resilience.sealed_write(path, data, site=site)


def _net_from_payload(path, payload, obs_dim, n_actions, hidden, device,
                      kind):
    from cpr_tpu_torch.integrity import IntegrityError
    net = ActorCritic(obs_dim, n_actions, hidden, device=device)
    try:
        flat = convert.actor_critic_from_flax(
            serialization.from_bytes(payload), device)
        if flat.numel() != net.n_params:
            raise ValueError(f"{flat.numel()} parameters, the net has "
                             f"{net.n_params}")
    except IntegrityError:
        raise
    except Exception as e:  # a garbled payload, no fingerprint
        raise resilience.reject_undecodable(path, kind=kind, err=e,
                                            action="refused") from e
    with torch.no_grad():
        net.flat.copy_(flat)
    return net


def load_checkpoint(path: str, env, cfg: TrainConfig, device=None):
    """The ActorCritic of a checkpoint written by either package."""
    payload, _ = resilience.sealed_read(path, kind="model_checkpoint",
                                        action="refused")
    return _net_from_payload(path, payload, env.observation_length,
                             env.n_actions, ppo_config(cfg).hidden,
                             _device.resolve(device), "model_checkpoint")


def serving_meta(env, cfg: TrainConfig) -> dict:
    """Net-reconstruction record embedded in every checkpoint meta
    sidecar (the reference's driver.py:213-224)."""
    return dict(protocol=cfg.protocol,
                n_actions=int(env.n_actions),
                observation_length=int(env.observation_length),
                hidden=list(ppo_config(cfg).hidden),
                episode_len=int(cfg.episode_len),
                gamma=float(cfg.gamma))


def export_policy_snapshot(path: str, net: ActorCritic, *, protocol: str,
                           n_actions: int, observation_length: int,
                           hidden, **extra):
    """Write a self-contained serving snapshot (msgpack + JSON meta
    sidecar, both atomic)."""
    meta = dict(protocol=protocol, n_actions=int(n_actions),
                observation_length=int(observation_length),
                hidden=[int(h) for h in hidden], **extra)
    save_checkpoint(path, net, meta, site="snapshot")
    return meta


def load_policy_network(path: str, device=None):
    """A serving snapshot as (net, params, meta): the ActorCritic, its
    flat parameter vector and the sidecar's meta with `integrity` and
    `payload_sha256`. Refuses (IntegrityError) a missing sidecar, a
    sidecar whose fingerprint contradicts the payload, or a damaged
    envelope."""
    from cpr_tpu_torch.integrity import IntegrityError, integrity_event

    sidecar = path + ".json"
    try:
        with open(sidecar) as f:
            meta = json.load(f)
    except (OSError, ValueError) as exc:
        integrity_event(artifact=path, kind="policy_snapshot",
                        reason="sidecar_missing", action="refused",
                        detail=str(exc))
        raise IntegrityError(
            f"policy snapshot {path}: meta sidecar {sidecar} is missing or "
            f"unreadable ({exc}) — re-export with export_policy_snapshot; "
            f"the msgpack alone does not define the net shape",
            artifact=path, kind="policy_snapshot",
            reason="sidecar_missing") from None
    missing = [k for k in ("n_actions", "observation_length", "hidden")
               if k not in meta]
    if missing:
        raise ValueError(
            f"{path}.json is not a serving snapshot: missing {missing} "
            f"(write checkpoints with export_policy_snapshot or a "
            f"train_from_config recent enough to embed serving_meta)")
    payload, tag = resilience.sealed_read(path, kind="policy_snapshot",
                                          action="refused")
    expected = meta.get("payload_sha256")
    found = hashlib.sha256(payload).hexdigest()
    if expected is not None and found != expected:
        integrity_event(artifact=path, kind="policy_snapshot",
                        reason="sidecar_missing", action="refused",
                        detail="sidecar fingerprint mismatch")
        raise IntegrityError(
            f"policy snapshot {path}: meta sidecar {sidecar} expects "
            f"payload sha256 {expected[:12]}…, file on disk hashes to "
            f"{found[:12]}… — the pair is torn (stale sidecar or swapped "
            f"msgpack); re-export both",
            artifact=path, kind="policy_snapshot", reason="sidecar_missing")
    meta = dict(meta, integrity=tag, payload_sha256=found)
    net = _net_from_payload(path, payload, int(meta["observation_length"]),
                            int(meta["n_actions"]),
                            tuple(int(h) for h in meta["hidden"]),
                            _device.resolve(device), "policy_snapshot")
    return net, net.flat, meta


def load_policy_snapshot(path: str, device=None):
    """A greedy policy `obs -> action` from a serving snapshot: a
    `NetPolicy` (K11-act in the stream kernels on CUDA, the argmax of
    the plain forward on the CPU). Returns (policy, meta)."""
    net, _, meta = load_policy_network(path, device)
    return NetPolicy(net, greedy=True), meta


def train_from_config(cfg: TrainConfig, *, out_dir: str | None = None,
                      n_updates: int | None = None, mesh=None,
                      progress: Callable | None = None,
                      resume: bool | str = False,
                      snapshot_freq: int | None = None,
                      metrics_port: int | None = None, device=None,
                      init_params: torch.Tensor | None = None):
    """Full training run: returns (net, history, eval_rows).

    Checkpoints (when out_dir is set): last-model.msgpack after every
    eval, best-model.msgpack when the mean eval relative reward improves
    (ppo.py:429-453), each with its serving meta; metrics.jsonl one line
    per update and per eval row. A nonfinite loss, or an eval below
    `revert_frac` x the best, restarts from the best params with a fresh
    optimizer state. `device`: the card unless "cpu" (the env as
    `build_env` makes it there); `init_params`: a flat parameter vector
    to start from instead of the port's own init (`make_train`'s
    init_fn)."""
    if resume or snapshot_freq is not None:
        raise NotImplementedError(
            "resumable train snapshots are not ported to cpr_tpu_torch yet "
            "(ROADMAP item 6)")
    if metrics_port is not None:
        raise NotImplementedError(
            "the live training metrics endpoint is not ported to "
            "cpr_tpu_torch yet (ROADMAP item 12)")
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded training is not ported to cpr_tpu_torch yet "
            "(ROADMAP item 13)")
    dev = _device.resolve(device)
    env = build_env(cfg, dev)
    lane_alphas = cfg.lane_alphas(cfg.n_envs)
    env_params = _stack_params(lane_alphas, cfg.gamma, cfg.episode_len,
                               dense=cfg.reward == "dense_per_progress")
    pcfg = ppo_config(cfg)
    transform = make_reward_transform(cfg, lane_alphas, dev)
    init_fn, train_step = make_train(env, env_params, pcfg, transform,
                                     per_env_params=True, device=dev)
    carry = init_fn(random.PRNGKey(cfg.seed, dev), params=init_params)
    step = maybe_checkify(train_step)

    total = n_updates if n_updates is not None else cfg.total_updates
    history, eval_rows, best = [], [], -np.inf
    best_params = None
    tele = telemetry.current()
    steps_per_update = cfg.n_envs * pcfg.n_steps
    metrics_log = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        metrics_log = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        metrics_log.write(json.dumps(
            {"run": True, "protocol": cfg.protocol, "seed": cfg.seed,
             "total_updates": total, "device": str(dev)}) + "\n")
        metrics_log.flush()

    def log(row):
        if metrics_log is not None:
            metrics_log.write(json.dumps(row) + "\n")
            metrics_log.flush()

    def save_model(name, meta, kind):
        path = os.path.join(out_dir, name)
        save_checkpoint(path, carry[0].net, meta)
        tele.event("checkpoint", path=path, what=kind)

    try:
        for i in range(total):
            with tele.span("update", env_steps=steps_per_update) as sp:
                carry, metrics = step(carry)
                sp.fence(carry[2])
                acc = metrics.pop("device_metrics", None)
                m = {k: float(v) for k, v in metrics.items()}
            if acc is not None:
                device_metrics.emit("ppo_update", train_step.metrics_spec,
                                    acc, update=i + 1)
            m["wall_s"] = round(sp.dur_s, 6)
            if sp.dur_s > 0:
                m["steps_per_sec"] = round(steps_per_update / sp.dur_s)
            history.append(m)
            log({"update": i + 1, **m})
            if progress is not None:
                progress(i, m)
            ts = carry[0]
            if (best_params is not None
                    and any(not math.isfinite(m.get(k, 0.0))
                            for k in ("pg_loss", "v_loss"))):
                ts.replace_params(best_params)
                tele.event("revert", update=i + 1, score=None, best=best,
                           reason="nonfinite_loss")
                log({"revert": True, "update": i + 1,
                     "reason": "nonfinite_loss", "best": best})
            due = (i + 1) % cfg.eval.freq == 0 or i + 1 == total
            if due and i + 1 > cfg.eval.start_at_iteration:
                with tele.span("eval"):
                    rows = evaluate_per_alpha(env, cfg, ts.net)
                for r in rows:
                    r["update"] = i + 1
                eval_rows.extend(rows)
                for r in rows:
                    log({"eval": True, **r})
                score = float(np.mean([r["relative_reward"] for r in rows]))
                meta = dict(update=i + 1, score=score,
                            **serving_meta(env, cfg))
                if out_dir is not None:
                    save_model("last-model.msgpack", meta, "last")
                if score > best:
                    best = score
                    best_params = ts.params.detach().clone()
                    if out_dir is not None:
                        save_model("best-model.msgpack", meta, "best")
                elif (cfg.revert_frac is not None
                      and best_params is not None
                      and score < cfg.revert_frac * best):
                    ts.replace_params(best_params)
                    tele.event("revert", update=i + 1, score=score,
                               best=best)
                    log({"revert": True, "update": i + 1, "score": score,
                         "best": best})
    finally:
        if metrics_log is not None:
            metrics_log.close()
    return carry[0].net, history, eval_rows
