"""Carrying state between the JAX package and the port.

What crosses over is the parameter record, the policy net's weights,
PRNG keys, the per-lane env states (Nakamoto's scalars; bk's,
Ethereum's, Tailstorm's and Stree's `Dag` plus scalars, and the latter
two's `stale` plane), the serve engine's experience rings, compiled MDP
tables and compiled netsim topologies.
Everything passes through numpy with the reference's field names; keys
are uint32 word pairs there (jax's key data) and int32 bit patterns
here.

    params_from_numpy({f: np.asarray(getattr(jax_params, f)) ...})
    state_from_numpy({f: np.asarray(getattr(jax_state, f)) ...}, device)
    state_to_numpy(state) -> {field: np.ndarray}
    dag_state_from_numpy(env, {"dag": {f: ...}, f: ...}, device)
    dag_state_to_numpy(state) -> {"dag": {f: ...}, f: ...}
    actor_critic_from_flax(flax_params, device) -> flat parameter vector
    actor_critic_to_flax(flat, obs_dim, n_actions, hidden) -> flax tree
    exp_buffer_from_numpy(jax.device_get(jax_rings), device)
    exp_buffer_to_numpy(rings) -> {field: np.ndarray}
    tensor_mdp(tm.n_states, tm.n_actions, *(np.asarray(getattr(tm, f))
               for f in ("start", "src", "act", "dst", "prob", "reward",
                         "progress")), device=device)
    compiled_net(jax_compiled_net) -> netsim.CompiledNet
"""

from __future__ import annotations

import numpy as np
import torch

from cpr_tpu_torch import _device
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.envs.nakamoto import INT_FIELDS, STATE_FIELDS, State
from cpr_tpu_torch.params import FIELDS as PARAM_FIELDS
from cpr_tpu_torch.params import INT_FIELDS as PARAM_INT_FIELDS
from cpr_tpu_torch.params import EnvParams


def params_from_numpy(d: dict) -> EnvParams:
    """EnvParams from a dict of the reference's field names (scalars or
    arrays with a leading axis); values keep float32/int32."""
    missing = set(PARAM_FIELDS) - set(d)
    if missing:
        raise KeyError(f"missing params fields: {sorted(missing)}")
    return EnvParams(**{
        f: torch.from_numpy(np.array(
            d[f], dtype=np.int32 if f in PARAM_INT_FIELDS else np.float32))
        for f in PARAM_FIELDS})


def state_from_numpy(d: dict, device=None) -> State:
    """Nakamoto State [L] from numpy arrays under the reference's field
    names (`key` as uint32 [L, 2])."""
    missing = set(STATE_FIELDS) - set(d)
    if missing:
        raise KeyError(f"missing state fields: {sorted(missing)}")
    dev = _device.resolve(device)
    out = {}
    for f in STATE_FIELDS:
        if f == "key":
            out[f] = rnd.from_numpy_words(d[f], dev)
        else:
            dt = np.int32 if f in INT_FIELDS else np.float32
            out[f] = torch.from_numpy(np.array(d[f], dtype=dt)).to(dev)
    return State(**out)


def state_to_numpy(state: State) -> dict:
    """{field: numpy array}, `key` as uint32 [L, 2]."""
    return {f: (rnd.to_numpy_words(getattr(state, f)) if f == "key"
                else getattr(state, f).detach().cpu().numpy())
            for f in STATE_FIELDS}


def tensor_mdp(n_states: int, n_actions: int, start, src, act, dst, prob,
               reward, progress, *, device=None):
    """The port's TensorMDP over the arrays of a reference TensorMDP (as
    numpy): ids as int32, the float columns and `start` in `prob`'s
    float type, so both packages solve the very same table."""
    from cpr_tpu_torch.mdp.explicit import TensorMDP

    dev = _device.resolve(device)
    fdt = np.asarray(prob).dtype

    def put(x, dt):
        return torch.from_numpy(np.array(x, dt)).to(dev)

    return TensorMDP.from_columns(
        n_states, n_actions, put(start, fdt), put(src, np.int32),
        put(act, np.int32), put(dst, np.int32), put(prob, fdt),
        put(reward, fdt), put(progress, fdt))


def dag_state_from_numpy(env, d: dict, device=None):
    """A DAG env state [L] for `env` (a `DagEnv`) from numpy arrays
    under the reference's field names: `d["dag"]` holds the `Dag` fields
    (`parents` a sequence of [L, B] planes), the other keys the env
    state's scalars and planes (`key` as uint32 [L, 2]). Shapes and
    dtypes must be the reference's."""
    from cpr_tpu_torch.core import dag as D

    dev = _device.resolve(device)
    names = [f for f in env.state_cls.__dataclass_fields__ if f != "dag"]
    missing = set(names + ["dag"]) - set(d)
    missing |= {f"dag.{f}" for f in set(D.FIELDS) - set(d.get("dag", {}))}
    if missing:
        raise KeyError(f"missing state fields: {sorted(missing)}")
    planes = d["dag"]

    def put(x, dt):
        return torch.from_numpy(np.array(x, dtype=dt)).to(dev)

    np_dt = {torch.int32: np.int32, torch.float32: np.float32,
             torch.bool: np.bool_}
    dag = D.Dag(
        parents=tuple(put(p, np.int32) for p in planes["parents"]),
        **{f: put(planes[f], np_dt[D.PLANE_DTYPES[f]])
           for f in D.FIELDS if f != "parents"})
    out = {}
    for f in names:
        if f == "key":
            out[f] = rnd.from_numpy_words(d[f], dev)
        else:
            dt = (np.int32 if f in env.int_fields else np.bool_
                  if f in env.bool_fields or f in env.plane_fields
                  else np.float32)
            out[f] = put(d[f], dt)
    return env.state_cls(dag=dag, **out)


def dag_state_to_numpy(state) -> dict:
    """{"dag": {field: np.ndarray, "parents": [planes]}, field: ...} of a
    DAG env state, `key` as uint32 [L, 2]."""
    import dataclasses

    def np_(t):
        return t.detach().cpu().numpy()

    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "dag":
            out["dag"] = {g.name: ([np_(p) for p in v.parents]
                                   if g.name == "parents"
                                   else np_(getattr(v, g.name)))
                          for g in dataclasses.fields(v)}
        elif f.name == "key":
            out["key"] = rnd.to_numpy_words(v)
        else:
            out[f.name] = np_(v)
    return out


def _dense_names(p: dict) -> list:
    out = []
    for prefix in ("pi", "vf"):
        i = 0
        while f"{prefix}_{i}" in p:
            out.append(f"{prefix}_{i}")
            i += 1
        out.append(f"{prefix}_head")
    return out


def actor_critic_from_flax(tree: dict, device=None) -> torch.Tensor:
    """The flat parameter vector of `train.ppo.ActorCritic` from flax's
    params tree of the reference's ActorCritic (`{"params": {"pi_0":
    {"kernel": [in, out], "bias": [out]}, ..., "pi_head", "vf_0", ...,
    "vf_head"}}`, numpy leaves): each kernel row-major, then its bias,
    layer by layer. Lossless: the floats are copied."""
    p = tree["params"] if "params" in tree else tree
    parts = []
    for name in _dense_names(p):
        parts.append(np.asarray(p[name]["kernel"], np.float32).ravel())
        parts.append(np.asarray(p[name]["bias"], np.float32).ravel())
    flat = np.concatenate(parts)
    return torch.from_numpy(flat).to(_device.resolve(device))


def actor_critic_to_flax(flat: torch.Tensor, obs_dim: int, n_actions: int,
                         hidden) -> dict:
    """flax's params tree (numpy leaves) of a flat parameter vector, its
    keys in sorted order, as every tree that went through jax.tree.map
    has them (the trained params the reference checkpoints)."""
    from cpr_tpu_torch.train.ppo import layer_shapes
    a = flat.detach().cpu().numpy().astype(np.float32)
    layers, off = {}, 0
    for name, i, o in layer_shapes(obs_dim, n_actions, hidden):
        kernel = a[off:off + i * o].reshape(i, o).copy()
        off += i * o
        layers[name] = {"bias": a[off:off + o].copy(), "kernel": kernel}
        off += o
    if off != a.size:
        raise ValueError(f"flat vector of {a.size} floats, the net "
                         f"({obs_dim}, {n_actions}, {tuple(hidden)}) has "
                         f"{off}")
    return {"params": dict(sorted(layers.items()))}


# the experience rings' fields (learn/buffer.py `init_buffer`) and dtypes
_EXP_DTYPES = {"obs": np.float32, "action": np.int32, "reward": np.float32,
               "done": np.bool_, "era": np.float32, "erd": np.float32,
               "policy": np.int32, "cursor": np.int32, "t": np.int32,
               "key": np.uint32}


def exp_buffer_from_numpy(d: dict, device=None) -> dict:
    """The port's experience rings (`learn.buffer.init_buffer`'s dict)
    from the JAX package's, numpy leaves; the key words cross as int32
    bit patterns."""
    dev = _device.resolve(device)
    missing = set(_EXP_DTYPES) - set(d)
    if missing:
        raise KeyError(f"missing ring fields: {sorted(missing)}")
    out = {}
    for f, dt in _EXP_DTYPES.items():
        a = np.ascontiguousarray(np.asarray(d[f], dtype=dt))
        if f == "key":
            a = a.view(np.int32)
        out[f] = torch.from_numpy(a.copy()).to(dev)
    return out


def exp_buffer_to_numpy(exp: dict) -> dict:
    """The JAX package's ring dict (numpy) of the port's rings."""
    out = {f: exp[f].detach().cpu().numpy().copy() for f in _EXP_DTYPES}
    out["key"] = out["key"].view(np.uint32)
    return out


def compiled_net(cn):
    """The port's `netsim.CompiledNet` from the JAX package's (or any
    object with its fields): the same numpy planes, so both engines run
    one topology."""
    from cpr_tpu_torch.netsim.compile import CompiledNet
    return CompiledNet(
        n=int(cn.n), compute=np.asarray(cn.compute, np.float32),
        kind=np.asarray(cn.kind, np.int32), p0=np.asarray(cn.p0, np.float64),
        p1=np.asarray(cn.p1, np.float64),
        activation_delay=float(cn.activation_delay),
        flooding=bool(cn.flooding))
