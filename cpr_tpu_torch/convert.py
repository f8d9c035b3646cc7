"""Carrying state between the JAX package and the port.

The system has no weights: what crosses over is the parameter record,
PRNG keys, the per-lane Nakamoto `State` and compiled MDP tables.
Everything passes through numpy with the reference's field names; keys
are uint32 word pairs there (jax's key data) and int32 bit patterns
here.

    params_from_numpy({f: np.asarray(getattr(jax_params, f)) ...})
    state_from_numpy({f: np.asarray(getattr(jax_state, f)) ...}, device)
    state_to_numpy(state) -> {field: np.ndarray}
    tensor_mdp(tm.n_states, tm.n_actions, *(np.asarray(getattr(tm, f))
               for f in ("start", "src", "act", "dst", "prob", "reward",
                         "progress")), device=device)
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
