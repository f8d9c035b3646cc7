"""Sharded resident lanes: the lane API of an env split over a mesh axis.

Reference counterpart: `cpr_tpu/parallel/lanes.py` (`check_even_shards`,
`ShardedLaneFns`, `make_sharded_lane_fns`). `make_sharded_lane_fns(env,
mesh)` gives the three resident lane entry points, `init_lanes`,
`reset_lanes` and `step_lanes`, over a lane batch split into n equal
slices: shard b holds lanes [b·L/n, (b+1)·L/n) on its device and runs the
env's own lane functions on them (K3 for Nakamoto, K10 for a DAG env on
the card; the plain twins on the CPU). Held-lane freezing, admission and
the stream prologue are the env's code, so a lane admitted with seed S
still replays `rollout(PRNGKey(S))` bit for bit on whichever shard holds
it.

The carry stays split by shard between calls: it is a `ShardedCarry`,
one (state, obs) a shard, each updated in place by its shard's
`step_lanes`; nothing is gathered between chained calls. `gather`
concatenates one in lane order (a copy, for the caller that wants it).
Per-call inputs (actions and masks [L]) are split by the same slices and
the outputs concatenated in lane order on the first shard's device.

Uneven batches are refused up front (`check_even_shards`), naming both
values.
"""

from __future__ import annotations

import dataclasses

import torch

from cpr_tpu_torch.envs.base import map_state

__all__ = ["check_even_shards", "make_sharded_lane_fns", "ShardedLaneFns",
           "ShardedCarry", "lane_slices", "split_params"]


def check_even_shards(n: int, mesh, *, axis: str = "d",
                      what: str = "lanes") -> int:
    """Refuse a batch that does not divide the mesh axis, naming both
    values. Returns the device count on the axis."""
    n_devices = int(mesh.shape[axis])
    n = int(n)
    if n_devices < 1:
        raise ValueError(f"mesh axis '{axis}' has no devices")
    if n % n_devices:
        raise ValueError(
            f"cannot shard {n} {what} evenly over {n_devices} devices "
            f"(mesh axis '{axis}': {n} % {n_devices} = "
            f"{n % n_devices}); use a multiple of the device count or "
            f"a smaller mesh")
    return n_devices


def lane_slices(n: int, mesh, axis: str, what: str):
    """[(device, lo, hi)] of the shards of an n-lane batch on `axis`."""
    k = check_even_shards(n, mesh, axis=axis, what=what)
    per = n // k
    return [(dev, b * per, (b + 1) * per)
            for b, dev in enumerate(mesh.axis_devices(axis))]


def split_params(params, n: int, lo: int, hi: int, dev):
    """The params of lanes [lo, hi) on `dev`: fields with a leading lane
    axis of n are sliced, the others copied whole."""
    return params.replace(**{
        f.name: (v[lo:hi] if v.dim() > 0 and v.shape[0] == n else v).to(dev)
        for f in dataclasses.fields(params)
        for v in (getattr(params, f.name),)})


class ShardedCarry(list):
    """A lane carry split by shard: entry b is shard b's (state, obs)."""


def _to(x, dev):
    return x if x is None else x.to(dev)


class ShardedLaneFns:
    """The three resident lane programs of one env over one mesh axis;
    mirrors the env's lane API call for call. Build via
    `make_sharded_lane_fns`."""

    def __init__(self, env, mesh, axis: str = "d"):
        self.env = env
        self.mesh = mesh
        self.axis = axis
        self.n_devices = int(mesh.shape[axis])
        if self.n_devices < 1:
            raise ValueError(f"mesh axis '{axis}' has no devices")
        self.devices = mesh.axis_devices(axis)

    def _slices(self, n: int, what: str = "lanes"):
        return lane_slices(n, self.mesh, self.axis, what)

    def shard(self, tree):
        """Split a lane-major (state, obs) carry by shard (a copy a
        shard on its device)."""
        n = tree[1].shape[0]
        return ShardedCarry(map_state(lambda t: t[lo:hi].to(dev).clone(),
                                      tree)
                            for dev, lo, hi in self._slices(n))

    def gather(self, carry):
        """The carry in lane order on the first shard's device (a copy)."""
        dev = self.devices[0]
        return map_state(lambda *ts: torch.cat([t.to(dev) for t in ts]),
                         *carry)

    def _each(self, keys, params, fn):
        n = keys.shape[0]
        return ShardedCarry(
            fn(keys[lo:hi].to(dev), split_params(params, n, lo, hi, dev))
            for dev, lo, hi in self._slices(n))

    def init_lanes(self, keys, params):
        """Sharded `init_lanes`: fresh per-lane (state, obs) via the
        rollout stream prologue, split by shard."""
        return self._each(keys, params, self.env.init_lanes)

    def reset_lanes(self, keys, params):
        """Sharded `reset_lanes` (raw reset)."""
        return self._each(keys, params, self.env.reset_lanes)

    def step_lanes(self, carry, actions, admit_mask, fresh_states,
                   step_mask, params):
        """Sharded `step_lanes`: each shard steps its slice in place (its
        carry entry is updated and returned); admission and holds are the
        env's, per shard. Returns (carry, (obs, reward, done, info)) with
        the outputs concatenated in lane order on the first shard's
        device."""
        n = actions.shape[0]
        slices = self._slices(n)
        if len(carry) != len(slices) or len(fresh_states) != len(slices):
            raise ValueError(f"a carry of {len(carry)} shards and fresh "
                             f"states of {len(fresh_states)} for "
                             f"{len(slices)} shards")
        outs = []
        for b, (dev, lo, hi) in enumerate(slices):
            _, out = self.env.step_lanes(
                carry[b], _to(actions[lo:hi], dev), _to(admit_mask[lo:hi],
                                                        dev),
                fresh_states[b], _to(step_mask[lo:hi], dev),
                split_params(params, n, lo, hi, dev))
            outs.append(out)
        dev0 = self.devices[0]
        obs = torch.cat([o[0].to(dev0) for o in outs])
        reward = torch.cat([o[1].to(dev0) for o in outs])
        done = torch.cat([o[2].to(dev0) for o in outs])
        info = {k: torch.cat([o[3][k].to(dev0) for o in outs])
                for k in outs[0][3]}
        return carry, (obs, reward, done, info)


def make_sharded_lane_fns(env, mesh, *, axis: str = "d") -> ShardedLaneFns:
    """Build the sharded resident lane programs for `env` over `mesh`.

        mesh = default_mesh(devices=[torch.device("cuda")] * 4)
        lanes = make_sharded_lane_fns(env, mesh)
        carry = lanes.init_lanes(keys, params)      # split by shard
        carry, out = lanes.step_lanes(carry, ...)   # in place, per shard

    The lane count of every call must divide the mesh axis
    (`check_even_shards`)."""
    return ShardedLaneFns(env, mesh, axis)
