"""Parallel solvers and lanes of the port: a mesh of shards.

Reference counterpart: `cpr_tpu/parallel/` (SURVEY.md §2.8). Three
parallel axes over one `Mesh` (`parallel/mesh.py`: an n-D array of
`torch.device` with named axes; a device may repeat, so one card runs
every sharded path with several shards on `cuda:0`):

- episode batches and resident lanes split by shard (`shard_envs`,
  `make_sharded_rollout_fn`, `make_sharded_lane_fns`): each shard runs
  the env's own kernels (K2/K3, K10) on its lane slice;
- value iteration with the transitions split by shard and the partial Q
  planes summed (`sharded_value_iteration`, kernel K16-psum), or with
  the states split by shard (`sharded_state_value_iteration`, K16-state);
- the grid axis of grid-batched VI (`make_grid_chunk_step(mesh=)`, K7 a
  shard) and grid x state (`make_grid_state_chunk_step`, K16-grid).

Everything runs in one process: shards on one device share its buffers;
shards on other cards get their slices by peer copies
(`mesh.exchange_slices`), a path that runs only with two or more cards.
Batches that do not divide the mesh axis are refused by name
(`check_even_shards`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cpr_tpu_torch import kernels
from cpr_tpu_torch.mdp.explicit import (TensorMDP, _Ctl, _greedy_backup,
                                        _run_until_stopped, resolve_vi_impl,
                                        ring_residuals, run_chunk_driver,
                                        vi_residuals_event)
from cpr_tpu_torch.parallel.grid import make_grid_chunk_step
from cpr_tpu_torch.parallel.lanes import (ShardedCarry, ShardedLaneFns,
                                          check_even_shards, lane_slices,
                                          make_sharded_lane_fns)
from cpr_tpu_torch.parallel.mesh import (Mesh, default_mesh, distinct,
                                         exchange_slices)
from cpr_tpu_torch.parallel.state_shard import (_mesh_devices,
                                                make_grid_state_chunk_step,
                                                partition_by_state_block,
                                                sharded_state_value_iteration,
                                                state_halo_bytes)
from cpr_tpu_torch.telemetry import now

__all__ = [
    "Mesh",
    "default_mesh",
    "shard_envs",
    "sharded_value_iteration",
    "sharded_state_value_iteration",
    "make_grid_chunk_step",
    "make_grid_state_chunk_step",
    "partition_by_state_block",
    "state_halo_bytes",
    "make_sharded_rollout_fn",
    "sharded_rollout",
    "make_sharded_lane_fns",
    "ShardedLaneFns",
    "ShardedCarry",
    "check_even_shards",
]


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return tree


def _leaves(tree):
    out: list = []
    _tree_map(out.append, tree)
    return out


def shard_envs(mesh: Mesh, tree, axis: str = "d"):
    """Split a batched env state/keys tree (dicts, tuples, dataclasses
    of tensors with a leading batch axis) by shard: a `ShardedCarry` of
    one tree a shard on its device. The batch must divide the mesh axis,
    refused up front with both values named."""
    batched = [x for x in _leaves(tree) if x.dim() >= 1]
    n = batched[0].shape[0] if batched else 0
    return ShardedCarry(
        _tree_map(lambda t: t[lo:hi].to(dev) if t.dim() >= 1 else t.to(dev),
                  tree)
        for dev, lo, hi in lane_slices(n, mesh, axis, "batched envs"))


def make_sharded_rollout_fn(env, mesh: Mesh, params, policy, n_steps: int,
                            axis: str = "d", chunk: int | None = None,
                            collect_metrics: bool = False):
    """`fn(keys) -> stats` of `env.make_episode_stats_fn` with the episode
    batch split over the mesh: one K2 (or K10) launch a shard a chunk,
    the per-lane stats concatenated in lane order, the metrics
    accumulator equal to the unsharded call's. Batches that do not divide
    the mesh axis are refused with both values named."""
    return env.make_episode_stats_fn(params, policy, n_steps, chunk=chunk,
                                     collect_metrics=collect_metrics,
                                     mesh=mesh, mesh_axis=axis)


def sharded_rollout(env, mesh: Mesh, keys, params, policy, n_steps: int,
                    axis: str = "d", chunk: int | None = None):
    """One-shot `make_sharded_rollout_fn` (build the fn once instead when
    calling repeatedly)."""
    return make_sharded_rollout_fn(env, mesh, params, policy, n_steps, axis,
                                   chunk)(keys)


# -- transition-sharded VI (K16-psum) -----------------------------------------


def table_on(tm: TensorMDP, dev) -> TensorMDP:
    """`tm` with every tensor on `dev` (itself where it is there)."""
    if tm.device == torch.device(dev):
        return tm
    return dataclasses.replace(tm, **{
        f.name: getattr(tm, f.name).to(dev) for f in dataclasses.fields(tm)
        if isinstance(getattr(tm, f.name), torch.Tensor)})


def psum_ranges(tm: TensorMDP, n: int):
    """The n shards of the sorted rows: (chunk, [(b, r0, r1, k0, k1)]),
    shard b's rows [r0, r1) = [b * chunk, (b + 1) * chunk) cut at T (the
    reference pads the last with inert rows) and the segments [k0, k1)
    they touch; a segment may straddle two shards."""
    T = int(tm.prob.shape[0])
    chunk = max(math.ceil(T / n), 1)
    seg_ptr = tm.seg_ptr.cpu().numpy()
    out = []
    for b in range(n):
        r0, r1 = min(b * chunk, T), min((b + 1) * chunk, T)
        k0 = k1 = 0
        if r1 > r0:
            k0 = int(np.searchsorted(seg_ptr, r0, side="right")) - 1
            k1 = int(np.searchsorted(seg_ptr, r1 - 1, side="right"))
        out.append((b, r0, r1, k0, k1))
    return chunk, out


class _PsumPlain:
    """The plain twin of K16-psum: per shard a segment sum of its row
    range into a partial plane, the planes summed in shard order, the
    greedy backup."""

    def __init__(self, tm: TensorMDP, ranges):
        self.tm, self.ranges = tm, ranges
        S, A, dev = tm.n_states, tm.n_actions, tm.device
        i64 = torch.int64
        self.row_seg = torch.repeat_interleave(
            torch.arange(tm.n_segments, device=dev),
            (tm.seg_ptr[1:] - tm.seg_ptr[:-1]).to(i64))
        seg_state = torch.repeat_interleave(
            torch.arange(S, device=dev),
            (tm.state_seg[1:] - tm.state_seg[:-1]).to(i64))
        self.key = seg_state * A + tm.seg_act.to(i64)
        self.mask = tm.valid_actions()

    def partials(self, terms):
        out = []
        for _, r0, r1, _, _ in self.ranges:
            z = torch.zeros(self.tm.n_segments, dtype=terms.dtype,
                            device=terms.device)
            out.append(z.index_add(0, self.row_seg[r0:r1], terms[r0:r1]))
        return out

    def sweep(self, discount, value, prog):
        tm = self.tm
        S, A = tm.n_states, tm.n_actions
        planes = []
        for col, x in ((tm.reward, value), (tm.progress, prog)):
            parts = self.partials(tm.prob * (col + discount * x[tm.dst]))
            q = parts[0]
            for part in parts[1:]:
                q = q + part
            full = torch.zeros(S * A, dtype=q.dtype, device=q.device)
            full[self.key] = q
            planes.append(full.reshape(S, A))
        return _greedy_backup(planes[0], planes[1], *self.mask)


class _PsumCuda:
    """K16-psum on the card: the shards' partial launches and the backup,
    two launches a sweep on one card (the partials of every shard, then
    the backup). Across cards the backup runs on the lead card, which
    receives the other cards' partial planes and sends the new vectors
    back."""

    def __init__(self, tm: TensorMDP, devices, chunk, ranges):
        self.lead = devices[0]
        self.devs = distinct(devices)
        self.tables = {d: table_on(tm, d) for d in self.devs}
        self.S, self.dt = tm.n_states, tm.prob.dtype
        self.chunk, self.n = chunk, len(ranges)
        self.ranges = {d: [r for r, dv in zip(ranges, devices) if dv == d]
                       for d in self.devs}
        n_seg = tm.n_segments

        def zeros(d):
            return torch.zeros(n_seg, dtype=self.dt, device=d)

        # the lead's planes of every shard; each other card's of its own
        self.qv = {self.lead: [zeros(self.lead) for _ in ranges]}
        self.qp = {self.lead: [zeros(self.lead) for _ in ranges]}
        for d in self.devs[1:]:
            self.qv[d] = [zeros(d) if dv == d else None for dv in devices]
            self.qp[d] = [zeros(d) if dv == d else None for dv in devices]
        self.ctls = {d: _Ctl(self.dt, d, 0) for d in self.devs[1:]}

    def vectors(self, value, prog):
        """Each card's (value pair, progress pair, policy)."""
        out = {}
        for d in self.devs:
            v0 = value.to(d, self.dt).contiguous().clone()
            p0 = prog.to(d, self.dt).contiguous().clone()
            out[d] = ([v0, torch.empty_like(v0)], [p0, torch.empty_like(p0)],
                      torch.full((self.S,), -1, dtype=torch.int32, device=d))
        return out

    def run(self, vec, c: _Ctl, resid, resid_len, first, count, discount,
            *, stop_delta, max_iter, can_stop):
        def call(d, lead, first, count):
            v, p, pol = vec[d]
            cd = c if lead else self.ctls[d]
            kernels.psum_sweeps(
                self.tables[d], self.ranges[d], lead, self.chunk, discount,
                self.qv[d], self.qp[d], v, p, pol, cd.ctl, cd.delta,
                resid if lead else None, resid_len if lead else 0, first,
                count, stop_delta=stop_delta, max_iter=max_iter,
                can_stop=can_stop and lead)

        if len(self.devs) == 1:
            call(self.lead, True, first, count)
            return
        for i in range(first, first + count):
            for d in self.devs[1:]:
                call(d, False, i, 1)
                for b, q in enumerate(self.qv[d]):
                    if q is not None:
                        self.qv[self.lead][b].copy_(q, non_blocking=True)
                        self.qp[self.lead][b].copy_(self.qp[d][b],
                                                    non_blocking=True)
            call(self.lead, True, i, 1)
            nxt = (i + 1) % 2
            exchange_slices({d: [vec[d][0][nxt], vec[d][1][nxt], vec[d][2]]
                             for d in self.devs},
                            [(self.lead, slice(None))])

    def loop(self, discount, stop_delta, max_iter, resid_len):
        """The while impl: K4's device loop control over K16-psum."""
        z = torch.zeros(self.S, dtype=self.dt)
        vec = self.vectors(z, z)
        c = _Ctl(self.dt, self.lead, resid_len)

        def launch(first, count):
            self.run(vec, c, c.resid, resid_len, first, count, discount,
                     stop_delta=stop_delta, max_iter=max_iter, can_stop=True)

        _run_until_stopped(launch, max_iter, c)
        it = c.it
        v, p, pol = vec[self.lead]
        return (v[it % 2], p[it % 2], pol, float(c.delta[0]), it,
                c.resid[:resid_len].cpu().numpy())

    def chunk_step(self, discount):
        c = _Ctl(self.dt, self.lead, 0)

        def step(value, prog, steps):
            c.reset()
            vec = self.vectors(value, prog)
            deltas = torch.empty(steps, dtype=self.dt, device=self.lead)
            self.run(vec, c, deltas, steps, 0, steps, discount,
                     stop_delta=0.0, max_iter=steps, can_stop=False)
            v, p, pol = vec[self.lead]
            return v[steps % 2], p[steps % 2], pol, deltas

        return step


def _psum_loop_plain(tw: _PsumPlain, discount, stop_delta, max_iter,
                     resid_len):
    tm = tw.tm
    z = torch.zeros(tm.n_states, dtype=tm.prob.dtype, device=tm.device)
    resid = np.zeros(resid_len, z.numpy().dtype)
    value, prog, it = z, z, 0
    while True:
        v2, p2, pol = tw.sweep(discount, value, prog)
        d = (v2 - value).abs().max() if tm.n_states else z.sum()
        delta = float(d)
        value, prog, it = v2, p2, it + 1
        if resid_len:
            resid[(it - 1) % resid_len] = delta
        if not d > stop_delta or it >= max_iter:
            return value, prog, pol, delta, it, resid


def _psum_chunk_plain(tw: _PsumPlain, discount):
    def step(value, prog, steps):
        deltas = torch.empty(steps, dtype=value.dtype)
        for j in range(steps):
            v2, p2, pol = tw.sweep(discount, value, prog)
            deltas[j] = (v2 - value).abs().max()
            value, prog = v2, p2
        return value, prog, pol, deltas

    return step


def sharded_value_iteration(tm: TensorMDP, mesh: Mesh, *, axis: str = "d",
                            max_iter: int = 0, discount: float = 1.0,
                            eps: float | None = None,
                            stop_delta: float | None = None,
                            impl: str | None = None, chunk: int = 64,
                            accel_m: int = 0,
                            checkpoint_path: str | None = None,
                            checkpoint_every: int = 1):
    """Value iteration with the transition table sharded over the mesh.

    The table's sorted rows are split into n contiguous chunks (a
    segment may straddle two); each shard sums its rows' terms into
    partial Q planes, and the planes are summed over the shards in shard
    order before the greedy backup (the reference's psum). Kernel
    K16-psum on the card, `_PsumPlain` on the CPU.

    Semantics of `TensorMDP.value_iteration` (same backup and stop
    rule; same dict). `impl`: "while" (the device keeps K4's loop
    control) or "chunked" (host chunks; `accel_m` turns on Anderson
    mixing between chunks, `explicit.run_chunk_driver`); CPR_VI_IMPL
    sets the default. Checkpoints (`checkpoint_path=`, chunked only) are
    not ported (ROADMAP item 6)."""
    stop_delta = tm.resolve_stop_delta(
        discount=discount, eps=eps, stop_delta=stop_delta, max_iter=max_iter)
    tm._check_segment_width()
    impl = resolve_vi_impl(impl)
    if checkpoint_path is not None and impl == "while":
        raise ValueError(
            "checkpoint_path requires impl='chunked': the while impl "
            "runs as one device program with no between-chunk seam")
    del checkpoint_every
    t0 = now()
    n = mesh.shape[axis]
    devices = _mesh_devices(mesh, axis)
    if n > kernels.PSUM_MAX_SHARDS:
        raise ValueError(f"transition-sharded VI takes at most "
                         f"{kernels.PSUM_MAX_SHARDS} shards, got {n}")
    tm = table_on(tm, devices[0])
    rows, ranges = psum_ranges(tm, n)
    disc, stop = tm._cast(discount), tm._cast(stop_delta)
    max_iter_ = max_iter if max_iter > 0 else (1 << 30)
    cuda = devices[0].type == "cuda"
    twin = _PsumCuda(tm, devices, rows, ranges) if cuda else _PsumPlain(
        tm, ranges)
    if impl == "while":
        from cpr_tpu_torch.mdp.explicit import VI_RESID_LEN
        run = twin.loop if cuda else (
            lambda *a: _psum_loop_plain(twin, *a))
        value, progress_v, policy, delta, it, resid = run(
            disc, stop, max_iter_, VI_RESID_LEN)
        resid = ring_residuals(resid, int(it))
    else:
        step = twin.chunk_step(disc) if cuda else _psum_chunk_plain(twin,
                                                                    disc)
        value, progress_v, policy, delta, it, resid = run_chunk_driver(
            step, tm.n_states, tm.prob.dtype, stop, max_iter_, chunk,
            accel_m=accel_m, checkpoint_path=checkpoint_path,
            device=devices[0])
    resid = vi_residuals_event(impl, int(it), resid, stop_delta, delta)
    return dict(
        vi_discount=discount,
        vi_delta=float(delta),
        vi_stop_delta=stop_delta,
        vi_policy=policy.cpu().numpy(),
        vi_value=value.cpu().numpy(),
        vi_progress=progress_v.cpu().numpy(),
        vi_iter=int(it),
        vi_max_iter=max_iter,
        vi_residuals=resid,
        vi_time=now() - t0,
    )
