"""State-axis sharded Bellman backups: value iteration split by states.

Reference counterpart: `cpr_tpu/parallel/state_shard.py`. Each shard
owns a contiguous block of S/n states and exactly the transitions that
leave it, sweeps its block, and per sweep the blocks' value and progress
slices make up the replicated [S] vectors that every shard's
`value[dst]` gather reads (the reference's all_gathers).

In the port a shard's block is a sorted table of its own
(`TensorMDP.from_columns` over `partition_by_state_block`'s columns of
the block, `Block`): s_blk states with local src ids, whose dst index
the replicated vector of length S (or S_pad). On the card one sweep of
a shard is one launch of kernel K16-state (`csrc/shard_sweep.cu`): K4's
per-state backup over the block, writing the shard's slice of the next
replicated vectors and its max delta into a slot of its own; the sweep's
delta is the max over the slots. Shards on one card share the
replicated buffers; shards on other cards get the slices by peer copies
(`mesh.exchange_slices`). On the CPU the plain twin
`_state_block_sweep_plain` sweeps each block.

Bit-identity by construction: every (state, action) segment lies wholly
in one block with its rows in their compiled order, and K16-state runs
K4's per-state code, so the sharded fixpoint equals the single-device
`impl="chunked"` solve bit for bit at any shard count.

Chunked impl only (`impl="while"` is refused): the host chunk seam is
`explicit.run_chunk_driver`'s. The grid axis composes: see
`make_grid_state_chunk_step` (kernel K16-grid).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cpr_tpu_torch import kernels, telemetry
from cpr_tpu_torch.mdp.explicit import (TensorMDP, _bits_to_float,
                                        _np_dtype, _valid_actions,
                                        check_vi_working_set,
                                        grid_valid_segments, make_vi_sweep,
                                        resolve_vi_impl, run_chunk_driver,
                                        vi_residuals_event,
                                        vi_working_set_bytes)
from cpr_tpu_torch.parallel.lanes import check_even_shards
from cpr_tpu_torch.parallel.mesh import distinct, exchange_slices

__all__ = [
    "partition_by_state_block",
    "sharded_state_value_iteration",
    "make_grid_state_chunk_step",
    "state_halo_bytes",
]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def partition_by_state_block(tm, n: int, S_pad: int | None = None):
    """Bucket the COO transition columns by source-state block.

    Block b of `n` owns states [b*S/n, (b+1)*S/n); every transition goes
    to its source's block with src localized (src - block start), blocks
    are padded to the longest block with inert rows (prob 0, src = S/n:
    past the block's states), and the padded blocks are concatenated, so
    shard b's rows are [b*t_blk, (b+1)*t_blk).

    Rows with nondecreasing src (a sorted `TensorMDP`'s, or a frontier
    compile's) are already bucketed: the bucketing is a split, no
    argsort.

    `tm` is any table with n_states and the six columns (tensors or
    arrays). Returns `(cols, slot, t_blk)`: the six [n*t_blk] numpy
    columns (src_local, act, dst, prob, reward, progress), `slot` the
    index of each original row in the padded layout, and `t_blk`.

    `S_pad` (a multiple of n, >= n_states) blocks over a padded state
    space: the pad states own no rows, back up to value 0 / policy -1,
    and callers slice the vectors back to [n_states]."""
    S = S_pad if S_pad is not None else tm.n_states
    if S % n or S < tm.n_states:
        raise ValueError(
            f"cannot shard {S} states into {n} blocks: {S} % {n} = "
            f"{S % n}")
    s_blk = S // n
    src = _np(tm.src).astype(np.int64)
    T = src.shape[0]
    blk = src // s_blk
    counts = np.bincount(blk, minlength=n)
    t_blk = max(int(counts.max()), 1) if T else 1
    if np.all(src[1:] >= src[:-1]):
        order = np.arange(T)  # pre-bucketed
    else:
        order = np.argsort(blk, kind="stable")
    starts = np.zeros(n, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    blk_o = blk[order]
    slot_o = blk_o * t_blk + (np.arange(T) - starts[blk_o])
    slot = np.empty(T, np.int64)
    slot[order] = slot_o
    src_local = np.full(n * t_blk, s_blk, np.int32)  # pad: past the block
    src_local[slot] = (src - blk * s_blk).astype(np.int32)
    cols = [src_local]
    for col, fill, dt in ((tm.act, 0, np.int32), (tm.dst, 0, np.int32),
                          (tm.prob, 0.0, None), (tm.reward, 0.0, None),
                          (tm.progress, 0.0, None)):
        a = _np(col)
        out = np.full(n * t_blk, fill, dt or a.dtype)
        out[slot] = a
        cols.append(out)
    return tuple(cols), slot, t_blk


def state_halo_bytes(S: int, n: int, dtype) -> int:
    """Bytes of value + progress crossing shard boundaries a sweep: each
    of the n shards gathers the (S - S/n) remote entries of both vectors
    (the policy's gather, once a chunk, is not counted)."""
    if n <= 1:
        return 0
    return 2 * (S - S // n) * _np_dtype(dtype).itemsize * n


@dataclass(frozen=True)
class Block:
    """One state shard: the sorted table of its block (`s_blk` states,
    local src ids, dst into the replicated vectors; its pad rows sort
    past `state_seg[s_blk]`), its first state `off`, the count of its
    real rows and its device."""

    table: TensorMDP
    off: int
    n_real: int

    @property
    def device(self) -> torch.device:
        return self.table.device

    @property
    def n_states(self) -> int:
        return self.table.n_states


def make_blocks(cols, n: int, t_blk: int, s_blk: int, A: int, devices):
    """The n `Block`s of a partition's columns, block b on devices[b]."""
    out = []
    for b in range(n):
        dev = devices[b]
        part = [c[b * t_blk:(b + 1) * t_blk] for c in cols]

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        start = torch.zeros(s_blk, dtype=torch.from_numpy(part[3]).dtype,
                            device=dev)
        t = TensorMDP.from_columns(s_blk, A, start, *(put(x) for x in part))
        n_real = int(t.seg_ptr[int(t.state_seg[s_blk])])
        out.append(Block(t, b * s_blk, n_real))
    return out


def _block_mask(block: Block, prob=None):
    t = block.table
    r = slice(0, block.n_real)
    return _valid_actions(t.src[r], t.act[r],
                          (t.prob if prob is None else prob)[r],
                          t.n_states, t.n_actions)


def _state_block_sweep_plain(block: Block, mask, discount, value, prog,
                             prob=None):
    """The plain twin of K16-state: one Bellman sweep of `block`'s states
    over its real rows, reading the replicated `value`/`prog`; returns
    the block's (value, progress, policy)."""
    t = block.table
    r = slice(0, block.n_real)
    return make_vi_sweep(t.n_states, t.n_actions)(
        t.src[r], t.act[r], t.dst[r], (t.prob if prob is None else prob)[r],
        t.reward[r], t.progress[r], *mask, discount, value, prog)


def _state_chunk_plain(blocks, S_pad: int, discount):
    masks = [_block_mask(b) for b in blocks]

    def chunk(value, prog, steps):
        dev = value.device
        deltas = torch.empty(steps, dtype=value.dtype, device=dev)
        for j in range(steps):
            v2, p2 = torch.empty_like(value), torch.empty_like(prog)
            pol = torch.empty(S_pad, dtype=torch.int32, device=dev)
            d = torch.zeros((), dtype=value.dtype, device=dev)
            for b, m in zip(blocks, masks):
                s = slice(b.off, b.off + b.n_states)
                vb, pb, polb = _state_block_sweep_plain(b, m, discount,
                                                        value, prog)
                v2[s], p2[s], pol[s] = vb, pb, polb
                d = torch.maximum(d, (vb - value[s]).abs().max())
            deltas[j] = d
            value, prog = v2, p2
        return value, prog, pol, deltas

    return chunk


def _state_chunk_cuda(blocks, S_pad: int, discount):
    """`steps` K16-state sweeps a chunk: with every shard on one card one
    C call (steps x n launches); across cards a call a card a sweep, then
    the slices exchanged."""
    devs = distinct(b.device for b in blocks)
    lead = blocks[0].device
    groups = {d: [k for k, b in enumerate(blocks) if b.device == d]
              for d in devs}

    def chunk(value, prog, steps):
        dt = value.dtype
        rep = {}
        for d in devs:
            v0 = value.to(d).contiguous().clone()
            p0 = prog.to(d).contiguous().clone()
            rep[d] = ([v0, torch.empty_like(v0)], [p0, torch.empty_like(p0)],
                      torch.empty(S_pad, dtype=torch.int32, device=d),
                      torch.zeros((len(groups[d]), steps), dtype=torch.int64,
                                  device=d))

        def run(d, first, count):
            v, p, pol, dbits = rep[d]
            kernels.state_block_sweeps([blocks[k] for k in groups[d]],
                                       discount, v, p, pol, dbits, first,
                                       count)

        if len(devs) == 1:
            run(lead, 0, steps)
        else:
            for i in range(steps):
                for d in devs:
                    run(d, i, 1)
                nxt = (i + 1) % 2
                exchange_slices(
                    {d: [rep[d][0][nxt], rep[d][1][nxt]] for d in devs},
                    [(b.device, slice(b.off, b.off + b.n_states))
                     for b in blocks])
            exchange_slices({d: [rep[d][2]] for d in devs},
                            [(b.device, slice(b.off, b.off + b.n_states))
                             for b in blocks])
        bits = torch.cat([rep[d][3].to(lead) for d in devs]).max(0).values
        v, p, pol, _ = rep[lead]
        return v[steps % 2], p[steps % 2], pol, _bits_to_float(bits, dt)

    return chunk


def _mesh_devices(mesh, axis):
    devs = mesh.axis_devices(axis)
    kinds = {d.type for d in devs}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"a mesh of CPU or of CUDA devices is needed, got "
                         f"{sorted(str(d) for d in devs)}")
    return devs


def sharded_state_value_iteration(tm: TensorMDP, mesh, *,
                                  axis: str = "d", max_iter: int = 0,
                                  discount: float = 1.0,
                                  eps: float | None = None,
                                  stop_delta: float | None = None,
                                  impl: str | None = None,
                                  chunk: int = 64,
                                  checkpoint_path: str | None = None,
                                  checkpoint_every: int = 1,
                                  value0=None, progress0=None,
                                  pad_states: bool = False,
                                  protocol: str | None = None,
                                  cutoff: int | None = None):
    """Value iteration with the state axis sharded over `mesh`'s `axis`:
    the same dict as `TensorMDP.value_iteration(impl="chunked")` (plus
    `vi_state_shards`, `vi_halo_bytes`), the same fixpoint bit for bit
    (module docstring). `value0`/`progress0` warm-start the solve (the
    RTDP handoff, `mdp.rtdp_graph.rtdp_sharded_polish`);
    `protocol`/`cutoff` label the `mdp_solve` event, which carries
    `state_shards`, `halo_bytes` and `states_per_sec`.

    A state count that does not divide the mesh is refused by name
    (`check_even_shards`) unless `pad_states=True`, which blocks over a
    padded state space: the pad states own no rows, are never a
    destination, and are sliced off before return.

    Chunked impl only; `impl="while"` is refused. Checkpoints
    (`checkpoint_path=`) are not ported (ROADMAP item 6)."""
    impl = resolve_vi_impl(impl or "chunked")
    if impl != "chunked":
        raise ValueError(
            "state-sharded VI requires impl='chunked': the host "
            "between-chunk seam is what provides checkpoint/resume "
            "and fault retries; the while impl is a single device "
            "program with no such seam (use "
            "cpr_tpu_torch.parallel.sharded_value_iteration for a "
            "transition-sharded while solve)")
    del checkpoint_every
    stop_delta = tm.resolve_stop_delta(
        discount=discount, eps=eps, stop_delta=stop_delta,
        max_iter=max_iter)
    tm._check_segment_width()
    S, A = tm.n_states, tm.n_actions
    n = mesh.shape[axis]
    devices = _mesh_devices(mesh, axis)
    if pad_states:
        S_pad = S + (-S % n)
    else:
        check_even_shards(S, mesh, axis=axis, what="states")
        S_pad = S
    t0 = telemetry.now()
    cols, _, t_blk = partition_by_state_block(tm, n, S_pad)
    check_vi_working_set(t_blk, S_pad, A, tm.prob.dtype, shards=n)
    s_blk = S_pad // n
    blocks = make_blocks(cols, n, t_blk, s_blk, A, devices)
    disc = tm._cast(discount)
    make = (_state_chunk_cuda if devices[0].type == "cuda"
            else _state_chunk_plain)
    max_iter_ = max_iter if max_iter > 0 else (1 << 30)

    def pad0(x):
        if x is None or S_pad == S:
            return x
        x = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x)
        return torch.cat([x.to(devices[0]), torch.zeros(
            S_pad - S, dtype=x.dtype, device=devices[0])])

    value, progress_v, policy, delta, it, resid = run_chunk_driver(
        make(blocks, S_pad, disc), S_pad, tm.prob.dtype,
        tm._cast(stop_delta), max_iter_, chunk,
        checkpoint_path=checkpoint_path,
        value0=pad0(value0), prog0=pad0(progress0),
        predicted_bytes=vi_working_set_bytes(
            t_blk, S_pad, A, tm.prob.dtype, shards=n),
        device=devices[0])
    resid = vi_residuals_event(impl, int(it), resid, stop_delta, delta)
    vi_time = telemetry.now() - t0
    halo = state_halo_bytes(S_pad, n, tm.prob.dtype)
    telemetry.current().event(
        "mdp_solve", protocol=protocol, cutoff=cutoff, grid=[1, 1],
        sweeps=int(it), converged=int(float(delta) <= float(stop_delta)),
        points=1, n_states=S, n_transitions=int(tm.src.shape[0]),
        n_devices=int(n), state_shards=int(n), halo_bytes=int(halo),
        solve_s=round(vi_time, 6),
        states_per_sec=(round(S * int(it) / vi_time, 3)
                        if vi_time > 0 else None))
    return dict(
        vi_discount=discount,
        vi_delta=float(delta),
        vi_stop_delta=stop_delta,
        vi_policy=policy.cpu().numpy()[:S],
        vi_value=value.cpu().numpy()[:S],
        vi_progress=progress_v.cpu().numpy()[:S],
        vi_iter=int(it),
        vi_max_iter=max_iter,
        vi_residuals=resid,
        vi_time=vi_time,
        vi_state_shards=int(n),
        vi_halo_bytes=int(halo),
    )


# -- the grid x state 2-D mesh (K16-grid) -------------------------------------


@dataclass(frozen=True)
class GridShard:
    """Shard (i, j) of a grid x state mesh: grid slice [g0, g0 + G_blk)
    over state block `block`, with its points' probability columns
    [G_blk, t_blk] in the block's row order and their segment validity."""

    block: Block
    g0: int
    probs: torch.Tensor
    valid: torch.Tensor  # uint8 [G_blk, n_seg] (the card's), or None
    masks: list | None  # the plain twin's per-point masks, or None


def _grid_state_chunk_plain(shards, G_blk: int, discount):
    """The plain twin of K16-grid: per live point, `steps` sweeps of its
    blocks (each `_state_block_sweep_plain` under the point's column)."""
    by_g0: dict = {}
    for sh in shards:
        by_g0.setdefault(sh.g0, []).append(sh)

    def chunk(carry, frozen, steps):
        value, prog, pol = carry
        v2, p2, pol2 = value.clone(), prog.clone(), pol.clone()
        deltas = torch.zeros((value.shape[0], steps), dtype=value.dtype,
                             device=value.device)
        fz = frozen.tolist()
        for g0, row in by_g0.items():
            for gl in range(G_blk):
                g = g0 + gl
                if fz[g]:
                    continue
                v, p = value[g], prog[g]
                for j in range(steps):
                    nv, np_ = torch.empty_like(v), torch.empty_like(p)
                    npol = torch.empty_like(pol[g])
                    d = torch.zeros((), dtype=v.dtype, device=v.device)
                    for sh in row:
                        b = sh.block
                        s = slice(b.off, b.off + b.n_states)
                        vb, pb, polb = _state_block_sweep_plain(
                            b, sh.masks[gl], discount, v, p,
                            prob=sh.probs[gl])
                        nv[s], np_[s], npol[s] = vb, pb, polb
                        d = torch.maximum(d, (vb - v[s]).abs().max())
                    deltas[g, j] = d
                    v, p = nv, np_
                v2[g], p2[g], pol2[g] = v, p, npol
        return (v2, p2, pol2), deltas

    return chunk


def _grid_state_chunk_cuda(shards, G: int, G_blk: int, discount):
    devs = distinct(sh.block.device for sh in shards)
    lead = shards[0].block.device
    groups = {d: [k for k, sh in enumerate(shards) if sh.block.device == d]
              for d in devs}

    def chunk(carry, frozen, steps):
        value, prog, pol = carry
        fz = frozen.to(lead)
        live_all = (~fz).cpu().numpy()
        rep, lives = {}, {}
        for d in devs:
            v0, p0 = value.to(d).clone(), prog.to(d).clone()
            rep[d] = ([v0, torch.empty_like(v0)], [p0, torch.empty_like(p0)],
                      pol.to(d).clone())
        dbits = [torch.zeros((G_blk, steps), dtype=torch.int64,
                             device=sh.block.device) for sh in shards]
        for k, sh in enumerate(shards):
            ids = np.flatnonzero(live_all[sh.g0:sh.g0 + G_blk]).astype(
                np.int32)
            lives[k] = torch.from_numpy(ids).to(sh.block.device)

        def run(d, first, count):
            v, p, polr = rep[d]
            kernels.grid_block_sweeps(
                [(shards[k].block.table, shards[k].probs, shards[k].valid,
                  lives[k], shards[k].g0, shards[k].block.off, dbits[k])
                 for k in groups[d]], discount, v, p, polr, first, count,
                steps)

        if len(devs) == 1:
            run(lead, 0, steps)
        else:
            parts = [(sh.block.device,
                      (slice(sh.g0, sh.g0 + G_blk),
                       slice(sh.block.off, sh.block.off + sh.block.n_states)))
                     for sh in shards]
            for i in range(steps):
                for d in devs:
                    run(d, i, 1)
                nxt = (i + 1) % 2
                exchange_slices({d: [rep[d][0][nxt], rep[d][1][nxt],
                                     rep[d][2]] for d in devs}, parts)
        v, p, polr = rep[lead]
        # an odd step count leaves the frozen points' rows of the other
        # buffer unwritten
        v2, p2 = v[steps % 2], p[steps % 2]
        if steps % 2 and not bool(live_all.all()):
            v2[fz], p2[fz] = value.to(lead)[fz], prog.to(lead)[fz]
        # the shards' slots, a max over each grid slice's state blocks
        bits = torch.zeros((G, steps), dtype=torch.int64, device=lead)
        for sh, db in zip(shards, dbits):
            rows = slice(sh.g0, sh.g0 + G_blk)
            bits[rows] = torch.maximum(bits[rows], db.to(lead))
        return (v2, p2, polr), _bits_to_float(bits, value.dtype)

    return chunk


def grid_shards(tm: TensorMDP, G: int, probs, mesh, axis: str,
                state_axis: str):
    """The `GridShard`s of a grid x state mesh over `tm`'s structure and
    the points' columns `probs` [G, T] (in `tm`'s row order), with the
    grid slice's size and the lead device (shard (0, 0)'s)."""
    S, A = tm.n_states, tm.n_actions
    n_g = mesh.shape[axis]
    n_s = mesh.shape[state_axis]
    check_even_shards(G, mesh, axis=axis, what="grid points")
    check_even_shards(S, mesh, axis=state_axis, what="states")
    devgrid = mesh.grid_devices(axis, state_axis)
    kinds = {d.type for d in devgrid.reshape(-1)}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError("a mesh of CPU or of CUDA devices is needed")
    cols, slot, t_blk = partition_by_state_block(tm, n_s)
    check_vi_working_set(t_blk, S, A, tm.prob.dtype, shards=n_s)
    s_blk, G_blk = S // n_s, G // n_g
    probs = _np(probs)
    probs_b = np.zeros((G, n_s * t_blk), probs.dtype)
    probs_b[:, slot] = probs
    lead = devgrid[0, 0]
    cuda = lead.type == "cuda"
    blocks: dict = {}
    shards = []
    for i in range(n_g):
        for j in range(n_s):
            dev = devgrid[i, j]
            if (j, dev) not in blocks:
                blocks[(j, dev)] = make_blocks(
                    [c[j * t_blk:(j + 1) * t_blk] for c in cols], 1, t_blk,
                    s_blk, A, [dev])[0]
                blocks[(j, dev)] = Block(blocks[(j, dev)].table, j * s_blk,
                                         blocks[(j, dev)].n_real)
            b = blocks[(j, dev)]
            pc = b.table.sort_rows(torch.from_numpy(np.ascontiguousarray(
                probs_b[i * G_blk:(i + 1) * G_blk,
                        j * t_blk:(j + 1) * t_blk])))
            if cuda:
                shards.append(GridShard(b, i * G_blk, pc,
                                        grid_valid_segments(b.table, pc),
                                        None))
            else:
                shards.append(GridShard(
                    b, i * G_blk, pc, None,
                    [_block_mask(b, pc[g]) for g in range(G_blk)]))
    return shards, G_blk, lead


def make_grid_state_chunk_step(tm: TensorMDP, G: int, probs, *, discount,
                               mesh, axis: str = "g",
                               state_axis: str = "s"):
    """Grid x state 2-D mesh chunk step: the [G] grid axis split over
    `axis` and each point's state space over `state_axis`.

    `probs` [G, T] are the points' probability columns in `tm`'s row
    order (`tm.sort_rows`). They are bucketed through the state
    partition's `slot` map; shard (i, j) sweeps grid slice i over state
    block j, one K16-grid launch a sweep on the card
    (`_grid_state_chunk_plain` on the CPU), and writes its [G_blk, s_blk]
    part of the replicated [G, S] planes.

    The bit-freezing contract of `explicit.make_grid_vi_chunk`: frozen
    points pass their carry through unchanged and report delta 0, so each
    point's fixpoint equals the 1-D grid solve (and the solo chunked
    solve) bit for bit.

    Returns `(chunk_step, place)` with the `run_grid_chunk_driver`
    convention: `chunk_step(carry, frozen, steps)`, `place(x)` a host
    array on the lead device."""
    shards, G_blk, lead = grid_shards(tm, G, probs, mesh, axis, state_axis)
    disc = tm._cast(discount)

    def place(x):
        return torch.from_numpy(np.asarray(x)).to(lead)

    if lead.type == "cuda":
        return _grid_state_chunk_cuda(shards, G, G_blk, disc), place
    return _grid_state_chunk_plain(shards, G_blk, disc), place
