"""Fixed-capacity block DAG as a structure of lane-batched planes (port of
cpr_tpu/core/dag.py).

Reference counterparts:
- simulator/lib/dag.ml — append-only DAG, serial ids, O(1) parent/child
  access, per-node visibility views (dag.ml:39-45),
- simulator/lib/simulator.ml:2-10 — per-block metadata {value; pow;
  signature; visibility; received_at; rewards},
- reward accumulation along `precursor` (simulator/lib/simulator.ml:377-388)
  becomes per-block cumulative reward columns written at append time.

Where the JAX package writes one lane's DAG and vmaps it, every plane
here carries a leading lane axis: a per-slot field is `[L, B]`, a parent
slot is one `[L, B]` int32 plane of `parents`, the ancestry planes are
`[L, B, B]` bool, and `n`, `live_floor` and `overflow` are `[L]`. Index
arguments (tips, targets) are `[L]` int32 tensors, one slot per lane.
The field names, modes (full capacity, lifted, ring window, ancestry
planes) and tie rules are the reference's: an argmin/argmax picks the
lowest slot among equals, and only `first_by_age` orders by age.

Every function is functional (returns a new `Dag`; planes it changes are
copies), plain PyTorch, and runs on any device. Kernel K8
(`csrc/dag.cuh`) holds the same primitives as CUDA device functions for
ring windows with ancestry planes, one warp per lane; they run inside
the env stream kernels (K10), and `dag_script` below is their check.

Convention: two parties — miner 0 is the attacker, miner 1 the defender
cloud (simulator/gym/engine.ml:100-107). `vis_a` is the attacker's view,
`vis_d` the defender cloud's; a block the attacker appends starts
withheld (vis_a & ~vis_d) until a release sets vis_d.
"""

from __future__ import annotations

import dataclasses
import math

import torch

NONE = -1
NO_POW = math.inf  # pow_hash for non-PoW blocks; smaller = better

ATTACKER = 0
DEFENDER = 1

I32, F32, BOOL = torch.int32, torch.float32, torch.bool


@dataclasses.dataclass
class Dag:
    """One DAG per lane; field order and names as the reference's."""

    parents: tuple  # P x [L, B] int32, NONE-padded; slot 0 = precursor
    auxf: torch.Tensor  # [L, B] float32 protocol cache (bk: leader hash)
    auxg: torch.Tensor  # [L, B] float32
    aux2: torch.Tensor  # [L, B] int32, NONE when unused
    anc2: torch.Tensor  # [L, LB] int32 binary-lifting planes (LB = 0: off)
    anc4: torch.Tensor
    anc8: torch.Tensor
    anc16: torch.Tensor
    gid: torch.Tensor  # [L, RB] int32 ring occupant id (RB = 0: full mode)
    live_floor: torch.Tensor  # [L] int32 lowest still-referenceable gid
    chain: torch.Tensor  # [L, MB, MB] bool chain-ancestry rows
    closure: torch.Tensor  # [L, MB, MB] bool parent-closure rows
    kind: torch.Tensor  # [L, B] int32
    height: torch.Tensor  # [L, B] int32
    aux: torch.Tensor  # [L, B] int32
    pow_hash: torch.Tensor  # [L, B] float32
    signer: torch.Tensor  # [L, B] int32
    miner: torch.Tensor  # [L, B] int32
    vis_a: torch.Tensor  # [L, B] bool
    vis_d: torch.Tensor  # [L, B] bool
    vis_d_since: torch.Tensor  # [L, B] float32
    born_at: torch.Tensor  # [L, B] float32
    cum_atk: torch.Tensor  # [L, B] float32
    cum_def: torch.Tensor  # [L, B] float32
    cum_prog: torch.Tensor  # [L, B] float32
    n: torch.Tensor  # [L] int32 blocks appended (ring: all-time count)
    overflow: torch.Tensor  # [L] bool

    def replace(self, **kw) -> "Dag":
        return dataclasses.replace(self, **kw)

    @property
    def is_ring(self) -> bool:
        return self.gid.shape[-1] > 0

    @property
    def has_masks(self) -> bool:
        return self.chain.shape[-1] > 0

    @property
    def lifted(self) -> bool:
        return self.anc2.shape[-1] > 0

    @property
    def parent0(self) -> torch.Tensor:
        return self.parents[0]

    @property
    def capacity(self) -> int:
        return self.parents[0].shape[-1]

    @property
    def max_parents(self) -> int:
        return len(self.parents)

    @property
    def n_lanes(self) -> int:
        return self.parents[0].shape[0]

    @property
    def device(self):
        return self.parents[0].device

    def slots(self) -> torch.Tensor:
        """[B] iota over block slots."""
        return torch.arange(self.capacity, dtype=I32, device=self.device)

    def exists(self) -> torch.Tensor:
        """[L, B] slots holding a live block (ring: gid in [0, n), which
        rejects stale occupants surviving a logical reset)."""
        if self.is_ring:
            return (self.gid >= 0) & (self.gid < self.n[:, None])
        return self.slots()[None, :] < self.n[:, None]

    def age_key(self) -> torch.Tensor:
        """[L, B] insertion-order key (the ring's gid, else the slot)."""
        if self.is_ring:
            return self.gid
        return self.slots()[None, :].expand(self.n_lanes, -1)


FIELDS = tuple(f.name for f in dataclasses.fields(Dag))
PLANE_DTYPES = {
    "auxf": F32, "auxg": F32, "aux2": I32, "anc2": I32, "anc4": I32,
    "anc8": I32, "anc16": I32, "gid": I32, "live_floor": I32, "chain": BOOL,
    "closure": BOOL, "kind": I32, "height": I32, "aux": I32,
    "pow_hash": F32, "signer": I32, "miner": I32, "vis_a": BOOL,
    "vis_d": BOOL, "vis_d_since": F32, "born_at": F32, "cum_atk": F32,
    "cum_def": F32, "cum_prog": F32, "n": I32, "overflow": BOOL}


def empty(n_lanes: int, capacity: int, max_parents: int, lift: bool = False,
          ring: bool = False, anc_masks: bool = False, device=None) -> Dag:
    """`n_lanes` empty DAGs (dag.py:168-231): `lift` materializes the
    anc2..anc16 jump planes, `ring` turns the capacity into a window over
    the W most recent blocks, `anc_masks` materializes the chain/closure
    ancestry planes. ring and lift do not combine."""
    if ring and lift:
        raise ValueError("ring + lift: jumps could land on reused slots")
    L, B, P = n_lanes, capacity, max_parents
    LB, RB, MB = (B if lift else 0), (B if ring else 0), (B if anc_masks
                                                         else 0)

    def f(fill, dt, width=B):
        return torch.full((L, width), fill, dtype=dt, device=device)

    return Dag(
        parents=tuple(f(NONE, I32) for _ in range(P)),
        auxf=f(0.0, F32), auxg=f(0.0, F32), aux2=f(NONE, I32),
        anc2=f(NONE, I32, LB), anc4=f(NONE, I32, LB), anc8=f(NONE, I32, LB),
        anc16=f(NONE, I32, LB),
        gid=f(NONE, I32, RB),
        live_floor=torch.zeros(L, dtype=I32, device=device),
        chain=torch.zeros((L, MB, MB), dtype=BOOL, device=device),
        closure=torch.zeros((L, MB, MB), dtype=BOOL, device=device),
        kind=f(0, I32), height=f(0, I32), aux=f(0, I32),
        pow_hash=f(NO_POW, F32), signer=f(NONE, I32), miner=f(NONE, I32),
        vis_a=f(False, BOOL), vis_d=f(False, BOOL),
        vis_d_since=f(0.0, F32), born_at=f(0.0, F32), cum_atk=f(0.0, F32),
        cum_def=f(0.0, F32), cum_prog=f(0.0, F32),
        n=torch.zeros(L, dtype=I32, device=device),
        overflow=torch.zeros(L, dtype=BOOL, device=device),
    )


# -- small helpers --------------------------------------------------------------

def lanes(dag: Dag) -> torch.Tensor:
    return torch.arange(dag.n_lanes, device=dag.device)


def at(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """plane[lane, idx[lane]] for a [L, B] plane and in-range [L] idx."""
    return plane.gather(1, idx.to(torch.int64)[:, None])[:, 0]


def full(dag: Dag, value, dtype) -> torch.Tensor:
    """`value` (a number or an [L] tensor) as an [L] tensor of `dtype`."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype).expand(dag.n_lanes)
    return torch.full((dag.n_lanes,), value, dtype=dtype, device=dag.device)


def where(c, a, b):
    return torch.where(c, a, b)


# -- append ---------------------------------------------------------------------

def append(dag: Dag, parents, **kw):
    """Append one block on every lane; returns (dag, idx [L])."""
    return append_if(dag, full(dag, True, BOOL), parents, **kw)


def append_if(dag: Dag, cond, parents, *, kind=0, height=0, aux=0,
              pow_hash=NO_POW, signer=NONE, miner=NONE, vis_a=True,
              vis_d=True, time=0.0, reward_atk=0.0, reward_def=0.0,
              progress=None, auxf=0.0, auxg=0.0, aux2=NONE,
              chain_parent=None):
    """`append` gated by `cond` [L] (dag.py:252-366); returns (dag,
    idx_or_NONE [L]). `parents` is an [L, P] int32 row per lane
    (NONE-padded); parent slot 0 is the precursor along which the
    cumulative rewards accumulate. Every field of a claimed slot is
    written; ring mode claims slot n % W and flags `overflow` when that
    evicts a live block at or above `live_floor`."""
    L, B = dag.n_lanes, dag.capacity
    cond = full(dag, cond, BOOL)
    ln = lanes(dag)
    if dag.is_ring:
        idx = torch.remainder(dag.n, B)
        evicted = at(dag.gid, idx)
        overflow = dag.overflow | (cond & (evicted >= 0) & (evicted < dag.n)
                                   & (evicted >= dag.live_floor))
    else:
        idx = torch.minimum(dag.n, full(dag, B - 1, I32))
        overflow = dag.overflow | (cond & (dag.n >= B))
    parents = parents.to(I32)
    p0 = parents[:, 0]
    has_p0 = p0 >= 0
    base = where(has_p0, p0, torch.zeros_like(p0))
    zero = torch.zeros(L, dtype=F32, device=dag.device)
    cum_atk = where(has_p0, at(dag.cum_atk, base), zero) + full(
        dag, reward_atk, F32)
    cum_def = where(has_p0, at(dag.cum_def, base), zero) + full(
        dag, reward_def, F32)
    if progress is None:
        cum_prog = where(has_p0, at(dag.cum_prog, base), zero) + 1.0
    else:
        cum_prog = full(dag, progress, F32)

    def put(arr, value):
        value = full(dag, value, arr.dtype) if arr.dim() == 2 else value
        out = arr.clone()
        old = out[ln, idx]
        c = cond if arr.dim() == 2 else cond[:, None]
        out[ln, idx] = where(c, value, old)
        return out

    upd = {}
    if dag.lifted:
        def hop(plane, v):
            return where(v >= 0, at(plane, v.clamp(min=0)),
                         torch.full_like(v, NONE))

        v2 = hop(dag.parents[0], p0)
        v4 = hop(dag.anc2, v2)
        v8 = hop(dag.anc4, v4)
        v16 = hop(dag.anc8, v8)
        upd.update(anc2=put(dag.anc2, v2), anc4=put(dag.anc4, v4),
                   anc8=put(dag.anc8, v8), anc16=put(dag.anc16, v16))
    if dag.is_ring:
        upd["gid"] = put(dag.gid, dag.n)
    if dag.has_masks:
        new_bit = dag.slots()[None, :] == idx[:, None]
        cp = p0 if chain_parent is None else full(dag, chain_parent, I32)
        crow = new_bit | _valid_row(dag, dag.chain, cp)
        orow = new_bit
        for p in range(dag.max_parents):
            orow = orow | _valid_row(dag, dag.closure, parents[:, p])
        upd["chain"] = put(dag.chain, crow)
        upd["closure"] = put(dag.closure, orow)

    vis_d_t = full(dag, vis_d, BOOL)
    time_t = full(dag, time, F32)
    dag = dag.replace(
        parents=tuple(put(plane, parents[:, p])
                      for p, plane in enumerate(dag.parents)),
        auxf=put(dag.auxf, auxf), auxg=put(dag.auxg, auxg),
        aux2=put(dag.aux2, aux2), **upd,
        kind=put(dag.kind, kind), height=put(dag.height, height),
        aux=put(dag.aux, aux), pow_hash=put(dag.pow_hash, pow_hash),
        signer=put(dag.signer, signer), miner=put(dag.miner, miner),
        vis_a=put(dag.vis_a, vis_a), vis_d=put(dag.vis_d, vis_d_t),
        vis_d_since=put(dag.vis_d_since,
                        where(vis_d_t, time_t, torch.full_like(time_t,
                                                               math.inf))),
        born_at=put(dag.born_at, time_t),
        cum_atk=put(dag.cum_atk, cum_atk), cum_def=put(dag.cum_def, cum_def),
        cum_prog=put(dag.cum_prog, cum_prog),
        n=(dag.n + cond.to(I32) if dag.is_ring
           else torch.minimum(dag.n + cond.to(I32), full(dag, B, I32))),
        overflow=overflow,
    )
    return dag, where(cond, idx, torch.full_like(idx, NONE))


# -- ring window and ancestry planes ------------------------------------------

def retire_below(dag: Dag, floor_gid) -> Dag:
    """Raise the ring retirement frontier to `floor_gid` [L] (monotone);
    no-op in full mode (dag.py:369-380)."""
    if not dag.is_ring:
        return dag
    return dag.replace(live_floor=torch.maximum(dag.live_floor,
                                                full(dag, floor_gid, I32)))


def _valid_row(dag: Dag, plane, x):
    """[L, B] bits of row `plane[x]` that still refer to their original
    blocks (ring: the occupant-gid filter drops reclaimed columns)."""
    xi = x.clamp(min=0)
    row = plane[lanes(dag), xi] & (x >= 0)[:, None]
    if dag.is_ring:
        row = row & (dag.gid <= at(dag.gid, xi)[:, None]) & (dag.gid >= 0)
    return row


def chain_mask(dag: Dag, x) -> torch.Tensor:
    """x and its ancestors along the chain pointer (needs anc_masks)."""
    return _valid_row(dag, dag.chain, x)


def closure_mask(dag: Dag, x) -> torch.Tensor:
    """x and its full recursive parent-row closure (needs anc_masks)."""
    return _valid_row(dag, dag.closure, x)


def release_masked(dag: Dag, tip, time) -> Dag:
    """release_with_ancestors via one closure-row read (dag.py:409)."""
    return release(dag, closure_mask(dag, tip), time)


def _argmax_where(m, key, fill):
    """(first slot of the largest `key` where m, any(m)) per lane."""
    best = torch.argmax(where(m, key, torch.full_like(key, fill)),
                        dim=1).to(I32)
    return where(m.any(1), best, torch.full_like(best, NONE))


def common_ancestor_masked(dag: Dag, a, b):
    """Deepest (max height) shared chain element of two tips (dag.py:418)."""
    m = chain_mask(dag, a) & chain_mask(dag, b)
    return _argmax_where(m, dag.height, -1)


def chain_first_at_most(dag: Dag, tip, values, target, extra_mask=None):
    """Highest chain member of `tip` whose `values` entry is <= target
    [L] (dag.py:428), for values nonincreasing down the chain."""
    m = chain_mask(dag, tip) & (values <= full(dag, target, I32)[:, None])
    if extra_mask is not None:
        m = m & extra_mask
    return _argmax_where(m, dag.height, -1)


def drop_if_retired(dag: Dag, idx):
    """NONE where slot `idx` has retired below the ring floor (dag.py:441);
    call right after retire_below."""
    if not dag.is_ring:
        return idx
    retired = (idx >= 0) & (at(dag.gid, idx.clamp(min=0)) < dag.live_floor)
    return where(retired, torch.full_like(idx, NONE), idx)


def first_by_age(dag: Dag, mask):
    """Earliest-appended block in `mask` per lane, NONE if empty (dag.py:454)."""
    key = where(mask, dag.age_key(), torch.full_like(dag.age_key(), 2**30))
    best = torch.argmin(key, dim=1).to(I32)
    return where(mask.any(1), best, torch.full_like(best, NONE))


def last_by_age(dag: Dag, mask):
    """Latest-appended block in `mask` per lane, NONE if empty (dag.py:463):
    the wrap-safe form of the highest masked slot."""
    key = where(mask, dag.age_key(), torch.full_like(dag.age_key(), -1))
    best = torch.argmax(key, dim=1).to(I32)
    return where(mask.any(1), best, torch.full_like(best, NONE))


def descendants_mask(dag: Dag, a) -> torch.Tensor:
    """[L, B] blocks with `a` [L] on their chain row, `a` included
    (dag.py:471): one column of the chain plane. In a ring a row's bit at
    column a means the current occupant only if the row's owner is at
    least as young as it (`gid >= gid[a]`)."""
    ai = a.clamp(min=0)
    col = dag.chain[lanes(dag), :, ai] & (a >= 0)[:, None]
    if dag.is_ring:
        col = col & (dag.gid >= at(dag.gid, ai)[:, None])
    return col & dag.exists()


def select_vis(cond, released: Dag, dag: Dag) -> Dag:
    """where(cond, released, dag) on the two fields release changes."""
    c = cond[:, None]
    return dag.replace(vis_d=where(c, released.vis_d, dag.vis_d),
                       vis_d_since=where(c, released.vis_d_since,
                                         dag.vis_d_since))


def newer_than(dag: Dag, v) -> torch.Tensor:
    """[L, B] blocks appended after v (the ring's stale-pointer guard;
    all true in full mode)."""
    if not dag.is_ring:
        return torch.ones((dag.n_lanes, dag.capacity), dtype=BOOL,
                          device=dag.device)
    return dag.gid > at(dag.gid, v.clamp(min=0))[:, None]


def children0_mask(dag: Dag, v) -> torch.Tensor:
    """[L, B] blocks whose precursor (parent slot 0) is v (dag.py:520)."""
    return dag.exists() & (dag.parent0 == v[:, None]) & newer_than(dag, v)


def release(dag: Dag, mask, time) -> Dag:
    """Make the masked withheld blocks visible to the defender cloud."""
    newly = mask & ~dag.vis_d & dag.exists()
    return dag.replace(
        vis_d=dag.vis_d | newly,
        vis_d_since=where(newly, full(dag, time, F32)[:, None],
                          dag.vis_d_since))


# -- walk-based queries (full mode) ------------------------------------------
#
# The reference's walks are unbounded while loops. A DAG that filled its
# capacity pins its appends to the last slot, which can close a parent
# cycle there, and a walk on it never ends. Here every walk stops after
# `walk_bound` iterations, which no walk of a DAG without a cycle reaches
# (K8's walks stop at the same bound).

def walk_bound(dag: Dag) -> int:
    """The iteration bound of every walk: two per slot, and two more."""
    return 2 * dag.capacity + 2


def release_chain(dag: Dag, tip, time) -> Dag:
    """Release `tip`, its parent row, and walk down the precursor chain
    until a block that was defender-visible before the call
    (dag.py:596-646), each lane until its own walk ends."""
    slots = dag.slots()[None, :]
    exists = dag.exists()
    time = full(dag, time, F32)[:, None]
    vis_d, since = dag.vis_d, dag.vis_d_since
    t = tip.clone()
    t_vis = at(vis_d, tip.clamp(min=0))
    for _ in range(walk_bound(dag)):
        live = (t >= 0) & ~t_vis
        if not bool(live.any()):
            break
        ti = t.clamp(min=0)
        nxt = at(dag.parent0, ti)
        nxt_vis = at(vis_d, nxt.clamp(min=0))
        mask = slots == ti[:, None]
        for plane in dag.parents:
            v = at(plane, ti)
            mask = mask | ((slots == v[:, None]) & (v >= 0)[:, None])
        newly = mask & ~vis_d & exists & live[:, None]
        vis_d = vis_d | newly
        since = where(newly, time, since)
        t = where(live, nxt, t)
        t_vis = where(live, nxt_vis, t_vis)
    return dag.replace(vis_d=vis_d, vis_d_since=since)


def _parents_hit_dense(dag: Dag, mask) -> torch.Tensor:
    """[L, B] blocks named in the parent row of any block in `mask`."""
    slots = dag.slots()[None, None, :]
    hits = torch.zeros_like(mask)
    for col in dag.parents:
        m = mask & (col >= 0)
        hits = hits | (m[:, :, None] & (col[:, :, None] == slots)).any(1)
    return hits


def release_closure(dag: Dag, tip, time) -> Dag:
    """`release_chain` plus the visibility-closure fixpoint: any parent
    of a defender-visible block becomes visible (dag.py:649-681)."""
    dag = release_chain(dag, tip, time)
    exists = dag.exists()
    time = full(dag, time, F32)[:, None]
    vis_d, since = dag.vis_d, dag.vis_d_since

    def missing(vis):
        return _parents_hit_dense(dag, exists & vis) & ~vis & exists

    m = missing(vis_d)
    while bool(m.any()):
        newly = m & ~vis_d & exists
        vis_d = vis_d | newly
        since = where(newly, time, since)
        m = missing(vis_d)
    return dag.replace(vis_d=vis_d, vis_d_since=since)


def walk_back(dag: Dag, tip, stop_fn):
    """Follow parent slot 0 from `tip` while not stop_fn(dag, idx) [L]
    (monotone along the chain), returning the first chain node where it
    holds, or NONE past the root (dag.py:684-725); a lifted DAG jumps by
    the largest anc plane whose landing node does not yet satisfy it."""
    i = tip.clone()

    def ok(j):
        return (j >= 0) & ~stop_fn(dag, j.clamp(min=0))

    for _ in range(walk_bound(dag)):
        live = ok(i)
        if not bool(live.any()):
            break
        ii = i.clamp(min=0)
        nxt = at(dag.parent0, ii)
        if dag.lifted:
            for plane in (dag.anc2, dag.anc4, dag.anc8, dag.anc16):
                j = at(plane, ii)
                nxt = where(ok(j), j, nxt)
        i = where(live, nxt, i)
    return i


def block_at_height(dag: Dag, tip, target_height, is_block_fn=None):
    """The first block at height <= target_height down the precursor
    chain from `tip` (dag.py:728-748)."""
    target = full(dag, target_height, I32)

    def stop(d, i):
        s = at(d.height, i) <= target
        if is_block_fn is not None:
            s = s & is_block_fn(d, i)
        return s

    if is_block_fn is not None and dag.lifted:
        i = tip.clone()
        for _ in range(walk_bound(dag)):
            live = (i >= 0) & ~stop(dag, i.clamp(min=0))
            if not bool(live.any()):
                break
            i = where(live, at(dag.parent0, i.clamp(min=0)), i)
        return i
    return walk_back(dag, tip, stop)


def common_ancestor_by_height(dag: Dag, a, b):
    """Common ancestor of two chain tips by a height-synchronized walk
    (dag.py:751-817); binary-lifting LCA on a lifted DAG."""
    x, y = a.clone(), b.clone()
    p0 = dag.parent0
    for _ in range(walk_bound(dag)):
        live = (x != y) & (x >= 0) & (y >= 0)
        if not bool(live.any()):
            break
        xi, yi = x.clamp(min=0), y.clamp(min=0)
        hx, hy = at(dag.height, xi), at(dag.height, yi)
        if dag.lifted:
            planes = (dag.anc16, dag.anc8, dag.anc4, dag.anc2)
            dists = (16, 8, 4, 2)

            def down(i, dist):
                out = at(p0, i)
                for plane, dj in zip(planes[::-1], dists[::-1]):
                    j = at(plane, i)
                    out = where((dist >= dj) & (j >= 0), j, out)
                return out

            eq_x, eq_y = at(p0, xi), at(p0, yi)
            for plane in planes[::-1]:
                jx, jy = at(plane, xi), at(plane, yi)
                u = (jx >= 0) & (jy >= 0) & (jx != jy)
                eq_x, eq_y = where(u, jx, eq_x), where(u, jy, eq_y)
            d = hx - hy
            nx = where(d > 0, down(xi, d), where(d < 0, x, eq_x))
            ny = where(d < 0, down(yi, -d), where(d > 0, y, eq_y))
        else:
            nx = where(hx >= hy, at(p0, xi), x)
            ny = where(hy >= hx, at(p0, yi), y)
        x, y = where(live, nx, x), where(live, ny, y)
    return x


# -- masks and selection --------------------------------------------------------

def mask_of(idx, valid, B: int) -> torch.Tensor:
    """[L, B] mask with idx[:, i] set where valid[:, i] (dag.py:820)."""
    slots = torch.arange(B, dtype=I32, device=idx.device)
    return ((idx[:, :, None] == slots) & valid[:, :, None]).any(1)


def top_k_by(score, mask, k: int, largest: bool = False):
    """Slots of the k best masked entries by score per lane, ascending by
    default; (idx [L, k] int32, valid [L, k]). Ties go to the lowest slot
    and, with fewer than k entries, the later picks are slot 0 with
    valid False (dag.py:830-860: k passes of argmin/argmax for k <= 16,
    lax.top_k beyond).

    One stable sort gives the same picks: the extraction takes entries in
    (score, slot) order, and once only neutral scores remain every pass
    returns slot 0, which the `where` restores; beyond k = 16 lax.top_k
    returns the neutral entries' own slots, as the sort does."""
    neutral = -math.inf if largest else math.inf
    s = where(mask, score.to(F32), torch.full_like(score, neutral,
                                                   dtype=F32))
    vals, idx = torch.sort(s, dim=1, descending=largest, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(I32)
    valid = vals != neutral
    if k <= 16:
        idx = where(valid, idx, torch.zeros_like(idx))
    return idx, valid


# -- the K8 check script ------------------------------------------------------
#
# A register machine over the primitives above, run on every lane at once:
# op t (shared by all lanes) reads its per-lane arguments `args[t, lane]`
# (int32) and `fargs[t, lane]` (float32), reads and writes eight int32 slot
# registers per lane, and records four int32 results per lane. The same
# script runs through the reference's core/dag.py (tests), through
# `script_plain` and through K8's check kernel (csrc/dag_script.cu), and
# every result and the final DAG must agree. An argument naming a register
# is its index, -1 for NONE; `hreg(r)` is the height of register r's slot
# (0 for NONE).
#   APPEND         cond, dst, kind, height - hreg(parent 0), vis_d, miner,
#                  aux, progress given (height * 2), parent registers
#                  [8, 8 + P); fargs time, reward_atk, reward_def, pow_hash;
#                  out (idx, n, overflow, 0)
#   RELEASE_MASKED tip; fargs time                     out (visible, ...)
#   SELECT_VIS     tip, cond; fargs time               out (visible, ...)
#   RELEASE_TOPK   block, take; top SCRIPT_TOPK of its precursor-children
#                  by born_at, the first `take` released   out (visible, n)
#   RETIRE         floor register (its gid), register to drop_if_retired
#                  out (live_floor, register)
#   CA             a, b, dst: common_ancestor_masked   out (dst)
#   CHAIN_FIRST    tip, depth, dst: chain_first_at_most(height <=
#                  hreg(tip) - depth)                   out (dst)
#   FIRST_BY_AGE   block, kind, dst: of its precursor-children of kind
#   TOPK           -, kind: top SCRIPT_TOPK of existing blocks of kind by
#                  born_at    out (sum of valid slots, n valid, first, last)
#   COUNTS         r: out (exists, newer than r, precursor-children of r,
#                  first_by_age(exists))
#   LAST_BY_AGE    block, kind, dst: of its precursor-children of kind
#   DESCENDANTS    a: out (its descendants_mask's count, last_by_age,
#                  first_by_age, and count of defender-visible ones)
# (the vote-quorum envs' queries, in a second script `RING_OPS_Q` so that
# the first script's draws stay as they were)
# and, in full mode only (the walk-based queries):
#   RELEASE_CHAIN, RELEASE_CLOSURE   tip; fargs time    out (visible, ...)
#   BLOCK_AT_HEIGHT  tip, depth, dst       CA_HEIGHT  a, b, dst

(OP_APPEND, OP_RELEASE_MASKED, OP_SELECT_VIS, OP_RELEASE_TOPK, OP_RETIRE,
 OP_CA, OP_CHAIN_FIRST, OP_FIRST_BY_AGE, OP_TOPK, OP_COUNTS,
 OP_RELEASE_CHAIN, OP_RELEASE_CLOSURE, OP_BLOCK_AT_HEIGHT,
 OP_CA_HEIGHT, OP_LAST_BY_AGE, OP_DESCENDANTS) = range(16)
SCRIPT_REGS, SCRIPT_TOPK, SCRIPT_OUT = 8, 5, 4
RING_OPS = tuple(range(10))
RING_OPS_Q = RING_OPS + (OP_LAST_BY_AGE, OP_DESCENDANTS)
FULL_OPS = (OP_APPEND, OP_RELEASE_TOPK, OP_RETIRE, OP_FIRST_BY_AGE, OP_TOPK,
            OP_COUNTS, OP_RELEASE_CHAIN, OP_RELEASE_CLOSURE,
            OP_BLOCK_AT_HEIGHT, OP_CA_HEIGHT)


def make_script(seed: int, n_lanes: int, n_ops: int, max_parents: int,
                ops=RING_OPS, lift: bool = False):
    """A numpy-seeded script: (ops [T] int32, args [T, L, 8 + P] int32,
    fargs [T, L, 4] float32). Op 0 appends a genesis block to register 0
    on every lane; appends are half the ops. Times repeat (t // 3), so
    born_at ties exercise the lowest-slot rule. `lift` keeps heights one
    above parent 0 (the lifted walks' precondition)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    T, L, P, R = n_ops, n_lanes, max_parents, SCRIPT_REGS
    others = [o for o in ops if o != OP_APPEND]
    op = np.where(rng.random(T) < 0.5, OP_APPEND,
                  rng.choice(others, T)).astype(np.int32)
    op[0] = OP_APPEND
    args = np.full((T, L, 8 + P), -1, np.int32)
    fargs = np.zeros((T, L, 4), np.float32)
    reg = lambda: rng.integers(0, R, L)  # noqa: E731
    for t in range(T):
        a = args[t]
        fargs[t, :, 0] = t // 3
        if op[t] == OP_APPEND:
            kind = rng.integers(0, 2, L)
            a[:, 0] = rng.random(L) < 0.9
            a[:, 1] = reg()
            a[:, 2] = kind
            a[:, 3] = 1 if lift else np.where(kind == 0, 1, 0)
            a[:, 4] = rng.random(L) < 0.5
            a[:, 5] = rng.integers(-1, 2, L)
            a[:, 6] = rng.integers(0, 3, L)
            a[:, 7] = rng.random(L) < 0.3
            a[:, 8] = reg()
            for p in range(1, P):
                a[:, 8 + p] = np.where(rng.random(L) < 0.4, reg(), -1)
            fargs[t, :, 1:3] = rng.integers(0, 3, (L, 2))
            fargs[t, :, 3] = rng.random(L)
        else:
            a[:, 0], a[:, 1], a[:, 2] = reg(), reg(), reg()
            if op[t] in (OP_SELECT_VIS, OP_FIRST_BY_AGE, OP_TOPK,
                         OP_LAST_BY_AGE):
                a[:, 1] = rng.integers(0, 2, L)
            if op[t] in (OP_RELEASE_TOPK, OP_CHAIN_FIRST, OP_BLOCK_AT_HEIGHT):
                a[:, 1] = rng.integers(0, SCRIPT_TOPK + 1, L)
        if t == 0:
            a[:, 0], a[:, 1], a[:, 8:] = 1, 0, -1
    return op, args, fargs


def _script_op(dag: Dag, regs, op: int, a, f):
    """One op of the script on every lane; returns (dag, regs, out)."""
    L, dev = dag.n_lanes, dag.device
    out = torch.zeros((L, SCRIPT_OUT), dtype=I32, device=dev)
    ln = lanes(dag)

    def reg(i):
        return torch.where(i >= 0, regs[ln, i.clamp(min=0).long()],
                           torch.full_like(i, NONE))

    def hreg(r):
        return torch.where(r >= 0, at(dag.height, r.clamp(min=0)),
                           torch.zeros_like(r))

    def visible(d):
        return (d.vis_d & d.exists()).sum(1).to(I32)

    def set_reg(dst, v):
        r = regs.clone()
        r[ln, dst.long()] = v
        return r

    x, y, z = reg(a[:, 0]), reg(a[:, 1]), a[:, 2]
    if op == OP_APPEND:
        P = dag.max_parents
        parents = torch.stack([reg(a[:, 8 + p]) for p in range(P)], 1)
        height = hreg(parents[:, 0]) + a[:, 3]
        # progress given where a[7]: height * 2, else the default (the
        # precursor's + 1), both per lane
        base = torch.where(parents[:, 0] >= 0,
                           at(dag.cum_prog, parents[:, 0].clamp(min=0)),
                           torch.zeros(L, dtype=F32, device=dev)) + 1.0
        progress = torch.where(a[:, 7] != 0, (height * 2).to(F32), base)
        dag, idx = append_if(
            dag, a[:, 0] != 0, parents, kind=a[:, 2], height=height,
            vis_d=a[:, 4] != 0, miner=a[:, 5], aux=a[:, 6], time=f[:, 0],
            reward_atk=f[:, 1], reward_def=f[:, 2], pow_hash=f[:, 3],
            progress=progress)
        regs = set_reg(a[:, 1], idx)
        out[:, 0], out[:, 1], out[:, 2] = idx, dag.n, dag.overflow.to(I32)
    elif op == OP_RELEASE_MASKED:
        dag = release_masked(dag, x, f[:, 0])
        out[:, 0] = visible(dag)
    elif op == OP_SELECT_VIS:
        dag = select_vis(a[:, 1] != 0, release_masked(dag, x, f[:, 0]), dag)
        out[:, 0] = visible(dag)
    elif op == OP_RELEASE_TOPK:
        idx, valid = top_k_by(dag.born_at, children0_mask(dag, x),
                              SCRIPT_TOPK)
        take = torch.arange(SCRIPT_TOPK, device=dev)[None, :] < a[:, 1:2]
        dag = release(dag, mask_of(idx, valid & take, dag.capacity), f[:, 0])
        out[:, 0], out[:, 1] = visible(dag), valid.sum(1).to(I32)
    elif op == OP_RETIRE:
        if dag.is_ring:
            floor = torch.where(x >= 0, at(dag.gid, x.clamp(min=0)),
                                torch.zeros_like(x))
            dag = retire_below(dag, floor)
        dropped = drop_if_retired(dag, y)
        regs = set_reg(a[:, 1].clamp(min=0), dropped)
        out[:, 0], out[:, 1] = dag.live_floor, dropped
    elif op in (OP_CA, OP_CHAIN_FIRST, OP_FIRST_BY_AGE, OP_BLOCK_AT_HEIGHT,
                OP_CA_HEIGHT, OP_LAST_BY_AGE):
        if op == OP_CA:
            v = common_ancestor_masked(dag, x, y)
        elif op == OP_CHAIN_FIRST:
            v = chain_first_at_most(dag, x, dag.height, hreg(x) - a[:, 1])
        elif op == OP_FIRST_BY_AGE:
            v = first_by_age(dag, children0_mask(dag, x)
                             & (dag.kind == a[:, 1:2]))
        elif op == OP_LAST_BY_AGE:
            v = last_by_age(dag, children0_mask(dag, x)
                            & (dag.kind == a[:, 1:2]))
        elif op == OP_BLOCK_AT_HEIGHT:
            v = block_at_height(dag, x, hreg(x) - a[:, 1])
        else:
            v = common_ancestor_by_height(dag, x, y)
        regs = set_reg(z, v)
        out[:, 0] = v
    elif op == OP_TOPK:
        idx, valid = top_k_by(dag.born_at, dag.exists()
                              & (dag.kind == a[:, 1:2]), SCRIPT_TOPK)
        out[:, 0] = torch.where(valid, idx, torch.zeros_like(idx)).sum(1)
        out[:, 1] = valid.sum(1)
        out[:, 2], out[:, 3] = idx[:, 0], idx[:, -1]
    elif op == OP_COUNTS:
        ex = dag.exists()
        out[:, 0] = ex.sum(1)
        out[:, 1] = (newer_than(dag, x) & ex).sum(1)
        out[:, 2] = children0_mask(dag, x).sum(1)
        out[:, 3] = first_by_age(dag, ex)
    elif op == OP_DESCENDANTS:
        m = descendants_mask(dag, x)
        out[:, 0] = m.sum(1)
        out[:, 1] = last_by_age(dag, m)
        out[:, 2] = first_by_age(dag, m)
        out[:, 3] = (m & dag.vis_d).sum(1)
    elif op in (OP_RELEASE_CHAIN, OP_RELEASE_CLOSURE):
        fn = release_chain if op == OP_RELEASE_CHAIN else release_closure
        dag = fn(dag, x, f[:, 0])
        out[:, 0] = visible(dag)
    else:
        raise ValueError(f"unknown script op {op}")
    return dag, regs, out


def script_plain(dag: Dag, ops, args, fargs):
    """Plain twin of K8's check kernel: run the script on `dag` (updated
    functionally); returns (dag, regs [L, 8], out [T, L, 4])."""
    regs = torch.full((dag.n_lanes, SCRIPT_REGS), NONE, dtype=I32,
                      device=dag.device)
    outs = []
    for t in range(len(ops)):
        dag, regs, out = _script_op(dag, regs, int(ops[t]), args[t],
                                    fargs[t])
        outs.append(out)
    return dag, regs, torch.stack(outs)


def dag_script(dag: Dag, ops, args, fargs):
    """Run the K8 check script (see above) on `dag`: K8's check kernel on
    CUDA (ring windows with ancestry planes; the DAG is updated in place),
    `script_plain` on the CPU. `ops` is a numpy or host int32 array,
    `args`/`fargs` tensors [T, L, 8 + P] / [T, L, 4] on the DAG's device.
    Returns (dag, regs, out)."""
    if dag.device.type == "cuda":
        from cpr_tpu_torch import kernels
        regs, out = kernels.dag_script(dag, ops, args, fargs)
        return dag, regs, out
    if dag.device.type != "cpu":
        raise ValueError(f"unsupported device {dag.device}")
    return script_plain(dag, ops, args, fargs)
