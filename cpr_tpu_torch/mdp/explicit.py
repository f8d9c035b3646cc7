"""Explicit (tabular) MDPs as flat transition arrays + torch solvers.

Reference counterpart: `cpr_tpu/mdp/explicit.py` (itself after
mdp/lib/explicit_mdp.py). The host half — the `MDP` table, its
invariant check, the probabilistic-termination transform `ptmdp`, the
reachable-state search and the sparse steady-state solve — is numpy and
scipy, copied. The device half solves a `TensorMDP` with four
hand-written CUDA kernels:

- K4 (`csrc/mdp_sweep.cu`), one Bellman sweep: two segment sums over the
  rows of each (state, action) in a fixed order, then the masked greedy
  backup and the max value delta; it drives value iteration, both the
  while impl (the stop rule evaluated on the device) and the chunked
  impl with Anderson mixing between chunks;
- K5 (`csrc/mdp_sweep.cu`), one policy-evaluation sweep over each
  state's on-policy segment;
- K7 (`csrc/mdp_sweep.cu`), K4 over a grid of G probability columns
  with per-point validity and freezing (`make_grid_vi_chunk`,
  `run_grid_chunk_driver`);
- K6 (`csrc/rtdp.cu`), batched eps-greedy RTDP walkers in one persistent
  launch (`TensorMDP.rtdp`, `cpr_tpu_torch.mdp.rtdp_graph`).

All read the TensorMDP's rows, sorted once by segment. Their plain torch
twins (`make_vi_sweep`, `_pe_sweep`, `_grid_chunk_plain`,
`_rtdp_plain`) run where the tensors lie on the CPU; a CUDA tensor
always goes to the kernel.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse
import scipy.sparse.linalg
import torch

from cpr_tpu_torch import _device, kernels, telemetry
from cpr_tpu_torch.telemetry import now


def sum_to_one(xs) -> bool:
    return math.isclose(sum(xs), 1.0, rel_tol=1e-9)


# ceiling (bytes) on the dense [S*A, K] padded tables padded_layout()
# materializes for the device RTDP path; ~2 GiB by default
PAD_BYTES_ENV_VAR = "CPR_MDP_PAD_BYTES"
_PAD_BYTES_DEFAULT = 2 << 30


class PaddedLayoutTooLarge(MemoryError):
    """padded_layout() refused to build its dense [S*A, K] tables: their
    size exceeds the CPR_MDP_PAD_BYTES ceiling. Large compiles solve
    through the COO segment-sum sweep (value_iteration), which never
    pads; `TensorMDP.rtdp` reads the segment index and never pads
    either."""


# opt-in ceiling (bytes) on one device's VI working set — COO columns
# + [S, A] Q planes + the [S] value/progress/policy vectors.  0 (the
# default) disables the guard; a card with a known memory budget sets it
# so an over-sized single-device solve refuses by name instead of
# running out of memory mid-sweep.  The state-sharded solver checks its
# per-shard working set against the same ceiling.
VI_BYTES_ENV_VAR = "CPR_VI_BYTES"
_VI_BYTES_DEFAULT = 0


class ViWorkingSetTooLarge(MemoryError):
    """A VI solve's per-device working set exceeds the CPR_VI_BYTES
    ceiling.  Shard the state axis over more devices
    (cpr_tpu_torch.parallel.sharded_state_value_iteration) or raise the
    ceiling explicitly."""


def vi_working_set_bytes(T: int, S: int, A: int, dtype, *,
                         shards: int = 1) -> int:
    """Per-device bytes a chunked COO sweep keeps resident: T
    transition rows (per shard when state-sharded), the shard's
    [S/shards, A] Q-value/Q-progress planes, and the replicated [S]
    value/progress/policy vectors every shard's `value[dst]` gather
    reads. `dtype` is a numpy or torch float type."""
    item = _np_dtype(dtype).itemsize
    cols = T * (3 * np.dtype(np.int32).itemsize + 3 * item)
    planes = 2 * (S // shards) * A * item
    vectors = 3 * S * item
    return int(cols + planes + vectors)


def check_vi_working_set(T: int, S: int, A: int, dtype, *,
                         shards: int = 1):
    """Refuse (by name) a VI solve whose per-device working set
    exceeds the opt-in CPR_VI_BYTES ceiling — no-op when unset."""
    ceiling = int(os.environ.get(VI_BYTES_ENV_VAR, _VI_BYTES_DEFAULT))
    if ceiling <= 0:
        return
    need = vi_working_set_bytes(T, S, A, dtype, shards=shards)
    if need > ceiling:
        label = (f"{shards} state shard(s)" if shards > 1
                 else "one device")
        raise ViWorkingSetTooLarge(
            f"VI working set needs {need:,} bytes per device at "
            f"{label} (T={T:,} transition rows/shard, S={S:,}, A={A}, "
            f"dtype={_np_dtype(dtype)}), over the {VI_BYTES_ENV_VAR} "
            f"ceiling of {ceiling:,}; shard the state axis over more "
            f"devices (cpr_tpu_torch.parallel."
            f"sharded_state_value_iteration) or raise the ceiling "
            f"explicitly")




@dataclass
class MDP:
    """Host-side MDP table with flat transition storage.

    Action ids are positional per state (the compiler enumerates each
    state's available actions in order), matching the reference compiler
    convention (mdp/lib/compiler.py:49-54).
    """

    n_states: int = 0
    n_actions: int = 0
    start: dict[int, float] = field(default_factory=dict)
    src: list[int] = field(default_factory=list)
    act: list[int] = field(default_factory=list)
    dst: list[int] = field(default_factory=list)
    prob: list[float] = field(default_factory=list)
    reward: list[float] = field(default_factory=list)
    progress: list[float] = field(default_factory=list)

    # column dtypes of the materialized COO layout, in field order
    _COL_DTYPES = (np.int32, np.int32, np.int32,
                   np.float64, np.float64, np.float64)

    @property
    def n_transitions(self) -> int:
        return len(self.src) + sum(len(c[0]) for c in
                                   getattr(self, "_chunks", ()) or ())

    def __repr__(self):
        s, a, t = self.n_states, self.n_actions, self.n_transitions
        per = t / s if s else 0.0
        return f"MDP of size {s} / {a} / {t} / {per:.1f}"

    def add_transition(self, src: int, act: int, dst: int, *, probability: float,
                       reward: float, progress: float):
        if getattr(self, "_chunks", None):
            # bulk chunks already appended: route through the columnar
            # path so transition order (and therefore state-id
            # assignment downstream) stays the call order under mixed
            # add_transition/add_transitions use
            self.add_transitions([src], [act], [dst], [probability],
                                 [reward], [progress])
            return
        assert src >= 0 and dst >= 0 and act >= 0
        self._arrays_cache = None  # invalidate materialized columns
        self.n_states = max(self.n_states, src + 1, dst + 1)
        self.n_actions = max(self.n_actions, act + 1)
        self.src.append(src)
        self.act.append(act)
        self.dst.append(dst)
        self.prob.append(probability)
        self.reward.append(reward)
        self.progress.append(progress)

    def add_transitions(self, src, act, dst, prob, reward, progress):
        """Bulk columnar append: one numpy chunk per call, no
        per-transition Python work.  Chunks stack up in a growable
        side list and are concatenated lazily by arrays() (or folded
        into the public columns by consolidate()), so a frontier-
        batched compile appends each BFS round in O(1) list pushes
        instead of six list.append calls per transition.  Probability
        columns must already be numeric — the monomial tracer's Param
        objects travel as separate coef/expo columns on the bulk path
        (cpr_tpu/mdp/frontier.py), never inside `prob`."""
        cols = tuple(np.asarray(c, dt) for c, dt in
                     zip((src, act, dst, prob, reward, progress),
                         self._COL_DTYPES))
        n = len(cols[0])
        if any(c.ndim != 1 or len(c) != n for c in cols):
            raise ValueError(
                "add_transitions wants six equal-length 1-d columns, "
                f"got lengths {[c.shape for c in cols]}")
        if n == 0:
            return
        if min(int(cols[0].min()), int(cols[1].min()),
               int(cols[2].min())) < 0:
            raise ValueError("negative state/action id in bulk append")
        self._arrays_cache = None
        self.n_states = max(self.n_states, int(cols[0].max()) + 1,
                            int(cols[2].max()) + 1)
        self.n_actions = max(self.n_actions, int(cols[1].max()) + 1)
        chunks = getattr(self, "_chunks", None)
        if chunks is None:
            chunks = self._chunks = []
        chunks.append(cols)

    def consolidate(self):
        """Fold any pending bulk chunks into the public column fields
        (as numpy arrays), so code that reads `mdp.src` etc. directly
        sees the full transition set.  Returns self.  After this the
        MDP behaves like a ptmdp()-built one: columns are arrays, and
        further single add_transition calls are not supported."""
        arrs = self.arrays()
        (self.src, self.act, self.dst,
         self.prob, self.reward, self.progress) = arrs
        self._chunks = []
        self._arrays_cache = arrs
        return self

    def arrays(self):
        """Materialized COO columns, cached: check()/tensor()/ptmdp and
        the parametric grid pipeline all call this, and rebuilding six
        numpy arrays from Python lists per call dominates for
        multi-million-transition native compiles.  add_transition /
        add_transitions invalidate; callers must treat the tuple as
        read-only.  Fast path is zero-copy: when a column is already a
        numpy array of the right dtype (consolidated bulk compiles,
        ptmdp outputs), np.asarray returns it as-is."""
        cached = getattr(self, "_arrays_cache", None)
        if cached is not None:
            return cached
        base = (self.src, self.act, self.dst,
                self.prob, self.reward, self.progress)
        chunks = getattr(self, "_chunks", None) or []
        cols = []
        for i, dt in enumerate(self._COL_DTYPES):
            parts = ([np.asarray(base[i], dt)] if len(base[0]) else [])
            parts += [c[i] for c in chunks]
            if not parts:
                cols.append(np.zeros(0, dt))
            elif len(parts) == 1:
                cols.append(parts[0])
            else:
                cols.append(np.concatenate(parts))
        out = tuple(cols)
        self._arrays_cache = out
        return out

    def check(self) -> bool:
        """Invariant check (mirrors mdp/lib/explicit_mdp.py:63-95):
        start distribution sums to one, per-(state,action) outgoing
        probabilities sum to one, actions are contiguous per state.

        Runs on the sorted (src, act) key pairs via group-boundary
        reduceat — O(T log T) time, O(T) memory — instead of two dense
        S x A host planes, so checking a multi-million-transition
        native compile stays cheap even for sparse action sets
        (check_dense keeps the old dense implementation as the parity
        oracle)."""
        src, act, dst, prob, _, _ = self.arrays()
        assert sum_to_one(self.start.values())
        for s in self.start:
            assert 0 <= s < self.n_states
        key = src.astype(np.int64) * self.n_actions + act
        if len(key):
            order = np.argsort(key, kind="stable")
            ks = key[order]
            first = np.ones(len(ks), dtype=bool)
            first[1:] = ks[1:] != ks[:-1]
            group = np.flatnonzero(first)
            uniq = ks[group]
            sums = np.add.reduceat(prob[order], group)
            bad = ~np.isclose(sums, 1.0, rtol=1e-9)
            assert not bad.any(), \
                f"probabilities do not sum to 1 at {uniq[bad]}"
            # action contiguity per state: the distinct action ids of a
            # state must be exactly {0..max}; with uniq sorted and
            # deduplicated, that is max == count - 1 per state group
            state = uniq // self.n_actions
            acts = uniq % self.n_actions
            sfirst = np.ones(len(uniq), dtype=bool)
            sfirst[1:] = state[1:] != state[:-1]
            sgroup = np.flatnonzero(sfirst)
            amax = np.maximum.reduceat(acts, sgroup)
            count = np.diff(np.append(sgroup, len(uniq)))
            assert (amax == count - 1).all(), "non-contiguous actions"
        assert dst.max(initial=-1) < self.n_states
        return True

    def check_dense(self) -> bool:
        """The original dense S x A invariant check — kept as the
        parity oracle for check() (tests/test_mdp_grid.py); O(S*A)
        memory, do not call on large sparse compiles."""
        src, act, dst, prob, _, _ = self.arrays()
        assert sum_to_one(self.start.values())
        for s in self.start:
            assert 0 <= s < self.n_states
        key = src.astype(np.int64) * self.n_actions + act
        sums = np.zeros(self.n_states * self.n_actions)
        np.add.at(sums, key, prob)
        present = np.zeros(self.n_states * self.n_actions, dtype=bool)
        present[key] = True
        bad = present & ~np.isclose(sums, 1.0, rtol=1e-9)
        assert not bad.any(), f"probabilities do not sum to 1 at {np.where(bad)[0]}"
        # action contiguity per state: if action k present, all j<k present
        # == row-wise monotone decreasing presence
        pres = present.reshape(self.n_states, self.n_actions)
        assert (pres[:, :-1] | ~pres[:, 1:]).all(), "non-contiguous actions"
        assert dst.max(initial=-1) < self.n_states
        return True

    def tensor(self, dtype=torch.float32, device=None) -> TensorMDP:
        """The table as torch tensors on `device` (default: the current
        CUDA device; raises without one unless given device="cpu")."""
        dev = _device.resolve(device)
        src, act, dst, prob, reward, progress = self.arrays()
        start = np.zeros(self.n_states, dtype=np.float64)
        for s, p in self.start.items():
            start[s] = p
        fdt = _np_dtype(dtype)

        def put(x, dt):
            return torch.from_numpy(np.ascontiguousarray(x, dt)).to(dev)

        return TensorMDP.from_columns(
            self.n_states, self.n_actions, put(start, fdt), put(src, np.int32),
            put(act, np.int32), put(dst, np.int32), put(prob, fdt),
            put(reward, fdt), put(progress, fdt))


def ptmdp(old: MDP, *, horizon: int) -> MDP:
    """Explicit-level probabilistic-termination transform.

    Adds one terminal state and splits every progress-making transition
    into continue/terminate branches with continue probability
    (1 - 1/horizon)^progress (reference: mdp/lib/models/aft20barzur.py:244-304).
    """
    assert horizon > 0
    terminal = old.n_states
    src, act, dst, prob, reward, progress = old.arrays()
    keep = (1.0 - 1.0 / horizon) ** progress
    hp = progress != 0.0  # progress-making rows split in two
    term = np.full(hp.sum(), terminal, np.int32)
    zeros = np.zeros(hp.sum())
    new = MDP(
        n_states=old.n_states + 1,
        n_actions=old.n_actions,
        start=dict(old.start),
        src=np.concatenate([src, src[hp]]),
        act=np.concatenate([act, act[hp]]),
        dst=np.concatenate([dst, term]).astype(np.int32),
        prob=np.concatenate([np.where(hp, prob * keep, prob),
                             (prob * (1.0 - keep))[hp]]),
        reward=np.concatenate([reward, zeros]),
        progress=np.concatenate([progress, zeros]),
    )
    return new



# -- device half: the sorted table, K4/K5 and their plain twins ---------------


def _greedy_backup(qv, qp, valid, any_valid):
    """Masked argmax backup: ties to lowest action id; action-less states
    get value 0 / policy -1 (mdp/lib/explicit_mdp.py:123-146)."""
    S = qv.shape[0]
    rows = torch.arange(S, device=qv.device)
    qv_masked = torch.where(valid, qv, float("-inf"))
    best_a = torch.argmax(qv_masked, dim=1)
    best_v = torch.where(any_valid, qv_masked[rows, best_a], 0.0)
    best_p = torch.where(any_valid, qp[rows, best_a], 0.0)
    policy = torch.where(any_valid, best_a, -1).to(torch.int32)
    return best_v, best_p, policy


def make_vi_sweep(S: int, A: int):
    """The plain twin of K4: one Bellman sweep over COO rows with
    `index_add_` segment sums. On the CPU `index_add_` adds in row order,
    so over a TensorMDP's sorted rows it sums each segment in the order
    K4 does; on the card its atomics add in no fixed order."""

    def sweep(src, act, dst, prob, reward, progress, valid, any_valid,
              discount, value, prog):
        seg = src.to(torch.int64) * A + act
        zeros = torch.zeros(S * A, dtype=prob.dtype, device=prob.device)
        qv = zeros.index_add(0, seg, prob * (reward + discount * value[dst]))
        qp = zeros.index_add(0, seg, prob * (progress + discount * prog[dst]))
        return _greedy_backup(qv.reshape(S, A), qp.reshape(S, A), valid,
                              any_valid)

    return sweep


def _valid_actions(src, act, prob, S: int, A: int):
    """Per-(state,action) availability mask, on probability mass, so
    zero-probability rows are inert."""
    seg = src.to(torch.int64) * A + act
    mass = torch.zeros(S * A, dtype=torch.int64, device=src.device)
    mass.index_add_(0, seg, (prob > 0).to(torch.int64))
    valid = (mass > 0).reshape(S, A)
    return valid, valid.any(dim=1)


def _plain_sweep(m: TensorMDP, mask, discount, value, prog):
    """One sweep of the plain twin of K4; `mask` is
    `_valid_actions(m.src, m.act, m.prob, S, A)`."""
    return make_vi_sweep(m.n_states, m.n_actions)(
        m.src, m.act, m.dst, m.prob, m.reward, m.progress, *mask, discount,
        value, prog)


def _pe_sweep(m: TensorMDP, policy, discount, rew, prg):
    """The plain twin of K5 (the `_pe_loop` body): segment sums over src
    of the on-policy rows (policy[src] == act)."""
    on = policy.to(torch.int64)[m.src.to(torch.int64)] == m.act
    w = torch.where(on, m.prob, 0.0)
    src = m.src.to(torch.int64)
    zeros = torch.zeros(m.n_states, dtype=m.prob.dtype,
                        device=m.prob.device)
    r2 = zeros.index_add(0, src, w * (m.reward + discount * rew[m.dst]))
    p2 = zeros.index_add(0, src, w * (m.progress + discount * prg[m.dst]))
    return r2, p2


# residual-trajectory ring length: the last VI_RESID_LEN per-sweep deltas
# of the while impl ride in a fixed ring on the device; ring_residuals()
# unrolls it host-side.
VI_RESID_LEN = 512

# sweeps the host enqueues between two reads of the device stop flag
VI_LAUNCH_BLOCK = 64


class _Ctl:
    """The device-side control block of a K4/K5 loop: `ctl` int64 [4]
    (max-delta bits, sweeps done, stop flag, blocks finished), the last
    delta, and a residual ring."""

    def __init__(self, dtype, device, resid_len: int):
        self.ctl = torch.zeros(4, dtype=torch.int64, device=device)
        self.delta = torch.full((1,), float("inf"), dtype=dtype,
                                device=device)
        self.resid = torch.zeros(max(resid_len, 1), dtype=dtype,
                                 device=device)

    def reset(self):
        self.ctl.zero_()

    @property
    def it(self) -> int:
        return int(self.ctl[1])


def _run_until_stopped(launch, max_iter: int, ctl: _Ctl) -> int:
    """Enqueue `launch(first, count)` in blocks of VI_LAUNCH_BLOCK until
    the device stop flag is set (or max_iter sweeps are enqueued). The
    flag of block k is read after block k+1 is enqueued, so the card
    never waits on the host; launches after the stop return at once.
    The flag copies, their events and the final wait go to the stream of
    the control block's card, the one the launches use. Returns the
    number of sweeps enqueued."""
    flags = [torch.empty(1, dtype=torch.int64, pin_memory=True)
             for _ in range(2)]
    n, blocks = 0, 0
    pending: list = []
    with torch.cuda.device(ctl.ctl.device):
        while n < max_iter:
            count = min(VI_LAUNCH_BLOCK, max_iter - n)
            launch(n, count)
            n += count
            flag = flags[blocks % 2]
            blocks += 1
            flag.copy_(ctl.ctl[2:3], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            pending.append((ev, flag))
            if len(pending) == 2:
                ev0, flag0 = pending.pop(0)
                ev0.synchronize()
                if int(flag0[0]):
                    break
        torch.cuda.current_stream().synchronize()
    return n


def _vi_loop_cuda(m: TensorMDP, discount, stop_delta, max_iter,
                  resid_len):
    S, dt, dev = m.n_states, m.prob.dtype, m.device
    v = [torch.zeros(S, dtype=dt, device=dev),
         torch.empty(S, dtype=dt, device=dev)]
    p = [torch.zeros(S, dtype=dt, device=dev), torch.empty_like(v[1])]
    pol = torch.full((S,), -1, dtype=torch.int32, device=dev)
    c = _Ctl(dt, dev, resid_len)

    def launch(first, count):
        kernels.vi_sweeps(m, discount, v, p, pol, c.ctl, c.delta, c.resid,
                          resid_len, first, count, stop_delta=stop_delta,
                          max_iter=max_iter, can_stop=True)

    _run_until_stopped(launch, max_iter, c)
    it = c.it
    return (v[it % 2], p[it % 2], pol, float(c.delta[0]), it,
            c.resid[:resid_len].cpu().numpy())


def _vi_loop_plain(m: TensorMDP, discount, stop_delta, max_iter,
                   resid_len):
    z = torch.zeros(m.n_states, dtype=m.prob.dtype, device=m.device)
    mask = m.valid_actions()
    resid = np.zeros(resid_len, _np_dtype(m.prob.dtype))
    value, prog, it, delta = z, z, 0, math.inf
    pol = torch.full((m.n_states,), -1, dtype=torch.int32)
    while True:
        v2, p2, pol = _plain_sweep(m, mask, discount, value, prog)
        d = (v2 - value).abs().max() if m.n_states else z.sum()
        delta = float(d)
        value, prog, it = v2, p2, it + 1
        if resid_len:
            resid[(it - 1) % resid_len] = delta
        if not d > stop_delta or it >= max_iter:
            return value, prog, pol, delta, it, resid


def vi_while_loop(m: TensorMDP, discount, stop_delta, max_iter,
                  resid_len=VI_RESID_LEN):
    """Value iteration: Bellman sweeps until the value delta drops to
    stop_delta or max_iter sweeps ran, the first from zeros.

    On the card each sweep is one K4 launch; K4 keeps the sweep count,
    the delta, the stop flag and the residual ring on the device and
    evaluates the stop rule itself, so the host only enqueues blocks of
    launches and reads the flag once a block. On the CPU the plain twin
    runs the same loop.

    Returns (value, progress, policy, delta, it, resid): `resid` is the
    ring of the last `resid_len` per-sweep deltas (sweep j writes slot
    (j-1) % resid_len; ring_residuals() unrolls it)."""
    run = _vi_loop_cuda if m.prob.is_cuda else _vi_loop_plain
    return run(m, discount, stop_delta, max_iter, resid_len)


def ring_residuals(resid, it: int):
    """Chronological residual trajectory from a vi_while_loop ring:
    the deltas of the last min(it, resid_len) sweeps, oldest first."""
    r = np.asarray(resid)
    n = len(r)
    if n == 0 or it <= 0:
        return np.zeros(0, r.dtype if n else np.float32)
    if it <= n:
        return r[:it]
    return np.roll(r, -(it % n))


def vi_residuals_event(impl: str, it: int, resid, stop_delta, delta):
    """Emit the `vi_residuals` telemetry event for a finished solve
    (no-op when no sink is active) and return the trajectory as a host
    array, capped at the last VI_RESID_LEN sweeps."""
    resid = np.asarray(resid)
    tail = resid[-VI_RESID_LEN:]
    telemetry.current().event(
        "vi_residuals", impl=impl, n_sweeps=int(it),
        residuals=[float(d) for d in tail],
        truncated=int(it) > len(tail),
        stop_delta=float(stop_delta), final_delta=float(delta))
    return resid


def resolve_vi_impl(impl: str | None) -> str:
    """Impl selection: explicit arg > CPR_VI_IMPL env > "while"."""
    impl = impl or os.environ.get("CPR_VI_IMPL", "while")
    if impl not in ("while", "chunked"):
        raise ValueError(f"unknown VI impl '{impl}'")
    return impl


def make_vi_chunk(m: TensorMDP, discount):
    """`chunk_step(value, prog, steps) -> (value, prog, pol, deltas)`:
    `steps` unconditional Bellman sweeps from (value, prog), with the
    per-sweep deltas [steps]. On the card, `steps` K4 launches that
    never stop; on the CPU the plain twin."""
    return (_vi_chunk_cuda if m.prob.is_cuda else _vi_chunk_plain)(
        m, discount)


def _vi_chunk_plain(m: TensorMDP, discount):
    mask = m.valid_actions()

    def chunk_plain(value, prog, steps):
        deltas = torch.empty(steps, dtype=m.prob.dtype)
        for j in range(steps):
            v2, p2, pol = _plain_sweep(m, mask, discount, value, prog)
            deltas[j] = (v2 - value).abs().max()
            value, prog = v2, p2
        return value, prog, pol, deltas

    return chunk_plain


def _vi_chunk_cuda(m: TensorMDP, discount):
    S, dt, dev = m.n_states, m.prob.dtype, m.device
    c = _Ctl(dt, dev, 0)

    def chunk_cuda(value, prog, steps):
        c.reset()
        v = [value.to(dt).contiguous().clone(), torch.empty_like(value)]
        p = [prog.to(dt).contiguous().clone(), torch.empty_like(prog)]
        pol = torch.empty(S, dtype=torch.int32, device=dev)
        deltas = torch.empty(steps, dtype=dt, device=dev)
        kernels.vi_sweeps(m, discount, v, p, pol, c.ctl, c.delta, deltas,
                          steps, 0, steps, stop_delta=0.0,
                          max_iter=steps, can_stop=False)
        return v[steps % 2], p[steps % 2], pol, deltas

    return chunk_cuda


def _anderson_mix(hist):
    """Anderson (type-II) mixing over the chunk map g = G(x) on the
    JOINT (value, progress) system: weights a (sum 1) minimize the
    concatenated residual ||sum a_i (g_i - x_i)|| over both vectors, so
    one weight vector accelerates both consistently (revenue is
    value/progress, so both must land). `hist` holds (x_value, x_prog,
    g_value, g_prog) tuples, newest last; the m x m Gram matrix (m <= 3)
    comes from device dots and is solved on the host with a small
    ridge."""
    m = len(hist)
    fv = [gv - xv for xv, _, gv, _ in hist]
    fp = [gp - xp for _, xp, _, gp in hist]
    G = np.array([[float(torch.dot(fv[i], fv[j]))
                   + float(torch.dot(fp[i], fp[j]))
                   for j in range(m)] for i in range(m)], np.float64)
    G += (1e-10 * (np.trace(G) / m + 1e-30)) * np.eye(m)
    try:
        w = np.linalg.solve(G, np.ones(m))
    except np.linalg.LinAlgError:
        return hist[-1][2], hist[-1][3]
    if not np.isfinite(w).all() or abs(w.sum()) < 1e-12:
        return hist[-1][2], hist[-1][3]
    a = w / w.sum()
    value = sum(float(ai) * gv for ai, (_, _, gv, _) in zip(a, hist))
    prog = sum(float(ai) * gp for ai, (_, _, _, gp) in zip(a, hist))
    return value, prog


# chunks in a row without a new lowest delta, after which the chunked
# driver gives up Anderson mixing and restarts from zero. A float32 solve
# whose stop_delta is finer than one ULP of its values plateaus on the
# way in: 19 chunks on AFT'20 at maximum_fork_length 20 (chunk 64), which
# then converged; a limit cycle never makes a new lowest delta.
ACCEL_STALLS = 32


def _initial(x0, S: int, dtype, dev) -> torch.Tensor:
    """A solve's own copy of its start vector: zeros, or the warm start
    `x0` (array or tensor of shape [S])."""
    if x0 is None:
        return torch.zeros(S, dtype=dtype, device=dev)
    x0 = torch.as_tensor(x0).to(dev, dtype)
    if tuple(x0.shape) != (S,):
        raise ValueError(f"warm start of shape {tuple(x0.shape)}, "
                         f"expected ({S},)")
    return x0.clone()


def run_chunk_driver(chunk_step, S, dtype, stop_delta, max_iter,
                     chunk: int = 64, accel_m: int = 0,
                     checkpoint_path: str | None = None,
                     value0=None, prog0=None,
                     predicted_bytes: int | None = None, *, device=None):
    """Host loop of chunked VI: call `chunk_step(value, prog, steps) ->
    (value, prog, pol, deltas)` from zeros, or from the warm start
    `value0`/`prog0` (the RTDP handoff: a table explored by
    `rtdp_graph`), in full chunks with a 1-sweep tail, stopping at a
    chunk boundary once the chunk's last delta is at most stop_delta,
    or when max_iter sweeps ran.

    `accel_m > 1` turns on Anderson mixing between chunks. The fixpoint
    is untouched and convergence is still certified by a PLAIN sweep's
    delta inside the next chunk; the history is dropped whenever the
    delta grows, and the loop never mixes on the way out. After
    ACCEL_STALLS chunks in a row without a new lowest delta the driver
    stops mixing and restarts from zero: a mixed iterate can sit on a
    limit cycle of the rounded sweep (in float32 a delta of a few ULP of
    the values, above a stop_delta finer than one ULP), which plain
    sweeps from there may never leave, while plain sweeps from zero rise
    monotonically to a fixed point of the rounded sweep, as the while
    impl does.

    Checkpointing is not ported yet. A failed launch raises; nothing is
    retried."""
    if checkpoint_path is not None:
        raise NotImplementedError(
            "VI checkpoints (checkpoint_path=) are not ported yet: they "
            "need the resilience/integrity planes, ROADMAP item 6")
    dev = _device.resolve(device)
    value = _initial(value0, S, dtype, dev)
    prog = _initial(prog0, S, dtype, dev)
    it = 0
    delta = math.inf
    pol = None
    mixing = accel_m > 1
    hist: list = []
    prev_delta = None
    best, stalls = math.inf, 0
    resids: list = []
    with telemetry.memory_watermark(
            "vi", predicted_bytes=predicted_bytes) as wm:
        while it < max_iter:
            step = chunk if max_iter - it >= chunk else 1
            x_value, x_prog = value, prog
            g_value, g_prog, pol, deltas = chunk_step(x_value, x_prog, step)
            it += step
            value, prog = g_value, g_prog
            resids.append(deltas.cpu().numpy())
            delta = float(resids[-1][-1])
            wm.sample()
            if delta <= float(stop_delta):
                break
            if mixing and step == chunk and it < max_iter:
                best, stalls = ((delta, 0) if delta < best
                                else (best, stalls + 1))
                if stalls >= ACCEL_STALLS:
                    mixing, hist = False, []
                    value = torch.zeros_like(value)
                    prog = torch.zeros_like(prog)
                elif prev_delta is not None and delta > prev_delta:
                    hist = []  # extrapolation hurt: fall back to plain
                else:
                    hist = (hist + [(x_value, x_prog, g_value, g_prog)]
                            )[-accel_m:]
                    if len(hist) >= 2:
                        value, prog = _anderson_mix(hist)
                prev_delta = delta
    resid = (np.concatenate(resids) if resids
             else np.zeros(0, _np_dtype(dtype)))
    return value, prog, pol, delta, it, resid


def vi_chunked(m: TensorMDP, discount, stop_delta, max_iter,
               chunk: int = 64, accel_m: int = 0,
               checkpoint_path: str | None = None):
    """Host-driven VI: chunks of `chunk` unconditional sweeps until the
    last in-chunk delta drops to stop_delta (or max_iter sweeps ran).
    Same fixpoint and return shape as vi_while_loop; the residual
    trajectory is the full per-sweep history. `accel_m` opts into
    Anderson mixing (run_chunk_driver)."""
    return run_chunk_driver(
        make_vi_chunk(m, discount), m.n_states, m.prob.dtype, stop_delta,
        max_iter, chunk, accel_m=accel_m, checkpoint_path=checkpoint_path,
        predicted_bytes=vi_working_set_bytes(
            int(m.prob.shape[0]), m.n_states, m.n_actions, m.prob.dtype),
        device=m.device)


def grid_valid_segments(m: TensorMDP, probs) -> torch.Tensor:
    """[G, n_seg] uint8: whether segment k carries probability mass
    under point g's column (`probs` [G, T] in the table's row order).
    At gamma in {0, 1} rows carry probability 0, so validity differs
    between points; the columns do not change between chunks, so a grid
    solve builds this once. Integer sums, so deterministic on the card."""
    n_seg = m.n_segments
    row_seg = torch.repeat_interleave(
        torch.arange(n_seg, device=m.device),
        (m.seg_ptr[1:] - m.seg_ptr[:-1]).to(torch.int64))
    out = torch.empty((probs.shape[0], n_seg), dtype=torch.uint8,
                      device=m.device)
    for g in range(probs.shape[0]):
        mass = torch.zeros(n_seg, dtype=torch.int32, device=m.device)
        mass.index_add_(0, row_seg, (probs[g] > 0).to(torch.int32))
        out[g] = mass > 0
    return out


def make_grid_vi_chunk(m: TensorMDP, probs, discount):
    """Grid-batched twin of `make_vi_chunk` over `m`'s structure with
    one probability column per point (`probs` [G, T], in the table's row
    order: `m.sort_rows`). Returns `grid_chunk(carry, frozen, steps) ->
    (carry, deltas [G, steps])`, carry = (value, prog, policy) [G, S]:
    every point not in `frozen` [G] bool advances `steps` Bellman sweeps
    under its own validity masks; frozen points keep value, progress
    and policy bit for bit and report delta 0. On the card K7 sweeps all
    live points per launch; on the CPU the plain twin loops over them."""
    return (_grid_chunk_cuda if m.prob.is_cuda else _grid_chunk_plain)(
        m, probs, discount)


def _grid_chunk_plain(m: TensorMDP, probs, discount):
    """The plain twin of K7: `_vi_chunk_plain` applied per live point."""
    S, A = m.n_states, m.n_actions
    sweep = make_vi_sweep(S, A)
    masks = [_valid_actions(m.src, m.act, probs[g], S, A)
             for g in range(probs.shape[0])]

    def grid_chunk(carry, frozen, steps):
        value, prog, pol = carry
        v2, p2, pol2 = value.clone(), prog.clone(), pol.clone()
        deltas = torch.zeros((value.shape[0], steps), dtype=value.dtype,
                             device=value.device)
        for g, fz in enumerate(frozen.tolist()):
            if fz:
                continue
            v, p = value[g], prog[g]
            for j in range(steps):
                nv, np_, npol = sweep(m.src, m.act, m.dst, probs[g],
                                      m.reward, m.progress, *masks[g],
                                      discount, v, p)
                deltas[g, j] = (nv - v).abs().max()
                v, p = nv, np_
            v2[g], p2[g], pol2[g] = v, p, npol
        return (v2, p2, pol2), deltas

    return grid_chunk


def _bits_to_float(bits: torch.Tensor, dtype) -> torch.Tensor:
    """The floats (>= 0) whose bit patterns K7 max-reduced into int64."""
    if dtype == torch.float64:
        return bits.view(torch.float64)
    return bits.to(torch.int32).view(torch.float32)


def _grid_chunk_cuda(m: TensorMDP, probs, discount):
    valid = grid_valid_segments(m, probs)

    def grid_chunk(carry, frozen, steps):
        value, prog, pol = carry
        live = torch.nonzero(~frozen).flatten().to(torch.int32)
        v = [value.clone(), torch.empty_like(value)]
        p = [prog.clone(), torch.empty_like(prog)]
        pol2 = pol.clone()
        dbits = torch.zeros((value.shape[0], steps), dtype=torch.int64,
                            device=value.device)
        kernels.grid_vi_sweeps(m, probs, valid, live, discount, v, p, pol2,
                               dbits, steps)
        v2, p2 = v[steps % 2], p[steps % 2]
        if steps % 2 and int(live.shape[0]) < value.shape[0]:
            v2[frozen], p2[frozen] = value[frozen], prog[frozen]
        return (v2, p2, pol2), _bits_to_float(dbits, value.dtype)

    return grid_chunk


def run_grid_chunk_driver(chunk_step, place, G, S, dtype, stop_delta,
                          max_iter, chunk: int = 64,
                          checkpoint_path: str | None = None, *,
                          device=None):
    """Host loop of grid-batched chunked VI, `run_chunk_driver`'s rule
    per point: full chunks with a 1-sweep tail; after each chunk a live
    point whose last delta is at most stop_delta freezes; the grid stops
    when every point froze or max_iter sweeps ran.

    `chunk_step(carry, frozen, steps) -> (carry, deltas [G, steps])`
    with carry = (value, prog, policy) planes [G, S]; `place(x)` puts a
    host array on the solve's device. Each chunk samples the memory
    watermark (scope "mdp_grid"). Checkpoints are not ported (ROADMAP
    item 6); a failed launch raises.

    Returns (value, prog, policy, delta [G], conv_iter [G],
    converged [G], it, resid [G, it]) as numpy arrays: conv_iter is the
    sweep count at which each point froze (the full budget where it did
    not)."""
    if checkpoint_path is not None:
        raise NotImplementedError(
            "grid VI checkpoints (checkpoint_path=) are not ported yet: "
            "they need the resilience checkpoints, ROADMAP item 6")
    np_dtype = _np_dtype(dtype)
    frozen = np.zeros(G, dtype=bool)
    conv_it = np.zeros(G, np.int64)
    final_delta = np.full(G, np.inf)
    it = 0
    resids: list = []
    carry = (place(np.zeros((G, S), np_dtype)),
             place(np.zeros((G, S), np_dtype)),
             place(np.full((G, S), -1, np.int32)))
    with telemetry.memory_watermark("mdp_grid") as wm:
        while it < max_iter and not bool(frozen.all()):
            step = chunk if max_iter - it >= chunk else 1
            carry, deltas = chunk_step(carry, place(frozen), step)
            it += step
            d = deltas.cpu().numpy()
            resids.append(d)
            last = d[:, -1]
            live = ~frozen
            final_delta[live] = last[live]
            newly = live & (last <= float(stop_delta))
            conv_it[newly] = it
            frozen |= newly
            wm.sample()
    conv_it[~frozen] = it  # unconverged points ran the whole budget
    resid = (np.concatenate(resids, axis=1) if resids
             else np.zeros((G, 0), np_dtype))
    return (carry[0].cpu().numpy(), carry[1].cpu().numpy(),
            carry[2].cpu().numpy(), final_delta, conv_it, frozen.copy(),
            it, resid)


def _pe_loop(m: TensorMDP, policy, discount, theta, max_iter):
    """Policy evaluation sweeps from zeros while delta > theta and
    it < max_iter (K5 on the card, its plain twin on the CPU). Returns
    (reward, progress, delta, it)."""
    if max_iter <= 0:
        z = torch.zeros(m.n_states, dtype=m.prob.dtype, device=m.device)
        return z, z, math.inf, 0
    run = _pe_loop_cuda if m.prob.is_cuda else _pe_loop_plain
    return run(m, policy, discount, theta, max_iter)


def _pe_loop_cuda(m: TensorMDP, policy, discount, theta, max_iter):
    S, dt, dev = m.n_states, m.prob.dtype, m.device
    r = [torch.zeros(S, dtype=dt, device=dev), torch.empty(S, dtype=dt,
                                                           device=dev)]
    p = [torch.zeros_like(r[0]), torch.empty_like(r[0])]
    c = _Ctl(dt, dev, 0)

    def launch(first, count):
        kernels.pe_sweeps(m, policy, discount, r, p, c.ctl, c.delta,
                          first, count, theta=theta, max_iter=max_iter)

    _run_until_stopped(launch, max_iter, c)
    it = c.it
    return r[it % 2], p[it % 2], float(c.delta[0]), it


def _pe_loop_plain(m: TensorMDP, policy, discount, theta, max_iter):
    z = torch.zeros(m.n_states, dtype=m.prob.dtype, device=m.device)
    rew, prg, it = z, z, 0
    while True:
        r2, p2 = _pe_sweep(m, policy, discount, rew, prg)
        d = (r2 - rew).abs().max() if m.n_states else z.sum()
        rew, prg, it = r2, p2, it + 1
        if not d > theta or it >= max_iter:
            return rew, prg, float(d), it


# -- RTDP walkers: K6 and its plain twin ---------------------------------------


def start_cdf(m: TensorMDP) -> torch.Tensor:
    """The start distribution's float32 CDF, summed in state order on the
    host (numpy's sequential add), on the table's device. JAX's
    `jnp.cumsum` may associate otherwise; with at most two nonzero start
    entries, as the fc16/aft20 and generic tables have, every order
    gives the same sums."""
    return torch.from_numpy(np.cumsum(
        m.start.cpu().numpy().astype(np.float32), dtype=np.float32)
    ).to(m.device)


def _rtdp_walk(m: TensorMDP, key, *, graph: bool, max_steps: int,
               batch: int, cap: int, eps, restart_p, discount, stop_delta,
               decay, value0=None, prog0=None) -> dict:
    """Run the RTDP walkers of `_rtdp_loop` (graph False: `max_steps`
    steps) or `_rtdp_graph_loop` (graph True: visit counters, the
    priority buffer of `cap` entries feeding restarts with probability
    `restart_p`, and the damped residual stop) over `m`. K6 on the
    card, `_rtdp_plain` on the CPU. Returns dict(V, P, visits, buf_s,
    buf_pri, s, t, resid) as tensors and ints."""
    if m.prob.dtype != torch.float32:
        raise NotImplementedError(
            "device RTDP runs float32 tables only (its random draws are "
            "jax's float32 stream)")
    S, dev, f32 = m.n_states, m.device, torch.float32
    words = key.reshape(2).cpu()
    args = dict(graph=graph, max_steps=int(max_steps), batch=int(batch),
                cap=int(cap), eps=m._cast(eps), restart_p=m._cast(restart_p),
                discount=m._cast(discount), stop_delta=m._cast(stop_delta),
                decay=m._cast(decay))
    run = kernels.rtdp_walkers if m.prob.is_cuda else _rtdp_plain
    return run(m, words, _initial(value0, S, f32, dev),
               _initial(prog0, S, f32, dev), start_cdf(m), **args)


def _walker_rows(m: TensorMDP, s, K: int):
    """Rows [B, A, K] of the segments of states `s` [B] (slot j of
    action a = the j-th row of segment (s, a), 0 beyond) and their
    validity; the padded layout's [B, A, K] slice without the copy."""
    B, A = s.shape[0], m.n_actions
    i64 = torch.int64
    lo = m.state_seg[s.to(i64)].to(i64)
    hi = m.state_seg[s.to(i64) + 1].to(i64)
    seg = torch.full((B, A), -1, dtype=i64, device=m.device)
    bi = torch.arange(B, device=m.device)
    for j in range(A):  # a state has at most A segments
        k = lo + j
        has = k < hi
        kk = torch.where(has, k, 0)
        a = m.seg_act[kk].to(i64)
        seg[bi[has], a[has]] = kk[has]
    sk = seg.clamp(min=0)
    rlo = m.seg_ptr[sk].to(i64)
    rhi = m.seg_ptr[sk + 1].to(i64)
    rows = rlo[..., None] + torch.arange(K, device=m.device)
    inrow = (seg[..., None] >= 0) & (rows < rhi[..., None])
    return torch.where(inrow, rows, 0), inrow


def _fma_row_sums(prob, rew, prg, v, p, discount):
    """Action values [B, A] of RTDP's [B, A, K] slots: per slot
    x = fma(discount, V[dst], reward), then q = fma(prob, x, q) over the
    slots in row order. XLA:CPU contracts JAX's `(prob * (reward +
    discount * V[dst])).sum(-1)` into exactly these fused multiply-adds
    (unlike the segment sums of VI, which it leaves unfused); K6 calls
    fmaf. Each fma is emulated in float64, where the product is exact:
    one rounding to float64, then one to float32."""
    d = torch.tensor(discount, dtype=torch.float64)
    f32, f64 = torch.float32, torch.float64
    xv = (rew.to(f64) + d * v.to(f64)).to(f32).to(f64)
    xp = (prg.to(f64) + d * p.to(f64)).to(f32).to(f64)
    pr = prob.to(f64)
    q = torch.zeros(prob.shape[:-1], dtype=f32, device=prob.device)
    qp = torch.zeros_like(q)
    for j in range(prob.shape[-1]):
        q = (q.to(f64) + pr[..., j] * xv[..., j]).to(f32)
        qp = (qp.to(f64) + pr[..., j] * xp[..., j]).to(f32)
    return q, qp


def _rtdp_plain(m: TensorMDP, words, V, P, cdf, *, graph, max_steps,
                batch, cap, eps, restart_p, discount, stop_delta, decay):
    """The plain twin of K6: a step-by-step transcription of JAX's
    `_rtdp_loop` (graph False) and `_rtdp_graph_loop` (graph True) over
    the segment index, drawing through `cpr_tpu_torch.random`; the
    action values as `_fma_row_sums` computes them."""
    from cpr_tpu_torch import random as rnd

    S, A, K, B = m.n_states, m.n_actions, m.max_segment(), batch
    dev, f32 = m.device, torch.float32
    key = words.to(dev)
    bi = torch.arange(B, device=dev)
    seg_state = torch.repeat_interleave(
        torch.arange(S, device=dev),
        (m.state_seg[1:] - m.state_seg[:-1]).to(torch.int64))
    any_valid_state = torch.zeros(S, dtype=torch.int32, device=dev)
    any_valid_state.index_add_(0, seg_state, m.seg_valid.to(torch.int32))
    any_valid_state = any_valid_state > 0
    ninf = torch.tensor(float("-inf"), device=dev)
    tiny = torch.tensor(1e-30, dtype=f32, device=dev)

    def draw_start(k):
        u = rnd.uniform(k, (B,)) * cdf[-1]
        return torch.clamp(torch.searchsorted(cdf, u, right=True), 0,
                           S - 1).to(torch.int32)

    visits = torch.zeros(S, dtype=torch.int32, device=dev)
    buf_s = torch.zeros(cap, dtype=torch.int32, device=dev)
    buf_pri = torch.full((cap,), float("-inf"), dtype=f32, device=dev)
    resid = torch.tensor(float("inf"), dtype=f32, device=dev)
    ks = rnd.split(key, 2)
    key, s = ks[0], draw_start(ks[1])
    t = 0
    while t < max_steps and (not graph or bool(resid > stop_delta)):
        ks = rnd.split(key, 7 if graph else 5)
        key = ks[0]
        rows, inrow = _walker_rows(m, s, K)
        prob = torch.where(inrow, m.prob[rows], 0.0)
        dstb = torch.where(inrow, m.dst[rows], 0).to(torch.int64)
        rew = torch.where(inrow, m.reward[rows], 0.0)
        prg = torch.where(inrow, m.progress[rows], 0.0)
        q, qp = _fma_row_sums(prob, rew, prg, V[dstb], P[dstb], discount)
        va = prob.sum(-1) > 0
        has_a = va.any(-1)
        newv, newp, a_greedy = _greedy_backup(q, qp, va, has_a)
        sl = s.to(torch.int64)
        delta_lane = (newv - V[sl]).abs()
        V[sl] = newv
        P[sl] = newp
        visits.index_add_(0, sl, torch.ones_like(s))
        if graph:
            all_pri = torch.cat([buf_pri, delta_lane])
            all_s = torch.cat([buf_s, s])
            top = torch.sort(all_pri, descending=True,
                             stable=True).indices[:cap]
            buf_pri, buf_s = all_pri[top], all_s[top]
        a_rand = rnd.categorical(ks[1], torch.where(va, 0.0, ninf))
        a_beh = torch.where(rnd.uniform(ks[2], (B,)) < eps, a_rand,
                            a_greedy.to(torch.int64))
        a_beh = torch.where(has_a, a_beh, 0)
        prow = prob[bi, a_beh]
        nxt = rnd.categorical(ks[3], torch.log(prow + tiny))
        s_next = dstb[bi, a_beh, nxt].to(torch.int32)
        if graph:
            filled = buf_pri > 0.0
            logits = torch.where(filled, 0.0, ninf)
            if not bool(filled.any()):
                logits = torch.zeros_like(logits)
            pick = buf_s[rnd.categorical(ks[4], logits, shape=(B,))]
            use_buf = ((rnd.uniform(ks[5], (B,)) < restart_p)
                       & filled.any())
            restart = torch.where(use_buf, pick, draw_start(ks[6]))
        else:
            restart = draw_start(ks[4])
        s = torch.where(any_valid_state[s_next.to(torch.int64)] & has_a,
                        s_next, restart)
        if graph:
            r = torch.where(torch.isinf(resid), 0.0, resid * decay)
            resid = torch.maximum(r, delta_lane.max())
        t += 1
    return dict(V=V, P=P, visits=visits, buf_s=buf_s, buf_pri=buf_pri,
                s=s, t=t, resid=float(resid))


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


@dataclass(frozen=True)
class TensorMDP:
    """Device-resident MDP: COO transitions as torch tensors + solvers
    (K4/K5 on the card, their plain twins on the CPU).

    Built by `from_columns`, which sorts the rows stably by segment
    src*A+act, so the rows of one segment keep their compiled order, and
    indexes the segments: `state_seg[s]:state_seg[s+1]` are the
    non-empty segments of state s, in action order;
    `seg_ptr[k]:seg_ptr[k+1]` the rows of segment k, `seg_act[k]` its
    action and `seg_valid[k]` whether it carries probability mass.
    `row_order` is the sort's permutation (sorted row i is compiled row
    row_order[i]); `sort_rows` puts another column of the compiled order,
    such as a grid point's revalued probabilities, in the table's."""

    n_states: int
    n_actions: int
    src: torch.Tensor  # int32 [T], rows sorted by segment
    act: torch.Tensor
    dst: torch.Tensor
    prob: torch.Tensor  # float [T]
    reward: torch.Tensor
    progress: torch.Tensor
    start: torch.Tensor  # float [S]
    state_seg: torch.Tensor  # int32 [S + 1]
    seg_ptr: torch.Tensor  # int32 [n_seg + 1]
    seg_act: torch.Tensor  # int32 [n_seg]
    seg_valid: torch.Tensor  # uint8 [n_seg]
    row_order: torch.Tensor  # int32 [T]

    @classmethod
    def from_columns(cls, n_states: int, n_actions: int, start, src, act,
                     dst, prob, reward, progress) -> TensorMDP:
        """Sort the COO columns (tensors on one device) by segment and
        index them, with plain torch ops on that device (deterministic:
        a stable sort and integer sums)."""
        S, A = int(n_states), int(n_actions)
        if src.shape[0] >= 2**31:
            raise ValueError("row count exceeds int32")
        dev = src.device
        key = src.to(torch.int64) * A + act.to(torch.int64)
        order = torch.argsort(key, stable=True)
        key = key[order]
        T = int(key.shape[0])
        first = torch.ones(T, dtype=torch.bool, device=dev)
        first[1:] = key[1:] != key[:-1]
        starts = torch.nonzero(first).flatten()
        seg_key = key[starts]
        prob = prob[order].contiguous()
        # a segment is valid when one of its rows carries probability mass
        mass = torch.zeros(starts.shape[0], dtype=torch.int64, device=dev)
        mass.index_add_(0, torch.cumsum(first, 0) - 1,
                        (prob > 0).to(torch.int64))
        i32 = torch.int32

        def sort(x):
            return x[order].contiguous()

        return cls(
            n_states=S, n_actions=A, src=sort(src).to(i32),
            act=sort(act).to(i32), dst=sort(dst).to(i32), prob=prob,
            reward=sort(reward), progress=sort(progress),
            start=start.contiguous(),
            state_seg=torch.searchsorted(
                seg_key // max(A, 1),
                torch.arange(S + 1, device=dev)).to(i32).contiguous(),
            seg_ptr=torch.cat([starts, torch.full((1,), T, device=dev)])
            .to(i32).contiguous(),
            seg_act=(seg_key % max(A, 1)).to(i32).contiguous(),
            seg_valid=(mass > 0).to(torch.uint8),
            row_order=order.to(i32))

    @property
    def device(self) -> torch.device:
        return self.prob.device

    @property
    def n_segments(self) -> int:
        return int(self.seg_act.shape[0])

    def sort_rows(self, col) -> torch.Tensor:
        """Columns [..., T] in compiled row order -> the table's order,
        on the table's device."""
        col = torch.as_tensor(col).to(self.device)
        return col[..., self.row_order.to(torch.int64)].contiguous()

    def valid_actions(self):
        """The dense (valid [S, A], any_valid [S]) masks the plain twin
        of K4 reads."""
        return _valid_actions(self.src, self.act, self.prob, self.n_states,
                              self.n_actions)

    # -- value iteration --------------------------------------------------

    def resolve_stop_delta(self, *, discount, eps, stop_delta, max_iter=0):
        """Abort rule of eps-optimal VI (mdp/lib/explicit_mdp.py:106-110).
        For discount == 1 the eps formula degenerates to 0, so an explicit
        stop_delta — or a bare max_iter (fixed number of sweeps) — is
        required."""
        assert 0.0 < discount <= 1.0
        if stop_delta is None:
            if eps is None:
                if max_iter > 0:
                    return 0.0  # run exactly max_iter sweeps
                raise ValueError("need eps, stop_delta, or max_iter")
            if discount == 1.0:
                raise ValueError(
                    "eps-optimality is undefined at discount=1; pass "
                    "stop_delta (absolute value-delta threshold) instead"
                )
            stop_delta = eps * (1.0 - discount) / discount
        assert max_iter > 0 or stop_delta > 0, "infinite iteration"
        return stop_delta

    def _check_segment_width(self):
        assert self.n_states * self.n_actions < 2**31, (
            "state-action space exceeds int32 segment ids; shard the "
            "state axis (cpr_tpu_torch.parallel."
            "sharded_state_value_iteration)"
        )

    def _cast(self, x: float) -> float:
        """`x` rounded to the table's float type, as the reference
        passes discount and thresholds."""
        return float(torch.tensor(x, dtype=self.prob.dtype))

    def value_iteration(self, *, max_iter: int = 0, discount: float = 1.0,
                        eps: float | None = None,
                        stop_delta: float | None = None,
                        verbose: bool = False, impl: str | None = None,
                        checkpoint_path: str | None = None):
        """eps-optimal value iteration (reference semantics:
        mdp/lib/explicit_mdp.py:97-177 — double-buffered dense sweep that
        also tracks expected progress and the greedy policy; ties go to
        the lowest action id; states without actions get value 0 and
        policy -1).

        impl: "while" (default; the device keeps the stop rule, the host
        reads a flag once per block of launches) or "chunked" (fixed-size
        chunks with a host-side convergence check). CPR_VI_IMPL overrides
        the default; both produce the same fixpoint."""
        stop_delta = self.resolve_stop_delta(
            discount=discount, eps=eps, stop_delta=stop_delta,
            max_iter=max_iter)
        self._check_segment_width()
        check_vi_working_set(int(self.src.shape[0]), self.n_states,
                             self.n_actions, self.prob.dtype)
        impl = resolve_vi_impl(impl)
        if checkpoint_path is not None:
            raise NotImplementedError(
                "VI checkpoints (checkpoint_path=) are not ported yet: "
                "they need the resilience/integrity planes, ROADMAP item 6")
        t0 = now()
        run = vi_while_loop if impl == "while" else vi_chunked
        value, progress, policy, delta, it, resid = run(
            self, self._cast(discount), self._cast(stop_delta),
            max_iter if max_iter > 0 else (1 << 30))
        if impl == "while":
            resid = ring_residuals(resid, int(it))
        resid = vi_residuals_event(impl, int(it), resid, stop_delta, delta)
        if verbose:
            print(f"value iteration: {int(it)} sweeps, delta {float(delta):g}")
        return dict(
            vi_discount=discount,
            vi_delta=float(delta),
            vi_stop_delta=stop_delta,
            vi_policy=policy.cpu().numpy(),
            vi_value=value.cpu().numpy(),
            vi_progress=progress.cpu().numpy(),
            vi_iter=int(it),
            vi_max_iter=max_iter,
            vi_residuals=resid,
            vi_time=now() - t0,
        )

    def policy_evaluation(self, policy, *, theta: float,
                          discount: float = 1.0,
                          max_iter: int | None = None):
        """Iterative evaluation of a fixed (positional-action) policy
        (reference: mdp/lib/explicit_mdp.py:328-378); pe_iter counts the
        sweeps from 0."""
        pol = (policy.to(self.device, torch.int32)
               if isinstance(policy, torch.Tensor)
               else torch.from_numpy(np.array(policy, np.int32))
               .to(self.device)).contiguous()
        rew, prg, _, it = _pe_loop(
            self, pol, self._cast(discount), self._cast(theta),
            max_iter if max_iter is not None else (1 << 30))
        return dict(pe_reward=rew.cpu().numpy(),
                    pe_progress=prg.cpu().numpy(), pe_iter=int(it))

    # -- device RTDP (K6) ---------------------------------------------------

    def max_segment(self) -> int:
        """K, the longest segment's row count (1 for an empty table): the
        width of the padded layout and of RTDP's successor draw."""
        if self.n_segments == 0:
            return 1
        return int((self.seg_ptr[1:] - self.seg_ptr[:-1]).max())

    def padded_layout(self):
        """[S*A, K] padded per-(state, action) tables (Tdst int32,
        Tpack [S*A, K, 3] (prob, reward, progress), K): slot j of row
        s*A+a is the j-th row of segment (s, a) in compiled order, zeros
        beyond. Memoized. Refuses (PaddedLayoutTooLarge) above the
        CPR_MDP_PAD_BYTES ceiling (2 GiB by default). `rtdp` does not
        use it: it reads the segment index."""
        cached = getattr(self, "_padded_cache", None)
        if cached is not None:
            return cached
        S, A, K = self.n_states, self.n_actions, self.max_segment()
        item = self.prob.element_size()
        need = S * A * K * (4 + 3 * item)
        ceiling = int(os.environ.get(PAD_BYTES_ENV_VAR,
                                     _PAD_BYTES_DEFAULT))
        if need > ceiling:
            raise PaddedLayoutTooLarge(
                f"padded [S*A, K] layout needs {need:,} bytes "
                f"(S={S}, A={A}, K={K}, dtype={self.prob.dtype}), over "
                f"the {PAD_BYTES_ENV_VAR} ceiling of {ceiling:,}; solve "
                f"large compiles through the COO sweep (value_iteration) "
                f"or rtdp(), neither pads, or raise the ceiling")
        i64 = torch.int64
        key = self.src.to(i64) * A + self.act.to(i64)
        first = torch.repeat_interleave(
            self.seg_ptr[:-1].to(i64),
            (self.seg_ptr[1:] - self.seg_ptr[:-1]).to(i64))
        pos = torch.arange(key.shape[0], device=self.device) - first
        Tdst = torch.zeros((S * A, K), dtype=torch.int32,
                           device=self.device)
        Tpack = torch.zeros((S * A, K, 3), dtype=self.prob.dtype,
                            device=self.device)
        Tdst[key, pos] = self.dst
        for i, col in enumerate((self.prob, self.reward, self.progress)):
            Tpack[key, pos, i] = col
        out = (Tdst, Tpack, K)
        object.__setattr__(self, "_padded_cache", out)  # frozen dataclass
        return out

    def rtdp(self, key, *, steps: int, batch: int = 256, eps: float = 0.2,
             discount: float = 1.0, value0=None, progress0=None):
        """Device RTDP: `batch` parallel eps-greedy trajectories with
        greedy Bellman backups on every visited state, `steps` steps
        from `key` (a `cpr_tpu_torch.random` key); terminal lanes
        restart from the start distribution. Walks the states
        `cpr_tpu.mdp.explicit.TensorMDP.rtdp` walks for the same key.

        On the card one K6 launch runs the whole loop. K6 reads the
        sorted table and its segment index and takes only K (the longest
        segment, the width of the successor draw) from them, so it
        builds no padded [S*A, K] copy and never raises
        PaddedLayoutTooLarge where the reference's padded layout would:
        a difference of layout, not of result. Float32 tables only.
        Returns dict with rtdp_value / rtdp_progress arrays; unvisited
        states keep their init."""
        assert steps > 0 and batch > 0 and 0.0 <= eps <= 1.0
        self._check_segment_width()
        t0 = now()
        r = _rtdp_walk(self, key, graph=False, max_steps=steps,
                       batch=batch, cap=0, eps=eps, restart_p=0.0,
                       discount=discount, stop_delta=0.0, decay=0.5,
                       value0=value0, prog0=progress0)
        return dict(rtdp_value=r["V"].cpu().numpy(),
                    rtdp_progress=r["P"].cpu().numpy(),
                    rtdp_steps=steps, rtdp_batch=batch,
                    rtdp_time=now() - t0)

    # -- start-state aggregates -------------------------------------------

    def start_value(self, values) -> float:
        v = torch.as_tensor(np.asarray(values) if not isinstance(
            values, torch.Tensor) else values, dtype=self.start.dtype,
            device=self.start.device)
        return float(v @ self.start)

    # -- markov chain / steady state (host, scipy) ------------------------

    def _numpy(self):
        return (self.src.cpu().numpy(), self.act.cpu().numpy(),
                self.dst.cpu().numpy(),
                self.prob.cpu().numpy().astype(np.float64),
                self.reward.cpu().numpy().astype(np.float64),
                self.progress.cpu().numpy().astype(np.float64))

    def reachable_states(self, policy, *, start_state=None):
        """States visited under a policy (mdp/lib/explicit_mdp.py:179-208)."""
        src, act, dst, prob, _, _ = self._numpy()
        adj: dict[int, list[int]] = {}
        for i in range(len(src)):
            if prob[i] == 0.0:
                continue
            if policy[src[i]] == act[i]:
                adj.setdefault(int(src[i]), []).append(int(dst[i]))
        todo = set()
        if start_state is None:
            todo = {int(s) for s, p in enumerate(np.asarray(self.start)) if p > 0}
        else:
            todo = {int(start_state)}
        seen = set()
        while todo:
            s = todo.pop()
            seen.add(s)
            if policy[s] < 0:
                continue
            for d in adj.get(s, []):
                if d not in seen:
                    todo.add(d)
        return seen

    def markov_chain(self, policy, *, start_state):
        """Policy-induced markov chain as scipy sparse matrices
        (mdp/lib/explicit_mdp.py:210-250)."""
        reachable = sorted(self.reachable_states(policy, start_state=start_state))
        mc_of = {s: i for i, s in enumerate(reachable)}
        src, act, dst, prob, rew, prg = self._numpy()
        rows, cols, prbs, rews, prgs = [], [], [], [], []
        covered = set()
        for i in range(len(src)):
            s = int(src[i])
            if s not in mc_of or policy[s] != act[i] or prob[i] == 0.0:
                continue
            covered.add(s)
            rows.append(mc_of[s])
            cols.append(mc_of[int(dst[i])])
            prbs.append(prob[i])
            rews.append(rew[i])
            prgs.append(prg[i])
        for s in reachable:
            if s not in covered:  # terminal: self loop
                rows.append(mc_of[s])
                cols.append(mc_of[s])
                prbs.append(1.0)
                rews.append(0.0)
                prgs.append(0.0)
        n = len(reachable)
        return dict(
            prb=scipy.sparse.coo_matrix((prbs, (rows, cols)), shape=(n, n)),
            rew=scipy.sparse.coo_matrix((rews, (rows, cols)), shape=(n, n)),
            prg=scipy.sparse.coo_matrix((prgs, (rows, cols)), shape=(n, n)),
            mdp_states=reachable,
        )

    def steady_state(self, policy, *, start_state):
        """Stationary distribution of the policy-induced chain via a sparse
        least-norm solve (mdp/lib/explicit_mdp.py:252-326)."""
        t0 = now()
        mc = self.markov_chain(policy, start_state=start_state)
        prb = mc["prb"]
        n = prb.shape[0]
        rows = list(prb.row) + list(range(n)) + list(range(n))
        cols = list(prb.col) + list(range(n)) + [n] * n
        vals = list(prb.data) + [-1.0] * n + [1.0] * n
        Q = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n, n + 1))
        QTQ = Q.dot(Q.transpose())
        b = np.ones(n)
        v = scipy.sparse.linalg.spsolve(QTQ, b)
        if np.isnan(v).any():
            lsqr = scipy.sparse.linalg.lsqr(QTQ, b)
            v = lsqr[0]
            v = v / v.sum()
        assert math.isclose(v.sum(), 1.0, rel_tol=1e-5)
        ss = np.zeros(self.n_states)
        for mc_s, mdp_s in enumerate(mc["mdp_states"]):
            ss[mdp_s] = v[mc_s]
        return dict(ss=ss, ss_reachable=n,
                    ss_nonzero=int((v != 0).sum()),
                    ss_time=now() - t0)
