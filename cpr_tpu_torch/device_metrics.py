"""Device metrics: counters, stats and histogram cells folded on the card
(port of cpr_tpu/device_metrics.py; kernel K17).

A `MetricsSpec` names a set of cells, as the JAX package's does:
counters (int32 sums that wrap at 2^32), stats ({min, max, sum, count}
float32, min and max propagating NaN: a poisoned stats cell is itself a
sentinel) and histograms (int32 counts over static increasing edges,
`len(edges) + 1` bins with under- and overflow). Where the JAX package
threads a dict of arrays through its traced programs, the port keeps an
accumulator as ONE flat int32 tensor that the spec lays out: the counter
and histogram words first, then the stats cells as four blocks of
float32 bit patterns (every cell's min, then every max, every sum, every
count). `summarize` is one host copy of that tensor.

The update ops (`count`, `observe`, `observe_hist`, and `fold` for a
list of them) add into the accumulator IN PLACE and return it (the JAX
package returns a new dict). On a CUDA accumulator a fold is one launch
of K17 (csrc/metrics.cu) over every cell of the list, reading the
tensors other kernels wrote; on a CPU one it runs `fold_plain`, the same
arithmetic in PyTorch. There is no fallback from the one to the other.
A fold reads its inputs without a host sync, so the drivers that fold
(`make_episode_stats_fn(collect_metrics=True)`, `rollout(with_metrics=
True)`, the serve engine, PPO's update) add no sync to their paths; the
one readback is `summarize`, once a telemetry span.

The port's folds reduce over lanes as they fold: where the JAX package
vmaps a per-lane accumulator and merges it with `merge_axis`, a port
driver's accumulator is already the merged one (its float sums in K17's
order, not XLA's). `merge` and `merge_axis` exist for accumulators a
caller stacks or keeps apart.

Gating: `enabled()` reads `CPR_DEVICE_METRICS` ("1" = on) when a producer
is built (the episode-stats drivers take `collect_metrics=` instead),
so the off path runs exactly the launches it ran before.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

ENV_VAR = "CPR_DEVICE_METRICS"

# fold op kinds (csrc/metrics.cu Kind)
COUNT, NONFINITE, STATS, HIST = 0, 1, 2, 3
# K17's histogram limit: 32 bins
MAX_EDGES = 31
_INF_BITS = 0x7F800000      # float32 +inf as int32
_NINF_BITS = -0x00800000    # float32 -inf (0xff800000) as int32


def enabled() -> bool:
    """True when device metrics are requested (CPR_DEVICE_METRICS=1).
    Read at build time by the producers."""
    return os.environ.get(ENV_VAR) == "1"


@dataclasses.dataclass(frozen=True)
class Op:
    """One update of a fold: see `count_op`, `nonfinite_op`, `observe_op`
    and `hist_op`."""
    kind: int
    name: str
    x: Any = None          # a tensor, or None for an immediate update
    # mask of x's shape: bool, or int read as where=(mask != 0) (the
    # episode drivers pass n_episodes for has_ep without a glue op)
    where: Any = None
    scale: int = 1         # counter increment a unit
    n: int = 1             # immediate counter: n * scale
    value: float = 0.0     # immediate stats cell: one observation
    rows: bool = False     # NONFINITE: rows of x's last axis, any bad
    nonfinite: str | None = None  # STATS: x's nonfinite count goes here


def count_op(name: str, n, scale: int = 1) -> Op:
    """counter += scale * sum(n): `n` a bool/int tensor (summed, cast to
    int32 as the reference casts), or a Python int."""
    if isinstance(n, torch.Tensor):
        return Op(COUNT, name, x=n, scale=int(scale))
    return Op(COUNT, name, n=int(n), scale=int(scale))


def nonfinite_op(name: str, x, rows: bool = False) -> Op:
    """counter += the nonfinite elements of float tensor `x`; with
    `rows`, the rows of its last axis that hold any."""
    return Op(NONFINITE, name, x=x, rows=rows)


def observe_op(name: str, values, where=None,
               nonfinite: str | None = None) -> Op:
    """Fold `values` (a tensor, or a Python number: one observation)
    into a stats cell, masked by `where`; with `nonfinite`, also count
    the nonfinite elements of `values` (all of them, masked or not)
    into that counter in the same read."""
    if isinstance(values, torch.Tensor):
        return Op(STATS, name, x=values, where=where, nonfinite=nonfinite)
    if where is not None:
        raise ValueError("an immediate observation takes no mask")
    return Op(STATS, name, value=float(values), nonfinite=nonfinite)


def hist_op(name: str, values, where=None) -> Op:
    """Bin `values` (a tensor) into a hist cell: bin i counts values in
    [edges[i-1], edges[i]); NaN and +inf land in the overflow bin."""
    return Op(HIST, name, x=values, where=where)


def _wrap32(t: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (XLA's int32 sums wrap)."""
    return ((t + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _truth(where: torch.Tensor) -> torch.Tensor:
    return where if where.dtype == torch.bool else where != 0


class MetricsSpec:
    """Declarative set of named cells and their fold over one flat
    accumulator tensor (the layout above)."""

    _KINDS = {"counter": (COUNT, NONFINITE), "stats": (STATS,),
              "hist": (HIST,)}

    def __init__(self):
        self._cells: dict[str, tuple] = {}
        self._lay = None
        self._templates: dict[str, torch.Tensor] = {}

    # -- declaration ------------------------------------------------------

    def _declare(self, name, cell):
        self._cells[name] = cell
        self._lay = None
        self._templates = {}
        return self

    def counter(self, name: str):
        return self._declare(name, ("counter",))

    def stats(self, name: str):
        return self._declare(name, ("stats",))

    def hist(self, name: str, edges):
        edges = np.asarray(edges, np.float32)
        assert edges.ndim == 1 and (np.diff(edges) > 0).all(), (
            "hist edges must be a 1-D increasing vector")
        assert len(edges) <= MAX_EDGES, (
            f"K17 bins at most {MAX_EDGES} hist edges")
        return self._declare(name, ("hist", edges))

    @property
    def names(self):
        return tuple(self._cells)

    def kind(self, name: str) -> str:
        return self._cells[name][0]

    def edges(self, name: str) -> np.ndarray:
        return self._cells[name][1]

    # -- layout -----------------------------------------------------------

    def layout(self) -> tuple[dict, int, int, int]:
        """(word of each cell, int words I, stats cells S, total words
        I + 4 S): a counter's word, a hist's first bin, a stats cell's
        min word (max, sum and count S, 2 S and 3 S after it)."""
        if self._lay is None:
            word, off = {}, 0
            for name, cell in self._cells.items():
                if cell[0] == "counter":
                    word[name] = off
                    off += 1
                elif cell[0] == "hist":
                    word[name] = off
                    off += len(cell[1]) + 1
            stats = [n for n, c in self._cells.items() if c[0] == "stats"]
            for j, name in enumerate(stats):
                word[name] = off + j
            self._lay = (word, off, len(stats), off + 4 * len(stats))
        return self._lay

    # -- accumulator lifecycle --------------------------------------------

    def init(self, device="cpu") -> torch.Tensor:
        """A fresh accumulator on `device`: counters and bins 0, stats
        min +inf, max -inf, sum and count 0 (made on the device, no
        host copy)."""
        dev = torch.device(device)
        key = str(dev)
        t = self._templates.get(key)
        if t is None:
            _, I, S, W = self.layout()
            t = torch.zeros(W, dtype=torch.int32, device=dev)
            if S:
                t[I:I + S].fill_(_INF_BITS)
                t[I + S:I + 2 * S].fill_(_NINF_BITS)
            self._templates[key] = t
        return t.clone()

    # -- update ops -------------------------------------------------------

    def _check_op(self, op: Op):
        if op.name not in self._cells:
            raise KeyError(f"no cell {op.name!r} in this spec")
        assert op.kind in self._KINDS[self.kind(op.name)], (
            f"{op.name} is a {self.kind(op.name)} cell")
        if op.nonfinite is not None:
            assert self.kind(op.nonfinite) == "counter", op.nonfinite

    def fold(self, acc: torch.Tensor, ops) -> torch.Tensor:
        """Apply `ops` to `acc` in place: one K17 launch on a CUDA
        accumulator (every op's tensors on its device), `fold_plain` on
        a CPU one. Returns `acc`."""
        ops = list(ops)
        for op in ops:
            self._check_op(op)
        if not ops:
            return acc
        if acc.device.type == "cuda":
            from cpr_tpu_torch import kernels
            kernels.metrics_fold(acc, [self.lower(op) for op in ops])
            return acc
        if acc.device.type != "cpu":
            raise ValueError(f"unsupported device {acc.device}")
        return self.fold_plain(acc, ops)

    def count(self, acc, name: str, n, scale: int = 1):
        """acc[name] += sum(n) (a bool/int tensor or a Python int)."""
        return self.fold(acc, [count_op(name, n, scale)])

    def observe(self, acc, name: str, values, where=None):
        """Fold `values` (any shape) into a stats cell, optionally masked
        by `where` (same shape, True = include)."""
        return self.fold(acc, [observe_op(name, values, where)])

    def observe_hist(self, acc, name: str, values, where=None):
        """Bin `values` into a hist cell: bin i counts values in
        [edges[i-1], edges[i]) with open-ended under/overflow bins."""
        return self.fold(acc, [hist_op(name, values, where)])

    # -- K17's cells ------------------------------------------------------

    def lower(self, op: Op) -> dict:
        """`op` as a cell of K17's table (kernels.metrics_fold): the
        tensor as rows of a pointer and strides, the mask walked in the
        same order, the accumulator words."""
        word, _, S, _ = self.layout()
        cell = dict(kind=op.kind, x=None, mask=None, n=op.n, stride=1,
                    mstride=1, row_len=1, scale=op.scale, value=op.value,
                    dst=word[op.name], dst2=-1, n_stats=S, edges=None)
        if op.kind == STATS and op.nonfinite is not None:
            cell["dst2"] = word[op.nonfinite]
        if op.kind == HIST:
            cell["edges"] = self.edges(op.name)
        x = op.x
        if x is None:
            return cell
        if op.rows:
            x2 = x.reshape(-1, x.shape[-1]) if x.dim() != 2 else x
            if x2.dim() == 2 and x2.shape[1] > 0 and x2.stride(1) != 1:
                x2 = x2.contiguous()
            cell.update(x=x2, n=x2.shape[0], row_len=x2.shape[1],
                        stride=x2.stride(0))
            return cell
        x1, m1 = _rows(x, op.where)
        cell.update(x=x1, n=x1.numel(), stride=x1.stride(0) if x1.numel()
                    > 1 else 1)
        if m1 is not None:
            cell.update(mask=m1, mstride=m1.stride(0) if m1.numel() > 1
                        else 1)
        return cell

    # -- the plain version ------------------------------------------------

    def fold_plain(self, acc: torch.Tensor, ops) -> torch.Tensor:
        """Plain twin of K17: `ops` applied to `acc` in place by PyTorch
        ops, on any device (the CPU path; on the card only to hold the
        kernel). Counters sum in int64 and wrap to int32; stats follow
        jnp's where/minimum/maximum; hist bins count `x >= edge` over
        the edges, NaN in the overflow bin."""
        word, _, S, _ = self.layout()
        f = acc.view(torch.float32)
        dev = acc.device
        for op in ops:
            self._check_op(op)
            w = word[op.name]
            if op.kind in (COUNT, NONFINITE):
                if op.x is None:
                    inc = (op.n * op.scale) % 2 ** 32
                elif op.kind == COUNT:
                    inc = op.x.to(torch.int64).sum() * op.scale
                else:
                    bad = ~torch.isfinite(op.x.to(torch.float32))
                    if op.rows:
                        bad = bad.any(-1)
                    inc = bad.sum() * op.scale
                acc[w] = _wrap32(acc[w].to(torch.int64) + inc)
                continue
            if op.kind == STATS:
                if op.x is None:
                    v = torch.full((), op.value, dtype=torch.float32,
                                   device=dev)
                    mn = mx = sm = v
                    ct = 1.0
                    bad = ~torch.isfinite(v)
                else:
                    x = op.x.to(torch.float32)
                    bad = ~torch.isfinite(x)
                    if op.where is None:
                        wx = x
                        sm = x.sum()
                        ct = float(x.numel())
                        mn = x.amin() if x.numel() else None
                        mx = x.amax() if x.numel() else None
                    else:
                        m = _truth(op.where)
                        inf = float("inf")
                        wx = torch.where(m, x, inf)
                        mn = wx.amin() if x.numel() else None
                        mx = torch.where(m, x, -inf).amax() \
                            if x.numel() else None
                        sm = torch.where(m, x, 0.0).sum()
                        ct = m.sum().to(torch.float32)
                if mn is not None:
                    f[w] = torch.minimum(f[w], mn)
                    f[w + S] = torch.maximum(f[w + S], mx)
                f[w + 2 * S] = f[w + 2 * S] + sm
                f[w + 3 * S] = f[w + 3 * S] + ct
                if op.nonfinite is not None:
                    nw = word[op.nonfinite]
                    acc[nw] = _wrap32(acc[nw].to(torch.int64)
                                      + bad.sum())
                continue
            edges = self.edges(op.name)
            x = op.x.to(torch.float32).reshape(-1)
            idx = torch.zeros(x.shape, dtype=torch.int64, device=dev)
            for e in edges.tolist():
                idx += x >= e
            idx = torch.where(torch.isnan(x), len(edges), idx)
            wt = (torch.ones_like(idx) if op.where is None
                  else _truth(op.where).reshape(-1).to(torch.int64))
            counts = torch.zeros(len(edges) + 1, dtype=torch.int64,
                                 device=dev).index_add_(0, idx, wt)
            nb = len(edges) + 1
            acc[w:w + nb] = _wrap32(acc[w:w + nb].to(torch.int64) + counts)
        return acc

    # -- reductions -------------------------------------------------------

    def merge(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Combine two accumulators (e.g. across bench reps) into a new
        one: counters and bins add, stats min/min, max/max, sums add."""
        return self.merge_axis(torch.stack([a, b]), 0)

    def merge_axis(self, acc: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Reduce a stack of accumulators (`acc` [..., words], the words
        last) over `axis`."""
        _, I, S, W = self.layout()
        if acc.shape[-1] != W or axis in (-1, acc.dim() - 1):
            raise ValueError("merge_axis: the words are the last axis")
        f = acc.view(torch.float32)
        parts = [_wrap32(acc[..., :I].to(torch.int64).sum(axis)),
                 f[..., I:I + S].amin(axis).view(torch.int32),
                 f[..., I + S:I + 2 * S].amax(axis).view(torch.int32),
                 f[..., I + 2 * S:].sum(axis).view(torch.int32)]
        return torch.cat(parts, -1)

    # -- the single host readback -----------------------------------------

    def summarize(self, acc: torch.Tensor) -> dict:
        """ONE host copy of the accumulator -> a plain dict for the
        `device_metrics` event: counters as ints, stats with a derived
        mean (None min/max/mean for an empty cell), hists as edges and
        counts."""
        host = acc.detach().to("cpu").numpy().copy()
        f = host.view(np.float32)
        word, _, S, _ = self.layout()
        out = {}
        for name, cell in self._cells.items():
            w = word[name]
            if cell[0] == "counter":
                out[name] = int(host[w])
            elif cell[0] == "stats":
                n = float(f[w + 3 * S])
                out[name] = {
                    "min": float(f[w]) if n else None,
                    "max": float(f[w + S]) if n else None,
                    "sum": float(f[w + 2 * S]),
                    "count": n,
                    "mean": float(f[w + 2 * S]) / n if n else None,
                }
            else:
                out[name] = {
                    "edges": [float(e) for e in cell[1]],
                    "counts": [int(v) for v in
                               host[w:w + len(cell[1]) + 1]],
                }
        return out


def _rows(x: torch.Tensor, where):
    """`x` (and its mask, walked in the same order) as 1-D tensors K17
    reads by a pointer and a stride: a 1-D view keeps its stride, a
    tensor of more axes is flattened in its memory order (a transposed
    trajectory needs no copy), copied only where it is not dense."""
    if where is not None and tuple(where.shape) != tuple(x.shape):
        raise ValueError(f"mask shape {tuple(where.shape)} is not the "
                         f"values' {tuple(x.shape)}")
    if x.dim() <= 1:
        return x.reshape(-1), None if where is None else where.reshape(-1)
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    xp = x.permute(order)
    xp = xp if xp.is_contiguous() else xp.contiguous()
    mp = None
    if where is not None:
        mp = where.permute(order)
        mp = (mp if mp.is_contiguous() else mp.contiguous()).reshape(-1)
    return xp.reshape(-1), mp


def emit(scope: str, spec: MetricsSpec, acc: torch.Tensor, **extra):
    """Summarize `acc` (the one host readback) and emit a
    `device_metrics` point event on the current telemetry sink."""
    from cpr_tpu_torch import telemetry

    summary = spec.summarize(acc)
    telemetry.current().event("device_metrics", scope=scope,
                              metrics=summary, **extra)
    return summary


# -- the rollout specs --------------------------------------------------------

# episode-length bins: powers of two up to the dense-runaway ceiling
# (2016-step nakamoto episodes land in the 2048 bin)
_EP_LEN_EDGES = tuple(float(2 ** i) for i in range(4, 14))


def rollout_spec() -> MetricsSpec:
    """Per-step cells for `rollout(with_metrics=True)`: step/episode
    counts, reward range, episode-length mix, and nonfinite sentinels
    on obs/reward, folded from the stacked trajectory the caller
    materializes anyway."""
    spec = MetricsSpec()
    spec.counter("env_steps")
    spec.counter("episodes")
    spec.counter("nonfinite_obs")
    spec.counter("nonfinite_reward")
    spec.stats("reward")
    spec.stats("episode_length")
    spec.hist("episode_length_hist", _EP_LEN_EDGES)
    return spec


def episode_stats_spec(stat_keys) -> MetricsSpec:
    """Cells for the batched episode-stats drivers
    (`make_episode_stats_fn(collect_metrics=True)`), derived from the
    per-lane aggregates the driver computes anyway: `env_steps`/
    `episodes` counters; one stats cell per `episode_*` key (the spread
    across lanes of each lane's completed-episode mean);
    `episode_n_steps_hist` over the per-lane mean episode length;
    `nonfinite_stats` (poisoned per-lane aggregates) and
    `nonfinite_obs_boundary` (nonfinite elements of the live
    observation at chunk boundaries / stream end)."""
    spec = MetricsSpec()
    spec.counter("env_steps")
    spec.counter("episodes")
    spec.counter("nonfinite_stats")
    spec.counter("nonfinite_obs_boundary")
    for k in stat_keys:
        spec.stats(k)
    if "episode_n_steps" in stat_keys:
        spec.hist("episode_n_steps_hist", _EP_LEN_EDGES)
    return spec


def episode_stats_ops(*, stats, n_episodes, stat_keys) -> list[Op]:
    """The ops of `fold_episode_stats` over every lane at once: lanes
    that finished no episode are masked out of the stats cells and the
    hist (`n_episodes` itself is the mask: nonzero = has_ep) but still
    feed the nonfinite sentinel."""
    ops = [observe_op(k, stats[k], where=n_episodes,
                      nonfinite="nonfinite_stats") for k in stat_keys]
    ops.append(count_op("episodes", n_episodes))
    if "episode_n_steps" in stat_keys:
        ops.append(hist_op("episode_n_steps_hist",
                           stats["episode_n_steps"], where=n_episodes))
    return ops


def fold_episode_stats(spec: MetricsSpec, acc, *, stats, n_episodes,
                       stat_keys):
    """Fold the lanes' completed-episode aggregates (their `episode_*`
    means [L] and episode counts [L]) into an episode_stats_spec()
    accumulator, in one fold."""
    return spec.fold(acc, episode_stats_ops(
        stats=stats, n_episodes=n_episodes, stat_keys=stat_keys))


def obs_nonfinite(obs) -> torch.Tensor:
    """Per-step count of nonfinite observation elements: reduces the
    trailing feature axis."""
    x = torch.as_tensor(obs).to(torch.float32)
    return (~torch.isfinite(x)).sum(-1).to(torch.int32)


def rollout_ops(*, reward, done, ep_len, nonfinite_obs=None,
                obs=None) -> list[Op]:
    """The ops of `update_rollout`: `reward`/`done`/`ep_len` of one
    shape (`ep_len` = info["episode_n_steps"]), and either
    `nonfinite_obs`, the per-step counts of `obs_nonfinite`, or `obs`
    itself, whose nonfinite elements are counted in the fold (the same
    total)."""
    if (obs is None) == (nonfinite_obs is None):
        raise ValueError("pass one of nonfinite_obs and obs")
    return [count_op("env_steps", reward.numel()),
            count_op("episodes", done),
            (nonfinite_op("nonfinite_obs", obs) if obs is not None
             else count_op("nonfinite_obs", nonfinite_obs)),
            nonfinite_op("nonfinite_reward", reward),
            observe_op("reward", reward),
            observe_op("episode_length", ep_len, where=done),
            hist_op("episode_length_hist", ep_len, where=done)]


def update_rollout(spec: MetricsSpec, acc, *, reward, done, ep_len,
                   nonfinite_obs=None, obs=None):
    """Fold a stacked rollout segment (see `rollout_ops`) into a
    `rollout_spec()` accumulator in one fold."""
    return spec.fold(acc, rollout_ops(reward=reward, done=done,
                                      ep_len=ep_len,
                                      nonfinite_obs=nonfinite_obs, obs=obs))


# -- the serving spec ---------------------------------------------------------

# log-scale edges (seconds) for the per-burst dispatch-latency histogram:
# half-decade buckets over 10us .. ~316s
_BURST_S_EDGES = tuple(10.0 ** (e / 2.0) for e in range(-10, 6))


def serve_spec() -> MetricsSpec:
    """Cells for the serve resident engine: throughput counters
    (`env_steps`/`episodes`/`bursts`), `shed_sessions` (admission
    refusals, folded at drain), the `occupancy` spread (one observation
    a burst) and the burst wall time twice (`burst_s` and the
    `burst_s_hist` log buckets, folded at drain from the host walls)."""
    spec = MetricsSpec()
    spec.counter("env_steps")
    spec.counter("episodes")
    spec.counter("bursts")
    spec.counter("shed_sessions")
    spec.stats("occupancy")
    spec.stats("burst_s")
    spec.hist("burst_s_hist", _BURST_S_EDGES)
    return spec


# -- the PPO update spec ------------------------------------------------------

def ppo_spec() -> MetricsSpec:
    """Cells a PPO train_step accumulates: numerical sentinels on
    advantages and losses, KL early-stop skips, and the approximate-KL
    range across minibatches."""
    spec = MetricsSpec()
    spec.counter("nonfinite_advantages")
    spec.counter("nonfinite_loss")
    spec.counter("minibatches")
    spec.counter("minibatches_skipped")
    spec.stats("approx_kl")
    return spec
