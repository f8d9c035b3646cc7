"""Device RTDP with visit counters, a priority restart buffer and an
early exit.

Reference counterpart: `cpr_tpu/mdp/rtdp_graph.py` (`rtdp_graph`, its
loop `_rtdp_graph_loop`). `TensorMDP.rtdp` runs a fixed number of
eps-greedy walker steps; `rtdp_graph` adds what makes the walk useful on
large tables:

* a residual stop: the loop tracks `resid = max(resid * decay, this
  step's largest backup delta)`, a damped running peak, and ends when it
  falls to `stop_delta` (or after `max_steps`);
* per-state visit counters;
* a buffer of the `buffer` highest-|delta| states seen, merged each step
  (ties: the older entry first, as `lax.top_k` orders them); a walker
  that must restart resumes from a buffered state with probability
  `restart_p`, else from the start distribution.

The whole loop is one launch of kernel K6 on the card (its stop rule
decided on the device), the plain twin `explicit._rtdp_plain` on the
CPU. The same key walks the same states as the reference.

`rtdp_sharded_polish` needs the state-sharded solver (K16) and raises;
on one card the handoff is `rtdp_graph` followed by
`explicit.run_chunk_driver(value0=, prog0=)`.
"""

from __future__ import annotations

from cpr_tpu_torch.mdp.explicit import TensorMDP, _rtdp_walk
from cpr_tpu_torch.telemetry import now

__all__ = ["rtdp_graph", "rtdp_sharded_polish"]


def rtdp_graph(tm: TensorMDP, key, *, max_steps: int, batch: int = 256,
               buffer: int = 1024, eps: float = 0.2,
               restart_p: float = 0.5, discount: float = 1.0,
               stop_delta: float = 0.0, decay: float = 0.95,
               value0=None, progress0=None) -> dict:
    """Device RTDP over a compiled float32 TensorMDP (module docstring).
    At the default stop_delta 0.0 the loop runs `max_steps` steps unless
    the damped residual reaches exactly 0.

    Returns dict(rtdp_value, rtdp_progress, rtdp_visits, rtdp_buffer
    (the [buffer] highest-|delta| state ids, -1 where unfilled),
    rtdp_steps (steps run), rtdp_resid, rtdp_batch, rtdp_time)."""
    assert max_steps > 0 and batch > 0 and buffer > 0
    assert 0.0 <= eps <= 1.0 and 0.0 <= restart_p <= 1.0
    assert 0.0 < decay < 1.0
    tm._check_segment_width()
    t0 = now()
    r = _rtdp_walk(tm, key, graph=True, max_steps=max_steps, batch=batch,
                   cap=buffer, eps=eps, restart_p=restart_p,
                   discount=discount, stop_delta=stop_delta, decay=decay,
                   value0=value0, prog0=progress0)
    buf_pri = r["buf_pri"].cpu().numpy()
    buf = r["buf_s"].cpu().numpy()
    buf[~(buf_pri > 0.0)] = -1
    return dict(rtdp_value=r["V"].cpu().numpy(),
                rtdp_progress=r["P"].cpu().numpy(),
                rtdp_visits=r["visits"].cpu().numpy(), rtdp_buffer=buf,
                rtdp_steps=int(r["t"]), rtdp_resid=float(r["resid"]),
                rtdp_batch=batch, rtdp_time=now() - t0)


def rtdp_sharded_polish(*args, **kwargs):
    """The reference hands the RTDP table to the state-sharded solver;
    that solver is not ported (K16)."""
    raise NotImplementedError(
        "rtdp_sharded_polish needs the state-sharded VI (K16), not "
        "ported yet: ROADMAP item 13; on one card use rtdp_graph and "
        "run_chunk_driver(value0=, prog0=)")
