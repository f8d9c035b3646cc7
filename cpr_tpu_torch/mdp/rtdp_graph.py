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

`rtdp_sharded_polish` hands the walked table to the state-sharded
chunked VI (`parallel.sharded_state_value_iteration`, K16-state) as its
warm start.
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


def rtdp_sharded_polish(tm: TensorMDP, mesh, key, *, rtdp_steps: int,
                        batch: int = 256, buffer: int = 1024,
                        eps: float = 0.2, restart_p: float = 0.5,
                        rtdp_stop_delta: float = 0.0,
                        discount: float = 1.0,
                        stop_delta: float | None = None,
                        vi_eps: float | None = None, max_iter: int = 0,
                        axis: str = "d", chunk: int = 64,
                        pad_states: bool = False,
                        checkpoint_path: str | None = None,
                        checkpoint_every: int = 1,
                        protocol: str | None = None,
                        cutoff: int | None = None) -> dict:
    """Explore on the device, polish exactly: `rtdp_graph` (K6) hands its
    partly converged (value, progress) to the state-sharded chunked VI
    (K16-state) as a warm start, so the exact solve sweeps from near the
    fixpoint instead of zero. The dict of
    `sharded_state_value_iteration` plus the rtdp_* entries of
    `rtdp_graph`."""
    from cpr_tpu_torch.parallel import sharded_state_value_iteration

    r = rtdp_graph(tm, key, max_steps=rtdp_steps, batch=batch,
                   buffer=buffer, eps=eps, restart_p=restart_p,
                   discount=discount, stop_delta=rtdp_stop_delta)
    vi = sharded_state_value_iteration(
        tm, mesh, axis=axis, max_iter=max_iter, discount=discount,
        eps=vi_eps, stop_delta=stop_delta, chunk=chunk,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
        value0=r["rtdp_value"], progress0=r["rtdp_progress"],
        pad_states=pad_states, protocol=protocol, cutoff=cutoff)
    vi.update((k, v) for k, v in r.items() if k.startswith("rtdp_"))
    return vi
