"""The grid chunk step of grid-batched value iteration.

Reference counterpart: `cpr_tpu/parallel/grid.py`
(`make_grid_chunk_step`). Every (alpha, gamma) point solves an
independent MDP over the same transition structure. On one device the
step advances all live points by `steps` sweeps through
`cpr_tpu_torch.mdp.explicit.make_grid_vi_chunk` (kernel K7 on the card,
its plain twin on the CPU). With a mesh the [G] axis is split over the
shards: shard b advances points [b·G/n, (b+1)·G/n) with K7 over its slice
on its device (the table copied there once), so every point's sweeps are
the single-device ones bit for bit. Uneven grids are refused
(`check_even_shards`). The grid x state 2-D mesh is
`parallel.state_shard.make_grid_state_chunk_step`.
"""

from __future__ import annotations

import numpy as np
import torch

from cpr_tpu_torch.mdp.explicit import make_grid_vi_chunk

__all__ = ["make_grid_chunk_step"]


def make_grid_chunk_step(tm, G: int, *, discount, mesh=None,
                         axis: str = "d"):
    """Build the grid chunk step over `tm`'s structure (its own
    probability column is unused; the points' columns arrive as the
    [G, T] `probs` plane, in the table's row order: `tm.sort_rows`).

    Returns `(chunk_step, place)`: `chunk_step(carry, probs, frozen,
    steps) -> (carry, deltas [G, steps])` advances every unfrozen point
    `steps` sweeps; `place(x)` puts a host array on `tm`'s device (the
    mesh's first shard's). The validity masks of a `probs` plane are
    built on its first chunk and reused while the same plane comes
    back."""
    disc = tm._cast(discount)
    built: dict = {}
    shards = None
    if mesh is not None:
        from cpr_tpu_torch.parallel import table_on
        from cpr_tpu_torch.parallel.lanes import lane_slices
        shards = [(table_on(tm, dev), lo, hi)
                  for dev, lo, hi in lane_slices(G, mesh, axis,
                                                 "grid points")]
        lead = shards[0][0].device
    else:
        lead = tm.device

    def place(x):
        return torch.from_numpy(np.asarray(x)).to(lead)

    def chunk_step(carry, probs, frozen, steps):
        if built.get("probs") is not probs:
            steps_of = ([make_grid_vi_chunk(tm, probs, disc)]
                        if shards is None else
                        [make_grid_vi_chunk(t, probs[lo:hi].to(t.device),
                                            disc)
                         for t, lo, hi in shards])
            built.update(probs=probs, steps=steps_of)
        if shards is None:
            return built["steps"][0](carry, frozen, steps)
        outs = []
        for step, (t, lo, hi) in zip(built["steps"], shards):
            part = tuple(x[lo:hi].to(t.device) for x in carry)
            outs.append(step(part, frozen[lo:hi].to(t.device), steps))
        return (tuple(torch.cat([o[0][k].to(lead) for o in outs])
                      for k in range(3)),
                torch.cat([o[1].to(lead) for o in outs]))

    return chunk_step, place
