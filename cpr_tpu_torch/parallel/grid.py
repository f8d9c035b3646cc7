"""The grid chunk step of grid-batched value iteration.

Reference counterpart: `cpr_tpu/parallel/grid.py`
(`make_grid_chunk_step`). Every (alpha, gamma) point solves an
independent MDP over the same transition structure. On one device the
step advances all live points by `steps` sweeps through
`cpr_tpu_torch.mdp.explicit.make_grid_vi_chunk` (kernel K7 on the card,
its plain twin on the CPU). Sharding the grid axis over a mesh is not
ported (K16, ROADMAP item 13).
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
    [G, T] `probs` plane on `tm`'s device, in the table's row order:
    `tm.sort_rows`).

    Returns `(chunk_step, place)`: `chunk_step(carry, probs, frozen,
    steps) -> (carry, deltas [G, steps])` advances every unfrozen point
    `steps` sweeps; `place(x)` puts a host array on `tm`'s device. The
    validity masks of a `probs` plane are built on its first chunk and
    reused while the same plane comes back."""
    if mesh is not None:
        raise NotImplementedError(
            "grid-axis sharding (mesh=) is not ported yet: K16, ROADMAP "
            "item 13")
    del axis
    del G  # one device holds every point
    disc = tm._cast(discount)
    built: dict = {}

    def place(x):
        return torch.from_numpy(np.asarray(x)).to(tm.device)

    def chunk_step(carry, probs, frozen, steps):
        if built.get("probs") is not probs:
            built.update(probs=probs,
                         step=make_grid_vi_chunk(tm, probs, disc))
        return built["step"](carry, frozen, steps)

    return chunk_step, place
