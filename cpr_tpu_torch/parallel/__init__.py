"""Parallel solvers of the port.

Reference counterpart: `cpr_tpu/parallel/`. Ported: the single-device
part of the grid chunk step (`make_grid_chunk_step`, `mesh=None`).
Mesh-sharded lanes and solves (K16) are queued in ROADMAP item 13.
"""

from cpr_tpu_torch.parallel.grid import make_grid_chunk_step

__all__ = ["make_grid_chunk_step"]
