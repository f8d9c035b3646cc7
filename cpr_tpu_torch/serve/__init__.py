"""A continuously batched evaluation and policy service (port of
cpr_tpu/serve/).

Resident lanes on the card stay live for the life of the process; an
asyncio front-end multiplexes many concurrent client episodes onto them
by continuous batching: lanes are admitted (spliced from a fresh state)
and retired on any tick instead of padding work to rollout boundaries.

  engine.py    ResidentEngine: the (state, obs) lane carry, the
               interactive `step_lanes` tick (K3; K10 for a DAG env)
               and the K-step policy burst (K14; K14-dag for a DAG env;
               with the experience rings K15 inside).
  scheduler.py LaneScheduler: host-side sessions -> lanes placement and
               the admission queue.
  server.py    the asyncio front-end: the length-prefixed JSON protocol,
               the policy / netsim / MDP endpoints, admission control,
               telemetry, supervisor heartbeats, SIGTERM drain.
  protocol.py  the frame codec and a blocking client.

The multi-replica router (`router.py`) is ROADMAP item 12's rest.
"""

from cpr_tpu_torch.serve.engine import ResidentEngine  # noqa: F401
from cpr_tpu_torch.serve.protocol import ServeClient  # noqa: F401
from cpr_tpu_torch.serve.scheduler import LaneScheduler  # noqa: F401
