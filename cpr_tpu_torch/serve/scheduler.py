"""Host-side continuous-batching scheduler: sessions -> lanes.

Port of cpr_tpu/serve/scheduler.py, host only: the same code with its imports
from cpr_tpu_torch.

Deliberately jax-free and asyncio-free (plain data structures, unit
testable in microseconds): the server's tick loop asks `place()` for
this tick's admissions, the engine does the device-side splice, and
`retire()` frees a lane the moment its session completes — the next
`place()` backfills it from the admission queue.  Lane state never
survives a retire->admit cycle on the device side either: admission
splices a wholly fresh `init_lanes` state over the slot (the
reclaimed-slot aliasing class of bug is structurally excluded, and
tests/test_serve.py proves it bit-for-bit).

Admission control (fleet PR): the queue is priority-ordered (lower
class number places first; FIFO within a class), optionally bounded
(`max_queued` — `enqueue` raises `QueueFull` instead of growing
without limit), and optionally tenant-quota'd (`tenant_quota` — a
tenant already holding that many lanes is skipped by `place()` without
blocking other tenants behind it).  The shedding *policy* — what to
refuse and what `retry_after` to quote — lives in the server; this
module only supplies the mechanisms and the accounting.
"""

from __future__ import annotations

# interval source shared with the rest of the runtime (perf_counter —
# monotonic, so queue ages can never go backwards); telemetry is
# jax-free at import, preserving this module's import weight
from cpr_tpu_torch.telemetry import now


class QueueFull(Exception):
    """`enqueue` on a bounded queue already holding `max_queued`
    sessions.  The server turns this into an in-band shed refusal."""


class _Entry:
    __slots__ = ("session", "priority", "tenant", "t")

    def __init__(self, session, priority: int, tenant, t: float):
        self.session = session
        self.priority = priority
        self.tenant = tenant
        self.t = t


class LaneScheduler:
    """Tracks which session owns which lane plus the priority-ordered
    admission queue.  Sessions are opaque objects; identity is `is`."""

    def __init__(self, n_lanes: int, *, max_queued: int | None = None,
                 tenant_quota: int | None = None):
        if n_lanes <= 0:
            raise ValueError(f"n_lanes must be positive, got {n_lanes}")
        self.n_lanes = n_lanes
        self.max_queued = max_queued
        self.tenant_quota = tenant_quota
        self._owner: list = [None] * n_lanes
        # tenant tag per owned lane, parallel to _owner — the quota is
        # over *lanes held*, so it survives the session object itself
        self._owner_tenant: list = [None] * n_lanes
        # placement-ordered: sorted by (priority, enqueue order); the
        # queue is bounded so O(n) scans stay trivially cheap
        self._queue: list[_Entry] = []

    # -- admission queue --------------------------------------------------

    def enqueue(self, session, priority: int = 1, tenant=None) -> int:
        """Queue a session for admission; returns its queue position
        (0 = next to be placed).  Lower `priority` places first; ties
        keep FIFO order.  Raises `QueueFull` on a bounded queue at
        capacity — the caller sheds in-band instead of queueing."""
        if self.max_queued is not None and len(self._queue) >= self.max_queued:
            raise QueueFull(f"admission queue at capacity "
                            f"({self.max_queued})")
        pos = len(self._queue)
        while pos > 0 and self._queue[pos - 1].priority > priority:
            pos -= 1
        self._queue.insert(pos, _Entry(session, priority, tenant, now()))
        return pos

    def cancel(self, session) -> bool:
        """Drop a not-yet-placed session from the queue."""
        for i, e in enumerate(self._queue):
            if e.session is session:
                del self._queue[i]
                return True
        return False

    def place(self) -> list:
        """Assign queued sessions to free lanes (priority-FIFO x
        ascending lane id); returns [(lane, session), ...] for this
        tick's admissions.  A session whose tenant is at quota is
        skipped (it stays queued, aging normally) without blocking
        lower-priority sessions of other tenants."""
        placed = []
        free = [i for i in range(self.n_lanes) if self._owner[i] is None]
        if not free or not self._queue:
            return placed
        free.reverse()  # pop() yields ascending lane ids
        held: dict = {}
        for t in self._owner_tenant:
            if t is not None:
                held[t] = held.get(t, 0) + 1
        remaining = []
        for e in self._queue:
            if not free:
                remaining.append(e)
                continue
            if (self.tenant_quota is not None and e.tenant is not None
                    and held.get(e.tenant, 0) >= self.tenant_quota):
                remaining.append(e)
                continue
            lane = free.pop()
            self._owner[lane] = e.session
            self._owner_tenant[lane] = e.tenant
            if e.tenant is not None:
                held[e.tenant] = held.get(e.tenant, 0) + 1
            placed.append((lane, e.session))
        self._queue = remaining
        return placed

    # -- lane table -------------------------------------------------------

    def owner(self, lane: int):
        return self._owner[lane]

    def retire(self, lane: int):
        """Free a lane; returns the session that owned it."""
        session, self._owner[lane] = self._owner[lane], None
        self._owner_tenant[lane] = None
        return session

    def assigned(self) -> dict:
        """{lane: session} over currently owned lanes."""
        return {i: s for i, s in enumerate(self._owner) if s is not None}

    def drain(self) -> list:
        """Evict everything: returns every queued + placed session (in
        that order) and leaves the scheduler empty."""
        evicted = [e.session for e in self._queue]
        evicted += [s for s in self._owner if s is not None]
        self._queue.clear()
        self._owner = [None] * self.n_lanes
        self._owner_tenant = [None] * self.n_lanes
        return evicted

    # -- stats ------------------------------------------------------------

    def n_queued(self) -> int:
        return len(self._queue)

    def oldest_queued_s(self) -> float:
        """Age (seconds) of the oldest not-yet-placed session, 0.0 on
        an empty queue — growth here is the first sign admissions are
        falling behind (surfaced in the heartbeat and stats).  Oldest
        by *enqueue time*, not queue position: priority insertion can
        park a low-priority session behind later arrivals."""
        if not self._queue:
            return 0.0
        return now() - min(e.t for e in self._queue)

    def tenant_load(self, tenant) -> int:
        """Lanes held + queue slots occupied by `tenant` — the number
        the server's quota shed decision compares against."""
        if tenant is None:
            return 0
        held = sum(t == tenant for t in self._owner_tenant)
        return held + sum(e.tenant == tenant for e in self._queue)

    def n_assigned(self) -> int:
        return sum(s is not None for s in self._owner)

    def occupancy(self) -> float:
        return self.n_assigned() / self.n_lanes
