"""asyncio front-end of the serving layer.

Port of cpr_tpu/serve/server.py: the same server over the port's
ResidentEngine (K3 ticks and K14 bursts on the card) and its own query
modules: `netsim.query` on K12 (every netsim protocol), `mdp.solve_grid`
and the exact `break_even.*` on K7/K4, `netsim.attack_sweep` on K13.
The Monte-Carlo `break_even.*` queries (ROADMAP item 9) and `--devices
> 1` (item 13) are not ported: the former reply with the module's error,
the latter exits. The wire is byte for byte the reference's, so either
package's client talks to either package's server. Query endpoints run
on the engine's device.

The tick loop is the only writer of device state: each iteration it
(1) backfills freed lanes from the admission queue (one `splice`
dispatch seeds all of this tick's admissions), (2) advances every
interactive lane with a pending client action (one `step_lanes`
dispatch), (3) advances every policy-driven lane by one K-step burst
(one dispatch), completing sessions at their first `done` and retiring
their lanes.  Connection handlers never touch the device — they
enqueue sessions / pending actions and await futures the tick loop
resolves, so continuous batching falls out of plain asyncio ordering.

Endpoints beyond the episode surface (netsim honest-net queries and
break-even lookups) run on a single-worker executor thread, keeping the
tick loop responsive; netsim Engines are cached per query shape.

Operability: every decision emits a typed v7 `serve` telemetry event;
the child heartbeats to the supervisor (progress = emitted events, so
an idle-but-alive server never trips the watchdog); SIGTERM lands in
`resilience.preemption_guard` and the loop drains gracefully — evict
queued and in-flight sessions with a `draining` reply, emit the
throughput `report` event (ingested by the perf ledger) and the
device-metrics summary, close, exit 0.

Always-on learning (v17, docs/LEARNING.md): with `--learner
host:port` the engine records sampler-lane experience in device rings
and the tick loop ships drained batches to the learner through an
`ExperienceFeeder` (drop-oldest — a slow learner costs samples, never
serve latency).  With `--learn-watch dir` the heartbeat block polls
the learner's `latest.json` pointer and hot-swaps the `ppo` policy's
params at the next burst boundary (`engine.swap_policy`) — zero
drain, in-flight sessions unperturbed; a snapshot that
fails integrity or protocol validation is refused with a typed event
and the server keeps serving the previous params.  Heartbeats, stats
and the drain report carry `policy_fingerprint` +
`snapshot_staleness_s`, and `--staleness-slo-s` arms the
snapshot-staleness burn-rate alert next to the latency SLOs.

Run: `python -m cpr_tpu_torch.serve.server --protocol nakamoto ...`
(chip_smoke.py's wire and learning-loop phases run it as a child, with
`python -m cpr_tpu_torch.learn.learner` beside it).
"""

from __future__ import annotations

import asyncio
import itertools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from cpr_tpu_torch import resilience, telemetry
from cpr_tpu_torch.latency import LatencyBoard
from cpr_tpu_torch.monitor import alerts as slo_alerts
from cpr_tpu_torch.monitor.blackbox import dump_blackbox
from cpr_tpu_torch.monitor.expo import MetricsServer
from cpr_tpu_torch.monitor.registry import MetricsRegistry
from cpr_tpu_torch.serve import protocol as wire
from cpr_tpu_torch.serve.engine import ResidentEngine
from cpr_tpu_torch.serve.scheduler import LaneScheduler, QueueFull

# priority classes on the wire: requests say `priority="batch"` (or
# the class number); lower number places first.  Interactive sessions
# default to the front, batch traffic is shed first under SLO breach.
PRIORITY_CLASSES = {"interactive": 0, "normal": 1, "batch": 2}
_CLASS_NAMES = {v: k for k, v in PRIORITY_CLASSES.items()}
# SLO budget multiplier per priority class: the shed threshold is
# slo_s * scale, so batch traffic sheds at half the SLO while
# interactive traffic rides out twice the SLO before refusal
_SLO_SCALE = {0: 2.0, 1: 1.0, 2: 0.5}


def _priority_of(req: dict, default: int = 1) -> tuple:
    """(priority int, class name) from a request's `priority` field —
    a class name or an int (clamped into the known classes)."""
    raw = req.get("priority", default)
    if isinstance(raw, str):
        if raw not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority {raw!r}; one of "
                f"{sorted(PRIORITY_CLASSES)} or 0..{len(_SLO_SCALE) - 1}")
        p = PRIORITY_CLASSES[raw]
    else:
        p = min(max(int(raw), 0), len(_SLO_SCALE) - 1)
    return p, _CLASS_NAMES[p]


def _serve_event(action: str, session=None, **detail):
    """The one `serve` event call site (EVENT_FIELDS['serve'])."""
    telemetry.current().event("serve", action=action, session=session,
                              detail=detail)


def _admission_event(reason, op, priority, tenant, retry_after_s):
    """The one `admission` event call site (EVENT_FIELDS['admission']):
    fires per shed refusal only — admitted sessions stay on the v7
    serve admit trail."""
    telemetry.current().event(
        "admission", reason=reason, op=op, priority=priority,
        tenant=tenant, retry_after_s=retry_after_s)


def _request_event(trace_id, op, status, queue_wait_s, service_s,
                   total_s, session, lane, splice_s):
    """The one server-side `request` event call site
    (EVENT_FIELDS['request']); the client-side twin lives in
    protocol.ServeClient.  `role`/`run` correlate streams in
    tools/trace_stitch.py."""
    telemetry.current().event(
        "request", trace_id=trace_id, op=op, status=status,
        queue_wait_s=queue_wait_s, service_s=service_s, total_s=total_s,
        role="server", run=telemetry.run_id(), session=session,
        lane=lane, splice_s=splice_s)


def _op_family(op) -> str:
    """Latency-board family for one op (break_even.* variants share
    one histogram; everything else is its own family)."""
    op = str(op)
    return "break_even" if op.startswith("break_even.") else op


class _Session:
    __slots__ = ("sid", "kind", "seed", "policy", "policy_id", "lane",
                 "future", "done", "t_enqueue", "t_admit",
                 "t_first_burst", "t_complete", "splice_s",
                 "priority", "cls", "tenant")

    def __init__(self, sid, kind, seed, policy, policy_id, future,
                 priority=1, cls="normal", tenant=None):
        self.sid = sid
        self.kind = kind
        self.seed = seed
        self.policy = policy
        self.policy_id = policy_id
        self.lane = None
        self.future = future
        self.done = False
        self.priority = priority
        self.cls = cls
        self.tenant = tenant
        # request-scoped trace stamps (telemetry.now() clock): queued,
        # admitted (lane spliced), first policy burst dispatched,
        # session completed — the reply's latency breakdown
        self.t_enqueue = telemetry.now()
        self.t_admit = None
        self.t_first_burst = None
        self.t_complete = None
        self.splice_s = None


class ServeServer:
    """One engine + scheduler + TCP front-end."""

    def __init__(self, engine: ResidentEngine, *, host: str = "127.0.0.1",
                 port: int = 0, heartbeat_s: float = 1.0,
                 idle_sleep_s: float = 0.002, seed_base: int = 1 << 20,
                 slo_s: float | None = None,
                 max_queued: int | None = None,
                 tenant_quota: int | None = None,
                 replica_index: int | None = None,
                 metrics_port: int | None = None,
                 feeder=None, learn_watch: str | None = None,
                 staleness_slo_s: float | None = None,
                 protocol: str | None = None):
        self.engine = engine
        # serving protocol key (main() passes --protocol): swap
        # validation refuses snapshots trained for another protocol
        self.protocol = protocol
        # always-on learning plane: the feeder ships drained
        # experience to the learner; learn_watch is the snapshot
        # directory whose latest.json pointer the heartbeat polls
        self.feeder = feeder
        self.learn_watch = learn_watch
        self.staleness_slo_s = staleness_slo_s
        self._watch_seq = -1
        # staleness baseline before the first swap: process start
        # (telemetry.now() clock — never compared across processes)
        self._serve_t0 = telemetry.now()
        # bounded queue by default: 8x the lane count is ~8 bursts of
        # backlog, past which queueing only manufactures SLO misses —
        # shed instead.  Explicit <= 0 restores the unbounded queue.
        if max_queued is None:
            max_queued = 8 * engine.n_lanes
        elif max_queued <= 0:
            max_queued = None
        self.slo_s = slo_s
        self.replica_index = replica_index
        self.sched = LaneScheduler(engine.n_lanes, max_queued=max_queued,
                                   tenant_quota=tenant_quota)
        self._sheds = 0
        self._shed_reasons: dict[str, int] = {}
        self.host = host
        self.port = port  # replaced by the bound port after start()
        self.heartbeat_s = heartbeat_s
        self.idle_sleep_s = idle_sleep_s
        self._sid = itertools.count(1)
        # server-assigned seeds for seedless sessions, clear of the
        # small integers clients use for reproducible requests
        self._seed = itertools.count(seed_base)
        self._sessions: dict[int, _Session] = {}
        # lane -> (action, fut, session, t_requested)
        self._pending: dict[int, tuple] = {}
        self._executor = ThreadPoolExecutor(max_workers=1)
        # asyncio futures of executor ops still in flight — drained
        # before the loop exits so no client hangs on a dropped future
        self._inflight_exec: set = set()
        # per-op-family reply latency + per-entry-point device
        # dispatch walls (the `stats`/`heartbeat`/`report` SLO surface)
        self.latency = LatencyBoard()
        # v14 live health plane: the registry mirrors the counters the
        # event stream already carries (pull-based, scrapeable while
        # serving), with the latency board attached by reference as
        # the histogram family — no second observe path
        self.metrics = MetricsRegistry(
            namespace="cpr_serve",
            const_labels=({"replica": str(replica_index)}
                          if replica_index is not None else None))
        self.metrics.attach_board(
            "latency_seconds", self.latency,
            help="per-op-family reply latency (seconds)")
        # v15 live memory watermark: sampled once per heartbeat (one
        # allocator stats read — well under the <2% overhead budget),
        # surfaced as gauges in both scrape paths, in the heartbeat /
        # stats / drain reports, and emitted as the typed `memory`
        # event at drain (the ledger lifts it to serve_peak_bytes)
        self.mem = telemetry.MemoryWatermark("serve")
        # SLO burn-rate alerting: per-class latency budgets are the
        # SAME scaled budgets admission control sheds against, so an
        # alert and a shed always agree on what "over SLO" means
        self.alerts = slo_alerts.AlertEngine(
            slo_s,
            class_slo=({name: slo_s * _SLO_SCALE[p]
                        for name, p in PRIORITY_CLASSES.items()}
                       if slo_s is not None else None),
            staleness_slo_s=staleness_slo_s)
        self.metrics_port = metrics_port  # bound port after start()
        self.metrics_server: MetricsServer | None = None
        self._netsim_engines: dict[tuple, object] = {}
        # loaded nets servable as attack policies (main() mirrors the
        # engine's snapshot table here; the fingerprint — the snapshot
        # path — keys the attack-sweep disk cache, since callables
        # cannot be hashed)
        self.attack_policies: dict = {}
        self.attack_fingerprint: str = ""
        self._server = None
        self._loop_task = None
        self._draining = False
        self._drain_reason = None

    # -- lifecycle --------------------------------------------------------

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.metrics_port is not None:
            self.metrics_server = MetricsServer(
                self.metrics.render_prometheus, host=self.host,
                port=self.metrics_port)
            self.metrics_port = self.metrics_server.start()
        # prime the gauges so a scrape between bind and the first
        # heartbeat sees real samples, not a comment-only exposition
        self._refresh_gauges()
        _serve_event("start", port=self.port,
                     n_lanes=self.engine.n_lanes,
                     burst=self.engine.burst,
                     policies=list(self.engine.policy_names),
                     metrics_port=self.metrics_port)
        self._loop_task = asyncio.create_task(self._tick_loop())

    async def serve_until_drained(self):
        await self._loop_task

    def request_drain(self, reason: str):
        self._drain_reason = self._drain_reason or reason

    # -- the tick loop ----------------------------------------------------

    async def _tick_loop(self):
        hb_last = telemetry.now()
        while True:
            if resilience.preempt_requested():
                self.request_drain(
                    f"preempt:{resilience.preempt_reason()}")
            if self._drain_reason is not None:
                await self._drain(self._drain_reason)
                return
            progressed = self._tick_once()
            t = telemetry.now()
            if t - hb_last >= self.heartbeat_s:
                # periodic even when idle: emitted events are the
                # supervisor's progress signal, so an idle server
                # stays distinguishable from a wedged one
                hb_last = t
                if self.learn_watch is not None:
                    self._poll_snapshots()
                self.alerts.record_staleness(
                    self.snapshot_staleness_s())
                self._refresh_gauges()
                for a in self.alerts.evaluate():
                    slo_alerts.emit_alert(a)
                _serve_event(
                    "heartbeat",
                    queued=self.sched.n_queued(),
                    occupancy=self.sched.occupancy(),
                    steps=self.engine.steps,
                    episodes=self.engine.episodes,
                    # backlog age + in-flight op counts: growth here
                    # shows up before clients start timing out
                    oldest_queued_s=self.sched.oldest_queued_s(),
                    pending_steps=len(self._pending),
                    exec_ops=len(self._inflight_exec),
                    sheds=self._sheds,
                    policy_fingerprint=self.engine.policy_fingerprint(),
                    snapshot_staleness_s=self.snapshot_staleness_s(),
                    alerts=self.alerts.summary(),
                    memory=self.mem.snapshot())
            await asyncio.sleep(0.0 if progressed else self.idle_sleep_s)

    def _tick_once(self) -> bool:
        progressed = False
        # 1. admissions: backfill freed lanes from the queue. Interactive
        # sessions get their first observation from one splice dispatch
        # now; policy sessions are spliced by the burst below (inside its
        # launch on the card)
        placed = self.sched.place()
        admits = {}
        if placed:
            interactive = {lane: s.seed for lane, s in placed
                           if s.kind == "interactive"}
            t0 = telemetry.now()
            obs_rows = self.engine.splice(interactive) if interactive else {}
            t1 = telemetry.now()
            if interactive:
                self.latency.observe("device.splice", t1 - t0)
            for lane, s in placed:
                s.lane = lane
                s.t_admit = t1
                s.splice_s = t1 - t0 if lane in interactive else 0.0
                _serve_event("admit", s.sid, lane=lane, seed=s.seed,
                             kind=s.kind)
                if s.kind == "interactive" and not s.future.done():
                    s.future.set_result(obs_rows[lane])
                elif s.kind != "interactive":
                    admits[lane] = s.seed
            progressed = True
        # 2. interactive lanes with a pending client action
        if self._pending:
            pending, self._pending = self._pending, {}
            t0 = telemetry.now()
            out = self.engine.tick(
                {lane: a for lane, (a, _, _, _) in pending.items()})
            t1 = telemetry.now()
            self.latency.observe("device.tick", t1 - t0)
            for lane, (_, fut, s, t_req) in pending.items():
                row = out[lane]
                # the step's own breakdown: waited for this tick's
                # dispatch, then one shared device tick served it
                row["latency"] = dict(
                    queue_wait_s=max(0.0, t0 - t_req),
                    service_s=t1 - t0,
                    total_s=max(0.0, t1 - t_req))
                if row["done"]:
                    s.done = True
                    s.t_complete = t1
                    self._sessions.pop(s.sid, None)
                    self.sched.retire(lane)
                    _serve_event(
                        "complete", s.sid, kind="interactive",
                        n_steps=row["info"]["episode_n_steps"],
                        reward=row["info"]["episode_reward_attacker"])
                if not fut.done():
                    fut.set_result(row)
            progressed = True
        # 3. policy-driven lanes: one burst; complete each session at
        # its first done (the lane keeps streaming to the end of the
        # burst — executed steps count toward throughput either way —
        # then retires and is backfilled next tick)
        policy_lanes = {lane: s
                        for lane, s in self.sched.assigned().items()
                        if s.kind == "policy"}
        if policy_lanes:
            # v15: the burst dispatch is a SPAN, not just a latency
            # observation — span paths are what tools/trace_diff.py
            # aligns two runs by, so the serving layer's device work
            # (and the replica chaos seam below, whose injected
            # `slow@replica` sleep lands inside this scope) is
            # attributable to a named path
            with telemetry.current().span(
                    "serve_burst",
                    env_steps=len(policy_lanes) * self.engine.burst):
                t0 = telemetry.now()
                for s in policy_lanes.values():
                    if s.t_first_burst is None:
                        s.t_first_burst = t0
                out = self.engine.burst_run(
                    {lane: s.policy_id
                     for lane, s in policy_lanes.items()},
                    occupancy=self.sched.occupancy(), admit=admits)
                t1 = telemetry.now()
                self.latency.observe("device.burst", t1 - t0)
                for lane, s in policy_lanes.items():
                    if not out["done"][lane]:
                        continue  # episode spans into the next burst
                    s.t_complete = t1
                    att = float(out["episode_reward_attacker"][lane])
                    dfn = float(out["episode_reward_defender"][lane])
                    episode = dict(
                        reward_attacker=att, reward_defender=dfn,
                        progress=float(out["episode_progress"][lane]),
                        n_steps=int(out["episode_n_steps"][lane]),
                        relative_reward=(att / (att + dfn)
                                         if (att + dfn) else 0.0))
                    if not s.future.done():
                        # the fingerprint that served this episode's
                        # final burst: the revenue-vs-snapshot
                        # windowing key of tools/learn_smoke.py (None
                        # without swap policies)
                        s.future.set_result(dict(
                            ok=True, session=s.sid, seed=s.seed,
                            policy=s.policy, episode=episode,
                            policy_fingerprint=(
                                self.engine.policy_fingerprint())))
                    self.sched.retire(lane)
                    _serve_event(
                        "complete", s.sid, kind="policy",
                        n_steps=episode["n_steps"],
                        relative_reward=episode["relative_reward"])
                # chaos seam for the fleet smoke: a replica-tagged
                # server checks the injector after each completed
                # burst, so CPR_FAULT_INJECT="kill@replica=<i>"
                # deterministically kills exactly replica i at its
                # first burst under load (hang@replica wedges its tick
                # loop for the supervisor's quiet watchdog;
                # slow@replica sleeps INSIDE the serve_burst span —
                # the deterministic stand-in for a perf regression
                # that tools/obs_smoke.py asserts trace_diff blames)
                if self.replica_index is not None:
                    resilience.fault_point("replica",
                                           self.replica_index)
            # experience plane: one drain per burst boundary (the ring
            # capacity equals the burst, so full windows are ready
            # exactly now); submit never blocks — drop-oldest beyond
            # the feeder's small queue
            if self.feeder is not None:
                batch = self.engine.drain_experience()
                if batch is not None:
                    self.feeder.submit(batch)
            progressed = True
        return progressed

    # -- the learning plane -----------------------------------------------

    def snapshot_staleness_s(self):
        """Seconds since the serving policy last swapped (process
        start stands in before the first swap), or None when no
        swappable policy is registered.  Process-relative
        telemetry.now() stamps only — never compared across
        processes."""
        if not self.engine.swap_names:
            return None
        t0 = self.engine.last_swap_t
        return telemetry.now() - (t0 if t0 is not None
                                  else self._serve_t0)

    def _poll_snapshots(self):
        """One watch-loop poll: if the learner's latest.json moved
        past the last seq this server acted on, try the swap.  Every
        failure mode — unreadable pointer, missing snapshot, integrity
        refusal, protocol mismatch — leaves the previous params
        serving; zero-drain means the learning plane may fall behind
        but can never take the data plane down."""
        import json

        path = os.path.join(self.learn_watch, "latest.json")
        try:
            with open(path, "rb") as f:
                latest = json.load(f)
            seq = int(latest["seq"])
        except (OSError, ValueError, KeyError, TypeError):
            return  # not published yet / torn read: next poll retries
        if seq <= self._watch_seq:
            return
        self._watch_seq = seq
        self._swap_from_path(latest.get("path"), seq=seq)

    def _swap_from_path(self, path, seq=None) -> dict:
        """Load + validate + hot-swap one snapshot; shared by the
        watch poll and the in-band `policy.publish` op.  Returns the
        reply block (ok/swapped/fingerprint or the refusal)."""
        from cpr_tpu_torch.integrity import IntegrityError, integrity_event
        from cpr_tpu_torch.train.driver import load_policy_network

        name = self.engine.swap_names[0] if self.engine.swap_names \
            else None
        if name is None:
            return dict(ok=False, error="no swappable policy "
                                        "(start with --policy-snapshot)")
        staleness = self.snapshot_staleness_s()
        try:
            net, _, meta = load_policy_network(str(path),
                                               device=self.engine.device)
            # the snapshot must rebuild the net this engine serves:
            # protocol and dims are checked here against the serving
            # env; hidden-layer mismatches surface as the param-tree
            # structure refusal inside swap_policy
            env = self.engine.env
            if ((self.protocol is not None
                 and meta.get("protocol") not in (None, self.protocol))
                    or int(meta.get("n_actions", env.n_actions))
                    != int(env.n_actions)
                    or int(meta.get("observation_length",
                                    env.observation_length))
                    != int(env.observation_length)):
                integrity_event(
                    artifact=str(path), kind="policy_snapshot",
                    reason="version", action="refused",
                    expected=dict(protocol=self.protocol,
                                  n_actions=int(env.n_actions)),
                    found=dict(protocol=meta.get("protocol"),
                               n_actions=meta.get("n_actions")))
                return dict(ok=False, error="snapshot/env mismatch",
                            refused=True)
            out = self.engine.swap_policy(
                name, net, fingerprint=meta.get("payload_sha256"))
        except IntegrityError as e:
            # the typed event already fired inside the loader/engine
            return dict(ok=False, error=str(e), refused=True)
        if out.get("swapped"):
            from cpr_tpu_torch.learn import learn_event

            learn_event("swap", steps=None, batches=None,
                        fingerprint=out["fingerprint"],
                        staleness_s=staleness, seq=seq,
                        policy=name, swaps=self.engine.swaps)
            if self.feeder is not None:
                self.feeder.fingerprint = out["fingerprint"]
        return dict(ok=True, **out)

    def _refresh_gauges(self):
        """Refresh the registry's gauge families from live scheduler /
        engine state — the same readings the heartbeat event carries,
        pull-scrapeable between heartbeats."""
        g = self.metrics.set
        # one allocator read per refresh keeps the watermark live in
        # both scrape paths without a second sampling thread
        self.mem.sample()
        if self.mem.peak_bytes is not None:
            g("memory_peak_bytes", self.mem.peak_bytes,
              help="peak device/process memory over the serve run "
                   "(bytes; max across devices)")
        if self.mem.in_use_bytes is not None:
            g("memory_in_use_bytes", self.mem.in_use_bytes,
              help="device/process memory in use at last sample "
                   "(bytes)")
        if self.mem.headroom_bytes is not None:
            g("memory_headroom_bytes", self.mem.headroom_bytes,
              help="allocator limit minus peak (bytes) — remaining "
                   "capacity before the allocator refuses")
        g("queued", self.sched.n_queued(),
          help="admission queue depth")
        g("occupancy", self.sched.occupancy(),
          help="fraction of lanes assigned")
        g("oldest_queued_s", self.sched.oldest_queued_s(),
          help="age of the oldest queued session (seconds)")
        g("pending_steps", len(self._pending),
          help="interactive steps awaiting the next device tick")
        g("exec_ops", len(self._inflight_exec),
          help="executor-thread query ops in flight")
        g("steps", self.engine.steps,
          help="device steps executed since start")
        g("episodes", self.engine.episodes,
          help="episodes completed since start")
        g("sheds", self._sheds,
          help="admission refusals since start")
        staleness = self.snapshot_staleness_s()
        if staleness is not None:
            g("snapshot_staleness_s", staleness,
              help="age of the serving policy snapshot (seconds "
                   "since the last hot-swap; process start before "
                   "the first)")

    def _session_latency(self, s: _Session) -> dict:
        """One completed (or refused) session's reply breakdown.
        Monotonic stamps, clamped at 0 anyway so a reply can never
        carry a negative latency."""
        t_end = s.t_complete if s.t_complete is not None \
            else telemetry.now()
        t_admit = s.t_admit if s.t_admit is not None else t_end
        return dict(
            queue_wait_s=max(0.0, t_admit - s.t_enqueue),
            service_s=max(0.0, t_end - t_admit),
            total_s=max(0.0, t_end - s.t_enqueue))

    async def _drain(self, reason: str):
        self._draining = True
        _serve_event("drain", reason=reason)
        refusal = dict(ok=False, error="draining", draining=True)
        for s in self.sched.drain():
            if not s.future.done():
                s.future.set_result(dict(refusal, session=s.sid))
        for _, fut, _s, _t in self._pending.values():
            if not fut.done():
                fut.set_result(dict(refusal))
        self._pending.clear()
        self._sessions.clear()
        # executor: cancel queued work (each cancelled future resolves
        # to a draining refusal inside _blocking, so no client ever
        # hangs on a dropped future), then wait out the op that is
        # already running on the worker thread — it gets a real reply
        self._executor.shutdown(wait=False, cancel_futures=True)
        if self._inflight_exec:
            await asyncio.wait(list(self._inflight_exec), timeout=60.0)
            # one short turn so the handlers awaiting those futures
            # write their replies before the loop winds down
            await asyncio.sleep(0.05)
        report = dict(self.engine.report(),
                      latency=self.latency.snapshot())
        # headline SLO: the policy-episode endpoint's total-latency
        # quantiles, lifted into the perf ledger as serve_p50_s /
        # serve_p99_s rows (perf/ledger.py _SERVE_METRICS)
        run_lat = report["latency"].get("episode.run") or {}
        report["p50_s"] = run_lat.get("p50_s")
        report["p99_s"] = run_lat.get("p99_s")
        # per-priority-class tails + the shed accounting: the ledger
        # lifts class_p99_s into cfg_class-tagged serve_p99_s rows and
        # shed_rate into a lower-is-better serve_shed_rate row
        report["class_p99_s"] = {
            fam.split(":", 1)[1]: report["latency"][fam].get("p99_s")
            for fam in report["latency"]
            if fam.startswith("episode.run:")}
        report["sheds"] = self._sheds
        report["shed_reasons"] = dict(self._shed_reasons)
        denom = self._sheds + self.engine.admitted
        report["shed_rate"] = self._sheds / denom if denom else 0.0
        # one last alert evaluation before the report: breaches that
        # built up between heartbeats still emit their typed events,
        # and the report carries the final alert surface
        for a in self.alerts.evaluate():
            slo_alerts.emit_alert(a)
        report["alerts"] = self.alerts.summary()
        # final watermark sample rides the report AND the typed
        # `memory` event — the report block is what survives when a
        # stream gets cut before the final event lands
        self.mem.sample()
        self.mem.emit()
        report["memory"] = self.mem.snapshot()
        # learning plane: fingerprint + staleness always ride the
        # report; the `learn` block (ledger rows
        # learn_samples_per_sec / learn_snapshot_staleness_s) only
        # when the experience plane is on
        report["policy_fingerprint"] = self.engine.policy_fingerprint()
        staleness = self.snapshot_staleness_s()
        report["snapshot_staleness_s"] = staleness
        if self.engine.experience:
            busy = self.engine.busy_s
            report["learn"] = dict(
                samples=self.engine.samples,
                samples_per_sec=(self.engine.samples / busy
                                 if busy > 0 else 0.0),
                snapshot_staleness_s=staleness,
                swaps=self.engine.swaps,
                feeder=(self.feeder.stats()
                        if self.feeder is not None else None))
        if self.feeder is not None:
            self.feeder.close()
        _serve_event("report", **report)
        self.engine.emit_metrics()
        _serve_event("stop", reason=reason, steps=report["steps"],
                     episodes=report["episodes"])
        self._server.close()
        await self._server.wait_closed()
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None

    # -- connections ------------------------------------------------------

    async def _handle(self, reader, writer):
        try:
            while True:
                req = await wire.read_frame(reader)
                if req is None:
                    break
                resp = await self._serve_request(req)
                await wire.write_frame(writer, resp)
        except (wire.ProtocolError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _serve_request(self, req: dict) -> dict:
        """Dispatch one request with its trace context: stamp receipt,
        propagate (or mint) the trace id, backfill a wall-clock latency
        breakdown on ops that carry none of their own, fold the total
        into the per-family latency board, emit the v8 `request`
        event, and echo `trace_id` + `latency` in the reply."""
        trace = req.get("_trace") if isinstance(req.get("_trace"),
                                                dict) else {}
        trace_id = trace.get("id") or telemetry.new_trace_id()
        t_recv = telemetry.now()
        try:
            resp = await self._dispatch(req)
        except Exception as e:  # noqa: BLE001 — per-request wall
            resp = dict(ok=False, error=f"{type(e).__name__}: {e}")
        if not isinstance(resp, dict):  # defensive: handlers return dicts
            resp = dict(ok=False, error="handler returned no dict")
        lat = resp.get("latency")
        if not (isinstance(lat, dict) and "total_s" in lat):
            # immediate ops (hello/stats/executor queries): no queue,
            # service is the whole wall
            wall = telemetry.now() - t_recv
            lat = dict(queue_wait_s=0.0, service_s=wall, total_s=wall)
            resp["latency"] = lat
        resp["trace_id"] = trace_id
        status = ("ok" if resp.get("ok")
                  else "refused" if resp.get("draining")
                  or resp.get("shed") else "error")
        op = req.get("op")
        cls = resp.pop("_class", None)
        self.latency.observe(_op_family(op), lat["total_s"])
        self.metrics.inc("requests_total", op=str(op), status=status,
                         help="requests served, by op and status")
        if cls is not None:
            # per-priority-class tail latency: the drain report lifts
            # these into per-class serve_p99_s ledger rows
            self.latency.observe(f"{_op_family(op)}:{cls}",
                                 lat["total_s"])
            # the burn-rate engine sees the same per-class totals the
            # board does, judged against the class SLO budgets
            self.alerts.record_latency(cls, lat["total_s"])
        _request_event(trace_id, op, status, lat["queue_wait_s"],
                       lat["service_s"], lat["total_s"],
                       resp.get("session"), resp.pop("_lane", None),
                       resp.pop("_splice_s", None))
        return resp

    async def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "hello":
            return dict(ok=True, schema=telemetry.SCHEMA_VERSION,
                        run=telemetry.run_id(),
                        n_lanes=self.engine.n_lanes,
                        burst=self.engine.burst,
                        policies=list(self.engine.policy_names),
                        policy_fingerprint=(
                            self.engine.policy_fingerprint()))
        if op == "stats":
            return dict(ok=True, report=self.engine.report(),
                        queued=self.sched.n_queued(),
                        assigned=self.sched.n_assigned(),
                        occupancy=self.sched.occupancy(),
                        oldest_queued_s=self.sched.oldest_queued_s(),
                        pending_steps=len(self._pending),
                        exec_ops=len(self._inflight_exec),
                        sheds=self._sheds,
                        shed_reasons=dict(self._shed_reasons),
                        # per-op-family histogram summaries; named
                        # `latencies` because the singular `latency`
                        # reply key is the per-request breakdown
                        latencies=self.latency.snapshot(),
                        # the raw mergeable wire form: the router
                        # bucket-sums these into the fleet board
                        latencies_raw=self.latency.to_dict(),
                        alerts=self.alerts.summary(),
                        memory=self.mem.snapshot(),
                        policy_fingerprint=(
                            self.engine.policy_fingerprint()),
                        snapshot_staleness_s=(
                            self.snapshot_staleness_s()),
                        feeder=(self.feeder.stats()
                                if self.feeder is not None else None))
        if op == "policy.publish":
            # in-band twin of the latest.json watch: swap to the named
            # snapshot at the next burst boundary, or refuse with the
            # typed integrity path — either way, keep serving
            return self._swap_from_path(req.get("path"))
        if op == "metrics.scrape":
            # the in-band twin of the --metrics-port HTTP endpoint:
            # the registry's structured form (histograms_raw inside is
            # the fleet-merge input) plus the live alert surface
            return dict(ok=True, metrics=self.metrics.to_json(),
                        alerts=self.alerts.summary(),
                        latencies_raw=self.latency.to_dict())
        if op == "drain":
            self.request_drain(str(req.get("reason", "client")))
            return dict(ok=True, draining=True)
        if op == "episode.run":
            return await self._op_episode_run(req)
        if op == "episode.open":
            return await self._op_episode_open(req)
        if op == "episode.step":
            return await self._op_episode_step(req)
        if op == "episode.close":
            return self._op_episode_close(req)
        if op == "netsim.query":
            out = await self._blocking(self._netsim_query, req)
            _serve_event("query", endpoint="netsim",
                         protocol=out.get("protocol"))
            return out
        if op in ("break_even.revenue", "break_even.alpha"):
            out = await self._blocking(self._break_even, req, op)
            _serve_event("query", endpoint=op,
                         protocol=req.get("protocol"))
            return out
        if op == "mdp.solve_grid":
            out = await self._blocking(self._mdp_solve_grid, req)
            _serve_event("query", endpoint="mdp.solve_grid",
                         protocol=req.get("protocol"))
            return out
        if op == "netsim.attack_sweep":
            out = await self._blocking(self._attack_sweep, req)
            _serve_event("query", endpoint="netsim.attack_sweep",
                         protocol=req.get("protocol"))
            return out
        return dict(ok=False, error=f"unknown op {op!r}")

    # -- admission control -------------------------------------------------

    def _retry_after_s(self) -> float:
        """Latency-aware backoff hint for a shed reply: the backlog's
        estimated drain time (queue depth x the episode.run p50 from
        the latency board, spread over the lanes), clamped to
        [0.1, 30] seconds.  Before any episode has completed, the SLO
        itself (or 1s) stands in for the per-episode estimate."""
        h = self.latency.get("episode.run")
        per = h.quantile(0.5) if h is not None and h.count else None
        if per is None:
            per = self.slo_s if self.slo_s is not None else 1.0
        est = (self.sched.n_queued() + 1) * per / max(1, self.engine.n_lanes)
        return round(min(30.0, max(0.1, est)), 3)

    def _shed(self, reason: str, op: str, cls: str, tenant) -> dict:
        """One shed decision: count it, emit the typed v9 `admission`
        event, and build the in-band refusal (the connection stays up;
        `retry_after` tells the client when to come back)."""
        retry_after = self._retry_after_s()
        self._sheds += 1
        self._shed_reasons[reason] = self._shed_reasons.get(reason, 0) + 1
        self.engine.record_shed()
        self.alerts.record_admission(True)
        self.metrics.inc("sheds_total", reason=reason, op=str(op),
                         cls=str(cls), tenant=str(tenant or ""),
                         help="admission refusals, by reason")
        _admission_event(reason, op, cls, tenant, retry_after)
        return dict(ok=False, error=f"shed: {reason}", shed=True,
                    reason=reason, retry_after=retry_after)

    def _admission_check(self, op: str, priority: int, cls: str,
                         tenant) -> dict | None:
        """Shed refusal for a new session, or None to admit.  Checked
        before the session exists: a shed request never consumes a
        sid/seed, so the seed sequence of admitted traffic is
        unperturbed by load."""
        if (self.sched.max_queued is not None
                and self.sched.n_queued() >= self.sched.max_queued):
            return self._shed("queue_full", op, cls, tenant)
        if (self.sched.tenant_quota is not None and tenant is not None
                and self.sched.tenant_load(tenant)
                >= self.sched.tenant_quota):
            return self._shed("tenant_quota", op, cls, tenant)
        if self.slo_s is not None:
            budget = self.slo_s * _SLO_SCALE[priority]
            if self.sched.oldest_queued_s() > budget:
                return self._shed("slo_breach", op, cls, tenant)
        return None

    def _new_session(self, kind: str, req: dict, priority: int = 1,
                     cls: str = "normal") -> _Session:
        if self._draining or self._drain_reason is not None:
            raise RuntimeError("draining")
        policy = req.get("policy", "honest")
        if kind == "policy" and policy not in self.engine.policy_ids:
            raise ValueError(
                f"unknown policy {policy!r}; serving "
                f"{list(self.engine.policy_names)}")
        seed = int(req["seed"]) if "seed" in req and req["seed"] is not None \
            else next(self._seed)
        tenant = req.get("tenant")
        return _Session(next(self._sid), kind, seed, policy,
                        self.engine.policy_ids.get(policy),
                        asyncio.get_running_loop().create_future(),
                        priority=priority, cls=cls,
                        tenant=str(tenant) if tenant is not None else None)

    async def _op_episode_run(self, req):
        prio, cls = _priority_of(req, default=1)
        tenant = req.get("tenant")
        tenant = str(tenant) if tenant is not None else None
        refusal = self._admission_check("episode.run", prio, cls, tenant)
        if refusal is not None:
            return refusal
        s = self._new_session("policy", req, prio, cls)
        try:
            self.sched.enqueue(s, priority=prio, tenant=s.tenant)
        except QueueFull:
            return self._shed("queue_full", "episode.run", cls, s.tenant)
        self.alerts.record_admission(False)
        self.metrics.inc("admitted_total", cls=cls,
                         help="sessions admitted, by priority class")
        resp = await s.future
        lat = self._session_latency(s)
        if s.t_complete is not None:
            # the reply can leave late: between the burst stamping
            # t_complete and this coroutine resuming, the tick loop
            # may stall (GC, a wedged device, an injected
            # slow@replica) — wall the client is actually waiting, so
            # it belongs in the latency the board/drain report gate on
            stall = max(0.0, telemetry.now() - s.t_complete)
            lat["service_s"] += stall
            lat["total_s"] += stall
        return dict(resp, latency=lat,
                    _lane=s.lane, _splice_s=s.splice_s, _class=s.cls)

    async def _op_episode_open(self, req):
        prio, cls = _priority_of(req, default=PRIORITY_CLASSES["interactive"])
        tenant = req.get("tenant")
        tenant = str(tenant) if tenant is not None else None
        refusal = self._admission_check("episode.open", prio, cls, tenant)
        if refusal is not None:
            return refusal
        s = self._new_session("interactive", req, prio, cls)
        try:
            self.sched.enqueue(s, priority=prio, tenant=s.tenant)
        except QueueFull:
            return self._shed("queue_full", "episode.open", cls, s.tenant)
        self.alerts.record_admission(False)
        self.metrics.inc("admitted_total", cls=cls,
                         help="sessions admitted, by priority class")
        obs = await s.future
        if isinstance(obs, dict):  # drained before admission
            return dict(obs, latency=self._session_latency(s))
        self._sessions[s.sid] = s
        return dict(ok=True, session=s.sid, seed=s.seed,
                    obs=np.asarray(obs, np.float64).tolist(),
                    latency=self._session_latency(s),
                    _lane=s.lane, _splice_s=s.splice_s)

    async def _op_episode_step(self, req):
        s = self._sessions.get(req.get("session"))
        if s is None or s.lane is None or s.done:
            return dict(ok=False, error="no such open session")
        if s.lane in self._pending:
            return dict(ok=False, error="step already in flight")
        fut = asyncio.get_running_loop().create_future()
        self._pending[s.lane] = (int(req["action"]), fut, s,
                                 telemetry.now())
        row = await fut
        if "ok" in row:  # drained refusal
            return row
        return dict(ok=True, session=s.sid,
                    obs=np.asarray(row["obs"], np.float64).tolist(),
                    reward=row["reward"], done=row["done"],
                    info=row["info"], latency=row["latency"],
                    _lane=s.lane)

    def _op_episode_close(self, req):
        s = self._sessions.pop(req.get("session"), None)
        if s is not None and s.lane is not None and not s.done \
                and self.sched.owner(s.lane) is s:
            self.sched.retire(s.lane)
            _serve_event("complete", s.sid, kind="interactive",
                         closed=True)
        return dict(ok=True)

    async def _blocking(self, fn, *args):
        if self._draining or self._drain_reason is not None:
            return dict(ok=False, error="draining", draining=True)
        fut = asyncio.get_running_loop().run_in_executor(
            self._executor, fn, *args)
        self._inflight_exec.add(fut)
        try:
            return await fut
        except asyncio.CancelledError:
            # the drain's shutdown(cancel_futures=True) cancelled this
            # queued work item: the client gets a refusal, never a
            # silently dropped future.  A cancellation from anywhere
            # else (e.g. the connection handler) still propagates.
            if self._draining or self._drain_reason is not None:
                return dict(ok=False, error="draining", draining=True)
            raise
        finally:
            self._inflight_exec.discard(fut)

    # -- query endpoints (executor thread) --------------------------------

    def _netsim_query(self, req: dict) -> dict:
        from cpr_tpu_torch import netsim
        from cpr_tpu_torch.network import symmetric_clique

        proto = req.get("protocol", "nakamoto")
        k = int(req.get("k", 1))
        scheme = req.get("scheme", "constant")
        if not netsim.supports(proto, k, scheme):
            raise ValueError(
                f"netsim does not support ({proto}, k={k}, {scheme}); "
                f"supported protocols: {netsim.SUPPORTED_PROTOCOLS}")
        n_nodes = int(req.get("n_nodes", 10))
        act_delay = float(req.get("activation_delay", 1.0))
        prop_delay = float(req.get("propagation_delay", 1.0))
        n_act = int(req.get("activations", 1000))
        seed = int(req.get("seed", 0))
        ckey = (proto, k, scheme, n_nodes, act_delay, prop_delay, n_act)
        eng = self._netsim_engines.get(ckey)
        if eng is None:
            # one Engine per query shape (its planes and sizing)
            net = symmetric_clique(n_nodes, activation_delay=act_delay,
                                   propagation_delay=prop_delay)
            eng = netsim.Engine(net, protocol=proto, k=k, scheme=scheme,
                                activations=n_act,
                                device=self.engine.device)
            self._netsim_engines[ckey] = eng
        out = eng.run([seed], [act_delay])
        progress = float(out["progress"][0])
        return dict(
            ok=True, protocol=proto, seed=seed,
            rewards=[float(r) for r in out["reward"][0]],
            activations=[int(a) for a in out["node_act"][0]],
            progress=progress,
            orphan_rate=max(0.0, 1.0 - progress / n_act),
            sim_time=float(out["sim_time"][0]),
            head_height=int(out["head_height"][0]),
            n_blocks=int(out["n_blocks"][0]),
            on_chain=float(out["on_chain"][0]))

    def _break_even(self, req: dict, op: str) -> dict:
        # the package re-exports the function under the module's name,
        # so pull the callables straight from the submodule
        from cpr_tpu_torch.experiments.break_even import break_even, revenue

        if req.get("mode") == "exact":
            return self._break_even_exact(req, op)
        proto = req["protocol"]
        policy = req["policy"]
        gamma = float(req["gamma"])
        episode_len = int(req.get("episode_len", 256))
        reps = int(req.get("reps", 512))
        if op == "break_even.revenue":
            value = revenue(
                proto, policy, alpha=float(req["alpha"]), gamma=gamma,
                episode_len=episode_len, reps=reps,
                seed=int(req.get("seed", 0)))
            return dict(ok=True, protocol=proto, policy=policy,
                        revenue=value)
        value = break_even(
            proto, policy, gamma=gamma,
            support=tuple(req.get("support", (0.1, 0.5))),
            tol=float(req.get("tol", 0.005)),
            episode_len=episode_len, reps=reps,
            seed=int(req.get("seed", 0)))
        return dict(ok=True, protocol=proto, policy=policy, alpha=value)

    def _break_even_exact(self, req: dict, op: str) -> dict:
        """`mode: "exact"` break-even queries ride solve_grid_cached
        (`mdp.grid`, kernel K7): the optimal-attack revenue curve /
        break-even alpha from one fingerprint-cached exact grid solve — a
        repeat query for the same protocol/cutoff/grid is a disk-cache
        hit, surfaced by the `cached` flag in the reply (no `policy`
        field: the exact path optimizes over all policies)."""
        from cpr_tpu_torch.experiments.break_even import (break_even_exact,
                                                    exact_revenue_curve)

        proto = req["protocol"]
        gamma = float(req["gamma"])
        cutoff = int(req.get("cutoff", 8))
        kw = dict(gamma=gamma, cutoff=cutoff,
                  horizon=int(req.get("horizon", 100)),
                  stop_delta=float(req.get("stop_delta", 1e-6)),
                  native=bool(req.get("native", False)),
                  k=int(req.get("k", 2)), full=True,
                  device=self.engine.device)
        if op == "break_even.revenue":
            alphas = req.get("alphas") or [float(req["alpha"])]
            out = exact_revenue_curve(
                proto, alphas=tuple(float(a) for a in alphas), **kw)
            return dict(ok=True, protocol=proto, mode="exact",
                        cutoff=cutoff, revenue=out["revenue"],
                        alphas=out["alphas"], cached=out["cached"],
                        fingerprint=out["fingerprint"])
        out = break_even_exact(
            proto, support=tuple(req.get("support", (0.1, 0.5))),
            grid=int(req.get("grid", 17)), **kw)
        return dict(ok=True, protocol=proto, mode="exact",
                    cutoff=cutoff, alpha=out["alpha"],
                    cached=out["cached"],
                    fingerprint=out["fingerprint"])

    def _mdp_solve_grid(self, req: dict) -> dict:
        """Exact-MDP optimal-policy tables over an (alpha, gamma) grid:
        one parametric compile + one batched grid solve, served from
        the content-fingerprint disk cache (cpr_tpu_torch.mdp.
        solve_grid_cached) — a repeated query for the same protocol/
        cutoff/grid costs one cache read, never a re-solve."""
        from cpr_tpu_torch.mdp.grid import solve_grid_cached

        out = solve_grid_cached(
            req["protocol"], cutoff=int(req["cutoff"]),
            alphas=tuple(float(a) for a in req["alphas"]),
            gammas=tuple(float(g) for g in req["gammas"]),
            horizon=int(req.get("horizon", 100)),
            stop_delta=float(req.get("stop_delta", 1e-6)),
            native=bool(req.get("native", False)),
            k=int(req.get("k", 2)),
            include_policy=bool(req.get("include_policy", False)),
            device=self.engine.device)
        return dict(ok=True, **out)

    def _attack_sweep(self, req: dict) -> dict:
        """Adversary-in-the-network sweeps (netsim.attack_sweep_cached):
        the whole protocol x topology x delay x alpha x policy grid of
        one request runs as a single vmapped lane batch, served from
        the topology-fingerprint disk cache.  `topology` selects the
        network: {"kind": "two-agents"} (default, the degenerate
        anchor), {"kind": "clique", "n", "propagation_delay"}, or
        {"kind": "graphml", "xml", "label"} for arbitrary topologies
        over the wire.  Loaded policy snapshots (--policy-snapshot)
        are addressable by name next to the scripted SSZ policies."""
        from cpr_tpu_torch import netsim
        from cpr_tpu_torch.netsim.attack import DEFAULT_ALPHAS
        from cpr_tpu_torch.network import (of_graphml, symmetric_clique,
                                     two_agents)

        topo = req.get("topology") or {"kind": "two-agents"}
        kind = topo.get("kind", "two-agents")
        act_delay = float(topo.get("activation_delay", 60.0))
        if kind == "graphml":
            net = of_graphml(topo["xml"])
            label = str(topo.get("label", "graphml"))
        elif kind == "clique":
            n = int(topo.get("n", 4))
            net = symmetric_clique(
                n, activation_delay=act_delay,
                propagation_delay=float(
                    topo.get("propagation_delay", 1.0)))
            label = f"clique-{n}"
        elif kind == "two-agents":
            net = two_agents(alpha=0.5, activation_delay=act_delay)
            label = "two-agents"
        else:
            raise ValueError(f"unknown topology kind {kind!r}")
        policies = tuple(req.get("policies",
                                 netsim.DEFAULT_ATTACK_POLICIES))
        extra = {nm: fn for nm, fn in self.attack_policies.items()
                 if nm in policies}
        out = netsim.attack_sweep_cached(
            net, label,
            protocol=req.get("protocol", "nakamoto"),
            k=int(req.get("k", 1)),
            scheme=req.get("scheme", "constant"),
            policies=tuple(p for p in policies if p not in extra),
            extra_policies=extra or None,
            extra_fingerprint=self.attack_fingerprint if extra else "",
            alphas=tuple(float(a)
                         for a in req.get("alphas", DEFAULT_ALPHAS)),
            activation_delays=tuple(
                float(d) for d in req.get("activation_delays",
                                          (act_delay,))),
            activations=int(req.get("activations", 2000)),
            reps=int(req.get("reps", 4)),
            seed=int(req.get("seed", 0)),
            cache=bool(req.get("cache", True)),
            device=self.engine.device)
        return dict(ok=True, **out)


# -- child entry point ----------------------------------------------------


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="cpr_tpu_torch serving child")
    p.add_argument("--protocol", default="nakamoto")
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--gamma", type=float, default=0.5)
    p.add_argument("--activation-delay", type=float, default=1.0)
    p.add_argument("--max-steps", type=int, default=256)
    p.add_argument("--lanes", type=int, default=32)
    p.add_argument("--burst", type=int, default=256)
    p.add_argument("--devices", type=int, default=1,
                   help="shard the lane block over this many devices"
                        " (not ported: ROADMAP item 13)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device;"
                        " 'cpu' runs the plain versions on the host)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--policy-snapshot", default=None,
                   help="serving snapshot (driver.export_policy_snapshot"
                        " / train checkpoints); served as policy 'ppo'")
    p.add_argument("--ready-file", default=None,
                   help="atomic JSON {host,port,pid} once accepting")
    p.add_argument("--heartbeat-s", type=float, default=1.0)
    p.add_argument("--slo-s", type=float, default=None,
                   help="shed new sessions in-band when oldest_queued_s"
                        " breaches this (scaled per priority class);"
                        " default: no SLO shedding")
    p.add_argument("--max-queue", type=int, default=None,
                   help="admission queue bound (default 8x lanes;"
                        " <= 0 for unbounded)")
    p.add_argument("--tenant-quota", type=int, default=None,
                   help="max lanes+queue slots one tenant may hold")
    p.add_argument("--replica-index", type=int, default=None,
                   help="fleet replica id (set by serve.router); arms"
                        " the per-replica fault-injection site")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve Prometheus text metrics over HTTP on"
                        " this port (0 = ephemeral; the bound port"
                        " lands in the ready file); default: no HTTP"
                        " exposition (metrics.scrape stays available)")
    p.add_argument("--learner", default=None, metavar="HOST:PORT",
                   help="feed sampler-lane experience to this learner"
                        " (cpr_tpu_torch.learn.learner); requires"
                        " --policy-snapshot, turns the snapshot into a"
                        " sampling policy ('ppo#sample') and arms the"
                        " device experience rings")
    p.add_argument("--learn-watch", default=None, metavar="DIR",
                   help="watch DIR/latest.json and hot-swap the 'ppo'"
                        " policy at burst boundaries (zero drain);"
                        " requires --policy-snapshot")
    p.add_argument("--staleness-slo-s", type=float, default=None,
                   help="snapshot-staleness budget for the burn-rate"
                        " alert engine (docs/LEARNING.md); default:"
                        " signal off")
    args = p.parse_args(argv)
    if args.devices > 1:
        raise SystemExit(
            f"--devices {args.devices}: the lane block over several "
            f"devices is not ported to cpr_tpu_torch yet (ROADMAP item 13)")

    from cpr_tpu_torch import _device, supervisor

    supervisor.maybe_start_heartbeat()
    with supervisor.child_phase("serve:init"):
        from cpr_tpu_torch.envs.registry import get_sized
        from cpr_tpu_torch.params import make_params

        device = _device.resolve(args.device)
        env = get_sized(args.protocol, args.max_steps)
        params = make_params(alpha=args.alpha, gamma=args.gamma,
                             activation_delay=args.activation_delay,
                             max_steps=args.max_steps)
        learn_mode = bool(args.learner or args.learn_watch)
        if learn_mode and not args.policy_snapshot:
            raise SystemExit(
                "--learner/--learn-watch require --policy-snapshot "
                "(the engine needs an initial swappable net)")
        extra = {}
        swap = None
        sample = ()
        if args.policy_snapshot:
            if learn_mode:
                # swappable registration: the burst reads the slot's
                # weights at every launch (engine.swap_policy replaces
                # them between bursts); with a learner attached the same
                # net also samples ('ppo#sample') into the rings
                from cpr_tpu_torch.train.driver import load_policy_network

                net, net_params, meta = load_policy_network(
                    args.policy_snapshot, device=device)
                swap = {"ppo": (net, net_params, meta["payload_sha256"])}
                if args.learner:
                    sample = ("ppo",)
            else:
                from cpr_tpu_torch.train.driver import load_policy_snapshot

                policy, meta = load_policy_snapshot(args.policy_snapshot,
                                                    device=device)
                extra["ppo"] = policy
            if meta.get("protocol") not in (None, args.protocol):
                raise SystemExit(
                    f"snapshot trained on {meta.get('protocol')!r}, "
                    f"serving {args.protocol!r}")
        engine = ResidentEngine(env, params, n_lanes=args.lanes,
                                burst=args.burst, extra_policies=extra,
                                swap_policies=swap,
                                sample_policies=sample,
                                # ring capacity == burst: every burst
                                # fills exactly one feed window
                                experience=(args.burst if args.learner
                                            else 0),
                                device=device)
    with supervisor.child_phase("serve:compile"):
        engine.start()
    # backend-bearing manifest BEFORE traffic: the perf ledger
    # attributes every later serve report row to this record (the
    # `devices` key lands as cfg_devices on every lifted row, so
    # per-device-count throughput gates separately — docs/SCALING.md)
    telemetry.current().manifest(config=dict(
        entry="serve", protocol=args.protocol, n_lanes=args.lanes,
        burst=args.burst, devices=args.devices,
        max_steps=args.max_steps, alpha=args.alpha, gamma=args.gamma,
        learner=bool(args.learner),
        learn_watch=bool(args.learn_watch)))

    feeder = None
    if args.learner:
        from cpr_tpu_torch.learn.feed import ExperienceFeeder

        lhost, _, lport = args.learner.rpartition(":")
        feeder = ExperienceFeeder(lhost or "127.0.0.1", int(lport),
                                  fingerprint=(
                                      engine.policy_fingerprint()))

    async def amain():
        server = ServeServer(engine, host=args.host, port=args.port,
                             heartbeat_s=args.heartbeat_s,
                             slo_s=args.slo_s, max_queued=args.max_queue,
                             tenant_quota=args.tenant_quota,
                             replica_index=args.replica_index,
                             metrics_port=args.metrics_port,
                             feeder=feeder,
                             learn_watch=args.learn_watch,
                             staleness_slo_s=args.staleness_slo_s,
                             protocol=args.protocol)
        # the same loaded nets double as in-network attack policies
        # (netsim.attack_sweep); the snapshot path is the cache
        # fingerprint for their sweep results
        server.attack_policies = dict(extra)
        server.attack_fingerprint = args.policy_snapshot or ""
        await server.start()
        if args.ready_file:
            resilience.atomic_write_json(
                args.ready_file,
                dict(host=args.host, port=server.port, pid=os.getpid(),
                     metrics_port=server.metrics_port))
        await server.serve_until_drained()

    with supervisor.child_phase("serve:run"), resilience.preemption_guard():
        # the flight recorder's crash trigger: any exception unwinding
        # the serve loop (including an injected kill standing in for
        # one) dumps the telemetry ring before re-raising; a graceful
        # preemption drain dumps on the way out too (the preempt flag
        # outlives the guard)
        try:
            asyncio.run(amain())
        except BaseException as e:  # noqa: BLE001 — dump-and-reraise
            dump_blackbox(f"serve:{type(e).__name__}")
            raise
        if resilience.preempt_requested():
            dump_blackbox(f"serve:preempt:{resilience.preempt_reason()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
