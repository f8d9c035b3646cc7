"""The learner half of the always-on loop: PPO over fed experience (port
of cpr_tpu/learn/learner.py).

`python -m cpr_tpu_torch.learn.learner` runs a standalone process that

  1. accepts `learn.feed` frames (serve/protocol.py framing) carrying
     consolidated experience batches that the serve lanes recorded
     (learn/buffer.py -> engine.drain_experience -> feed.ExperienceFeeder);
  2. pools the per-lane windows and, whenever cfg.n_envs full windows
     are banked, runs one PPO update (train/ppo.py
     `make_experience_update`: K11-gae, K11-loss and K11-adam on the
     card);
  3. publishes serving snapshots every `--publish-every` updates
     through `train.driver.export_policy_snapshot` (flax's msgpack in
     the sealed envelope plus the meta sidecar, so either package loads
     them), then points an atomic `latest.json` at the newest one, the
     file serve/server.py watches to hot-swap without draining.

The snapshot fingerprint is the sha256 of the serialized params, the
sidecar's `payload_sha256`, so the learner's `publish` events, the
server's `swap` events and heartbeats, and the engine's no-op-swap
detection correlate on one id. It equals the JAX package's
`params_fingerprint` of the same weights in jax's canonical tree order
(keys sorted, as every tree after an update or a load has them).

Updates run inline in the feed handler: the learner may stall its own
socket during an update, but the serve tick loop never feels it (the
feeder thread owns the wait and sheds batches drop-oldest). Every batch
is checked against the learner's window length (cfg.n_steps).

Lifecycle: supervisor heartbeat, ready-file with the bound port,
SIGTERM via resilience.preemption_guard -> final publish + drain, exit
0. The learner runs on the card unless `--device cpu` asks for the host.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
from collections import deque
from datetime import datetime, timezone

import numpy as np
import torch

from cpr_tpu_torch import _device, random, resilience, telemetry
from cpr_tpu_torch.learn import learn_event
from cpr_tpu_torch.learn.feed import decode_batch
from cpr_tpu_torch.serve import protocol as wire

LATEST = "latest.json"


def params_fingerprint(net) -> str:
    """sha256 of the serialized params of `net` (a `train.ppo.
    ActorCritic`): identical to the snapshot sidecar's `payload_sha256`
    for the same params."""
    from cpr_tpu_torch.train.driver import _net_bytes

    return hashlib.sha256(_net_bytes(net)).hexdigest()


# per-lane window fields pooled between updates ([C, ...] each)
_WINDOW_FIELDS = ("obs", "action", "reward", "done", "era", "erd")


class Learner:
    """Pool fed experience windows, update PPO, publish snapshots."""

    def __init__(self, env, cfg, *, protocol: str, publish_dir: str,
                 publish_every: int = 1, seed: int = 0,
                 reward_transform="relative", device=None):
        from cpr_tpu_torch.train.ppo import (make_experience_update,
                                             relative_reward_on_done)

        self.env = env
        self.cfg = cfg
        self.protocol = protocol
        self.publish_dir = publish_dir
        self.publish_every = max(1, int(publish_every))
        self.device = _device.resolve(device)
        rt = relative_reward_on_done if reward_transform == "relative" \
            else reward_transform
        self.net, init_fn, self._update, self._mspec = \
            make_experience_update(env.n_actions, env.observation_length,
                                   cfg, reward_transform=rt,
                                   device=self.device)
        keys = random.split(random.PRNGKey(seed, self.device))
        init_key, self._key = keys[0], keys[1]
        self.ts = init_fn(init_key)
        # per-lane windows awaiting an update: each a dict of
        # [n_steps, ...] arrays plus its bootstrap last_obs [obs_dim]
        self.pool: deque = deque()
        self.batches = 0
        self.samples = 0
        self.updates = 0
        self.publishes = 0
        self.last_metrics: dict = {}
        self.fingerprint = params_fingerprint(self.ts.net)
        # update counter at the last publish: the drain-time final
        # publish fires only when progress is stranded past it
        self.published_at_update = -1

    # -- feed -------------------------------------------------------------

    def ingest(self, batch: dict) -> dict:
        """Pool one consolidated batch; run every update it unlocks.
        Returns the reply block for the feed acknowledgement."""
        n_lanes = int(np.asarray(batch["lanes"]).shape[0])
        if n_lanes:
            window = int(np.asarray(batch["obs"]).shape[1])
            if window != self.cfg.n_steps:
                raise ValueError(
                    f"fed window length {window} != learner n_steps "
                    f"{self.cfg.n_steps}; align the serve burst with "
                    f"the learner's --n-steps")
        for i in range(n_lanes):
            win = {f: np.asarray(batch[f])[i] for f in _WINDOW_FIELDS}
            win["last_obs"] = np.asarray(batch["last_obs"])[i]
            self.pool.append(win)
        self.batches += 1
        self.samples += int(batch.get("steps", 0))
        updated = 0
        while len(self.pool) >= self.cfg.n_envs:
            self._update_once()
            updated += 1
        return dict(pool=len(self.pool), updates=self.updates,
                    updated=updated, publishes=self.publishes,
                    fingerprint=self.fingerprint)

    def _update_once(self):
        """One PPO update over cfg.n_envs pooled windows, stacked
        time-major ([T, N, ...])."""
        wins = [self.pool.popleft() for _ in range(self.cfg.n_envs)]
        b = {f: torch.from_numpy(np.stack([w[f] for w in wins], axis=1))
             .to(self.device) for f in _WINDOW_FIELDS}
        b["last_obs"] = torch.from_numpy(np.stack(
            [w["last_obs"] for w in wins], axis=0)).to(self.device)
        t0 = telemetry.now()
        self.ts, self._key, metrics = self._update(self.ts, b, self._key)
        self.updates += 1
        self.fingerprint = params_fingerprint(self.ts.net)
        self.last_metrics = {k: float(v) for k, v in metrics.items()
                             if np.ndim(v) == 0 and k != "device"}
        learn_event("update", steps=self.cfg.n_steps * self.cfg.n_envs,
                    batches=1, fingerprint=self.fingerprint,
                    staleness_s=None, update=self.updates,
                    update_s=telemetry.now() - t0,
                    pg_loss=self.last_metrics.get("pg_loss"))
        if self.updates % self.publish_every == 0:
            self.publish()

    # -- publish ----------------------------------------------------------

    def publish(self) -> dict:
        """Export the current params as a sealed serving snapshot and
        atomically repoint `latest.json` at it (the snapshot lands
        first, so a reader never sees a pointer to a half-written
        one)."""
        from cpr_tpu_torch.train.driver import export_policy_snapshot

        seq = self.publishes
        path = os.path.join(self.publish_dir,
                            f"snapshot-{seq:06d}.msgpack")
        export_policy_snapshot(
            path, self.ts.net, protocol=self.protocol,
            n_actions=int(self.env.n_actions),
            observation_length=int(self.env.observation_length),
            hidden=list(self.cfg.hidden), seq=seq,
            updates=self.updates, samples=self.samples)
        resilience.atomic_write_json(
            os.path.join(self.publish_dir, LATEST),
            dict(seq=seq, path=path, fingerprint=self.fingerprint,
                 updates=self.updates, samples=self.samples,
                 time_utc=datetime.now(timezone.utc).isoformat(
                     timespec="seconds")))
        self.publishes += 1
        self.published_at_update = self.updates
        learn_event("publish", steps=self.samples, batches=self.batches,
                    fingerprint=self.fingerprint, staleness_s=None,
                    seq=seq, path=path, updates=self.updates)
        return dict(seq=seq, path=path, fingerprint=self.fingerprint)

    def stats(self) -> dict:
        return dict(batches=self.batches, samples=self.samples,
                    updates=self.updates, publishes=self.publishes,
                    pool=len(self.pool), fingerprint=self.fingerprint,
                    metrics=dict(self.last_metrics))


class LearnerServer:
    """TCP front-end: learn.feed / hello / stats / drain over the serve
    wire protocol."""

    def __init__(self, learner: Learner, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.learner = learner
        self.host = host
        self.port = port  # replaced by the bound port after start()
        self._server = None
        self._drain_reason = None

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    def request_drain(self, reason: str):
        self._drain_reason = self._drain_reason or reason

    async def serve_until_drained(self, poll_s: float = 0.05):
        while True:
            if resilience.preempt_requested():
                self.request_drain(
                    f"preempt:{resilience.preempt_reason()}")
            if self._drain_reason is not None:
                break
            await asyncio.sleep(poll_s)
        # final publish so a drain never strands unpublished progress
        lr = self.learner
        if lr.updates > lr.published_at_update:
            lr.publish()
        self._server.close()
        await self._server.wait_closed()

    async def _handle(self, reader, writer):
        try:
            while True:
                req = await wire.read_frame(reader)
                if req is None:
                    break
                try:
                    resp = self._dispatch(req)
                except Exception as e:  # noqa: BLE001 — per-request wall
                    resp = dict(ok=False,
                                error=f"{type(e).__name__}: {e}")
                await wire.write_frame(writer, resp)
        except (wire.ProtocolError, ConnectionError,
                asyncio.CancelledError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        lr = self.learner
        if op == "hello":
            return dict(ok=True, role="learner",
                        schema=telemetry.SCHEMA_VERSION,
                        run=telemetry.run_id(),
                        n_steps=lr.cfg.n_steps, n_envs=lr.cfg.n_envs,
                        fingerprint=lr.fingerprint)
        if op == "learn.feed":
            if self._drain_reason is not None:
                return dict(ok=False, error="draining", draining=True)
            return dict(ok=True, **lr.ingest(decode_batch(req)))
        if op == "stats":
            return dict(ok=True, **lr.stats())
        if op == "drain":
            self.request_drain(str(req.get("reason", "client")))
            return dict(ok=True, draining=True)
        return dict(ok=False, error=f"unknown op {op!r}")


# -- child entry point ----------------------------------------------------


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="cpr_tpu_torch learner child")
    p.add_argument("--protocol", default="nakamoto")
    p.add_argument("--max-steps", type=int, default=256)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--publish-dir", required=True,
                   help="snapshot directory; latest.json in here is "
                        "the hot-swap pointer serve/server.py watches")
    p.add_argument("--ready-file", default=None,
                   help="atomic JSON {host,port,pid} once accepting")
    p.add_argument("--hidden", type=int, nargs="+", default=[64, 64])
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--n-envs", type=int, default=16,
                   help="windows per update")
    p.add_argument("--n-steps", type=int, default=64,
                   help="window length; must equal the serve burst")
    p.add_argument("--update-epochs", type=int, default=4)
    p.add_argument("--n-minibatches", type=int, default=4)
    p.add_argument("--publish-every", type=int, default=1,
                   help="publish a snapshot every N updates")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device; "
                        "'cpu' runs the plain versions on the host)")
    args = p.parse_args(argv)

    from cpr_tpu_torch import supervisor

    supervisor.maybe_start_heartbeat()
    with supervisor.child_phase("learn:init"):
        from cpr_tpu_torch.envs.registry import get_sized
        from cpr_tpu_torch.train.ppo import PPOConfig

        env = get_sized(args.protocol, args.max_steps)
        cfg = PPOConfig(n_envs=args.n_envs, n_steps=args.n_steps,
                        lr=args.lr, update_epochs=args.update_epochs,
                        n_minibatches=args.n_minibatches,
                        hidden=tuple(args.hidden))
        os.makedirs(args.publish_dir, exist_ok=True)
        learner = Learner(env, cfg, protocol=args.protocol,
                          publish_dir=args.publish_dir,
                          publish_every=args.publish_every,
                          seed=args.seed, device=args.device)
    telemetry.current().manifest(config=dict(
        entry="learn", protocol=args.protocol, n_envs=args.n_envs,
        n_steps=args.n_steps, lr=args.lr, hidden=list(args.hidden),
        publish_every=args.publish_every, max_steps=args.max_steps,
        device=str(learner.device)))
    # seq-0 publish before accepting: the server always has a swap
    # target, and the revenue baseline is the untrained net
    with supervisor.child_phase("learn:publish0"):
        learner.publish()

    async def amain():
        server = LearnerServer(learner, host=args.host, port=args.port)
        await server.start()
        if args.ready_file:
            resilience.atomic_write_json(
                args.ready_file,
                dict(host=args.host, port=server.port, pid=os.getpid()))
        await server.serve_until_drained()

    with supervisor.child_phase("learn:run"), resilience.preemption_guard():
        asyncio.run(amain())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
