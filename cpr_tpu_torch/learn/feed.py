"""Experience feed: ships consolidated sampler batches to the learner.

Port of cpr_tpu/learn/feed.py, host only: the same code with its imports
from cpr_tpu_torch; the frames are byte for byte the reference's.

The serve tick loop drains the device rings at burst boundaries
(ResidentEngine.drain_experience) and hands the numpy batch to an
`ExperienceFeeder` — a daemon thread with a small bounded queue that
serializes and sends `learn.feed` frames over the serve wire protocol
(serve/protocol.py framing, same 4-byte-BE + JSON contract as every
other op).  The decoupling rules:

  * the tick loop NEVER blocks on the learner: `submit` is
    drop-oldest — a slow or dead learner costs experience, not serve
    latency (the drops are counted and ride the feed events);
  * the learner NEVER blocks the feeder forever: requests run on the
    feeder thread with the client's socket timeout, and errors tear
    down the connection for a lazy reconnect on the next batch.

`encode_batch`/`decode_batch` are the wire codec for a consolidated
batch (learn/buffer.py `consolidate` output): arrays travel as nested
JSON lists with the geometry fields (`lanes`, `steps`) alongside, and
the decoder rebuilds the exact dtypes, so a feed round-trip is
lossless up to float32.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from cpr_tpu_torch.learn import learn_event
from cpr_tpu_torch.serve.protocol import ServeClient

# batch fields that travel as arrays, with their wire dtypes
_ARRAY_FIELDS = (
    ("obs", np.float32), ("action", np.int32), ("reward", np.float32),
    ("done", bool), ("era", np.float32), ("erd", np.float32),
    ("policy", np.int32), ("last_obs", np.float32),
    ("lanes", np.int32),
)
_SCALAR_FIELDS = ("steps", "partial", "dropped_steps")

_STOP = object()


def encode_batch(batch: dict) -> dict:
    """Consolidated batch -> JSON-serializable feed payload."""
    out = {k: np.asarray(batch[k]).tolist() for k, _ in _ARRAY_FIELDS}
    for k in _SCALAR_FIELDS:
        out[k] = int(batch.get(k, 0))
    return out


def decode_batch(msg: dict) -> dict:
    """Feed payload -> consolidated batch (numpy, exact dtypes)."""
    out = {k: np.asarray(msg[k], dt) for k, dt in _ARRAY_FIELDS}
    for k in _SCALAR_FIELDS:
        out[k] = int(msg.get(k, 0))
    return out


class ExperienceFeeder:
    """Background shipper of experience batches to one learner."""

    def __init__(self, host: str, port: int, *, maxlen: int = 8,
                 timeout_s: float = 60.0, fingerprint=None):
        self._host, self._port = host, int(port)
        self._timeout_s = float(timeout_s)
        self._q: queue.Queue = queue.Queue(maxsize=int(maxlen))
        self._client: ServeClient | None = None
        # the serving snapshot fingerprint, stamped on feed events so
        # the learner trace says which policy generated the samples;
        # the server refreshes it after every swap
        self.fingerprint = fingerprint
        self.batches_fed = 0
        self.samples_fed = 0
        self.dropped = 0
        self.errors = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="experience-feeder")
        self._thread.start()

    def submit(self, batch: dict):
        """Enqueue a consolidated batch; drop-oldest on a full queue
        (the tick loop must never wait on the learner)."""
        while True:
            try:
                self._q.put_nowait(batch)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self.dropped += 1
                except queue.Empty:
                    pass

    def stats(self) -> dict:
        return dict(batches_fed=self.batches_fed,
                    samples_fed=self.samples_fed,
                    dropped=self.dropped, errors=self.errors,
                    queued=self._q.qsize())

    def close(self, timeout_s: float = 10.0):
        """Flush-free shutdown: stop after the in-flight send."""
        self._q.put(_STOP)
        self._thread.join(timeout_s)
        if self._client is not None:
            try:
                self._client.close()
            except OSError:
                pass
            self._client = None

    # -- feeder thread ----------------------------------------------------

    def _send(self, batch: dict) -> dict:
        if self._client is None:
            self._client = ServeClient(self._host, self._port,
                                       timeout=self._timeout_s)
        return self._client.request(
            "learn.feed", fingerprint=self.fingerprint,
            **encode_batch(batch))

    def _run(self):
        while True:
            batch = self._q.get()
            if batch is _STOP:
                return
            try:
                reply = self._send(batch)
            except Exception:
                # connection-level failure: drop this batch, count it,
                # and reconnect lazily on the next one — experience is
                # cheap, serve availability is not
                self.errors += 1
                if self._client is not None:
                    try:
                        self._client.close()
                    except OSError:
                        pass
                    self._client = None
                continue
            if not (isinstance(reply, dict) and reply.get("ok")):
                self.errors += 1
                continue
            self.batches_fed += 1
            self.samples_fed += int(batch.get("steps", 0))
            learn_event("feed", steps=int(batch.get("steps", 0)),
                        batches=1, fingerprint=self.fingerprint,
                        staleness_s=None, dropped=self.dropped,
                        pool=reply.get("pool"))
