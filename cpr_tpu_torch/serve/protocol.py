"""Wire protocol for cpr_tpu_torch.serve: length-prefixed JSON frames.

Port of cpr_tpu/serve/protocol.py, host only: the same code with its imports
from cpr_tpu_torch.

One frame = a 4-byte big-endian unsigned length followed by that many
bytes of UTF-8 JSON.  Requests and responses are JSON objects; every
request carries an `op` key, every response an `ok` bool.  The server
answers frames on one connection strictly in order, so a blocking
request/response client (`ServeClient`, used by tools/serve_smoke.py
and the tests) needs no correlation ids.

Trace context (schema v8): `_trace` is a reserved request field —
`{"id": <trace_id>, "run": <run_id>, "parent": <span or null>}` —
which the server propagates into its `request` telemetry event and
echoes back as `trace_id`, so the client- and server-side events of
one request correlate across JSONL streams (tools/trace_stitch.py).
`ServeClient.request` stamps it automatically, times the full
round-trip, and emits the client-side `request` event (a no-op
without a telemetry sink).
"""

from __future__ import annotations

import json
import socket
import struct
import time

from cpr_tpu_torch import resilience, telemetry

_HEADER = struct.Struct(">I")
# generous ceiling: the largest legitimate frame (an interactive step
# info dict) is well under 1 MB; anything bigger is a framing bug
MAX_FRAME = 16 << 20


class ProtocolError(RuntimeError):
    pass


class ShedRefusal(resilience.TransientFault):
    """In-band admission-control refusal (`shed: ...` with a
    `retry_after` hint): transient in the shared taxonomy — the server
    is up, just loaded, so backing off and retrying is correct."""

    def __init__(self, resp: dict):
        super().__init__(resp.get("error", "shed"))
        self.resp = resp
        try:
            self.retry_after_s = float(resp.get("retry_after") or 0.0)
        except (TypeError, ValueError):
            self.retry_after_s = 0.0


class DrainRefusal(RuntimeError):
    """In-band drain refusal: terminal — this server is going away, so
    retrying against it is wrong (a router retries elsewhere)."""

    def __init__(self, resp: dict):
        super().__init__(resp.get("error", "draining"))
        self.resp = resp


def pack_frame(obj) -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME:
        raise ProtocolError(f"frame of {len(body)} bytes exceeds "
                            f"MAX_FRAME={MAX_FRAME}")
    return _HEADER.pack(len(body)) + body


def _decode(body: bytes):
    try:
        return json.loads(body.decode("utf-8"))
    except ValueError as e:
        raise ProtocolError(f"undecodable frame: {e}") from e


async def read_frame(reader):
    """Read one frame from an asyncio StreamReader; None on clean EOF
    at a frame boundary."""
    import asyncio

    try:
        header = await reader.readexactly(_HEADER.size)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise ProtocolError("connection closed mid-header") from e
    (n,) = _HEADER.unpack(header)
    if n > MAX_FRAME:
        raise ProtocolError(f"frame length {n} exceeds {MAX_FRAME}")
    try:
        body = await reader.readexactly(n)
    except asyncio.IncompleteReadError as e:
        raise ProtocolError("connection closed mid-frame") from e
    return _decode(body)


async def write_frame(writer, obj):
    writer.write(pack_frame(obj))
    await writer.drain()


def _client_request_event(trace_id, op, status, queue_wait_s,
                          service_s, total_s):
    """The one client-side `request` event call site
    (EVENT_FIELDS['request']); the server-side twin lives in
    server.py.  queue_wait/service are the server's own breakdown
    copied off the reply; total is the client wall, so
    `total_s(client) - total_s(server)` is the wire + framing
    overhead (the `reply` leg in trace_stitch's critical path)."""
    telemetry.current().event(
        "request", trace_id=trace_id, op=op, status=status,
        queue_wait_s=queue_wait_s, service_s=service_s,
        total_s=total_s, role="client", run=telemetry.run_id())


class ServeClient:
    """Blocking request/response client over one TCP connection."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self._addr = (host, port)
        self._timeout = timeout
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            chunk = self._sock.recv(n)
            if not chunk:
                raise ProtocolError("server closed the connection")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def request(self, op: str, **fields):
        trace_id = telemetry.new_trace_id()
        t0 = telemetry.now()
        self._sock.sendall(pack_frame(dict(
            fields, op=op,
            _trace=dict(id=trace_id, run=telemetry.run_id(),
                        parent=None))))
        (n,) = _HEADER.unpack(self._recv_exact(_HEADER.size))
        if n > MAX_FRAME:
            raise ProtocolError(f"frame length {n} exceeds {MAX_FRAME}")
        resp = _decode(self._recv_exact(n))
        total_s = telemetry.now() - t0
        lat = resp.get("latency") if isinstance(resp, dict) else None
        lat = lat if isinstance(lat, dict) else {}
        status = ("ok" if resp.get("ok")
                  else "refused" if resp.get("draining")
                  or resp.get("shed") else "error") \
            if isinstance(resp, dict) else "error"
        _client_request_event(trace_id, op, status,
                              lat.get("queue_wait_s"),
                              lat.get("service_s"), total_s)
        return resp

    def call_with_retry(self, op: str, *, max_attempts: int = 5,
                        base_delay_s: float = 0.25,
                        max_delay_s: float = 30.0, sleep=time.sleep,
                        **fields):
        """`request` through the shared retry taxonomy
        (resilience.with_retries): shed refusals are transient and the
        backoff honors the server's `retry_after` hint (the in-band
        contract: a shed reply quotes when capacity is expected back),
        connection loss is transient with an automatic reconnect, and
        a drain refusal is terminal — `DrainRefusal` propagates, since
        this server is going away and only a router can retry
        elsewhere.  Returns the successful reply dict."""
        hint = {"s": 0.0}

        def attempt():
            if self._sock is None:
                self._sock = socket.create_connection(
                    self._addr, timeout=self._timeout)
            try:
                resp = self.request(op, **fields)
            except (ProtocolError, ConnectionError, OSError):
                self.close()  # next attempt reconnects
                raise
            if isinstance(resp, dict) and not resp.get("ok"):
                if resp.get("shed"):
                    raise ShedRefusal(resp)
                if resp.get("draining"):
                    raise DrainRefusal(resp)
            return resp

        def classify(e) -> bool:
            if isinstance(e, ShedRefusal):
                hint["s"] = e.retry_after_s
                return True
            if isinstance(e, DrainRefusal):
                return False
            return resilience.default_classify(e)

        def _sleep(delay_s: float):
            # the exponential schedule is the floor; a larger server
            # hint stretches it (still capped), then the hint is spent
            sleep(min(max_delay_s, max(delay_s, hint["s"])))
            hint["s"] = 0.0

        return resilience.with_retries(
            attempt, classify=classify, max_attempts=max_attempts,
            base_delay_s=base_delay_s, max_delay_s=max_delay_s,
            sleep=_sleep, name=f"serve:{op}")

    def close(self):
        if self._sock is None:
            return
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
