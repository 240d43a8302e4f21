"""Master-side proxy for a remote worker (port of
``cake_tpu/runtime/client.py``, ``SessionLost`` and ``StageClient``).

One connection per WORKER: all of a node's contiguous ranges ride one
socket, and a multi-range request is one round trip. Every round trip runs
under a per-op deadline (the socket timeout). With a session active
(``begin_session``) a failed round trip is retried with bounded backoff by
re-dialing and RESENDING the same (sid, seq) frame, which the worker answers
idempotently (runtime/worker.py sessions). Without a session a resend would
apply KV writes twice, so the first failure raises.

``round_trips``, ``tx_bytes`` and ``rx_bytes`` count the client's forwards
and their payload bytes (frame prefix and header excluded). The heartbeat
monitor and the metrics calls are not ported (ROADMAP.md queue A).
"""

from __future__ import annotations

import logging
import socket
import time

from cake_tpu_torch.runtime import proto

log = logging.getLogger("cake_tpu_torch.client")


def parse_address(addr: str, *, default_host: str = "0.0.0.0", what: str = "address"
                  ) -> tuple[str, int]:
    """``host:port`` -> (host, port), with an error naming the bad field."""
    host, _, port = addr.rpartition(":")
    if not port.isdigit():
        raise ValueError(f"{what} {addr!r} must be of the form host:port (missing or "
                         "non-numeric port)")
    return host or default_host, int(port)


class SessionLost(ConnectionError):
    """The worker no longer holds this session's state (a coded ERROR reply:
    restarted, evicted, or a sequence gap). A resend cannot succeed; the
    caller rebuilds state (the generator's history replay, the engine's
    failure isolation)."""

    def __init__(self, node: str, code: str, message: str):
        super().__init__(f"worker {node}: {code}: {message}")
        self.node = node
        self.code = code


class StageClient:
    """Connects to one worker and forwards activations through its ranges."""

    def __init__(
        self,
        host: str,
        node_name: str,
        timeout: float = 30.0,
        *,
        op_deadline_s: float | None = None,
        op_retries: int = 2,
        reconnect_attempts: int = 3,
        reconnect_backoff_s: float = 0.5,
    ):
        self.node_name = node_name
        self.host = host
        self._timeout = timeout
        self.op_deadline_s = timeout if op_deadline_s is None else op_deadline_s
        self.op_retries = max(0, op_retries)
        self.reconnect_attempts = max(1, reconnect_attempts)
        self.reconnect_backoff_s = reconnect_backoff_s
        self.sid: str | None = None  # replay session riding every FORWARD
        self._seq = 0
        self.round_trips = 0
        self.tx_bytes = 0
        self.rx_bytes = 0
        self._connect()

    def _connect(self) -> None:
        addr_host, addr_port = parse_address(
            self.host, what=f"topology host for node {self.node_name!r}"
        )
        t0 = time.perf_counter()
        self._sock = socket.create_connection((addr_host, addr_port), timeout=self._timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(self.op_deadline_s)
        proto.write_frame(self._sock, proto.hello_frame())
        reply = proto.read_frame(self._sock)
        if reply.type != proto.MsgType.WORKER_INFO:
            raise ConnectionError(
                f"worker {self.node_name} handshake failed: got {reply.type.name}"
            )
        self.info = proto.WorkerInfo.from_dict(reply.header["info"])
        self.handshake_ms = (time.perf_counter() - t0) * 1e3
        log.info(
            "connected to %s (%s): device=%s dtype=%s ranges=%s in %.1fms",
            self.node_name, self.host, self.info.device, self.info.dtype, self.info.ranges,
            self.handshake_ms,
        )

    # ------------------------------------------------------------- sessions

    def begin_session(self, sid: str) -> None:
        """Start a fresh replay session: later forwards carry increasing seq
        under ``sid`` and become retry-safe."""
        self.sid = sid
        self._seq = 0

    def configure(
        self,
        *,
        op_deadline_s: float | None = None,
        op_retries: int | None = None,
        reconnect_attempts: int | None = None,
        reconnect_backoff_s: float | None = None,
    ) -> None:
        """Apply the wire-resilience knobs to a live client; the deadline
        takes effect on the current socket at once."""
        if op_deadline_s is not None:
            self.op_deadline_s = op_deadline_s
            self._sock.settimeout(op_deadline_s)
        if op_retries is not None:
            self.op_retries = max(0, op_retries)
        if reconnect_attempts is not None:
            self.reconnect_attempts = max(1, reconnect_attempts)
        if reconnect_backoff_s is not None:
            self.reconnect_backoff_s = reconnect_backoff_s

    def reconnect(self, attempts: int | None = None, backoff_s: float | None = None) -> None:
        """Re-dial with bounded exponential backoff (no sleep after the last
        failed attempt). Without a session a fresh connection means fresh
        worker-side KV; with one, the worker's state survives by sid."""
        attempts = self.reconnect_attempts if attempts is None else attempts
        backoff_s = self.reconnect_backoff_s if backoff_s is None else backoff_s
        self.close()
        last: Exception | None = None
        for i in range(attempts):
            try:
                self._connect()
                return
            except OSError as e:
                last = e
                log.warning("reconnect to %s failed (attempt %d/%d): %s",
                            self.node_name, i + 1, attempts, e)
                if i + 1 < attempts:
                    time.sleep(backoff_s * (2**i))
        raise ConnectionError(f"could not reconnect to worker {self.node_name}") from last

    def forward(
        self,
        x: proto.WireTensor,
        ranges: list[tuple[int, int]],
        pos: int,
        batch: dict | None = None,
        trace: str | None = None,
    ) -> proto.WireTensor:
        """One round trip: run ``x`` through the worker's owned ranges.
        ``batch`` selects the lockstep layout (proto.forward_frame);
        ``trace`` rides the header. With a session, a deadline or connection
        failure re-dials and resends the same (sid, seq) up to
        ``op_retries`` times; without one the first failure raises."""
        seq: int | None = None
        if self.sid is not None:
            seq = self._seq
            self._seq += 1
        retries = self.op_retries if seq is not None else 0
        for attempt in range(retries + 1):
            try:
                return self._round_trip(x, ranges, pos, batch, trace, seq)
            except SessionLost:
                raise
            except (ConnectionError, TimeoutError, OSError) as e:
                if attempt >= retries:
                    raise
                log.warning("op to %s failed (attempt %d/%d, seq=%s): %s; reconnecting for an "
                            "idempotent resend", self.node_name, attempt + 1, retries + 1, seq, e)
                # Never reuse the socket: a late reply to the timed-out op
                # would desync the request/reply stream.
                self.reconnect()
        raise AssertionError("unreachable")

    def _round_trip(self, x, ranges, pos, batch, trace, seq):
        frame = proto.forward_frame(
            x, ranges, pos, batch=batch, trace=trace,
            sid=self.sid if seq is not None else None, seq=seq,
        )
        proto.write_frame(self._sock, frame)
        reply = proto.read_frame(self._sock)
        self.round_trips += 1
        self.tx_bytes += len(x.data)
        self.rx_bytes += len(reply.payload)
        if reply.type == proto.MsgType.ERROR:
            code = reply.header.get("code")
            if code in (proto.ERR_UNKNOWN_SESSION, proto.ERR_BAD_SEQ):
                raise SessionLost(self.node_name, code, reply.header["error"])
            raise RuntimeError(f"worker {self.node_name}: {reply.header['error']}")
        if reply.type != proto.MsgType.TENSOR:
            raise ConnectionError(f"unexpected reply {reply.type.name}")
        return reply.tensor()

    def reset(self) -> None:
        """Drop worker-side sequence state: with a session, retire the
        current sid (callers then begin a fresh one)."""
        proto.write_frame(self._sock, proto.reset_frame(sid=self.sid))

    def ping(self) -> float:
        t0 = time.perf_counter()
        proto.write_frame(self._sock, proto.ping_frame())
        reply = proto.read_frame(self._sock)
        if reply.type != proto.MsgType.PING:
            raise ConnectionError(f"unexpected ping reply {reply.type.name}")
        return (time.perf_counter() - t0) * 1e3

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
