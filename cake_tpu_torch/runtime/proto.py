"""Wire protocol: framed TCP tensor transport (port of
``cake_tpu/runtime/proto.py``, its pure-Python codec).

    Frame:   [magic u32][frame_len u32][type u8][header_len u32][header JSON][payload]

The header is compact JSON (``separators=(",", ":")``), the tensor payload a
flat tail of raw bytes; bf16 travels as raw 16-bit words. Frames are
byte-identical to the JAX package's, so a port master drives a JAX worker
and the reverse (tests/test_torch_proto.py holds every frame's bytes
equal). Ops are block RANGES [lo, hi) plus (pos, seq_len): one round trip
for one contiguous span. RESET and ERROR are first-class. The JAX
package's C++ socket codec is not ported: this module is the port's codec.
"""

from __future__ import annotations

import dataclasses
import json
import platform
import socket
import struct
from enum import IntEnum
from typing import Any

import numpy as np

from cake_tpu_torch import __version__

MAGIC = 0x74707563  # "tpuc"
MAX_FRAME_SIZE = 512 * 1024 * 1024
_HDR = struct.Struct("<IIBI")  # magic, frame_len, type, header_len


class MsgType(IntEnum):
    HELLO = 1
    WORKER_INFO = 2
    FORWARD = 3      # header: {ranges: [[lo,hi],...], pos}; payload: x
    # No per-chunk validity field: a chunk may carry a padded tail, whose
    # keys land at FUTURE positions that the causal mask hides until real
    # tokens overwrite them (the master reads its logits at the valid length).
    TENSOR = 4       # payload: result tensor
    RESET = 5        # new sequence: drop this session's (or connection's) KV
    ERROR = 6        # header: {error: str[, code]}
    PING = 7         # health check; answered with PING (+ worker wall clock)
    STATS = 8        # telemetry pull (the port's workers answer with ERROR)


# Wire dtype tags <-> numpy. bf16 has no numpy dtype: it travels as uint16
# words and is re-viewed as torch.bfloat16 on arrival (runtime/worker.py).
_DTYPE_TO_TAG = {
    "float32": "f32",
    "float16": "f16",
    "bfloat16": "bf16",
    "int32": "i32",
    "int8": "i8",
    "uint16": "bf16",  # bf16 backing store
}
_TAG_TO_NP = {
    "f32": np.float32,
    "f16": np.float16,
    "bf16": np.uint16,
    "i32": np.int32,
    "i8": np.int8,
}


@dataclasses.dataclass
class WireTensor:
    """Raw-bytes tensor: its bytes, wire tag and shape."""

    data: bytes | memoryview
    dtype: str  # wire tag: f32 / f16 / bf16 / i32 / i8
    shape: tuple[int, ...]

    @classmethod
    def from_numpy(cls, arr: np.ndarray, dtype_tag: str | None = None) -> "WireTensor":
        tag = dtype_tag or _DTYPE_TO_TAG[arr.dtype.name]
        return cls(data=arr.tobytes(), dtype=tag, shape=tuple(arr.shape))

    def to_numpy(self) -> np.ndarray:
        return np.frombuffer(self.data, dtype=_TAG_TO_NP[self.dtype]).reshape(self.shape)

    def header(self) -> dict[str, Any]:
        return {"dtype": self.dtype, "shape": list(self.shape)}


@dataclasses.dataclass
class WorkerInfo:
    """Worker handshake diagnostics. The capability flags default False, so
    a peer whose handshake omits one is taken not to have it."""

    version: str = __version__
    dtype: str = "bf16"
    os: str = dataclasses.field(default_factory=platform.system)
    arch: str = dataclasses.field(default_factory=platform.machine)
    device: str = "unknown"
    device_count: int = 1
    latency_ms: float = 0.0
    ranges: list[list[int]] = dataclasses.field(default_factory=list)
    batch_ops: bool = False   # understands the FORWARD ``batch`` header
    verify_ops: bool = False  # understands the ``verify`` batch kind
    stats_ops: bool = False   # answers STATS pulls

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "WorkerInfo":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class Frame:
    type: MsgType
    header: dict[str, Any]
    payload: bytes | memoryview = b""

    def tensor(self) -> WireTensor:
        t = self.header["tensor"]
        return WireTensor(data=self.payload, dtype=t["dtype"], shape=tuple(t["shape"]))


def _frame_head(frame: Frame) -> tuple[bytes, int]:
    """Prefix + header JSON, and the frame's length (checked against the cap)."""
    header_bytes = json.dumps(frame.header, separators=(",", ":")).encode()
    frame_len = _HDR.size + len(header_bytes) + len(frame.payload)
    if frame_len > MAX_FRAME_SIZE:
        raise ValueError(f"frame of {frame_len} B exceeds cap {MAX_FRAME_SIZE}")
    head = _HDR.pack(MAGIC, frame_len, int(frame.type), len(header_bytes))
    return head + header_bytes, frame_len


def encode_frame(frame: Frame) -> bytes:
    head, _ = _frame_head(frame)
    return b"".join((head, frame.payload))


def decode_frame(buf: memoryview) -> Frame:
    magic, frame_len, mtype, header_len = _HDR.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    if frame_len != len(buf):
        raise ValueError(f"frame length mismatch: {frame_len} != {len(buf)}")
    header_end = _HDR.size + header_len
    header = json.loads(bytes(buf[_HDR.size : header_end]))
    return Frame(type=MsgType(mtype), header=header, payload=buf[header_end:])


# ------------------------------------------------------------------ socket IO


def _recv_exact(sock: socket.socket, n: int) -> memoryview:
    """``n`` bytes into one writable buffer. The caller sets the socket's
    deadline. A timeout before any byte is a clean TimeoutError the caller
    may retry; mid-frame the stream is torn, so it becomes a
    ConnectionError."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            r = sock.recv_into(view[got:], n - got)
        except TimeoutError:
            if got == 0:
                raise
            raise ConnectionError(f"peer stalled mid-frame ({got}/{n} bytes)") from None
        if r == 0:
            raise ConnectionError("peer closed connection")
        got += r
    return view


def read_frame(sock: socket.socket) -> Frame:
    head = _recv_exact(sock, _HDR.size)
    magic, frame_len, mtype, header_len = _HDR.unpack_from(head, 0)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    if frame_len > MAX_FRAME_SIZE:
        raise ValueError(f"frame of {frame_len} B exceeds cap {MAX_FRAME_SIZE}")
    # One receive buffer; the payload is a zero-copy (writable) slice of it.
    rest = _recv_exact(sock, frame_len - _HDR.size)
    header = json.loads(bytes(rest[:header_len]))
    return Frame(type=MsgType(mtype), header=header, payload=rest[header_len:])


def write_frame(sock: socket.socket, frame: Frame) -> int:
    """One sendall of the whole frame (one segment run even with Nagle on)."""
    head, frame_len = _frame_head(frame)
    sock.sendall(b"".join((head, frame.payload)))
    return frame_len


# ------------------------------------------------------------------ frames


def hello_frame() -> Frame:
    return Frame(MsgType.HELLO, {"version": __version__})


def worker_info_frame(info: WorkerInfo) -> Frame:
    return Frame(MsgType.WORKER_INFO, {"info": info.to_dict()})


def forward_frame(
    x: WireTensor,
    ranges: list[tuple[int, int]],
    pos: int,
    batch: dict | None = None,
    trace: str | None = None,
    flow: int | None = None,
    sid: str | None = None,
    seq: int | None = None,
) -> Frame:
    """One round trip for one contiguous span (or several on one worker).

    ``batch`` selects the left-padded LOCKSTEP layout (models/llama/batch.py):
      {"kind": "prefill", "pads": [B], "ends": [B]}          pos == 0
      {"kind": "decode",  "pads": [B]}                        pos == slot
      {"kind": "join",    "pads": [1], "ends": [1], "lane": l} pos == 0
    Absent = the single-stream layout (pad-free rows at one position).
    ``trace`` is the request id the worker echoes; ``flow`` a timeline flow
    id (carried, unused by the port). ``sid``/``seq`` travel together: the
    epoch's replay session and the op's number in it, which make a resend
    after a reconnect idempotent (runtime/worker.py)."""
    header = {
        "ranges": [list(r) for r in ranges],
        "pos": int(pos),
        "tensor": x.header(),
    }
    if batch is not None:
        header["batch"] = batch
    if trace is not None:
        header["trace"] = str(trace)
    if flow is not None:
        header["flow"] = int(flow)
    if sid is not None:
        header["sid"] = str(sid)
        header["seq"] = int(seq or 0)
    return Frame(MsgType.FORWARD, header, payload=x.data)


def tensor_frame(x: WireTensor, trace: str | None = None) -> Frame:
    header: dict[str, Any] = {"tensor": x.header()}
    if trace is not None:
        header["trace"] = str(trace)
    return Frame(MsgType.TENSOR, header, payload=x.data)


def reset_frame(sid: str | None = None) -> Frame:
    """New sequence: with ``sid`` drop that session's state, without it this
    connection's KV."""
    if sid is None:
        return Frame(MsgType.RESET, {})
    return Frame(MsgType.RESET, {"sid": str(sid)})


# Machine-readable ERROR codes: retrying either cannot succeed, so the
# client escalates to session-lost recovery instead of spending retries.
ERR_UNKNOWN_SESSION = "unknown-session"  # worker restarted / session evicted
ERR_BAD_SEQ = "bad-seq"                  # sequence gap: state diverged


def error_frame(message: str, code: str | None = None) -> Frame:
    if code is None:
        return Frame(MsgType.ERROR, {"error": message})
    return Frame(MsgType.ERROR, {"error": message, "code": code})


def ping_frame(t: float | None = None) -> Frame:
    """Health probe; a replying worker stamps its wall clock into ``t``."""
    if t is None:
        return Frame(MsgType.PING, {})
    return Frame(MsgType.PING, {"t": round(float(t), 6)})


def stats_request_frame(events: int = 256, timeline: int = 4096) -> Frame:
    """Master -> worker telemetry pull, with caps on the tails it may carry."""
    return Frame(MsgType.STATS, {"events": int(events), "timeline": int(timeline)})


def stats_reply_frame(report: dict) -> Frame:
    return Frame(MsgType.STATS, {"report": report})
