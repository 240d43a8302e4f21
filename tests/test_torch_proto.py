"""The port's wire codec (``cake_tpu_torch/runtime/proto.py``) against the
JAX package's (``cake_tpu/runtime/proto.py``): every kind of frame has the
same bytes for the same arguments, each package decodes the other's frames,
bad magic and oversize frames are refused, and bf16 activations cross the
wire bitwise (``torch_to_wire`` / ``wire_to_torch``)."""

import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.runtime import proto as jproto
from cake_tpu.runtime.worker import jax_to_wire, wire_to_jax
from cake_tpu_torch.runtime import proto
from cake_tpu_torch.runtime.worker import torch_to_wire, wire_to_torch

X = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
INFO = dict(dtype="f32", os="Linux", arch="x86_64", device="cpu", device_count=1,
            latency_ms=1.25, ranges=[[0, 2], [4, 6]], batch_ops=True)


def _frames(p):
    x = p.WireTensor.from_numpy(X)
    return {
        "hello": p.hello_frame(),
        "worker_info": p.worker_info_frame(p.WorkerInfo(**INFO)),
        "forward": p.forward_frame(x, [(0, 2), (4, 6)], 7),
        "forward_batch": p.forward_frame(
            x, [(0, 2)], 0, batch={"kind": "prefill", "pads": [3, 0], "ends": [16, 16]},
            trace="req-1", flow=5, sid="ep-abc", seq=3,
        ),
        "forward_join": p.forward_frame(
            x, [(2, 4)], 0, batch={"kind": "join", "pads": [9], "ends": [12], "lane": 1},
            sid="seq-x", seq=0,
        ),
        "tensor": p.tensor_frame(x),
        "tensor_traced": p.tensor_frame(x, trace="req-2"),
        "reset": p.reset_frame(),
        "reset_sid": p.reset_frame(sid="ep-abc"),
        "error": p.error_frame("boom"),
        "error_coded": p.error_frame("gone", code=p.ERR_UNKNOWN_SESSION),
        "error_bad_seq": p.error_frame("gap", code=p.ERR_BAD_SEQ),
        "ping": p.ping_frame(),
        "ping_t": p.ping_frame(t=1234.5678901),
        "stats_request": p.stats_request_frame(events=8, timeline=16),
        "stats_reply": p.stats_reply_frame({"node": "w1", "wall": 1.5}),
    }


PORT, JAX = _frames(proto), _frames(jproto)


@pytest.mark.parametrize("name", sorted(PORT))
def test_frame_bytes_equal_the_jax_package(name):
    assert proto.encode_frame(PORT[name]) == jproto.encode_frame(JAX[name])


@pytest.mark.parametrize("name", sorted(PORT))
def test_each_package_decodes_the_others_frames(name):
    ours = proto.decode_frame(memoryview(jproto.encode_frame(JAX[name])))
    theirs = jproto.decode_frame(memoryview(proto.encode_frame(PORT[name])))
    for got, want in ((ours, JAX[name]), (theirs, PORT[name])):
        assert int(got.type) == int(want.type)
        assert got.header == want.header
        assert bytes(got.payload) == bytes(want.payload)


def test_constants_and_worker_info_fields_match():
    assert proto.MAGIC == jproto.MAGIC and proto.MAX_FRAME_SIZE == jproto.MAX_FRAME_SIZE
    assert {m.name: int(m) for m in proto.MsgType} == {m.name: int(m) for m in jproto.MsgType}
    assert (proto.ERR_UNKNOWN_SESSION, proto.ERR_BAD_SEQ) == (
        jproto.ERR_UNKNOWN_SESSION, jproto.ERR_BAD_SEQ)
    info = jproto.WorkerInfo.from_dict(proto.WorkerInfo(**INFO).to_dict())
    assert info.to_dict() == jproto.WorkerInfo(**INFO).to_dict()


def test_bad_magic_and_oversize_frames_are_refused(monkeypatch):
    data = bytearray(proto.encode_frame(PORT["forward"]))
    data[0] ^= 0xFF
    with pytest.raises(ValueError, match="bad magic"):
        proto.decode_frame(memoryview(bytes(data)))
    for head, error in ((bytes(data[:proto._HDR.size]), "bad magic"),
                        # A header announcing a frame past the cap is refused
                        # before its body is read.
                        (proto._HDR.pack(proto.MAGIC, 65, 3, 2), "exceeds cap")):
        monkeypatch.setattr(proto, "MAX_FRAME_SIZE", 64 if error == "exceeds cap" else 2**29)
        a, b = socket.socketpair()
        try:
            a.sendall(head)
            with pytest.raises(ValueError, match=error):
                proto.read_frame(b)
        finally:
            a.close()
            b.close()
    with pytest.raises(ValueError, match="exceeds cap"):
        proto.encode_frame(PORT["forward"])


def test_socket_round_trip_and_mid_frame_close():
    a, b = socket.socketpair()
    try:
        proto.write_frame(a, PORT["forward_batch"])
        got = proto.read_frame(b)
        assert got.header == PORT["forward_batch"].header
        np.testing.assert_array_equal(got.tensor().to_numpy(), X)
        a.sendall(proto.encode_frame(PORT["forward"])[:20])
        a.close()
        with pytest.raises(ConnectionError):
            proto.read_frame(b)
    finally:
        b.close()


def test_bf16_round_trips_bitwise_and_matches_the_jax_encoding():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 64, generator=g).to(torch.bfloat16)
    x[0, 0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.0])
    wire = torch_to_wire(x)
    assert wire.dtype == "bf16" and wire.shape == (2, 5, 64)
    frame = proto.decode_frame(memoryview(proto.encode_frame(proto.tensor_frame(wire))))
    back = wire_to_torch(frame.tensor(), torch.bfloat16)
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
    # The JAX package reads the same bytes as the same bf16 values, and
    # encodes them back to the same bytes.
    jx = wire_to_jax(frame.tensor(), jnp.bfloat16)
    assert bytes(jax_to_wire(jx).data) == bytes(wire.data)


def test_f32_into_bf16_narrows_round_to_nearest_even():
    v = np.array([1.0 + 2**-8, 1.0 + 3 * 2**-8, -3.0e38, 1e-40], np.float32)
    t = proto.WireTensor.from_numpy(v)
    got = wire_to_torch(t, torch.bfloat16)
    want = np.asarray(wire_to_jax(t, jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    assert wire_to_torch(t, torch.float32).numpy().tobytes() == v.tobytes()
