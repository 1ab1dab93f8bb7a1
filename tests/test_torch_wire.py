"""PyTorch port: the serving wire (serving/wire.py) and the kv_push
framing (serving/server.py `_kv_push_frames`) against the JAX package,
byte for byte.

The same JSON and BIN messages encode to the same bytes in both packages,
each package decodes the other's frames (blocking sockets and asyncio
streams alike), the length-prefix checks agree on every prefix with the
same `FrameError` text, and a kv_push blob splits into the same frames.
Exact: no tolerance."""

import asyncio
import json
import socket

import pytest

import paddle_tpu.serving.server as jserver
import paddle_tpu.serving.wire as jwire
import paddle_tpu_torch.serving.server as pserver
import paddle_tpu_torch.serving.wire as pwire

MESSAGES = [
    {"type": "hello"},
    {"type": "ping"},
    {"type": "generate", "id": 3, "prompt": [1, 2, 3], "max_new": 4,
     "temperature": 0.0, "stream": True, "timeout_s": 2.5},
    {"type": "generate", "id": "r-1", "prompt": list(range(300)),
     "trace": {"trace_id": "ab" * 16, "parent": "cd" * 8},
     "prefill_only": True, "push_to": {"host": "127.0.0.1", "port": 1}},
    {"type": "token", "id": "a", "token": 5, "index": 0, "burst": 4},
    {"type": "done", "id": 7, "tokens": [1, 2, 3], "reason": "length",
     "timing": {"queue_ms": 0.125, "prefill_ms": 1e-7, "total_ms": 1e12},
     "push_ok": False, "push_error": "peer closed"},
    {"type": "error", "id": None, "error": "ünïcode ✓   \"quoted\""},
    {"type": "overload", "id": 1, "reason": "queue_full", "inflight": 6,
     "max_inflight": 6},
    {"type": "stats", "latency_ms": {"p50": 0.1, "p99": float(2 ** 60)},
     "spec_slot_accept_ewma": [None, 0.25], "draining": False},
    {"nested": {"a": [[], {}, [1, [2, [3]]]], "b": -0.0, "c": 1e-300}},
]

BINARY = [
    ({"type": "kv_push", "id": "a", "seq": 0, "last": False,
      "tokens": [1, 2], "meta": {"n_pages": 1, "layers": []}},
     bytes(range(256)) * 5),
    ({"type": "kv_push", "id": 9, "seq": 3, "last": True}, b""),
    ({"type": "send_grad", "blocks": ["w"]}, b"\x00\xff" * 1000),
]


def test_constants_equal():
    for name in ("MAX_FRAME", "BIN_BIT", "MAX_BIN_PAYLOAD", "PAYLOAD_KEY",
                 "PROTO", "PROTO_DESC"):
        assert getattr(pwire, name) == getattr(jwire, name), name
    assert pwire.FrameConn.MAX_WRITE_BUFFER == jwire.FrameConn.MAX_WRITE_BUFFER


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_json_frames_are_the_same_bytes(i):
    msg = MESSAGES[i]
    assert pwire.encode(msg) == jwire.encode(msg)
    n, binary = pwire.split_length(pwire.encode(msg)[:4])
    assert (n, binary) == jwire.split_length(jwire.encode(msg)[:4])
    assert not binary


@pytest.mark.parametrize("i", range(len(BINARY)))
def test_bin_frames_are_the_same_bytes(i):
    msg, payload = BINARY[i]
    frame = pwire.encode_bin(msg, payload)
    assert frame == jwire.encode_bin(msg, payload)
    assert pwire.split_length(frame[:4]) == jwire.split_length(frame[:4])
    assert pwire.split_length(frame[:4])[1]


def _read_sync(wire_mod, data: bytes, **kw):
    """Every frame of `data` through `read_frame_sync` over a socketpair,
    then what the reader says at the end (None or the FrameError)."""
    a, b = socket.socketpair()
    try:
        b.sendall(data)
        b.close()
        out = []
        while True:
            try:
                msg = wire_mod.read_frame_sync(a, **kw)
            except wire_mod.FrameError as e:
                return out + [("FrameError", str(e))]
            out.append(msg)
            if msg is None:
                return out
    finally:
        a.close()


def _read_async(wire_mod, data: bytes, **kw):
    async def run():
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        out = []
        while True:
            try:
                msg = await wire_mod.read_frame(reader, **kw)
            except wire_mod.FrameError as e:
                return out + [("FrameError", str(e))]
            out.append(msg)
            if msg is None:
                return out
    return asyncio.run(run())


STREAM = b"".join([jwire.encode(m) for m in MESSAGES]
                  + [jwire.encode_bin(m, p) for m, p in BINARY])


@pytest.mark.parametrize("reader", [_read_sync, _read_async],
                         ids=["sync", "asyncio"])
@pytest.mark.parametrize("cut", [None, 3, 50, -7],
                         ids=["whole", "in-prefix", "mid-frame", "mid-bin"])
def test_readers_decode_the_other_package_frames(reader, cut):
    """Each package reads the other's stream to the same messages, the
    same clean end or the same FrameError on a cut stream."""
    data = STREAM if cut is None else STREAM[:cut]
    port_bytes = b"".join([pwire.encode(m) for m in MESSAGES]
                          + [pwire.encode_bin(m, p) for m, p in BINARY])
    assert port_bytes == STREAM
    got, want = reader(pwire, data), reader(jwire, data)
    assert got == want
    if cut is None:
        assert got[-1] is None and len(got) == len(MESSAGES) + len(BINARY) + 1
        assert got[len(MESSAGES)][pwire.PAYLOAD_KEY] == BINARY[0][1]
    else:
        assert got[-1] is None or got[-1][0] == "FrameError"


PREFIXES = [
    (0).to_bytes(4, "big"), (17).to_bytes(4, "big"),
    (64 << 20).to_bytes(4, "big"), ((64 << 20) + 1).to_bytes(4, "big"),
    (0x80000000 | 100).to_bytes(4, "big"),
    (0x80000000 | (8 << 20)).to_bytes(4, "big"),
    (0x80000000 | ((8 << 20) + 1)).to_bytes(4, "big"),
    (0xFFFFFFFF).to_bytes(4, "big"),
]


@pytest.mark.parametrize("raw", PREFIXES, ids=lambda r: r.hex())
@pytest.mark.parametrize("cap", [None, 8 << 20], ids=["no-cap", "bin-cap"])
def test_length_prefix_checks_agree(raw, cap):
    def check(w):
        try:
            return w.split_length(raw, bin_cap=cap), w.check_length(raw)
        except w.FrameError as e:
            return "FrameError", str(e)
    assert check(pwire) == check(jwire)


def test_caps_raise_the_same_frame_errors(monkeypatch):
    """Over MAX_FRAME (both encoders), a bad header length and a non-JSON
    or non-object body: the same FrameError text."""
    for w in (pwire, jwire):
        monkeypatch.setattr(w, "MAX_FRAME", 64)

    def errors(w):
        out = []
        for fn in (lambda: w.encode({"x": "y" * 100}),
                   lambda: w.encode_bin({"x": 1}, b"z" * 100),
                   lambda: w._decode_bin_body(b"\x00\x00\x01\x00{}"),
                   lambda: w._decode_bin_body(b"\x00\x00"),
                   lambda: w._decode_body(b"[1, 2]"),
                   lambda: w._decode_body(b"\xff\xfe"),
                   lambda: w._decode_body(b"{bad json")):
            with pytest.raises(w.FrameError) as e:
                fn()
            out.append(str(e.value))
        return out
    assert errors(pwire) == errors(jwire)


@pytest.mark.parametrize("msg", [
    {}, {"trace": "x"}, {"trace": {"trace_id": 3}},
    {"trace": {"trace_id": "t"}},
    {"trace": {"trace_id": "t", "parent": "p", "extra": 1}},
    {"trace": {"trace_id": "t", "parent": 5}}])
def test_trace_context_and_hello_agree(msg):
    assert pwire.get_trace(msg) == jwire.get_trace(msg)
    assert pwire.hello_msg("replica", a=1) == jwire.hello_msg("replica", a=1)


@pytest.mark.parametrize("n_tokens,payload_len", [
    (4, 0), (16, 1000), (300, 3 * (8 << 20) + 17), (40_000, 9 << 20)])
def test_kv_push_frames_split_alike(n_tokens, payload_len):
    """A blob over the binary-frame cap splits into the same BIN frames,
    part 0 sized from its encoded header (long prompts' headers too)."""
    toks = [(i * 7) % 31999 for i in range(n_tokens)]
    meta = {"n_pages": max(1, n_tokens // 16), "page_size": 16,
            "layers": [{"name": f"blk{i}_attn", "dtype": "bfloat16",
                        "h_kv": 8, "dh": 64} for i in range(8)]}
    payload = bytes(range(251)) * (payload_len // 251) + \
        b"\x07" * (payload_len % 251)
    got = pserver._kv_push_frames("r1", toks, meta, payload)
    assert got == jserver._kv_push_frames("r1", toks, meta, payload)
    assert all(len(f) - 4 <= pwire.MAX_BIN_PAYLOAD for f in got)
    head = json.loads(got[0][8:8 + int.from_bytes(got[0][4:8], "big")])
    assert head["tokens"] == toks and head["last"] == (len(got) == 1)


def test_kv_push_header_over_the_cap_raises_alike(monkeypatch):
    for w in (pwire, jwire):
        monkeypatch.setattr(w, "MAX_BIN_PAYLOAD", 512)
    msgs = []
    for srv in (pserver, jserver):
        with pytest.raises(srv.wire.FrameError) as e:
            srv._kv_push_frames(0, list(range(200)), {"n_pages": 1}, b"x")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
