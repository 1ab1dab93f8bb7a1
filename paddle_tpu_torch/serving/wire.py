"""Length-prefixed JSON frame protocol of the serving front end — the
port's copy of paddle_tpu/serving/wire.py (stdlib only), frame for frame
the same bytes, so a client, router or replica of either package talks to
any other.

Every message on the wire is

    [4-byte big-endian unsigned length N][N bytes of UTF-8 JSON]

(the reference's "packet = uint32 length + body", paddle/pserver/
ProtoServer.h:37).  A BINARY frame variant tags the length prefix's high
bit and carries

    [>I : BIN_BIT | N][>I : H][H bytes UTF-8 JSON header][N-4-H raw bytes]

— the header is an ordinary message dict, the raw payload rides behind it
and is attached to the decoded dict under `PAYLOAD_KEY` (the `kv_push`
page blobs of disaggregated prefill/decode).  The server
(serving/server.py, asyncio) and the client (serving/client.py, blocking
sockets) both speak through this module.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional

_LEN = struct.Struct(">I")

#: refuse frames above this — a corrupt/hostile length prefix must not make
#: the receiver allocate gigabytes (64 MiB >> any real request/response)
MAX_FRAME = 64 * 1024 * 1024

#: high bit of the length prefix tags a binary frame (header + raw
#: payload); every JSON frame's length is <= MAX_FRAME << 2^31, so the bit
#: can never be set by accident on a well-formed legacy stream
BIN_BIT = 0x80000000

#: the SERVING tier's binary-frame budget: the replica server and the
#: fleet router read with `bin_cap=MAX_BIN_PAYLOAD`, so a hostile/corrupt
#: BIN length prefix on a front-end socket can never make them buffer
#: tens of megabytes (kv_push senders chunk their page payloads under
#: this).  The cap is OPT-IN per read path — the parameter-server wire
#: legitimately ships whole-shard block frames far above it and keeps the
#: plain MAX_FRAME bound.
MAX_BIN_PAYLOAD = 8 * 1024 * 1024

#: decoded binary frames carry their raw payload under this key (bytes);
#: leading underscore keeps it out of any JSON re-encode by convention
PAYLOAD_KEY = "_payload"

#: wire-protocol version, carried by the `hello` frame both the replica
#: server and the fleet router answer on connect.  Bump on any change a
#: v(n-1) peer could not parse; additive message types/fields do NOT bump
#: it (peers advertise those through `capabilities` instead).
PROTO = 1

#: one-line protocol description, used by error frames answering a
#: malformed FIRST frame — a peer that speaks the wrong protocol (an HTTP
#: client, a bare JSON line, an old binary framing) gets told what this
#: socket expects instead of a silent close.  The fleet router depends on
#: this to classify peers.
PROTO_DESC = (f"paddle_tpu serving wire protocol v{PROTO}: every message "
              f"is [4-byte big-endian length][UTF-8 JSON object]; open "
              f"with a {{\"type\": \"hello\"}} frame to negotiate")


def hello_msg(role: str, **extra) -> dict:
    """The version/capabilities frame a server answers on connect:
    `role` names what kind of peer this is ("replica" for the engine-pump
    server, "router" for the fleet front tier) so a connecting router/ctl
    can classify the far end before routing anything at it."""
    return {"type": "hello", "proto": PROTO, "role": role, **extra}


def get_trace(msg: dict) -> Optional[dict]:
    """Validated distributed-trace context off a wire frame, or None.

    Frames that cross processes (serving `generate`, pserver
    `send_grad`/`barrier`/`get_params`) may carry
    `{"trace": {"trace_id": "<hex>", "parent": "<span id>"}}` —
    docs/observability.md "Distributed tracing".  Malformed contexts are
    dropped, not fatal: tracing must never fail a request, and the
    serving replica server and the parameter server must agree on that
    rule, which is why the validation lives HERE and not in either."""
    tc = msg.get("trace")
    if isinstance(tc, dict) and isinstance(tc.get("trace_id"), str):
        out = {"trace_id": tc["trace_id"]}
        if isinstance(tc.get("parent"), str):
            out["parent"] = tc["parent"]
        return out
    return None


class FrameError(ValueError):
    """Malformed frame: oversized length prefix or non-JSON body."""


def encode(msg: dict) -> bytes:
    """One message -> length-prefixed wire bytes."""
    body = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME:
        raise FrameError(f"frame of {len(body)} bytes exceeds the "
                         f"{MAX_FRAME}-byte cap")
    return _LEN.pack(len(body)) + body


def _decode_body(body: bytes) -> dict:
    try:
        msg = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"frame body is not JSON: {e}") from e
    if not isinstance(msg, dict):
        raise FrameError(f"frame body must be a JSON object, "
                         f"got {type(msg).__name__}")
    return msg


def encode_bin(msg: dict, payload: bytes) -> bytes:
    """One message + raw payload -> binary wire frame (module docstring
    layout).  `msg` must not already carry PAYLOAD_KEY."""
    header = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    n = _LEN.size + len(header) + len(payload)
    if n > MAX_FRAME:
        raise FrameError(f"binary frame of {n} bytes exceeds the "
                         f"{MAX_FRAME}-byte cap")
    return _LEN.pack(BIN_BIT | n) + _LEN.pack(len(header)) \
        + header + payload


def _decode_bin_body(body: bytes) -> dict:
    """Binary frame body -> header dict with the raw payload attached
    under PAYLOAD_KEY."""
    if len(body) < _LEN.size:
        raise FrameError("binary frame too short for its header prefix")
    (h,) = _LEN.unpack(body[:_LEN.size])
    if h > len(body) - _LEN.size:
        raise FrameError(f"binary frame header length {h} overruns the "
                         f"{len(body)}-byte body — corrupt stream?")
    msg = _decode_body(body[_LEN.size:_LEN.size + h])
    msg[PAYLOAD_KEY] = bytes(body[_LEN.size + h:])
    return msg


def check_length(raw: bytes) -> int:
    """Validate a length prefix; returns the body length (binary-frame
    tag bit stripped — use split_length to see it)."""
    return split_length(raw)[0]


def split_length(raw: bytes,
                 bin_cap: Optional[int] = None) -> tuple[int, bool]:
    """Validate a length prefix; returns (body length, is_binary).
    `bin_cap` additionally bounds a BINARY frame's declared body — the
    serving front ends pass MAX_BIN_PAYLOAD so a corrupt/hostile prefix
    is refused BEFORE any buffering, not after 64 MiB of it."""
    (n,) = _LEN.unpack(raw)
    binary = bool(n & BIN_BIT)
    n &= ~BIN_BIT
    if n > MAX_FRAME:
        raise FrameError(f"frame length {n} exceeds the {MAX_FRAME}-byte "
                         f"cap — corrupt stream?")
    if binary and bin_cap is not None and n > bin_cap:
        raise FrameError(f"binary frame length {n} exceeds this "
                         f"endpoint's {bin_cap}-byte binary-frame cap")
    return n, binary


async def read_frame(reader, bin_cap: Optional[int] = None) \
        -> Optional[dict]:
    """One frame from an asyncio StreamReader; None on clean EOF."""
    import asyncio

    try:
        raw = await reader.readexactly(_LEN.size)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    n, binary = split_length(raw, bin_cap=bin_cap)
    try:
        body = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionError) as e:
        raise FrameError(f"stream ended mid-frame ({e})") from e
    return _decode_bin_body(body) if binary else _decode_body(body)


class FrameConn:
    """One accepted client connection on an asyncio frame server — shared
    by the replica server (serving/server.py) and the fleet router
    (fleet/router.py), so the slow-reader discipline can never drift
    between the two front ends:

    a client that stops READING while its streams keep producing would
    grow the transport's send buffer without bound (token frames are
    pushed from loop callbacks, never awaiting drain) — past
    MAX_WRITE_BUFFER the connection is declared dead and closed, which
    surfaces to the owner's handler as EOF (the same path as a
    disconnect, where in-flight work gets cancelled)."""

    _seq = 0
    MAX_WRITE_BUFFER = 8 * 1024 * 1024

    def __init__(self, writer):
        FrameConn._seq += 1
        self.seq = FrameConn._seq
        self.writer = writer
        self.dead = False
        self.rids = {}             # client id -> owner's routing id

    def send(self, msg: dict) -> None:
        self._write(encode(msg))

    def send_bin(self, msg: dict, payload: bytes) -> None:
        """Binary frame variant (header + raw payload) — negotiated via
        hello capabilities; same slow-reader discipline as send()."""
        self._write(encode_bin(msg, payload))

    def _write(self, frame: bytes) -> None:
        if self.dead or self.writer.is_closing():
            return
        try:
            if self.writer.transport.get_write_buffer_size() > \
                    self.MAX_WRITE_BUFFER:
                self.dead = True   # slow reader: sever, don't buffer
                self.writer.close()
                return
            self.writer.write(frame)
        except (ConnectionError, RuntimeError):
            self.dead = True


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None if not buf else buf  # caller distinguishes
        buf += chunk
    return buf


def read_frame_sync(sock: socket.socket,
                    bin_cap: Optional[int] = None) -> Optional[dict]:
    """One frame from a blocking socket; None on clean EOF."""
    raw = _recv_exact(sock, _LEN.size)
    if raw is None:
        return None
    if len(raw) < _LEN.size:
        raise FrameError("stream ended inside a length prefix")
    n, binary = split_length(raw, bin_cap=bin_cap)
    body = _recv_exact(sock, n)
    if body is None or len(body) < n:
        raise FrameError(f"stream ended mid-frame (wanted {n} bytes)")
    return _decode_bin_body(body) if binary else _decode_body(body)


def write_frame_sync(sock: socket.socket, msg: dict) -> None:
    sock.sendall(encode(msg))


def write_frame_bin_sync(sock: socket.socket, msg: dict,
                         payload: bytes) -> None:
    sock.sendall(encode_bin(msg, payload))
