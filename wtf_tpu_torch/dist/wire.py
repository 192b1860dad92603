"""Wire protocol: address scheme + length-prefixed framed messages.

Reference surface (src/wtf/socket.{h,cc}): `tcp://host:port/` and
`unix:///path` address strings (socket.cc:70-225), Listen/Dial with
TCP_NODELAY (socket.cc:227-308), u32-length-prefixed messages
(Send socket.cc:310-323, Receive :325-358).  The reference serializes with
yas binary archives; SURVEY.md §2.6 notes the wire format is an internal
detail, not a contract — this module uses an explicit little-endian struct
layout instead:

  server -> client:  the raw testcase bytes (server.h:720-736 sends just
                     the testcase string)
  client -> server:  u32 testcase_len | testcase
                     u32 n_cov | n_cov * u64 coverage addresses
                     u8 result kind (0 ok, 1 timedout, 2 cr3change, 3 crash,
                                     4 overlay-full: node resource limit —
                                     master requeues the testcase)
                     u16 name_len | crash name utf-8
                     (client.cc:187-200 / server.h:771-779 message shape)
"""

from __future__ import annotations

import errno
import socket
import struct
from typing import Optional, Set, Tuple

from wtf_tpu_torch.core.results import (
    Cr3Change, Crash, Ok, OverlayFull, TestcaseResult, Timedout,
)

MAX_MSG = 64 * 1024 * 1024  # sanity bound on a frame


# ---------------------------------------------------------------------------
# addresses
# ---------------------------------------------------------------------------

def parse_address(address: str):
    """'tcp://host:port/' -> (AF_INET, (host, port));
    'unix:///path' -> (AF_UNIX, path).  (socket.cc:70-225)"""
    if address.startswith("tcp://"):
        rest = address[len("tcp://"):].rstrip("/")
        host, _, port = rest.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad tcp address {address!r}")
        return socket.AF_INET, (host, int(port))
    if address.startswith("unix://"):
        path = address[len("unix://"):]
        if not path:
            raise ValueError(f"bad unix address {address!r}")
        return socket.AF_UNIX, path
    raise ValueError(f"unsupported address scheme {address!r}")


def listen(address: str, backlog: int = 64) -> socket.socket:
    family, addr = parse_address(address)
    sock = socket.socket(family, socket.SOCK_STREAM)
    if family == socket.AF_INET:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.bind(addr)
    sock.listen(backlog)
    return sock


# Connect errors worth retrying inside a dial window: the master not up
# yet (refused / unix socket file missing) plus the transient network
# conditions a rebooting master or flapping route produces.  Anything
# else (bad address family, EACCES, ...) is a configuration error and
# aborts immediately — retrying would just mask it for retry_for seconds.
_TRANSIENT_ERRNOS = frozenset({
    errno.ECONNREFUSED, errno.ECONNRESET, errno.ECONNABORTED,
    errno.EHOSTUNREACH, errno.ENETUNREACH, errno.ENETDOWN,
    errno.ETIMEDOUT, errno.EINTR, errno.EAGAIN,
})


def _transient_connect_error(e: OSError) -> bool:
    if isinstance(e, (ConnectionRefusedError, FileNotFoundError,
                      socket.timeout)):
        return True
    return e.errno in _TRANSIENT_ERRNOS


def dial(address: str, timeout: Optional[float] = None,
         retry_for: float = 0.0) -> socket.socket:
    """Connect to a master.  `retry_for` seconds of connect retries cover
    the node-starts-before-master race (the reference leaves this to the
    operator; nodes here are commonly spawned together with the master)
    AND transient network failures (EHOSTUNREACH/ETIMEDOUT/EINTR/...) —
    a blip must not abort a node that was told to keep trying.  Past the
    deadline the last error re-raises."""
    import time

    family, addr = parse_address(address)
    deadline = time.monotonic() + retry_for
    while True:
        sock = socket.socket(family, socket.SOCK_STREAM)
        if timeout is not None:
            sock.settimeout(timeout)
        try:
            sock.connect(addr)
        except OSError as e:
            sock.close()
            if not _transient_connect_error(e) \
                    or time.monotonic() >= deadline:
                raise
            time.sleep(0.05)
            continue
        if family == socket.AF_INET:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock


# ---------------------------------------------------------------------------
# framing (u32 length prefix, socket.cc:310-358)
# ---------------------------------------------------------------------------

def send_msg(sock: socket.socket, body: bytes) -> None:
    sock.sendall(struct.pack("<I", len(body)) + body)


def recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None  # peer closed
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket) -> Optional[bytes]:
    hdr = recv_exact(sock, 4)
    if hdr is None:
        return None
    (length,) = struct.unpack("<I", hdr)
    if length > MAX_MSG:
        raise ValueError(f"oversized frame ({length} bytes)")
    return recv_exact(sock, length)


# ---------------------------------------------------------------------------
# hello + batch frames (lane multiplexing)
# ---------------------------------------------------------------------------
# Every node opens with a hello frame claiming n_slots.  n_slots == 1 is
# the reference shape (one testcase frame in flight, one result frame
# back).  n_slots > 1 multiplexes a whole lane batch over ONE connection:
# the master sends a batch frame of up to n_slots testcases and the node
# replies with one batch frame of results — what lets a 4096-lane GPU node
# talk to the master through a single fd instead of 4096 (the reference
# is architecturally 1 fd per core, server.h:386-389, and its select()
# master caps out at FD_SETSIZE).

HELLO_MAGIC = b"WTFH"    # v1: server->client frames are raw payloads
HELLO2_MAGIC = b"WTF2"   # v2: server->client frames carry a 1-byte tag
HELLO3_MAGIC = b"WTF3"   # v3: v2 + streaming coverage deltas (fleet tier)

# v2 downstream frame tags.  v1 has no in-band way to distinguish "the
# campaign is over, don't come back" from "the master died" — the raw
# testcase payload can be any bytes, so nothing can ride in-band without
# colliding.  A v2 hello opts the connection into tagged frames:
#   TAG_WORK  payload = one testcase (slots == 1) or a batch frame (mux)
#   TAG_BYE   orderly end (budget done / drain): do NOT reconnect
# v1 clients (and any reference-shaped client) keep getting untagged
# frames and learn about shutdown the way they always did: a close.
#
# v3 (WTF3 hello: 16-byte client identity appended) additionally opts
# the connection into streaming coverage deltas (wtf_tpu_torch/fleet/delta):
#   TAG_CURSOR    master->node, right after the hello: the ack cursor
#                 the master holds for this client identity, so a
#                 reconnecting node resumes sparse deltas instead of
#                 resending its whole bitmap
#   TAG_COVDELTA  node->master: every post-hello upstream frame carries
#                 this tag + a delta-result body (or a batch frame of
#                 delta-result bodies on mux links) — newly-set coverage
#                 bits only, as sparse word-index+mask pairs over the
#                 client's own bit space, with bit->address table
#                 registrations riding alongside
#   TAG_TELEM     node->master (tagged/delta connections): a periodic
#                 telemetry snapshot — the node's CUMULATIVE registry
#                 state plus a digest of recent events, sequence-numbered
#                 per connection epoch.  Pure observability: carries no
#                 campaign state, so the master may drop it on decode
#                 error without touching slot accounting, and a re-sent
#                 frame can never double-count (the aggregator keeps the
#                 latest snapshot per client identity).
TAG_WORK = 0
TAG_BYE = 1
TAG_CURSOR = 2
TAG_COVDELTA = 3
TAG_TELEM = 4

CLIENT_ID_LEN = 16


def encode_hello(n_slots: int, tagged: bool = False) -> bytes:
    return (HELLO2_MAGIC if tagged else HELLO_MAGIC) \
        + struct.pack("<I", n_slots)


def encode_hello_delta(n_slots: int, client_id: bytes) -> bytes:
    """The WTF3 hello: tagged frames + streaming coverage deltas.  The
    client identity survives reconnects (and master restarts, via the
    persisted cursor state) — it is what per-client ack cursors key on."""
    if len(client_id) != CLIENT_ID_LEN:
        raise ValueError(f"client id must be {CLIENT_ID_LEN} bytes")
    return HELLO3_MAGIC + struct.pack("<I", n_slots) + client_id


def decode_hello(body: bytes) -> Optional[int]:
    """n_slots when `body` is a hello frame (any version), else None."""
    if len(body) == 8 and body[:4] in (HELLO_MAGIC, HELLO2_MAGIC):
        return struct.unpack_from("<I", body, 4)[0]
    if len(body) == 8 + CLIENT_ID_LEN and body[:4] == HELLO3_MAGIC:
        return struct.unpack_from("<I", body, 4)[0]
    return None


def hello_is_tagged(body: bytes) -> bool:
    """True when a hello frame opted into tagged downstream frames."""
    return (len(body) == 8 and body[:4] == HELLO2_MAGIC) \
        or hello_is_delta(body)


def hello_is_delta(body: bytes) -> bool:
    """True when a hello frame opted into streaming coverage deltas."""
    return len(body) == 8 + CLIENT_ID_LEN and body[:4] == HELLO3_MAGIC


def hello_client_id(body: bytes) -> Optional[bytes]:
    """The 16-byte client identity of a WTF3 hello, else None."""
    return body[8:] if hello_is_delta(body) else None


def send_work(sock: socket.socket, body: bytes, tagged: bool) -> None:
    """Master->node work frame, tagged per the connection's hello."""
    send_msg(sock, bytes((TAG_WORK,)) + body if tagged else body)


def send_bye(sock: socket.socket) -> None:
    """Orderly-shutdown frame (tagged connections only)."""
    send_msg(sock, bytes((TAG_BYE,)))


def encode_cursor(n_table: int, digest: bytes) -> bytes:
    """Master->node ack-cursor frame body: how many bit->address table
    entries the master holds for this client identity plus an 8-byte
    digest of the whole acked state (table + acked bitmap).  The node
    compares against its own state: match -> resume sparse deltas;
    mismatch (fresh master, lost cursor) -> whole-bitmap resync."""
    if len(digest) != 8:
        raise ValueError("cursor digest must be 8 bytes")
    return bytes((TAG_CURSOR,)) + struct.pack("<I", n_table) + digest


def decode_cursor(payload: bytes) -> Tuple[int, bytes]:
    """(n_table, digest8) of a TAG_CURSOR frame payload."""
    (n_table,) = struct.unpack_from("<I", payload, 0)
    digest = payload[4:12]
    if len(digest) != 8:
        raise ValueError("short cursor frame")
    return n_table, digest


def recv_tagged(sock: socket.socket) -> Optional[Tuple[int, bytes]]:
    """Node-side receive on a tagged connection: (tag, payload), or None
    when the peer closed.  An empty frame is a protocol violation on a
    tagged link (every frame carries at least its tag byte)."""
    body = recv_msg(sock)
    if body is None:
        return None
    if not body:
        raise ValueError("empty frame on tagged connection")
    return body[0], body[1:]


def encode_batch(items) -> bytes:
    """Concatenate length-prefixed blobs into one batch frame body."""
    parts = [struct.pack("<I", len(items))]
    for item in items:
        parts.append(struct.pack("<I", len(item)))
        parts.append(item)
    return b"".join(parts)


def decode_batch(body: bytes) -> list:
    (n,) = struct.unpack_from("<I", body, 0)
    off = 4
    items = []
    for _ in range(n):
        (length,) = struct.unpack_from("<I", body, off)
        off += 4
        items.append(body[off:off + length])
        off += length
    return items


# ---------------------------------------------------------------------------
# result message body
# ---------------------------------------------------------------------------

_KIND = {Ok: 0, Timedout: 1, Cr3Change: 2, Crash: 3, OverlayFull: 4}


def encode_result(testcase: bytes, coverage: Set[int],
                  result: TestcaseResult) -> bytes:
    kind = _KIND[type(result)]
    name = (result.name or "").encode() if isinstance(result, Crash) else b""
    parts = [
        struct.pack("<I", len(testcase)), testcase,
        struct.pack("<I", len(coverage)),
        struct.pack(f"<{len(coverage)}Q", *sorted(coverage)),
        struct.pack("<B", kind),
        struct.pack("<H", len(name)), name,
    ]
    return b"".join(parts)


def decode_result(body: bytes) -> Tuple[bytes, Set[int], TestcaseResult]:
    off = 0

    def take(fmt):
        nonlocal off
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, body, off)
        off += size
        return vals

    (tc_len,) = take("<I")
    testcase = body[off:off + tc_len]
    off += tc_len
    (n_cov,) = take("<I")
    coverage = set(take(f"<{n_cov}Q")) if n_cov else set()
    (kind,) = take("<B")
    (name_len,) = take("<H")
    name = body[off:off + name_len].decode()
    off += name_len
    result: TestcaseResult
    if kind == 0:
        result = Ok()
    elif kind == 1:
        result = Timedout()
    elif kind == 2:
        result = Cr3Change()
    elif kind == 4:
        result = OverlayFull()
    else:
        result = Crash(name or None)
    return testcase, coverage, result


# ---------------------------------------------------------------------------
# delta-result message body (WTF3 / TAG_COVDELTA upstream frames)
# ---------------------------------------------------------------------------
# Where a v1/v2 result ships the lane's WHOLE coverage set (n_cov u64
# addresses — O(covered blocks) per new-coverage result), a delta result
# ships only the bits newly set since the master's last ack:
#
#   u8  flags            bit 0: full resync (master must drop any prior
#                        cursor state for this client before applying)
#   u32 testcase_len | testcase
#   u32 table_base       first bit index of the address registrations
#   u32 n_addrs | n_addrs * u64        bit->address table entries for
#                                      indices [table_base, table_base+n)
#   u32 n_pairs | n_pairs * (u32 word_index, u32 mask)   the delta bits,
#                                      sparse over the client's bit space
#   u8  kind | u16 name_len | name     as in the v1/v2 result body
#   u16 bucket_len | bucket            triage bucket (crash dedup
#                                      service key; empty when unknown)
#
# Bit indices are CLIENT-local (decode order); the table registrations
# are what make them meaningful master-side.  The cursor state machines
# that produce/consume these live in wtf_tpu_torch/fleet/delta.py.

FLAG_FULL = 1


class DeltaFrame:
    """Decoded coverage-delta payload of one result."""

    __slots__ = ("full", "table_base", "addrs", "pairs")

    def __init__(self, full: bool, table_base: int, addrs, pairs):
        self.full = full
        self.table_base = table_base
        self.addrs = list(addrs)
        self.pairs = list(pairs)

    def cov_bytes(self) -> int:
        """Wire bytes of the coverage sections (table_base + n_addrs +
        n_pairs u32 headers, 8 per address, 8 per pair) — the part the
        delta scheme shrinks; testcase/result bytes are common to both
        protocols."""
        return 12 + 8 * len(self.addrs) + 8 * len(self.pairs)


def encode_result_delta(testcase: bytes, result: TestcaseResult,
                        delta: DeltaFrame, bucket: str = "") -> bytes:
    kind = _KIND[type(result)]
    name = (result.name or "").encode() if isinstance(result, Crash) else b""
    bucket_b = bucket.encode()
    pairs_flat = []
    for word, mask in delta.pairs:
        pairs_flat.append(word)
        pairs_flat.append(mask)
    parts = [
        struct.pack("<B", FLAG_FULL if delta.full else 0),
        struct.pack("<I", len(testcase)), testcase,
        struct.pack("<II", delta.table_base, len(delta.addrs)),
        struct.pack(f"<{len(delta.addrs)}Q", *delta.addrs),
        struct.pack("<I", len(delta.pairs)),
        struct.pack(f"<{len(pairs_flat)}I", *pairs_flat),
        struct.pack("<B", kind),
        struct.pack("<H", len(name)), name,
        struct.pack("<H", len(bucket_b)), bucket_b,
    ]
    return b"".join(parts)


def decode_result_delta(body: bytes):
    """-> (testcase, DeltaFrame, result, bucket)."""
    off = 0

    def take(fmt):
        nonlocal off
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, body, off)
        off += size
        return vals

    (flags,) = take("<B")
    (tc_len,) = take("<I")
    testcase = body[off:off + tc_len]
    off += tc_len
    table_base, n_addrs = take("<II")
    addrs = list(take(f"<{n_addrs}Q")) if n_addrs else []
    (n_pairs,) = take("<I")
    flat = take(f"<{2 * n_pairs}I") if n_pairs else ()
    pairs = [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
    (kind,) = take("<B")
    (name_len,) = take("<H")
    name = body[off:off + name_len].decode()
    off += name_len
    (bucket_len,) = take("<H")
    bucket = body[off:off + bucket_len].decode()
    off += bucket_len
    result: TestcaseResult
    if kind == 0:
        result = Ok()
    elif kind == 1:
        result = Timedout()
    elif kind == 2:
        result = Cr3Change()
    elif kind == 4:
        result = OverlayFull()
    else:
        result = Crash(name or None)
    delta = DeltaFrame(bool(flags & FLAG_FULL), table_base, addrs, pairs)
    return testcase, delta, result, bucket


# ---------------------------------------------------------------------------
# telemetry snapshot body (TAG_TELEM upstream frames)
# ---------------------------------------------------------------------------
# Observability piggybacks on the work connection instead of opening a
# second control plane: once per node heartbeat the client ships its
# CUMULATIVE Registry.snapshot() plus a short digest of recent events.
# The payload is JSON — telemetry names are an open set (tenant
# namespaces, backend counters) and this frame is heartbeat-rate, not
# per-testcase, so schema flexibility beats struct packing here.  The
# u32 seq is per connection epoch and strictly increasing; the master's
# aggregator drops seq <= last-applied for the same client identity, so
# a frame replayed across a reconnect can never double-count.

def encode_telem(seq: int, snapshot: dict, events=()) -> bytes:
    """Body of a TAG_TELEM frame (tag byte NOT included, matching
    encode_result_delta): u32 seq | json({"snapshot", "events"})."""
    import json

    payload = json.dumps({"snapshot": snapshot, "events": list(events)},
                         default=str).encode()
    return struct.pack("<I", seq) + payload


def decode_telem(body: bytes) -> Tuple[int, dict, list]:
    """-> (seq, snapshot, events) of a TAG_TELEM frame payload."""
    import json

    (seq,) = struct.unpack_from("<I", body, 0)
    payload = json.loads(body[4:].decode())
    return seq, payload.get("snapshot", {}), payload.get("events", [])
