"""The port's fleet tier (wtf_tpu_torch/fleet) against the JAX package's
(wtf_tpu/fleet), on the CPU; held against tests/test_fleet.py.

  * the delta codecs and cursors byte for byte: the address cursor's
    frames along a scripted exchange (loss, reconnect, resync, revoked
    results), the bitmap cursor's lane bodies, `pairs_of`,
    `cursor_digest` and the master cursor's summaries and state
  * `ServerCursor` rejects protocol violations, and the master evicts its
    cursors LRU and never one with a live connection
  * the content-addressed store: dedup and journal, bucket dedup, a torn
    journal tail, namespaces, fsck and repair, `fleet fsck` against the
    JAX CLI's, and the same blob tree and journal bytes as the JAX store
    for the same puts; `Corpus` as a view of the store
  * the GPU node's three wires (one link per lane with whole coverage
    sets, one link per lane with address deltas, one mux link with the
    bitmap cursor) end with the same aggregate coverage (the counterpart
    of test_batch_client_delta_matches_bitmap)
  * `fleet soak` small: the reports' deterministic fields equal the JAX
    soak's, its bars hold
  * `FleetTelemetry`'s exports equal the JAX package's for the same frames
    and clock, and `status` renders the same lines as the JAX CLI
"""

import contextlib
import io
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from test_harness import BENIGN

from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
# one torch thread in the port's processes: their tensors are narrow
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def _both(name: str):
    """(JAX module, port module) of wtf_tpu.<name>."""
    import importlib

    return (importlib.import_module(f"wtf_tpu.{name}"),
            importlib.import_module(f"wtf_tpu_torch.{name}"))


# ---------------------------------------------------------------------------
# delta codecs and cursors
# ---------------------------------------------------------------------------

def _script(delta, wire, results, cid):
    """One scripted exchange through `delta` (a fleet.delta module) and
    `wire`: every frame's bytes, the master cursor's summaries and its
    persisted state.  Covers sparse flow, a lost frame repaired by
    re-extraction, the pending fold, a fresh master's full resync and
    revoked (timeout) results."""
    out = []
    client = delta.AddressDeltaCursor(client_id=cid)
    server = delta.ServerCursor()

    def exchange(cov, result=None, ack=True, apply=True):
        body = client.encode_result(b"t", result or results.Ok(), cov)
        out.append(body)
        _, frame, _, _ = wire.decode_result_delta(body)
        if apply:
            out.append(sorted(server.apply(frame)))
        if ack:
            client.on_ack()

    client.on_cursor(*server.summary())
    exchange({0x10, 0x20, 0x30})
    exchange({0x10, 0x20})
    exchange({0x40}, ack=False, apply=False)      # lost
    client.on_cursor(*server.summary())
    exchange({0x50})                               # repaired
    exchange({0x60}, ack=False)                    # applied, ack lost
    client.on_cursor(*server.summary())            # the fold
    exchange({0x60})
    out.append(client.encode_empty(b"hang", results.Timedout()))
    fresh = delta.ServerCursor()
    client.on_cursor(*fresh.summary())             # full resync
    server = fresh
    exchange({0x70} | {0x1000 + 16 * i for i in range(40)})
    out.append((server.summary(), server.state(), client.full_resyncs,
                client.wants_full))
    words = np.zeros(9, np.uint32)
    words[[0, 3, 8]] = [0x80000001, 5, 0xFFFFFFFF]
    out.append(delta.pairs_of(words))
    out.append(delta.cursor_digest(server.table, server.words,
                                   len(server.table)))
    return out


def test_address_cursor_exchange_is_byte_equal():
    (jd, pd), (jw, pw), (jr, pr) = (_both("fleet.delta"),
                                    _both("dist.wire"),
                                    _both("core.results"))
    cid = bytes(range(16))
    assert _script(pd, pw, pr, cid) == _script(jd, jw, jr, cid)


class _Cache:
    def __init__(self, rips):
        self.rips = rips
        self.count = len(rips)

    def rip_of(self, idx):
        return self.rips[idx]


class _Backend:
    """What BitmapDeltaCursor reads of a batched backend: the decode
    cache's entry rips."""

    def __init__(self, rips):
        self.runner = type("R", (), {"cache": _Cache(rips)})()


def _bitmap_bodies(delta, results, seed):
    rng = np.random.default_rng(seed)
    rips = [0x1400001000 + 7 * i for i in range(70)]
    backend = _Backend(rips[:40])
    cursor = delta.BitmapDeltaCursor(backend, client_id=b"\x05" * 16)
    server = delta.ServerCursor()
    cursor.on_cursor(*server.summary())
    bodies = []
    for round_ in range(3):
        claimed = np.zeros(3, np.uint32)
        for lane in range(5):
            words = (rng.integers(0, 2**32, 3, dtype=np.uint64)
                     & rng.integers(0, 2**32, 3, dtype=np.uint64)
                     ).astype(np.uint32)
            words[1] &= (1 << (backend.runner.cache.count - 32)) - 1
            words[2] = 0
            result = results.Ok() if lane % 3 else results.Crash("crash-x")
            bodies.append(cursor.encode_lane(b"tc%d" % lane, result,
                                             None if lane == 4 else words,
                                             claimed, bucket="b" * lane,
                                             first=lane == 0))
        cursor.on_ack()
        backend.runner.cache.count = 40 + 10 * (round_ + 1)
        backend.runner.cache.rips = rips
    return bodies


def test_bitmap_cursor_lane_bodies_are_byte_equal():
    (jd, pd), (jr, pr) = _both("fleet.delta"), _both("core.results")
    assert _bitmap_bodies(pd, pr, 3) == _bitmap_bodies(jd, jr, 3)


def test_server_cursor_rejects_protocol_violations():
    from wtf_tpu_torch.dist import wire
    from wtf_tpu_torch.fleet.delta import ServerCursor

    server = ServerCursor()
    with pytest.raises(ValueError):   # registration gap
        server.apply(wire.DeltaFrame(False, 5, [0x1], []))
    server.apply(wire.DeltaFrame(False, 0, [0x1, 0x2], [(0, 0b11)]))
    with pytest.raises(ValueError):   # conflicting re-registration
        server.apply(wire.DeltaFrame(False, 0, [0x999], []))
    with pytest.raises(ValueError):   # bit beyond the table
        server.apply(wire.DeltaFrame(False, 2, [], [(1, 0x1)]))
    assert server.apply(wire.DeltaFrame(False, 0, [0x1, 0x2],
                                        [(0, 0b01)])) == {0x1}
    clone = ServerCursor.from_state(server.state())
    assert clone.summary() == server.summary()


def test_server_cursor_eviction_is_bounded_and_lru():
    from wtf_tpu_torch.dist.server import Server, _Conn
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.mutator import TlvStructureMutator

    rng = random.Random(3)
    server = Server("tcp://127.0.0.1:0/", TlvStructureMutator(rng, 16),
                    Corpus(rng=rng), cursor_cap=2)
    conns = []
    for i in range(3):
        conn = _Conn()
        conn.client_id = f"{i:032x}"
        conns.append(conn)
        server._cursor_for(conn)
    server._cursors["0" * 32].last_seen = 0.0  # oldest: client 0
    server._evict_cursors()
    assert len(server._cursors) == 2
    assert "0" * 32 not in server._cursors
    assert server.registry.counter("fleet.cursor_evictions").value == 1
    server._clients = {object(): conns[1]}
    server._cursors[conns[1].client_id].last_seen = 0.0
    server.cursor_cap = 1
    server._evict_cursors()
    assert conns[1].client_id in server._cursors
    assert len(server._cursors) == 1


# ---------------------------------------------------------------------------
# the content-addressed store
# ---------------------------------------------------------------------------

PUTS = [(b"hello", {}), (b"hello", {}), (b"crash-a", {
    "kind": "crash", "name": "crash-w-0x1", "bucket": "write.0x1.aa"}),
    (b"crash-b", {"kind": "crash", "name": "crash-w-0x1",
                  "bucket": "write.0x1.aa"}),
    (b"crash-c", {"kind": "crash", "bucket": "read.0x2.bb"}),
    (bytes(range(256)) * 9, {"name": "big"})]


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _fill(store_mod, registry_mod, root: Path):
    reg = registry_mod.Registry()
    store = store_mod.FleetStore(root, registry=reg)
    got = [store.put(data, **kw) for data, kw in PUTS]
    ns = store.namespace("tenant-a")
    got.append(ns.put(b"payload"))
    counters = {k: reg.counter(k).value for k in (
        "fleet.store_puts", "fleet.store_dedup", "fleet.bucket_dedup")}
    return got, counters, sorted(store.buckets)


def test_store_matches_jax_store(tmp_path):
    """The same puts leave the same blob tree and journal bytes, the same
    (digest, accepted) answers and the same counters."""
    (js, ps), (jt, pt) = _both("fleet.store"), _both("telemetry")
    assert _fill(ps, pt, tmp_path / "port") == \
        _fill(js, jt, tmp_path / "jax")
    tree = _tree(tmp_path / "port")
    assert tree == _tree(tmp_path / "jax")
    assert "default/manifest.jsonl" in tree
    assert "tenant-a/manifest.jsonl" in tree


def test_store_dedup_journal_and_torn_tail(tmp_path):
    from wtf_tpu_torch.fleet.store import FleetStore
    from wtf_tpu_torch.telemetry import Registry
    from wtf_tpu_torch.utils.hashing import hex_digest

    reg = Registry()
    store = FleetStore(tmp_path / "store", registry=reg)
    digest, new = store.put(b"hello")
    assert new and digest == hex_digest(b"hello")
    assert store.blob_path(digest).parent.name == digest[:2]  # fanout
    assert store.put(b"hello") == (digest, False)
    assert reg.counter("fleet.store_dedup").value == 1
    store.put(b"two")
    with open(store.journal_path, "a") as fh:
        fh.write('{"digest": "torn-mid-')  # kill mid-append
    again = FleetStore(tmp_path / "store")
    assert len(again) == 2 and again.get(digest) == b"hello"
    a, b = again.namespace("tenant-a"), again.namespace("tenant-b")
    da, _ = a.put(b"payload")
    assert a.has(da) and not b.has(da) and not again.has(da)


def _fsck(pkg: str, store: Path, *extra) -> tuple:
    import importlib

    cli = importlib.import_module(f"{pkg}.cli")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["fleet", "fsck", "--store", str(store), *extra])
    return rc, out.getvalue()


def test_fsck_recovers_torn_blob_and_lost_journal(tmp_path):
    """The RUNBOOK drill, with `fleet fsck` printing what the JAX CLI
    prints on the same store."""
    from wtf_tpu_torch.fleet.store import FleetStore

    root = tmp_path / "store"
    store = FleetStore(root)
    d_ok, _ = store.put(b"intact")
    d_torn, _ = store.put(b"will-be-torn-by-a-kill")
    store.blob_path(d_torn).write_bytes(b"will-")
    rc, line = _fsck("wtf_tpu_torch", root)
    assert (rc, line) == _fsck("wtf_tpu", root)
    assert rc == 1 and "1 torn" in line
    report = FleetStore(root).verify(repair=True)
    assert report["torn"] == [d_torn]
    recovered = FleetStore(root)
    assert recovered.has(d_ok) and not recovered.has(d_torn)
    recovered.journal_path.unlink()
    rebuilt = FleetStore(root)
    assert len(rebuilt) == 0
    assert rebuilt.verify(repair=True)["orphans"] == [d_ok]
    assert FleetStore(root).get(d_ok) == b"intact"
    rc, line = _fsck("wtf_tpu_torch", root)
    assert (rc, line) == _fsck("wtf_tpu", root)
    assert rc == 0 and "1/1 blobs ok, 0 torn" in line


def test_corpus_outputs_is_a_view_of_the_store(tmp_path):
    from wtf_tpu_torch.fleet.store import FleetStore
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.utils.hashing import hex_digest

    store = FleetStore(tmp_path / "store")
    corpus = Corpus(outputs_dir=tmp_path / "outputs", store=store)
    assert corpus.add(b"finding")
    digest = hex_digest(b"finding")
    assert (tmp_path / "outputs" / digest).read_bytes() == b"finding"
    assert store.get(digest) == b"finding"
    assert not corpus.add(b"finding")


# ---------------------------------------------------------------------------
# the GPU node's three wires
# ---------------------------------------------------------------------------

WIRES = {"per-lane whole sets": ["--no-cov-delta"],
         "per-lane deltas": [],
         "mux deltas": ["--mux"]}


def test_batch_client_delta_matches_bitmap(tmp_path):
    """A 4-lane port node on each wire, against a port master at equal
    seeds (both through the CLI, the three campaigns at once): the same
    aggregate coverage; the mux node holds one delta cursor for its whole
    lane batch, the per-lane node four."""
    procs = {}
    for key, flags in WIRES.items():
        root = tmp_path / key.replace(" ", "-")
        (root / "t" / "inputs").mkdir(parents=True)
        (root / "t" / "inputs" / "seed").write_bytes(BENIGN)
        addr = f"unix://{root}/m.sock"
        master = subprocess.Popen(
            [sys.executable, "-m", "wtf_tpu_torch", "master", "--name",
             "demo_tlv", "--runs", "24", "--seed", "65255", "--max_len",
             "128", "--target", str(root / "t"), "--address", addr,
             "--telemetry-dir", str(root / "telem")],
            cwd=REPO, env=ENV, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        deadline = time.monotonic() + 120
        while not (root / "m.sock").exists():
            assert master.poll() is None and time.monotonic() < deadline, \
                master.communicate()[1][-2000:]
            time.sleep(0.05)
        node = subprocess.Popen(
            [sys.executable, "-m", "wtf_tpu_torch", "fuzz", "--name",
             "demo_tlv", "--lanes", "4", "--limit", "50000", "--device",
             "cpu", "--address", addr, *flags],
            cwd=REPO, env=ENV, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs[key] = (root, master, node)
    got = {}
    for key, (root, master, node) in procs.items():
        for proc in (node, master):
            _, err = proc.communicate(timeout=600)
            assert proc.returncode in (0, 2), err[-2000:]
        doc = json.loads((root / "t" / "coverage.cov").read_text())
        end = [json.loads(ln) for ln in
               (root / "telem" / "events.jsonl").read_text().splitlines()
               if '"run-end"' in ln][-1]["metrics"]
        got[key] = (doc["addresses"], len(doc.get("cursors", {})),
                    end.get("fleet.delta_frames", 0),
                    end["campaign.testcases"])
    want = got["per-lane whole sets"]
    assert want[0] and want[1:] == (0, 0, 25)
    assert got["per-lane deltas"][0] == want[0]
    assert got["mux deltas"][0] == want[0]
    assert got["per-lane deltas"][1:] == (4, 25, 25)
    assert got["mux deltas"][1] == 1 and got["mux deltas"][2] > 0


# ---------------------------------------------------------------------------
# the soak and the fleet telemetry
# ---------------------------------------------------------------------------

DETERMINISTIC = ("clients", "runs", "accounted", "scripted_drops",
                 "scripted_resets")


def test_fleet_soak_small_matches_jax(tmp_path):
    (js, ps) = _both("fleet.soak")
    kw = dict(clients=16, runs_per_client=25, threads=4, seed=0xF1EE7,
              min_ratio=10.0)
    port = ps.run_soak(tmp_path / "port", **kw)
    ref = js.run_soak(tmp_path / "jax", **kw)
    assert {k: port[k] for k in DETERMINISTIC} == \
        {k: ref[k] for k in DETERMINISTIC}
    assert port["accounted"] == port["runs"] + 2
    assert port["delta_ratio"] >= 10.0
    assert port["reclaimed"] >= 1
    assert port["store_puts"] > 0


def test_fleet_smoke_passes(capsys):
    from wtf_tpu_torch.testing import fleet_smoke

    assert fleet_smoke.main([str(0xF1EE7)]) == 0
    assert "fleet-smoke PASS" in capsys.readouterr().out


def _telemetry(mod, metrics_mod, export: Path):
    """Three nodes' frames (one a duplicate, one a reconnect) through a
    FleetTelemetry on a fixed clock; returns its exports."""
    clock = iter(float(t) for t in range(1000, 1100))
    fleet = mod.FleetTelemetry(export_dir=export, clock=lambda: next(clock))
    for node, seq, n in ((b"\x01" * 16, 0, 10), (b"\x01" * 16, 1, 30),
                         (b"\x01" * 16, 1, 30), (b"\x02" * 16, 0, 7),
                         (b"\x02" * 16, 0, 9), (b"\x03" * 16, 4, 2)):
        reg = metrics_mod.Registry()
        reg.counter("campaign.testcases").inc(n)
        reg.counter("campaign.crashes").inc(n // 10)
        reg.counter("dist.cov_bytes_delta").inc(100 * n)
        reg.counter("dist.cov_bytes_bitmap").inc(4000 * n)
        reg.gauge("device.fused_steps").set(n)
        fleet.apply(node, seq, reg.snapshot(), [{"type": "retry"}])
    fleet.close()
    return {p.name: p.read_text() for p in sorted(export.iterdir())}


def test_fleet_telemetry_exports_match_jax(tmp_path):
    (jf, pf), (jm, pm) = _both("fleet.telemetry"), _both("telemetry")
    port = _telemetry(pf, pm, tmp_path / "port")
    assert port == _telemetry(jf, jm, tmp_path / "jax")
    assert set(port) == {"fleet-telem.jsonl", "status.json",
                         "telemetry.prom"}
    doc = json.loads(port["status.json"])
    assert doc["nodes"] == 3 and doc["duplicates_dropped"] == 1


def _status(pkg: str, d: Path, *extra) -> tuple:
    import importlib

    cli = importlib.import_module(f"{pkg}.cli")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["status", str(d), *extra])
    return rc, out.getvalue()


def test_status_renders_as_the_jax_cli(tmp_path):
    """`status` over a fleet master's status.json and a campaign's: the
    same lines as the JAX CLI (the status time is set ahead of the clock,
    so both print the age as 0 s)."""
    from wtf_tpu_torch import telemetry
    from wtf_tpu_torch.fleet import telemetry as fleet_telemetry

    fleet_dir = tmp_path / "fleet"
    _telemetry(fleet_telemetry, telemetry, fleet_dir)
    doc = json.loads((fleet_dir / "status.json").read_text())
    doc["ts"] = 4e9
    (fleet_dir / "status.json").write_text(json.dumps(doc))
    camp = tmp_path / "campaign"
    camp.mkdir()
    reg = telemetry.Registry()
    reg.counter("device.instructions").inc(1000)
    reg.counter("device.fused_steps").inc(970)
    reg.counter("megachunk.windows").inc(4)
    reg.counter("devdec.zero_host_windows").inc(3)
    reg.counter("supervise.dispatches").inc(9)
    with reg.spans.span("execute"):
        with reg.spans.span("device-step"):
            pass
    (camp / "status.json").write_text(json.dumps(
        {"kind": "campaign", "ts": 4e9, "batches": 3,
         "line": "#192 cov: 40 corp: 2", "metrics": reg.dump()}))
    for d in (fleet_dir, camp):
        got = _status("wtf_tpu_torch", d)
        assert got == _status("wtf_tpu", d)
        assert got[0] == 0 and "as of 0s ago" in got[1]
        assert _status("wtf_tpu_torch", d, "--json") == \
            _status("wtf_tpu", d, "--json")
    assert "fleet: 3 node(s)" in _status("wtf_tpu_torch", fleet_dir)[1]
    assert _status("wtf_tpu_torch", tmp_path / "none") == \
        _status("wtf_tpu", tmp_path / "none")
