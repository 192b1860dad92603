"""The port's master/client plane (wtf_tpu_torch/dist) against the JAX
package's (wtf_tpu/dist), on the CPU; held against tests/test_dist.py.

  * the wire codecs byte for byte on a grid: every result class, hello and
    hello3, batch, tagged and cursor frames, delta and telemetry bodies,
    and each package decoding the other's bytes
  * `master` + `fuzz --mux --lanes 4 --device cpu --fused-step on` CLI
    against the JAX `master` + `fuzz --backend tpu --mux --lanes 4` at
    `--runs 24 --seed 5` on demo_tlv, with the default delta wire and with
    `--no-cov-delta`: the master's count line (without its clock fields),
    outputs/, crashes/ and coverage.cov (without the nodes' random client
    ids) are equal
  * across the packages: a port node served by a JAX master, and a JAX
    node served by a port master, give the same results
  * the one-testcase `Client` (`fuzz --backend emu`) and the minset
    (`master --runs 0`), CLI against CLI
  * a malformed frame drops the node and not the master, a partial mux
    batch counts nothing, a crash name from the wire is sanitized, the
    one-link-per-lane node looks like n nodes, and `fuzz` without a CUDA
    device raises

The port's masters and nodes run in subprocesses while the JAX nodes run
in this one (their compiled programs are shared between runs); every
master is a subprocess of its package's CLI.  A one-node mux campaign is
deterministic, so the comparisons are exact.
"""

import contextlib
import io
import json
import os
import random
import re
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from test_harness import BENIGN, OVERFLOW, tlv

REPO = Path(__file__).resolve().parent.parent
# one torch thread in the port's processes: their tensors are 4 lanes wide
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
MASTER = ["--name", "demo_tlv", "--runs", "24", "--seed", "5",
          "--max_len", "64"]
NODE = ["fuzz", "--name", "demo_tlv", "--lanes", "4", "--limit", "20000",
        "--seed", "5"]
PORT_NODE = ["--device", "cpu", "--fused-step", "on"]
JAX_NODE = ["--backend", "tpu"]
MINSET_SEEDS = {"twin_a": tlv((1, b"\x01\x02")),
                "twin_b": tlv((1, b"\x09\x08")),
                "stores": tlv((2, b"ABCDEFGH"))}


# ---------------------------------------------------------------------------
# wire codecs, byte for byte
# ---------------------------------------------------------------------------

def _results(mod):
    r = mod.core.results if hasattr(mod, "core") else mod
    return [r.Ok(), r.Timedout(), r.Cr3Change(), r.OverlayFull(),
            r.Crash("crash-write-0xdead"), r.Crash(None),
            r.Crash("x" * 300)]


def _packages():
    import wtf_tpu.core.results as jr
    import wtf_tpu.dist.wire as jw
    import wtf_tpu_torch.core.results as pr
    import wtf_tpu_torch.dist.wire as pw

    return (jw, jr), (pw, pr)


COVERAGES = [set(), {0x1400001000}, {0x1400001000, 0x1400001005,
                                     0x7fff0000, 0xFFFF800040001000}]


def test_result_frames_are_byte_equal_and_cross_decode():
    (jw, jr), (pw, pr) = _packages()
    tcs = [b"", b"\x01\x02some testcase", bytes(range(256)) * 3]
    for jres, pres in zip(_results(jr), _results(pr)):
        for tc in tcs:
            for cov in COVERAGES:
                jb = jw.encode_result(tc, cov, jres)
                pb = pw.encode_result(tc, cov, pres)
                assert jb == pb, (jres, tc[:8], cov)
                # each package decodes the other's bytes to its own class
                tc2, cov2, got = pw.decode_result(jb)
                assert (tc2, cov2) == (tc, cov)
                assert type(got) is type(pres)
                assert getattr(got, "name", None) == \
                    getattr(pres, "name", None)
                tc3, cov3, back = jw.decode_result(pb)
                assert (tc3, cov3, type(back).__name__) == \
                    (tc, cov, type(jres).__name__)
        delta = jw.DeltaFrame(False, 3, [0x1000, 0x2000],
                              [(0, 0x80000001), (9, 0x10)])
        pdelta = pw.DeltaFrame(False, 3, [0x1000, 0x2000],
                               [(0, 0x80000001), (9, 0x10)])
        for bucket in ("", "write.0x1400.aa55"):
            jb = jw.encode_result_delta(b"payload", jres, delta, bucket)
            assert pw.encode_result_delta(b"payload", pres, pdelta,
                                          bucket) == jb
            tc, d2, got, b2 = pw.decode_result_delta(jb)
            assert (tc, d2.full, d2.table_base, d2.addrs, d2.pairs, b2) == \
                (b"payload", False, 3, [0x1000, 0x2000],
                 [(0, 0x80000001), (9, 0x10)], bucket)
            assert type(got).__name__ == type(jres).__name__


def test_hello_batch_cursor_and_telem_frames_are_byte_equal():
    (jw, _), (pw, _) = _packages()
    cid = bytes(range(16))
    for n in (1, 4, 4096):
        for tagged in (False, True):
            assert pw.encode_hello(n, tagged=tagged) == \
                jw.encode_hello(n, tagged=tagged)
        body = jw.encode_hello_delta(n, cid)
        assert pw.encode_hello_delta(n, cid) == body
        assert (pw.decode_hello(body), pw.hello_is_tagged(body),
                pw.hello_is_delta(body), pw.hello_client_id(body)) == \
            (n, True, True, cid)
    for items in ([], [b""], [b"x", b"y" * 1000, bytes(300)]):
        assert pw.encode_batch(items) == jw.encode_batch(items)
        assert pw.decode_batch(jw.encode_batch(items)) == items
    assert pw.encode_cursor(7, b"12345678") == \
        jw.encode_cursor(7, b"12345678")
    snap = {"campaign.testcases": {"kind": "c", "value": 12}}
    events = [{"type": "crash", "name": "crash-x"}]
    assert pw.encode_telem(3, snap, events) == \
        jw.encode_telem(3, snap, events)
    assert pw.decode_telem(jw.encode_telem(3, snap, events)) == \
        jw.decode_telem(jw.encode_telem(3, snap, events))
    for bad in ("tcp://nohost/", "udp://x:1/", "unix://"):
        with pytest.raises(ValueError):
            pw.parse_address(bad)
    for good in ("tcp://localhost:31337/", "tcp://10.0.0.1:50",
                 "unix:///tmp/x.sock"):
        assert pw.parse_address(good) == jw.parse_address(good)


def _wire_bytes(send) -> bytes:
    """What one send call puts on a socket."""
    a, b = socket.socketpair()
    try:
        send(a)
        a.close()
        out = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return out
            out += chunk
    finally:
        b.close()


def test_tagged_work_and_bye_frames_are_byte_equal():
    (jw, _), (pw, _) = _packages()
    for tagged in (False, True):
        for payload in (b"", b"testcase", bytes(5000)):
            assert _wire_bytes(lambda s: pw.send_work(s, payload, tagged)) \
                == _wire_bytes(lambda s: jw.send_work(s, payload, tagged))
    assert _wire_bytes(pw.send_bye) == _wire_bytes(jw.send_bye)
    a, b = socket.socketpair()
    try:
        jw.send_work(a, b"tc", True)
        jw.send_bye(a)
        assert pw.recv_tagged(b) == (pw.TAG_WORK, b"tc")
        assert pw.recv_tagged(b)[0] == pw.TAG_BYE
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# campaigns, CLI against CLI
# ---------------------------------------------------------------------------

def _strip_clock(line: str) -> str:
    return re.sub(r" (exec/s|lastcov|uptime): \S+", "", line.strip())


def _coverage(target: Path):
    """coverage.cov with each node's random client id left out: the
    addresses, and every cursor's table and words."""
    doc = json.loads((target / "coverage.cov").read_text())
    cursors = sorted((c["table"], c["words"])
                     for c in doc.get("cursors", {}).values())
    return doc["addresses"], cursors


def _names(target: Path, sub: str) -> list:
    d = target / sub
    return sorted(p.name for p in d.iterdir()) if d.is_dir() else []


def _start_master(pkg: str, root: Path, master_args: list, seeds: dict):
    """The master CLI of `pkg` in a subprocess over <root>/m.sock, its
    target dir <root>/t with `seeds` in inputs/."""
    inputs = root / "t" / "inputs"
    inputs.mkdir(parents=True)
    for name, data in seeds.items():
        (inputs / name).write_bytes(data)
    addr = f"unix://{root}/m.sock"
    proc = subprocess.Popen(
        [sys.executable, "-m", pkg, "master", *master_args,
         "--target", str(root / "t"), "--address", addr],
        cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return addr, proc


def _wait_listening(sock: Path, proc) -> None:
    """A node dials for 10 s; a master on a loaded machine may take longer
    to import and listen."""
    deadline = time.monotonic() + 120
    while not sock.exists():
        assert proc.poll() is None and time.monotonic() < deadline, \
            proc.communicate()[1][-2000:]
        time.sleep(0.05)


def _port_node(addr: str, node_args: list):
    return subprocess.Popen(
        [sys.executable, "-m", "wtf_tpu_torch", *node_args, "--address",
         addr], cwd=REPO, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _jax_node(addr: str, node_args: list) -> str:
    from wtf_tpu import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(node_args + ["--address", addr]) == 0
    return out.getvalue()


def _finish(root: Path, master, node_out: str) -> dict:
    stdout, stderr = master.communicate(timeout=600)
    assert master.returncode in (0, 2), stderr[-2000:]
    count = [ln for ln in stdout.splitlines() if ln.startswith("#")]
    served = [ln for ln in node_out.splitlines()
              if ln.startswith("node served ")]
    target = root / "t"
    return {"rc": master.returncode, "count": _strip_clock(count[-1]),
            "served": served, "outputs": _names(target, "outputs"),
            "crashes": _names(target, "crashes"),
            "coverage": _coverage(target)
            if (target / "coverage.cov").exists() else None}


# (master package, node shape, node flags, master flags, seeds)
CAMPAIGNS = {
    "jax": ("wtf_tpu", "jax", ["--mux"], MASTER, {"seed": BENIGN}),
    "jax-nodelta": ("wtf_tpu", "jax", ["--mux", "--no-cov-delta"], MASTER,
                    {"seed": BENIGN}),
    "port": ("wtf_tpu_torch", "port", ["--mux"], MASTER, {"seed": BENIGN}),
    "port-nodelta": ("wtf_tpu_torch", "port", ["--mux", "--no-cov-delta"],
                     MASTER, {"seed": BENIGN}),
    "jax-master-port-node": ("wtf_tpu", "port", ["--mux"], MASTER,
                             {"seed": BENIGN}),
    "port-master-jax-node": ("wtf_tpu_torch", "jax", ["--mux"], MASTER,
                             {"seed": BENIGN}),
    "jax-emu": ("wtf_tpu", "jax", ["--backend", "emu"], MASTER,
                {"seed": BENIGN}),
    "port-emu": ("wtf_tpu_torch", "port", ["--backend", "emu"], MASTER,
                 {"seed": BENIGN}),
    "jax-minset": ("wtf_tpu", "jax", ["--backend", "emu"],
                   ["--name", "demo_tlv", "--runs", "0"], MINSET_SEEDS),
    "port-minset": ("wtf_tpu_torch", "port", ["--backend", "emu"],
                    ["--name", "demo_tlv", "--runs", "0"], MINSET_SEEDS),
}


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """Every campaign of CAMPAIGNS once: the port's nodes start first, in
    subprocesses, and run while this process serves the JAX nodes."""
    base = tmp_path_factory.mktemp("dist")
    running = {}
    for key, (mpkg, shape, flags, margs, seeds) in CAMPAIGNS.items():
        root = base / key
        addr, master = _start_master(mpkg, root, margs, seeds)
        running[key] = (root, master, addr, shape, flags)
    for root, master, *_ in running.values():
        _wait_listening(root / "m.sock", master)
    port_nodes = {
        key: _port_node(addr, NODE + flags + (
            [] if "--backend" in flags else PORT_NODE))
        for key, (root, master, addr, shape, flags) in running.items()
        if shape == "port"}
    out = {}
    for key, (root, master, addr, shape, flags) in running.items():
        if shape == "jax":
            out[key] = _finish(root, master, _jax_node(
                addr, NODE + flags + (
                    [] if "--backend" in flags else JAX_NODE)))
    for key, proc in port_nodes.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-2000:]
        out[key] = _finish(running[key][0], running[key][1], stdout)
    return out


@pytest.mark.parametrize("port,jax", [
    ("port", "jax"), ("port-nodelta", "jax-nodelta")],
    ids=["delta", "no-cov-delta"])
def test_mux_campaign_equals_jax_cli(campaigns, port, jax):
    """A port master + a 4-lane port mux node (K1's plain version) end a
    25-testcase campaign exactly as the JAX CLI pair does."""
    assert campaigns[port] == campaigns[jax]
    got = campaigns[port]
    assert got["count"].startswith("#25.0 cov: ")
    assert got["served"] == ["node served 25 testcases"]
    assert got["outputs"] and got["crashes"]
    addresses, cursors = got["coverage"]
    assert addresses
    # the delta wire persists the node's ack cursor; the whole-set wire
    # has none
    assert len(cursors) == (0 if "nodelta" in port else 1)


def test_delta_and_whole_set_wires_agree(campaigns):
    for key in ("port", "jax"):
        a, b = campaigns[key], campaigns[f"{key}-nodelta"]
        assert (a["count"], a["outputs"], a["crashes"],
                a["coverage"][0]) == (b["count"], b["outputs"],
                                      b["crashes"], b["coverage"][0])


@pytest.mark.parametrize("mixed", ["jax-master-port-node",
                                   "port-master-jax-node"])
def test_cross_package_campaigns_agree(campaigns, mixed):
    """A port node serves a JAX master, and a JAX node a port master, with
    the same results as the JAX pair: the wire is the same on both
    sides."""
    assert campaigns[mixed] == campaigns["jax"]


def test_emu_client_equals_jax_cli(campaigns):
    """`fuzz --backend emu`: the one-testcase Client on the oracle."""
    assert campaigns["port-emu"] == campaigns["jax-emu"]
    assert campaigns["port-emu"]["served"] == ["node served 25 testcases"]
    # the oracle and the device batch find the same campaign
    assert campaigns["port-emu"]["outputs"] == campaigns["port"]["outputs"]


def test_minset_master_equals_jax_cli(campaigns):
    """`master --runs 0`: replay the seeds only; outputs/ keeps one of
    the two twins and the seed that adds coverage (server.h:552-556)."""
    got = campaigns["port-minset"]
    assert got == campaigns["jax-minset"]
    assert got["served"] == ["node served 3 testcases"]
    assert len(got["outputs"]) == 2


# ---------------------------------------------------------------------------
# the master against broken nodes, and the node shapes
# ---------------------------------------------------------------------------

def _addr(tmp_path: Path) -> str:
    return f"unix://{tmp_path}/master.sock"


def _serve(server, seconds=60.0):
    t = threading.Thread(target=server.run, kwargs={"max_seconds": seconds})
    t.start()
    return t


def _server(tmp_path, seed, runs=0, **kwargs):
    from wtf_tpu_torch.dist import Server
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.mutator import TlvStructureMutator

    rng = random.Random(seed)
    return Server(_addr(tmp_path), TlvStructureMutator(rng, 64),
                  Corpus(rng=rng), runs=runs, **kwargs)


def test_malformed_result_frame_drops_node_not_master(tmp_path):
    from wtf_tpu_torch.dist import wire

    server = _server(tmp_path, 5)
    server.paths = [BENIGN]
    thread = _serve(server)
    sock = wire.dial(_addr(tmp_path), retry_for=10.0)
    wire.send_msg(sock, wire.encode_hello(1))
    assert wire.recv_msg(sock) is not None
    wire.send_msg(sock, b"\xFF" * 7)  # not a decodable result body
    thread.join(timeout=60)           # reactor exits CLEANLY, not by crash
    sock.close()
    assert not thread.is_alive()
    assert server.stats.testcases == 0     # nothing counted from garbage
    assert list(server.paths) == [BENIGN]  # in-flight work requeued


def test_partial_mux_batch_is_all_or_nothing(tmp_path):
    from wtf_tpu_torch.core.results import Ok
    from wtf_tpu_torch.dist import wire

    server = _server(tmp_path, 11)
    seeds = [BENIGN, tlv((2, b"ABCDEFGH"))]
    server.paths = list(seeds)
    thread = _serve(server)
    sock = wire.dial(_addr(tmp_path), retry_for=10.0)
    wire.send_msg(sock, wire.encode_hello(2))  # mux node, 2 slots
    got = wire.decode_batch(wire.recv_msg(sock))
    assert sorted(got) == sorted(seeds)
    valid = wire.encode_result(got[0], {0x1400001000}, Ok())
    wire.send_msg(sock, wire.encode_batch([valid, b"\x00"]))
    thread.join(timeout=60)
    sock.close()
    assert not thread.is_alive()
    assert server.stats.testcases == 0
    assert len(server.coverage) == 0
    assert sorted(server.paths) == sorted(seeds)


def test_wire_crash_name_is_sanitized(tmp_path):
    from wtf_tpu_torch.core.results import Crash
    from wtf_tpu_torch.dist import wire
    from wtf_tpu_torch.utils.hashing import hex_digest

    crashes = tmp_path / "crashes"
    server = _server(tmp_path, 12, crashes_dir=crashes)
    server.paths = [BENIGN]
    thread = _serve(server)
    sock = wire.dial(_addr(tmp_path), retry_for=10.0)
    wire.send_msg(sock, wire.encode_hello(1))
    tc = wire.recv_msg(sock)
    wire.send_msg(sock, wire.encode_result(tc, set(),
                                           Crash("../../outside/evil")))
    sock.close()
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert not (tmp_path / "outside").exists()
    saved = [p.name for p in crashes.iterdir()]
    assert saved == [hex_digest(tc)]
    assert server.crash_names and all(
        "/" not in n and not n.startswith(".") for n in server.crash_names)


def test_batch_client_looks_like_n_nodes(tmp_path):
    """The one-link-per-lane shape: a 4-lane node is four ordinary nodes
    to the master (the reference's own assertions: its scheduling makes
    the mutation stream order-dependent, so counts, not bytes)."""
    from wtf_tpu_torch.backend.gpu import GpuBackend
    from wtf_tpu_torch.dist import BatchClient
    from wtf_tpu_torch.harness import demo_tlv

    server = _server(tmp_path, 3, runs=8, crashes_dir=tmp_path / "crashes")
    server.paths = [BENIGN, OVERFLOW, tlv((2, b"ABCDEFGH")),
                    tlv((1, b"\x05"))]
    thread = _serve(server, seconds=180)
    backend = GpuBackend(demo_tlv.build_snapshot(), n_lanes=4, limit=50_000,
                         device="cpu", fused_step="on")
    backend.initialize()
    node = BatchClient(backend, demo_tlv.TARGET, _addr(tmp_path))
    served = node.run(max_rounds=3)
    thread.join(timeout=180)
    assert not thread.is_alive()
    assert served == server.stats.testcases == 12  # 4 seeds + 8 mutations
    assert server.stats.crashes >= 1  # OVERFLOW seed crashed
    assert len(server.coverage) > 0
    assert len(server.corpus) >= 1
    # four connections, one per lane, and the node's phase spans
    spans = backend.registry.spans
    assert node.rounds == 3
    for name in ("wire-recv", "execute", "harvest", "restore"):
        assert spans.seconds(name) > 0, name


def test_fuzz_without_cuda_raises(tmp_path):
    """No quiet fallback: without --device cpu a node needs a CUDA device
    (this machine has none)."""
    import torch

    from wtf_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        cli.main(["fuzz", "--name", "demo_tlv", "--lanes", "4",
                  "--address", _addr(tmp_path), "--max-retry-secs", "0"])
