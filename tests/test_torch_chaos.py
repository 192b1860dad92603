"""The port's dist-tier fault tolerance (wtf_tpu_torch/dist under
wtf_tpu_torch/testing/faultinject's socket chaos), on the CPU; the
counterparts of tests/test_chaos.py.

  * `FaultPlan.seeded` draws the JAX plan's schedules, and ChaosSocket
    fires them on the same operation indices
  * transient dial errors retry, a non-transient one aborts, BYE stops a
    retrying link
  * a one-testcase node reconnects through scripted resets and a torn
    frame with zero testcases lost; the mux GPU node reconnects too
  * the master reclaims a silent node's work, drains on request (and on a
    real SIGTERM, `master` exiting 0), installs its SIGTERM handler only
    on the main thread, and skips a torn corpus file
  * `--wire-v1` speaks the legacy hello; a zero retry budget ends the
    node at the first loss, as the reference does
"""

import errno
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from test_harness import BENIGN, OVERFLOW, tlv

from wtf_tpu_torch.core.results import Ok
from wtf_tpu_torch.dist import BatchClient, Client, MasterLink, Server, wire
from wtf_tpu_torch.fuzz.corpus import Corpus
from wtf_tpu_torch.fuzz.mutator import TlvStructureMutator
from wtf_tpu_torch.harness import demo_tlv
from wtf_tpu_torch.telemetry import Registry
from wtf_tpu_torch.testing.faultinject import (
    FaultPlan, PARTIAL_SEND, RESET, chaos_dialing,
)
from wtf_tpu_torch.utils.hashing import hex_digest

from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent


def _addr(tmp_path: Path) -> str:
    return f"unix://{tmp_path}/master.sock"


def _serve(server, seconds=120.0):
    t = threading.Thread(target=server.run, kwargs={"max_seconds": seconds})
    t.start()
    return t


def _emu_backend():
    from wtf_tpu_torch.backend.emu import EmuBackend

    backend = EmuBackend(demo_tlv.build_snapshot())
    backend.initialize()
    return backend


class _Events:
    def __init__(self):
        self.records = []

    def emit(self, type, **fields):  # noqa: A002
        self.records.append({"type": type, **fields})

    def heartbeat(self, *a, **k):
        pass

    def of(self, type):  # noqa: A002
        return [r for r in self.records if r["type"] == type]


# ---------------------------------------------------------------------------
# the plan and the wire
# ---------------------------------------------------------------------------

def test_faultplan_seeded_matches_jax():
    from wtf_tpu.testing import faultinject as jfi

    for seed in (42, 43, 0xF1EE7):
        for n, k in ((4, 2), (16, 1), (3, 5)):
            assert FaultPlan.seeded(seed, n, faults_per_socket=k) \
                .socket_schedules == jfi.FaultPlan.seeded(
                    seed, n, faults_per_socket=k).socket_schedules
    a = FaultPlan.seeded(42, n_sockets=4, faults_per_socket=2)
    assert FaultPlan.seeded(43, 4).socket_schedules != a.socket_schedules


def test_chaos_socket_fires_on_operation_indices():
    from wtf_tpu_torch.testing.faultinject import ChaosSocket, DELAY

    plan = FaultPlan([{1: DELAY, 3: RESET}], delay_secs=0.001)
    a, b = socket.socketpair()
    try:
        chaos = ChaosSocket(a, plan.next_schedule(), plan)
        chaos.sendall(b"x")                 # op 0
        chaos.sendall(b"y")                 # op 1: delayed
        assert b.recv(2) == b"xy"
        b.sendall(b"z")
        assert chaos.recv(1) == b"z"        # op 2
        with pytest.raises(ConnectionResetError):
            chaos.recv(1)                   # op 3: reset
        assert plan.fired == [(DELAY, "send"), (RESET, "recv")]
        assert plan.next_schedule() == {}   # sockets past the list
    finally:
        b.close()


def test_dial_retries_transient_oserrors(tmp_path, monkeypatch):
    listener = wire.listen(_addr(tmp_path))
    calls = {"n": 0}
    real = socket.socket

    class Flaky(socket.socket):
        def connect(self, addr):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise OSError(
                    [errno.EHOSTUNREACH, errno.ETIMEDOUT][calls["n"] - 1],
                    "chaos")
            return real.connect(self, addr)

    monkeypatch.setattr(wire.socket, "socket", Flaky)
    try:
        wire.dial(_addr(tmp_path), retry_for=10.0).close()
    finally:
        listener.close()
    assert calls["n"] == 3


def test_dial_aborts_on_nontransient_error(tmp_path, monkeypatch):
    calls = {"n": 0}

    class Denied(socket.socket):
        def connect(self, addr):
            calls["n"] += 1
            raise PermissionError(errno.EACCES, "chaos")

    monkeypatch.setattr(wire.socket, "socket", Denied)
    with pytest.raises(PermissionError):
        wire.dial(_addr(tmp_path), retry_for=10.0)
    assert calls["n"] == 1


def test_masterlink_bye_stops_retry(tmp_path):
    listener = wire.listen(_addr(tmp_path))

    def serve():
        conn, _ = listener.accept()
        wire.recv_msg(conn)  # hello
        wire.send_bye(conn)
        conn.close()

    t = threading.Thread(target=serve)
    t.start()
    link = MasterLink(_addr(tmp_path), 1, max_retry_secs=30.0,
                      rng=random.Random(0))
    link.connect()
    start = time.monotonic()
    assert link.recv_work() is None
    assert time.monotonic() - start < 5.0  # no retry loop after BYE
    assert link._bye
    link.close()
    t.join(timeout=10)
    listener.close()


# ---------------------------------------------------------------------------
# reconnect and reclaim
# ---------------------------------------------------------------------------

def test_client_reconnect_chaos_zero_lost(tmp_path):
    """A reset result send (reclaim) and a torn one: the node reconnects,
    the master reclaims, and the campaign accounts exactly seeds + runs
    with a content-addressed outputs/."""
    runs = 16
    rng = random.Random(7)
    outputs = tmp_path / "outputs"
    corpus = Corpus(outputs_dir=outputs, rng=rng)
    server = Server(_addr(tmp_path), TlvStructureMutator(rng, 128), corpus,
                    crashes_dir=tmp_path / "crashes", runs=runs)
    seeds = [BENIGN, tlv((2, b"ABCDEFGH"))]
    server.paths = list(seeds)
    thread = _serve(server)
    registry = Registry()
    plan = FaultPlan([{9: RESET}, {6: PARTIAL_SEND}, {}, {}],
                     delay_secs=0.002)
    with chaos_dialing(plan):
        client = Client(_emu_backend(), demo_tlv.TARGET, _addr(tmp_path),
                        registry=registry, max_retry_secs=30.0,
                        retry_rng=random.Random(1))
        served = client.run()
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert plan.count_fired(RESET) == 1
    assert plan.count_fired(PARTIAL_SEND) == 1
    assert server.stats.testcases == len(seeds) + runs
    assert server.mutations == runs
    assert served >= len(seeds) + runs
    assert registry.counter("dist.retries").value >= 2
    assert server.registry.counter("dist.reclaimed").value == 2
    for p in outputs.iterdir():
        assert hex_digest(p.read_bytes()) == p.name


def test_mux_batch_client_reconnects(tmp_path):
    """The 4-lane mux GPU node (K1's plain version) survives a reset of
    its second round's reply: the whole in-flight batch reclaims and
    re-serves, nothing is lost."""
    from wtf_tpu_torch.backend.gpu import GpuBackend

    runs = 8
    rng = random.Random(3)
    server = Server(_addr(tmp_path), TlvStructureMutator(rng, 64),
                    Corpus(rng=rng), crashes_dir=tmp_path / "crashes",
                    runs=runs)
    server.paths = [BENIGN, OVERFLOW, tlv((2, b"ABCDEFGH")),
                    tlv((1, b"\x05"))]
    thread = _serve(server, seconds=180)
    backend = GpuBackend(demo_tlv.build_snapshot(), n_lanes=4, limit=50_000,
                         device="cpu", fused_step="on")
    backend.initialize()
    registry = Registry()
    plan = FaultPlan([{6: RESET}, {}, {}], delay_secs=0.002)
    with chaos_dialing(plan):
        node = BatchClient(backend, demo_tlv.TARGET, _addr(tmp_path),
                           mux=True, registry=registry,
                           max_retry_secs=60.0,
                           retry_rng=random.Random(2))
        node.run()
    thread.join(timeout=180)
    assert not thread.is_alive()
    assert plan.count_fired(RESET) == 1
    assert server.stats.testcases == 4 + runs  # zero lost
    assert registry.counter("dist.retries").value >= 1
    assert server.registry.counter("dist.reclaimed").value >= 1
    assert server.stats.crashes >= 1  # OVERFLOW still landed


def test_client_without_retry_budget_keeps_reference_behavior(tmp_path):
    rng = random.Random(11)
    server = Server(_addr(tmp_path), TlvStructureMutator(rng, 64),
                    Corpus(rng=rng), runs=50)
    server.paths = [BENIGN]
    thread = _serve(server)
    registry = Registry()
    plan = FaultPlan([{3: RESET}])  # first result send dies
    with chaos_dialing(plan):
        client = Client(_emu_backend(), demo_tlv.TARGET, _addr(tmp_path),
                        registry=registry)
        client.run(max_runs=5)
    assert registry.counter("dist.retries").value == 0
    assert client.runs == 1  # the loss ended the node
    server.runs = server.mutations  # release the master's budget wait
    thread.join(timeout=120)
    assert not thread.is_alive()


def test_wire_v1_client_speaks_legacy_hello(tmp_path):
    rng = random.Random(17)
    server = Server(_addr(tmp_path), TlvStructureMutator(rng, 64),
                    Corpus(rng=rng), runs=4)
    server.paths = [BENIGN]
    thread = _serve(server)
    client = Client(_emu_backend(), demo_tlv.TARGET, _addr(tmp_path),
                    max_retry_secs=30.0, wire_v1=True)
    served = client.run()
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert served == 1 + 4
    assert server.stats.testcases == 5


def test_master_reclaims_silent_node(tmp_path):
    runs = 6
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    (inputs / "a").write_bytes(BENIGN)
    (inputs / "b").write_bytes(tlv((2, b"ABCDEFGH")))
    rng = random.Random(5)
    events = _Events()
    server = Server(_addr(tmp_path), TlvStructureMutator(rng, 64),
                    Corpus(rng=rng), inputs_dir=inputs, runs=runs,
                    reclaim_timeout=0.3, events=events)
    thread = _serve(server)
    zombie = wire.dial(_addr(tmp_path), retry_for=10.0)
    wire.send_msg(zombie, wire.encode_hello(1))
    assert wire.recv_msg(zombie) is not None
    deadline = time.monotonic() + 30
    while (server.registry.counter("dist.reclaimed").value < 1
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert server.registry.counter("dist.reclaimed").value == 1
    client = Client(_emu_backend(), demo_tlv.TARGET, _addr(tmp_path))
    served = client.run()
    thread.join(timeout=120)
    zombie.close()
    assert not thread.is_alive()
    assert server.stats.testcases == 2 + runs  # zero lost
    assert served == 2 + runs
    reclaims = events.of("reclaim")
    assert reclaims and reclaims[0]["reason"] == "timeout"


# ---------------------------------------------------------------------------
# drain
# ---------------------------------------------------------------------------

def test_sigterm_drain(tmp_path):
    rng = random.Random(9)
    events = _Events()
    cov_path = tmp_path / "coverage.cov"
    server = Server(_addr(tmp_path), TlvStructureMutator(rng, 64),
                    Corpus(rng=rng), runs=10_000, coverage_path=cov_path,
                    events=events, drain_grace=2.0)
    server.paths = [BENIGN]
    thread = _serve(server)
    sock = wire.dial(_addr(tmp_path), retry_for=10.0)
    wire.send_msg(sock, wire.encode_hello(1, tagged=True))
    testcase = wire.recv_tagged(sock)
    assert testcase is not None and testcase[0] == wire.TAG_WORK
    server.request_drain()
    wire.send_msg(sock, wire.encode_result(testcase[1], {0x1000}, Ok()))
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert server.drained
    got = wire.recv_tagged(sock)
    assert got is not None and got[0] == wire.TAG_BYE
    sock.close()
    assert events.of("drain")
    assert json.loads(cov_path.read_text())["addresses"] == [0x1000]


def test_cmd_master_drain_exits_zero(tmp_path, monkeypatch, capsys):
    from wtf_tpu_torch import cli

    def fake_run(self, max_seconds=None):
        self.stats.crashes = 3
        self.drained = True
        return self.stats

    monkeypatch.setattr(Server, "run", fake_run)
    rc = cli.main(["master", "--name", "demo_tlv",
                   "--target", str(tmp_path),
                   "--address", _addr(tmp_path),
                   "--runs", "5", "--reclaim-timeout", "30"])
    assert rc == 0
    assert "master drained" in capsys.readouterr().out


def test_master_process_drains_on_sigterm(tmp_path):
    """A real SIGTERM to a `master` process holding a node's in-flight
    testcase: the node is told BYE, coverage.cov is written, and the
    process prints the drain line and exits 0."""
    master = subprocess.Popen(
        [sys.executable, "-m", "wtf_tpu_torch", "master", "--name",
         "demo_tlv", "--runs", "100000", "--target", str(tmp_path / "t"),
         "--address", _addr(tmp_path)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        sock = wire.dial(_addr(tmp_path), retry_for=30.0)
        wire.send_msg(sock, wire.encode_hello(1, tagged=True))
        got = wire.recv_tagged(sock)
        assert got is not None and got[0] == wire.TAG_WORK
        master.send_signal(signal.SIGTERM)
        time.sleep(0.2)
        wire.send_msg(sock, wire.encode_result(got[1], {0x2000}, Ok()))
        bye = wire.recv_tagged(sock)
        sock.close()
        out, err = master.communicate(timeout=60)
    finally:
        if master.poll() is None:
            master.kill()
    assert master.returncode == 0, err[-2000:]
    assert bye is not None and bye[0] == wire.TAG_BYE
    assert "master drained (state persisted)" in out
    doc = json.loads((tmp_path / "t" / "coverage.cov").read_text())
    assert doc["addresses"] == [0x2000]


def test_sigterm_handler_installed_in_main_thread(tmp_path):
    rng = random.Random(1)
    server = Server(_addr(tmp_path), TlvStructureMutator(rng, 64),
                    Corpus(rng=rng), runs=1)
    seen = {}
    before = signal.getsignal(signal.SIGTERM)
    orig_drain = Server._drain_step

    def drain_and_probe(self, now):
        seen["handler"] = signal.getsignal(signal.SIGTERM)
        self.request_drain()
        return orig_drain(self, now)

    server._drain_step = drain_and_probe.__get__(server)
    server.request_drain()
    server.run(max_seconds=10)  # main thread: handler installs
    assert callable(seen["handler"])
    assert seen["handler"] is not before
    assert signal.getsignal(signal.SIGTERM) is before
    assert server.drained
    # off the main thread run() leaves SIGTERM alone
    other = Server(f"unix://{tmp_path}/other.sock",
                   TlvStructureMutator(rng, 64), Corpus(rng=rng), runs=1)
    other._drain_step = drain_and_probe.__get__(other)
    other.request_drain()
    seen.clear()
    t = _serve(other, seconds=10)
    t.join(timeout=30)
    assert seen["handler"] is before and other.drained


def test_torn_corpus_file_skipped_on_replay(tmp_path):
    outputs = tmp_path / "outputs"
    outputs.mkdir()
    (outputs / hex_digest(BENIGN)).write_bytes(BENIGN)
    torn = tlv((2, b"ABCDEFGH"))
    (outputs / hex_digest(torn)).write_bytes(torn[: len(torn) // 2])
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    (inputs / "operator-seed").write_bytes(tlv((3, b"ok")))
    rng = random.Random(13)
    events = _Events()
    server = Server(_addr(tmp_path), TlvStructureMutator(rng, 64),
                    Corpus(outputs_dir=outputs, rng=rng), inputs_dir=inputs,
                    runs=0, events=events)
    thread = _serve(server)
    client = Client(_emu_backend(), demo_tlv.TARGET, _addr(tmp_path))
    served = client.run()
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert served == 2
    assert server.stats.testcases == 2
    errs = [r for r in events.of("error")
            if r.get("kind") == "torn-corpus-file"]
    assert len(errs) == 1
    assert os.path.exists(outputs / hex_digest(torn))  # left for the operator
