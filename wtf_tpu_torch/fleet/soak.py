"""Fleet soak: hundreds-to-1000 simulated clients over the REAL wire.

The proof harness for the fleet tier.  Everything on the wire is
production code — `dist.server.Server` reactor, `MasterLink` reconnect
machinery, the WTF3 delta cursors, the content-addressed store — only
the *execution engine* is simulated: a deterministic testcase->coverage
model (`CoverageModel`) stands in for the device, which is what makes a
1000-client campaign runnable on one box AND makes the ground truth
exact: the union of the model over every testcase the master ever
served IS the aggregate a serial replay would compute, regardless of
thread scheduling, resets or reclaims.

Injected faults (deterministic per client, keyed on run index):

  drop    the client computes a result, then its socket dies BEFORE the
          send — the delta frame is lost, the master reclaims the
          testcase; the reconnected client's next frame must repair the
          lost bits by re-extraction against the ack cursor
  reset   the socket dies AFTER the send — a pure reconnect (master
          kept the result; no reclaim)

Assertions (`run_soak` raises on any failure):
  - zero lost testcases: the master accounts exactly seeds + runs
  - aggregate coverage == the serial-replay union, byte-identical, and
    the persisted coverage.cov agrees
  - >= the scripted number of reconnects; >= 1 reclaim when drops are
    scripted
  - coverage wire bytes: delta <= bitmap-equivalent / `min_ratio`
    (the >=10x bar of the acceptance soak)
"""

from __future__ import annotations

import argparse
import json
import random
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Set

from wtf_tpu_torch.core.results import Ok
from wtf_tpu_torch.dist import wire
from wtf_tpu_torch.dist.client import MasterLink
from wtf_tpu_torch.fleet.delta import AddressDeltaCursor
from wtf_tpu_torch.utils.hashing import mix64


class CoverageModel:
    """Deterministic testcase -> address-set model.  A large `common`
    block set every execution hits (what makes whole-bitmap exchange
    expensive) plus content-derived rare addresses (what makes coverage
    grow under mutation)."""

    BASE = 0x1_4000_0000

    def __init__(self, common: int = 1500, rare_rate: int = 8,
                 space: int = 1 << 20):
        self.common = frozenset(self.BASE + 16 * i for i in range(common))
        self.rare_rate = rare_rate
        self.space = space

    def cover(self, data: bytes) -> Set[int]:
        out = set(self.common)
        for i in range(0, max(len(data) - 3, 0), 4):
            h = mix64(int.from_bytes(data[i:i + 4], "little") ^ (i << 32))
            if h % self.rare_rate == 0:
                out.add(self.BASE + 0x10_0000 + (h % self.space) * 8)
        out.add(self.BASE + 0x20_0000 + min(len(data), 512))
        return out


class SimClient:
    """One simulated node: real MasterLink (reconnect/backoff/cursor),
    simulated execution.  `mode` selects the wire dialect — the soak can
    mix WTF3 delta speakers with whole-bitmap WTF2 and raw v1 nodes
    against the same master."""

    def __init__(self, address: str, model: CoverageModel, mode: str,
                 seed: int, registry, max_retry_secs: float = 30.0,
                 faults: Optional[Dict[int, str]] = None,
                 telem_every: int = 0, telem_dup_every: int = 0):
        assert mode in ("delta", "v2", "v1")
        self.model = model
        self.mode = mode
        self.faults = dict(faults or {})
        self.registry = registry
        cursor = (AddressDeltaCursor(registry=registry)
                  if mode == "delta" else None)
        self.link = MasterLink(address, 1, max_retry_secs,
                               registry=registry,
                               rng=random.Random(seed),
                               tagged=(mode != "v1"), cursor=cursor)
        self.local: Set[int] = set()
        self.runs = 0
        self.drops = 0
        self.resets = 0
        # TAG_TELEM emission (obs_smoke): every `telem_every` runs send
        # the client registry's cumulative snapshot; every
        # `telem_dup_every`-th frame is sent TWICE verbatim — the
        # scripted duplicate the master must drop by sequence number
        self.telem_every = telem_every
        self.telem_dup_every = telem_dup_every
        self._telem_seq = 0
        self.telem_dups_sent = 0
        self.last_telem: Optional[dict] = None

    def send_telem(self) -> None:
        """One cumulative snapshot frame on the live work connection
        (plus a scripted verbatim duplicate when dialed)."""
        if self.link.cursor is None:
            return
        self._telem_seq += 1
        snapshot = self.registry.snapshot()
        body = wire.encode_telem(self._telem_seq, snapshot)
        if not self.link.send_telem(body):
            self._telem_seq -= 1
            return
        self.last_telem = snapshot
        if (self.telem_dup_every
                and self._telem_seq % self.telem_dup_every == 0):
            if self.link.send_telem(body):
                self.telem_dups_sent += 1

    def connect(self) -> None:
        self.link.connect(retry_for=30.0)

    def step(self) -> bool:
        """One lock-step exchange; False when the campaign is over for
        this client (BYE, or the retry budget is spent)."""
        tc = self.link.recv_work()
        if tc is None:
            return False
        self.registry.counter("campaign.testcases").inc()
        if self.telem_every and (self.runs + 1) % self.telem_every == 0:
            # BEFORE the result send: the lock-step master always reads
            # up to the next result frame, so a telem frame that
            # precedes one is never stranded behind the final BYE
            self.send_telem()
        coverage = self.model.cover(tc)
        new = coverage - self.local
        self.local |= coverage
        result = Ok()
        fault = self.faults.pop(self.runs, None)
        if fault == "drop":
            # lose the result frame: the master reclaims the testcase
            self.drops += 1
            self.link._drop_socket()
        if self.link.cursor is not None:
            self.link.send_delta(self.link.cursor.encode_result(
                tc, result, coverage if new else None))
        else:
            self.link.send(wire.encode_result(
                tc, coverage if new else set(), result))
        if fault == "reset":
            # lose the connection after the send: pure reconnect
            self.resets += 1
            self.link._drop_socket()
        self.runs += 1
        return True

    def close(self) -> None:
        self.link.close()


def _drive(clients: List[SimClient]) -> None:
    """Round-robin a worker thread's client group until all retire."""
    for client in clients:
        client.connect()
    active = list(clients)
    while active:
        still = []
        for client in active:
            try:
                alive = client.step()
            except OSError:
                alive = False
            if alive:
                still.append(client)
            else:
                client.close()
        active = still


def run_soak(workdir, clients: int = 64, runs_per_client: int = 60,
             seed: int = 0xF1EE7, threads: int = 16,
             v1_clients: int = 2, v2_clients: int = 2,
             drop_every: int = 8, reset_every: int = 16,
             min_ratio: float = 10.0, use_store: bool = True,
             reclaim_timeout: float = 0.0,
             max_seconds: float = 900.0) -> dict:
    """The soak.  Returns the report dict; raises AssertionError when
    any fleet invariant breaks.  Faults are scripted: every
    `drop_every`-th delta client loses one result frame, every
    `reset_every`-th takes one post-send reset (0 disables either).
    v1/v2 clients run fault-free — re-extraction repair is a WTF3
    property; the legacy dialects prove interop, not loss recovery."""
    from wtf_tpu_torch.dist.server import Server
    from wtf_tpu_torch.fleet.store import FleetStore
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.mutator import ByteMutator
    from wtf_tpu_torch.telemetry import Registry

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    address = f"unix://{workdir}/soak.sock"
    model = CoverageModel()
    rng = random.Random(seed)
    seeds = [bytes(rng.randrange(256) for _ in range(32)),
             bytes(rng.randrange(256) for _ in range(48))]
    runs = clients * runs_per_client
    store = (FleetStore(workdir / "store", registry=Registry())
             if use_store else None)
    corpus = Corpus(outputs_dir=workdir / "outputs", rng=rng,
                    store=store)
    server = Server(address, ByteMutator(rng, 64), corpus,
                    crashes_dir=workdir / "crashes", runs=runs,
                    coverage_path=workdir / "coverage.cov",
                    stats_every=5.0, reclaim_timeout=reclaim_timeout,
                    store=store)
    server.paths = list(seeds)

    # serial-replay ground truth: every testcase the master ever served
    # (re-serves after a reclaim repeat an entry; the union is a set)
    served_log: List[bytes] = []
    original_get = server.get_testcase

    def logged_get():
        tc = original_get()
        if tc is not None:
            served_log.append(tc)
        return tc

    server.get_testcase = logged_get

    server_thread = threading.Thread(
        target=server.run, kwargs={"max_seconds": max_seconds})
    server_thread.start()

    registry = Registry()  # shared by all sim clients
    sims: List[SimClient] = []
    scripted_drops = scripted_resets = 0
    for i in range(clients):
        if i < v1_clients:
            mode = "v1"
        elif i < v1_clients + v2_clients:
            mode = "v2"
        else:
            mode = "delta"
        faults: Dict[int, str] = {}
        if mode == "delta":
            idx = i - v1_clients - v2_clients
            if drop_every and idx % drop_every == 0:
                faults[2 + idx % 3] = "drop"
                scripted_drops += 1
            if reset_every and idx % reset_every == 3:
                faults[4 + idx % 3] = "reset"
                scripted_resets += 1
        sims.append(SimClient(address, model, mode, seed ^ (i << 8),
                              registry, faults=faults))

    t0 = time.time()
    groups = [sims[i::threads] for i in range(threads)]
    workers = [threading.Thread(target=_drive, args=(group,))
               for group in groups if group]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=max_seconds)
    server_thread.join(timeout=max_seconds)
    wall = time.time() - t0
    assert not server_thread.is_alive(), "master did not finish"

    # -- zero lost testcases --------------------------------------------
    expected = len(seeds) + runs
    accounted = server.stats.testcases
    assert accounted == expected, \
        f"lost testcases: accounted {accounted}, expected {expected}"

    # -- aggregate coverage == serial replay, byte-identical ------------
    serial: Set[int] = set()
    for tc in served_log:
        serial |= model.cover(tc)
    got = sorted(server.coverage)
    want = sorted(serial)
    assert got == want, \
        (f"aggregate coverage diverged from serial replay: "
         f"{len(got)} vs {len(want)} addresses, "
         f"missing={len(serial - server.coverage)}, "
         f"extra={len(server.coverage - serial)}")
    persisted = json.loads((workdir / "coverage.cov").read_text())
    assert persisted["addresses"] == want, "persisted coverage diverged"

    # -- fault accounting ------------------------------------------------
    retries = registry.counter("dist.retries").value
    reclaimed = server.registry.counter("dist.reclaimed").value
    if scripted_drops:
        assert reclaimed >= 1, "scripted drops produced no reclaim"
    if scripted_drops + scripted_resets:
        assert retries >= scripted_drops + scripted_resets, \
            f"retries {retries} < scripted faults"

    # -- delta wire-byte ratio ------------------------------------------
    delta_bytes = registry.counter("dist.cov_bytes_delta").value
    bitmap_bytes = registry.counter("dist.cov_bytes_bitmap").value
    ratio = bitmap_bytes / delta_bytes if delta_bytes else float("inf")
    assert ratio >= min_ratio, \
        (f"coverage wire bytes only {ratio:.1f}x smaller than "
         f"whole-bitmap exchange (bar {min_ratio}x): "
         f"{delta_bytes} vs {bitmap_bytes}")

    report = {
        "clients": clients, "runs": runs, "accounted": accounted,
        "wall_s": round(wall, 1),
        "results_per_s": round(accounted / wall, 1) if wall else None,
        "coverage": len(server.coverage), "corpus": len(corpus),
        "retries": retries, "reclaimed": reclaimed,
        "scripted_drops": scripted_drops,
        "scripted_resets": scripted_resets,
        "delta_cov_bytes": delta_bytes,
        "bitmap_equiv_bytes": bitmap_bytes,
        "delta_ratio": round(ratio, 1),
        "full_resyncs": server.registry.counter(
            "fleet.full_resyncs").value,
        "coverage_writes": server.registry.counter(
            "fleet.coverage_writes").value,
    }
    if store is not None:
        report["store_puts"] = store.registry.counter(
            "fleet.store_puts").value
        report["store_dedup"] = store.registry.counter(
            "fleet.store_dedup").value
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="wtf_tpu_torch.fleet.soak",
        description="fleet soak: N simulated clients over the real "
                    "WTF2/WTF3 wire with injected resets/reclaims")
    parser.add_argument("--clients", type=int, default=256)
    parser.add_argument("--runs-per-client", type=int, default=60)
    parser.add_argument("--seed", type=int, default=0xF1EE7)
    parser.add_argument("--threads", type=int, default=16)
    parser.add_argument("--v1", type=int, default=2)
    parser.add_argument("--v2", type=int, default=2)
    parser.add_argument("--min-ratio", type=float, default=10.0)
    parser.add_argument("--no-store", action="store_true")
    parser.add_argument("--workdir", type=Path, default=None)
    args = parser.parse_args(argv)

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        report = run_soak(
            args.workdir or tmp, clients=args.clients,
            runs_per_client=args.runs_per_client, seed=args.seed,
            threads=args.threads, v1_clients=args.v1,
            v2_clients=args.v2, min_ratio=args.min_ratio,
            use_store=not args.no_store)
    print(json.dumps(report, indent=1))
    print(f"fleet-soak PASS ({report['clients']} clients, zero lost, "
          f"aggregate == serial replay, delta {report['delta_ratio']}x "
          f"smaller)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
