"""The lane mesh: the batch's lane axis split over torch devices.

The counterpart of wtf_tpu/meshrun/mesh.py.  The fuzzer's one parallel
axis is its lanes, and every machine plane has a leading lane axis, so a
mesh cuts the lanes into equal contiguous blocks, one per shard: shard i
owns lanes [i*L/S, (i+1)*L/S).  The snapshot image, the decode table and
the coverage aggregates are read-only within a batch and are copied once
per DISTINCT device (`replicate`), not once per shard.

torch has no array that spans devices (the JAX package's sharded arrays
read like one global array on every host), so here the per-shard tensors
are the truth on the device.  The runner gathers planes only at its host
seams (`MeshMachine`, meshrun/runner.py) and scatters host writes back.

A mesh may name one device several times.  Shards that share a card (or
the CPU) exercise every per-shard path — K1 launched per shard over its
local lanes, shard-local early exit, the cross-shard merge, per-shard
counters — as the JAX tests' virtual 8-device CPU mesh does; they say
nothing about the speed of a mesh of several cards.

Several processes: `init_multihost` joins torch.distributed with the gloo
backend and returns a mesh of this process's shards that knows its place
among every process's.  The batch is then global: every process builds
the same host value (one snapshot, one seed), holds the lanes of its own
shards (`bounds`), and runs the same host loop, so each host seam reads
the same gathered planes and every collective is reached in the same
order.  Cross-shard steps all-gather tiny per-shard vectors through host
tensors (`gather_processes`).  gloo, because it runs the same code on
the CPU and beside a card, and because NCCL refuses two ranks on one
card and has no bitwise-OR reduction.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from wtf_tpu_torch.interp.machine import Machine
from wtf_tpu_torch.mem.overlay import DirtyOverlay


class LaneMesh:
    """An ordered tuple of shard devices (a device may repeat), and this
    process's place in a multi-process mesh (`rank` of `world`, every
    process holding `size` shards)."""

    def __init__(self, devices: Sequence, rank: int = 0, world: int = 1):
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a lane mesh needs at least one device")
        self.rank = int(rank)
        self.world = int(world)

    @property
    def size(self) -> int:
        """Shards in this process (the lanes a runner splits over)."""
        return len(self.devices)

    @property
    def global_size(self) -> int:
        return self.size * self.world

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * self.size

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The devices in first-seen order, each once."""
        return tuple(dict.fromkeys(self.devices))

    def bounds(self, n_lanes: int) -> List[Tuple[int, int]]:
        """[(lo, hi)] global lane block of each local shard, `n_lanes`
        being the whole batch over every process."""
        per = n_lanes // self.global_size
        return [((self.first_shard + i) * per,
                 (self.first_shard + i + 1) * per)
                for i in range(self.size)]

    def scope(self, i: int):
        """The context a launch on shard i runs in: its card made the
        current device (a kernel launched through ctypes runs on the
        thread's current device, not on its tensors')."""
        dev = self.devices[i]
        if dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def __repr__(self) -> str:
        where = f", rank {self.rank}/{self.world}" if self.world > 1 else ""
        return (f"LaneMesh({self.size} shards on "
                f"{', '.join(str(d) for d in self.distinct)}{where})")


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> LaneMesh:
    """A mesh of `n_devices` shards (None or 0: every visible device).
    On cuda: the first N cards torch.cuda.device_count() reports, one
    shard each, raising when there are fewer.  On the CPU: N shards of
    the one `cpu` device (0 means one shard)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return LaneMesh([dev] * (n_devices or 1))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass --device cpu to run on the CPU")
    count = torch.cuda.device_count()
    if n_devices and n_devices > count:
        raise ValueError(
            f"mesh wants {n_devices} devices but torch sees only {count} "
            f"(cuda)")
    return LaneMesh([torch.device("cuda", i)
                     for i in range(n_devices or count)])


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   devices: Optional[Sequence] = None,
                   timeout: float = 300.0) -> LaneMesh:
    """Join torch.distributed (gloo; `coordinator` is host:port or a
    tcp:// address, else the MASTER_ADDR/MASTER_PORT environment) and
    return the mesh of this process's shards — `devices`, by default
    every visible card (or one CPU shard without one) — placed among
    every process's.  Joining twice reuses the group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if coordinator:
            method = (coordinator if "://" in coordinator
                      else f"tcp://{coordinator}")
        else:
            method = "env://"
        kwargs = {}
        if num_processes is not None:
            kwargs["world_size"] = int(num_processes)
        if process_id is not None:
            kwargs["rank"] = int(process_id)
        dist.init_process_group(
            "gloo", init_method=method,
            timeout=datetime.timedelta(seconds=timeout), **kwargs)
    if devices is None:
        devices = make_mesh(None, "cuda" if torch.cuda.is_available()
                            else "cpu").devices
    return LaneMesh(devices, rank=dist.get_rank(),
                    world=dist.get_world_size())


def lane_sharding(mesh: LaneMesh, n_lanes: int) -> List[Tuple]:
    """[(device, lo, hi)] of each local shard: the placement of a
    per-lane plane of the global batch."""
    return [(d, lo, hi) for d, (lo, hi) in zip(mesh.devices,
                                               mesh.bounds(n_lanes))]


def gather_processes(t: torch.Tensor, mesh: LaneMesh) -> torch.Tensor:
    """`t` [n, ...] of every process of the mesh, concatenated in rank
    order on t's device: the all-gather across processes (itself on a
    one-process mesh).  gloo gathers host tensors, so it goes through
    the CPU, as bytes.  Every process must call it, in the same order."""
    if mesh.world == 1:
        return t
    import torch.distributed as dist

    host = t.detach().cpu().contiguous()
    raw = host.reshape(host.shape[0], -1).view(torch.uint8)
    bufs = [torch.empty_like(raw) for _ in range(mesh.world)]
    dist.all_gather(bufs, raw)
    return (torch.cat(bufs).view(host.dtype)
            .reshape(-1, *host.shape[1:]).to(t.device))


def gather_lanes(parts: Sequence[torch.Tensor],
                 mesh: LaneMesh) -> torch.Tensor:
    """Per-lane tensors of this process's shards (in shard order) as one
    tensor of every lane of the mesh, every process's, in global lane
    order on the first shard's device (one shard: its tensor as is)."""
    dev = mesh.devices[0]
    t = (parts[0].to(dev) if len(parts) == 1
         else torch.cat([p.to(dev) for p in parts]))
    return gather_processes(t, mesh)


def to_device(obj, device):
    """`obj` (a tensor, None, or a NamedTuple / dataclass / tuple of
    them) with every tensor on `device`; a tensor already there is
    returned as is, not copied."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(x, device) for x in obj))
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(x, device) for x in obj)
    raise TypeError(f"cannot place {type(obj).__name__} on a device")


def replicate(obj, mesh: LaneMesh) -> Dict[torch.device, object]:
    """{device: obj on it} for each distinct device of the mesh."""
    return {d: to_device(obj, d) for d in mesh.distinct}


def split_lanes(t: torch.Tensor, mesh: LaneMesh) -> List[torch.Tensor]:
    """A per-lane tensor of the global batch cut into the local shards'
    blocks, each on its shard's device (a view where it already lies
    there)."""
    return [t[lo:hi].to(d) for d, lo, hi in lane_sharding(mesh, t.shape[0])]


def shard_machine(machine: Machine, mesh: LaneMesh) -> List[Machine]:
    """The machine's lanes cut into one Machine per local shard (views of
    its planes on a shard of its own device).  On a multi-process mesh
    `machine` is the global batch, the same in every process, and each
    keeps its own shards' lanes."""
    if machine.n_lanes % mesh.global_size:
        raise ValueError(
            f"n_lanes={machine.n_lanes} does not divide over the "
            f"{mesh.global_size}-shard mesh")
    out = []
    for dev, lo, hi in lane_sharding(mesh, machine.n_lanes):
        kw = {f.name: getattr(machine, f.name)[lo:hi].to(dev)
              for f in dataclasses.fields(machine) if f.name != "overlay"}
        ov = machine.overlay
        out.append(Machine(**kw, overlay=DirtyOverlay(**{
            f.name: getattr(ov, f.name)[lo:hi].to(dev)
            for f in dataclasses.fields(ov)})))
    return out


def shard_image(image, mesh: LaneMesh) -> list:
    """One MemImage per local shard: pages and frame table replicated per
    distinct device, the per-lane `tenant` selector cut with the lanes
    (K1 and the precise step index it by LOCAL lane)."""
    base = replicate(dataclasses.replace(image, tenant=None), mesh)
    if image.tenant is None:
        return [base[d] for d in mesh.devices]
    rows = split_lanes(image.tenant, mesh)
    return [dataclasses.replace(base[d], tenant=row)
            for d, row in zip(mesh.devices, rows)]


# ---------------------------------------------------------------------------
# the gathered view of the shards (what the host seams read and write)
# ---------------------------------------------------------------------------

class _Planes:
    """Planes of per-shard owners gathered onto one device on demand.  A
    read concatenates the shards' plane (one shard on the device: the
    plane itself), and every process's on a multi-process mesh, and
    caches it; an assignment of a global plane scatters this process's
    lanes at once (shards get views of the value where it already lies
    on their device); an in-place write into a cached plane — seen by
    the tensor's version counter — is scattered back by `flush()`."""

    def __init__(self, owners: list, mesh: LaneMesh):
        self.owners = owners
        self.mesh = mesh
        self.device = mesh.devices[0]
        self.cache: Dict[str, Tuple[torch.Tensor, int]] = {}

    def get(self, name: str) -> torch.Tensor:
        hit = self.cache.get(name)
        if hit is None:
            t = gather_lanes([getattr(o, name) for o in self.owners],
                             self.mesh)
            hit = self.cache[name] = (t, t._version)
        return hit[0]

    def set(self, name: str, value: torch.Tensor) -> None:
        self._scatter(name, value)
        self.cache[name] = (value, value._version)

    def _scatter(self, name: str, value: torch.Tensor) -> None:
        pos = self.mesh.rank * value.shape[0] // self.mesh.world
        for o in self.owners:
            old = getattr(o, name)
            n = old.shape[0]
            setattr(o, name, value[pos:pos + n].to(old.device))
            pos += n

    def flush(self) -> None:
        for name, (t, version) in self.cache.items():
            if t._version != version:
                self._scatter(name, t)
        self.cache.clear()


_MACHINE_PLANES = frozenset(f.name for f in dataclasses.fields(Machine)
                            if f.name != "overlay")
_OVERLAY_PLANES = frozenset(f.name for f in dataclasses.fields(DirtyOverlay))


class MeshOverlay(DirtyOverlay):
    """The shards' overlays read as one [L, ...] overlay (see
    MeshMachine)."""

    def __init__(self, shards: list, mesh: LaneMesh):
        object.__setattr__(self, "_planes", _Planes(
            [m.overlay for m in shards], mesh))

    def __getattr__(self, name: str):
        if name in _OVERLAY_PLANES:
            return self._planes.get(name)
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        if name not in _OVERLAY_PLANES:
            raise AttributeError(f"MeshOverlay has no plane {name!r}")
        self._planes.set(name, value)

    @property
    def capacity(self) -> int:
        return self._planes.owners[0].pfn.shape[1]

    def __repr__(self) -> str:
        return f"MeshOverlay({len(self._planes.owners)} shards)"


class MeshMachine(Machine):
    """The per-shard machines read as one Machine of every lane (of
    every process), on the mesh's first device: what the host seams of
    the runner, the backend and the supervisor see.  Planes are gathered lazily and cached until
    the next device work on the shards (`flush` before it writes back any
    host change, `drop` after it forgets the stale gather).  It is a
    Machine, so the integrity check and scripted poison act on it as on
    a single-device machine."""

    def __init__(self, shards: List[Machine], mesh: LaneMesh):
        object.__setattr__(self, "shards", list(shards))
        object.__setattr__(self, "_planes", _Planes(self.shards, mesh))
        object.__setattr__(self, "overlay", MeshOverlay(self.shards, mesh))

    def __getattr__(self, name: str):
        if name in _MACHINE_PLANES:
            return self._planes.get(name)
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        if name not in _MACHINE_PLANES:
            raise AttributeError(f"MeshMachine has no plane {name!r}")
        self._planes.set(name, value)

    @property
    def n_lanes(self) -> int:
        return sum(m.n_lanes for m in self.shards) * self._planes.mesh.world

    @property
    def device(self) -> torch.device:
        return self._planes.device

    def flush(self) -> None:
        """Scatter host writes into gathered planes back to the shards
        and forget every gather (call before device work on the shards)."""
        self._planes.flush()
        self.overlay._planes.flush()

    def drop(self) -> None:
        """Forget every gather without writing back (call after device
        work on the shards, and before a restore overwrites them)."""
        self._planes.cache.clear()
        self.overlay._planes.cache.clear()

    def __repr__(self) -> str:
        return f"MeshMachine({len(self.shards)} shards, {self.n_lanes} lanes)"
