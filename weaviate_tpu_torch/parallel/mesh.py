"""Device meshes for row-sharded corpora (port of
``weaviate_tpu/parallel/mesh.py``).

Two mesh shapes shard corpus rows, as in the JAX package:

- the 1-D ``('shard',)`` mesh: every device holds one row shard, and the
  candidate merge gathers every shard's pairs in one step;
- the hierarchical ``('host', 'ici')`` mesh: devices are grouped by the
  process (host) that owns them, so a host's shards reduce first and only
  one winner block per host crosses between hosts (the two-level merge in
  ``sharded_search``).

A :class:`Mesh` is a plain value: the devices in row-shard order, the
axis names and their sizes, and the process that owns each shard. A
device may appear more than once: eight shards on ``cuda:0`` (or on
``cpu`` in the tests) each hold their own tensors and run their own scan,
the counterpart of XLA's virtual devices. Devices are grouped by process
then index, so consecutive row blocks stay inside one host on both mesh
shapes.

Across processes the mesh spans ``torch.distributed``'s world: each
process contributes the same local devices and holds only its own shards.
``maybe_initialize_distributed`` joins that world from the same three
``DCN_*`` variables the JAX package reads.
"""

from __future__ import annotations

import datetime
import os
import threading
from dataclasses import dataclass

import torch

from weaviate_tpu_torch.device import resolve

SHARD_AXIS = "shard"
#: hierarchical mesh axes: ``host`` crosses between processes, ``ici``
#: stays inside one
HOST_AXIS = "host"
ICI_AXIS = "ici"

#: env knob: fake N hosts in one process (the 8-shard mesh becomes a 2x4
#: "two-host pod" with WEAVIATE_TPU_VIRTUAL_HOSTS=2)
VIRTUAL_HOSTS_ENV = "WEAVIATE_TPU_VIRTUAL_HOSTS"
COORDINATOR_ENV = "DCN_COORDINATOR_ADDRESS"

#: how long a process waits for the coordinator before it gives up
JOIN_TIMEOUT_S = 300.0

_dist_lock = threading.Lock()
_dist_initialized = False


@dataclass(frozen=True, eq=False)
class Mesh:
    """Row-shard placement: ``devices[s]`` holds shard ``s`` and
    ``processes[s]`` is the rank that owns it. ``dims`` are the axis sizes
    in ``axis_names`` order; their product is the shard count."""

    devices: tuple
    axis_names: tuple
    dims: tuple
    processes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{sorted({str(d) for d in self.devices})})")


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _world() -> int:
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def maybe_initialize_distributed(env=None) -> bool:
    """Join the process group when the environment names a coordinator.

    Env surface (the JAX package's):
      DCN_COORDINATOR_ADDRESS  host:port of process 0 (required to enable)
      DCN_NUM_PROCESSES        total process count
      DCN_PROCESS_ID           this process's rank

    The group runs NCCL when this process sees a CUDA device and gloo
    otherwise. After this returns True, ``make_mesh()`` / ``default_mesh()``
    build meshes over every process's devices. Idempotent under a lock;
    returns whether the group is active. A coordinator that cannot be
    reached within ``JOIN_TIMEOUT_S`` raises ``RuntimeError`` naming it."""
    global _dist_initialized
    env = env if env is not None else os.environ
    addr = env.get(COORDINATOR_ENV)
    if not addr:
        return _dist_initialized
    import torch.distributed as dist

    with _dist_lock:
        if _dist_initialized:
            return True
        world = int(env.get("DCN_NUM_PROCESSES", "1"))
        rank = int(env.get("DCN_PROCESS_ID", "0"))
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://{addr}", world_size=world,
                rank=rank, timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
        except Exception as e:  # noqa: BLE001 - re-raised with the address
            raise RuntimeError(
                f"{COORDINATOR_ENV}={addr}: could not join the process "
                f"group as rank {rank} of {world} ({backend}): {e}") from e
        _dist_initialized = True
    return True


def local_devices(device=None) -> list:
    """This process's devices: every visible CUDA device, or the one
    ``device`` names when it is not CUDA (``"cpu"``). Raises without CUDA
    unless asked for the CPU."""
    if device is not None and torch.device(device).type != "cuda":
        return [torch.device(device)]
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "no CUDA device is visible: pass devices=[torch.device('cpu')] "
            "* n (or device='cpu') to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def device_count(device=None) -> int:
    """Devices across every process (JAX ``len(jax.devices())``)."""
    return len(local_devices(device)) * _world()


def local_device_count(device=None) -> int:
    return len(local_devices(device))


def is_multiprocess() -> bool:
    return _world() > 1


def _process_grouped_devices(devices=None) -> tuple[list, list]:
    """(devices, owning ranks) of every shard across the world, grouped
    by process then index. ``devices`` are this process's (default: every
    visible CUDA device); each process contributes the same list."""
    local = ([resolve(d) for d in devices] if devices is not None
             else local_devices())
    world = _world()
    return local * world, [r for r in range(world) for _ in local]


def make_mesh(n_devices: int | None = None, *, devices=None,
              axis_name: str = SHARD_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices, process-grouped."""
    devs, procs = _process_grouped_devices(devices)
    if n_devices is not None:
        devs, procs = devs[:n_devices], procs[:n_devices]
    return Mesh(tuple(devs), (axis_name,), (len(devs),), tuple(procs))


def virtual_hosts(env=None) -> int | None:
    """WEAVIATE_TPU_VIRTUAL_HOSTS as an int, or None when unset/invalid."""
    env = env if env is not None else os.environ
    raw = env.get(VIRTUAL_HOSTS_ENV)
    if not raw:
        return None
    try:
        n = int(raw)
    except ValueError:
        return None
    return n if n >= 1 else None


def make_hierarchical_mesh(n_hosts: int | None = None,
                           n_devices: int | None = None, *,
                           devices=None) -> Mesh:
    """2-D ``('host', 'ici')`` mesh: one row of local devices per host.

    ``n_hosts`` defaults to the process count (overridden by
    WEAVIATE_TPU_VIRTUAL_HOSTS). With one host this degenerates to the
    1-D ``shard`` mesh. Rows of the mesh are hosts, so consecutive corpus
    row blocks land inside one host."""
    devs, procs = _process_grouped_devices(devices)
    if n_devices is not None:
        devs, procs = devs[:n_devices], procs[:n_devices]
    if n_hosts is None:
        n_hosts = virtual_hosts() or _world()
    if n_hosts <= 1 or len(devs) <= 1:
        return Mesh(tuple(devs), (SHARD_AXIS,), (len(devs),), tuple(procs))
    if len(devs) % n_hosts:
        raise ValueError(
            f"{len(devs)} devices do not split evenly over {n_hosts} "
            "hosts — hierarchical row-sharding needs equal local device "
            "counts per host")
    per = len(devs) // n_hosts
    for h in range(n_hosts):
        if len(set(procs[h * per:(h + 1) * per])) != 1:
            raise ValueError(
                f"host {h} of {n_hosts} spans several processes: a host's "
                "shards must live in one process")
    return Mesh(tuple(devs), (HOST_AXIS, ICI_AXIS), (n_hosts, per),
                tuple(procs))


def _check(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh or None, "
                        f"got {type(mesh).__name__}")


def is_hierarchical(mesh: Mesh | None) -> bool:
    _check(mesh)
    return mesh is not None and HOST_AXIS in mesh.axis_names


def row_axes(mesh: Mesh | None):
    """The mesh axis (or composite axis tuple) corpus rows shard over."""
    if is_hierarchical(mesh):
        return (HOST_AXIS, ICI_AXIS)
    if mesh is not None and len(mesh.axis_names) == 1:
        return mesh.axis_names[0]  # honor a custom 1-D axis name
    return SHARD_AXIS


def n_row_shards(mesh: Mesh | None) -> int:
    """Row shards = devices of the mesh (both shapes shard rows over
    every device)."""
    _check(mesh)
    return 1 if mesh is None else mesh.size


def local_shards(mesh: Mesh) -> list[int]:
    """Shard indices this process holds, ascending."""
    rank = _rank()
    return [s for s, p in enumerate(mesh.processes) if p == rank]


def merge_device(mesh: Mesh) -> torch.device:
    """Where a merge's result lands: this process's first shard device."""
    return mesh.devices[local_shards(mesh)[0]]


def placement(mesh, device) -> torch.device:
    """The device a store's (or a database's) dispatches and results use:
    the mesh's merge device on a mesh (a ``TypeError`` for anything but a
    ``Mesh``), else ``device`` resolved (the card by default)."""
    if mesh is None:
        return resolve(device)
    _check(mesh)
    return merge_device(mesh)


def host_count(mesh: Mesh | None = None) -> int:
    """Hosts backing ``mesh`` (1-D meshes report the process count; a
    virtual-host override counts as real hosts for attribution)."""
    if is_hierarchical(mesh):
        return int(mesh.shape[HOST_AXIS])
    if mesh is None:
        return max(1, virtual_hosts() or 1)
    return max(1, virtual_hosts() or _world())


def host_labels(mesh: Mesh | None = None) -> list[str]:
    return [f"host-{i}" for i in range(host_count(mesh))]


def default_mesh(device=None) -> Mesh | None:
    """Mesh over every device, or None when there is one (the single
    device path keeps one buffer). Several processes, or virtual hosts,
    give the hierarchical mesh; otherwise the 1-D one. ``device`` picks
    the device type (default CUDA; ``"cpu"`` is one device a process)."""
    local = local_devices(device)
    if len(local) * _world() <= 1:
        return None
    if is_multiprocess() or (virtual_hosts() or 1) > 1:
        return make_hierarchical_mesh(devices=local)
    return make_mesh(devices=local)


def shardable_capacity(capacity: int, n_shards: int, chunk_size: int) -> int:
    """Round ``capacity`` up so each device gets an equal, chunk-aligned
    number of rows."""
    per_device = -(-capacity // n_shards)
    per_device = -(-per_device // chunk_size) * chunk_size
    return per_device * n_shards
