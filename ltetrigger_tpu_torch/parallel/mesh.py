"""The process mesh: one process per device, and the package's collectives.

Port of ltetrigger_tpu/parallel/mesh.py.  The JAX package is one controller
process that enqueues one compiled program on N chips.  The port's engine is
eager and bound by the host's launch work, so one Python process looping
over N cards would serialise exactly that work.  Here the mesh is ONE
PROCESS PER DEVICE on `torch.distributed`, over the same two axes:

  ch: monitored channels (wideband scan lanes), embarrassingly parallel
  t:  time blocks of one stream, overlap-save halo at the seams

Rank r sits at ch = r // n_time, t = r % n_time (the row-major layout of the
JAX mesh).  Every rank runs the same call with the same global arguments and
uploads and computes only its slice (`Mesh.local_slice`, the counterpart of
`channel_sharding`; `replicated` has no counterpart: what is not sliced is
simply the same on every rank).

Every collective of the package is in this module: `all_gather` along an
axis, `ring_recv_right` (the halo's hop), `all_gather_object` (event lists,
checkpoints).  Backends: NCCL when every rank has its own card, gloo on the
CPU.  gloo does not move CUDA tensors for these calls, so where the backend
is gloo and the tensor lies on a card the helpers stage it through pinned
host memory.  That is how several ranks share ONE card (each rank a process
with its own CUDA context, the host work spread over the processes): a
supported layout, not a stand-in for NCCL.

Without an initialised process group the world is one process:
`make_mesh()` gives {"ch": 1, "t": 1} and no collective is ever called, as
the JAX package does on one device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from ..ops.device import resolve_device

AXES = ("ch", "t")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the (ch, t) process mesh.

    shape:  {"ch": n, "t": m}, n * m == world size
    coords: this rank's index along each axis
    device: the device this rank computes on
    groups: the process group along each axis: the world's own where the
            axis spans the world (a world of one rank included, so that its
            collectives still run through the backend), None where nothing
            is ever sent along it (no process group, or an axis of size 1
            in a larger world)
    peers:  the global ranks along each axis, in axis order
    """
    shape: dict
    coords: dict
    device: torch.device
    groups: dict
    peers: dict

    def local_slice(self, n: int) -> tuple[int, int]:
        """[lo, hi): the rows of a leading axis of `n` that this rank owns
        (sharded over `ch`; ranks along `t` own the same rows)."""
        n_ch = self.shape["ch"]
        assert n % n_ch == 0, \
            f"{n} rows do not divide by the mesh ch axis ({n_ch})"
        per = n // n_ch
        return self.coords["ch"] * per, (self.coords["ch"] + 1) * per


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device="cuda",
                     backend: str | None = None,
                     timeout: float = 300.0) -> torch.device:
    """Join the process group: one call per rank, before `make_mesh`.

    coordinator: "host:port" of rank 0 (then `num_processes` and
        `process_id` are required); None takes rank, world size and address
        from the environment, as `torchrun` sets them.
    device: "cpu", "cuda" (card LOCAL_RANK, or process_id modulo the cards
        of this host) or "cuda:k".  The rank makes that card its current one.
    backend: None picks NCCL for a CUDA device and gloo for the CPU.  Ranks
        that share a card must ask for "gloo": NCCL wants a card per rank.
    timeout: seconds after which a rank that never arrives, or a collective
        whose peer is gone, is an error and not a hang.

    returns this rank's device (pass it to `make_mesh`)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device(dev)
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK", process_id or 0)
            dev = torch.device("cuda", int(local) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        kw.update(init_method=f"tcp://{coordinator}",
                  world_size=int(num_processes), rank=int(process_id))
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    return dev


def make_mesh(n_channels: int | None = None, n_time: int = 1,
              device="cuda") -> Mesh:
    """Mesh with axes (ch, t).  Defaults to all ranks on the ch axis.

    A collective: with an initialised process group every rank calls it, in
    the same order as any other call that creates groups.  device: "cuda"
    means this rank's current card (`init_distributed` has set it)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_channels is None:
        n_channels = world // n_time
    assert n_channels * n_time == world, \
        f"{n_channels} x {n_time} != {world} devices"
    shape = {"ch": n_channels, "t": n_time}
    coords = {"ch": rank // n_time, "t": rank % n_time}
    rows = {"ch": [[i * n_time + j for i in range(n_channels)]
                   for j in range(n_time)],
            "t": [[i * n_time + j for j in range(n_time)]
                  for i in range(n_channels)]}
    groups, peers = {}, {}
    for axis in AXES:
        groups[axis], peers[axis] = None, [rank]
        if not dist.is_initialized():
            continue
        if shape[axis] == world:
            groups[axis], peers[axis] = dist.group.WORLD, list(range(world))
        elif shape[axis] > 1:
            # every rank creates every group, in the same order
            for ranks in rows[axis]:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis], peers[axis] = g, ranks
    return Mesh(shape, coords, dev, groups, peers)


# ------------------------------------------------------------ collectives --
def _staged(x: torch.Tensor, group) -> bool:
    """gloo moves host tensors only: a CUDA tensor goes through pinned host
    memory (see the module docstring)."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return host


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = "ch",
               dim: int = 0) -> torch.Tensor:
    """Every rank's `x` along `axis`, concatenated on `dim` in axis order,
    on every rank of the axis (the counterpart of the JAX package's
    `process_allgather(tiled=True)`).  Every rank of the axis must call it,
    with equal shapes.  No communication where the axis has no group."""
    n, group = mesh.shape[axis], mesh.groups[axis]
    if group is None:
        return x
    is_bool = x.dtype == torch.bool
    src = x.contiguous()
    if is_bool:
        src = src.view(torch.uint8)
    staged = _staged(src, group)
    if staged:
        src = _to_host(src)
    out = torch.empty((n,) + src.shape, dtype=src.dtype, device=src.device,
                      pin_memory=staged)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    if staged:
        out = out.to(x.device, non_blocking=True)
    if is_bool:
        out = out.view(torch.bool)
    return torch.cat(out.unbind(0), dim=dim)


def ring_recv_right(x: torch.Tensor, mesh: Mesh,
                    axis: str = "t") -> torch.Tensor:
    """One hop of the ring along `axis`: every rank sends `x` to its left
    neighbour and returns what its right neighbour sent (the last rank gets
    the first rank's).  Every rank of the axis must call it, with equal
    shapes.  Needs an axis of size >= 2: a rank never sends to itself."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    if n < 2:
        raise ValueError(f"axis {axis!r} has size {n}: no neighbour")
    group, peers = mesh.groups[axis], mesh.peers[axis]
    src = x.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _to_host(src)
    recv = torch.empty(src.shape, dtype=src.dtype, device=src.device,
                       pin_memory=staged)
    ops = [dist.P2POp(dist.isend, src, peers[(i - 1) % n], group=group),
           dist.P2POp(dist.irecv, recv, peers[(i + 1) % n], group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device, non_blocking=True) if staged else recv


def all_gather_object(obj, mesh: Mesh, axis: str | None = "ch") -> list:
    """Every rank's picklable `obj` along `axis` (None: of the whole mesh,
    in rank order), as a list in axis order on every rank.  Every rank of
    the axis must call it."""
    if axis is None:
        n = mesh.shape["ch"] * mesh.shape["t"]
        group = dist.group.WORLD if dist.is_initialized() else None
    else:
        n, group = mesh.shape[axis], mesh.groups[axis]
    if group is None:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def gather_events(events: list, mesh: Mesh) -> list:
    """The (stream, Cell) events of every rank's own streams, merged, on
    every rank.  A collective along `ch`: every rank must call it (the
    streaming calls themselves never communicate).

    Order: by stream, and within a stream in the order its rank published
    (a stable sort by stream index).  An unsharded trigger publishes in
    step-then-stream order; its list, stably sorted by stream, is this one."""
    merged = [e for part in all_gather_object(list(events), mesh, "ch")
              for e in part]
    return sorted(merged, key=lambda e: e[0])
