"""Pass C's CFO telemetry ring (200 slots) over a dispatch of any length
as the hand-written CUDA kernel and its plain PyTorch version.

Replaces the JAX package's device loop `ring_step` of `_mib_postpass`
(ltetrigger_tpu/models/trigger.py:962, its lax.scan at :972) and, for
dispatches of at most 200 steps, its closed form (:679).
The CUDA source is ltetrigger_tpu_torch/csrc/cfo_ring.cu; its header gives
the design and the bound.

  ring_scan(ring0, count0, est, push, lost) -> (ring_f, count_f, mean)
      ring0 [*L, 200] float32, count0 [*L] int32: the ring and its push
      count; est [S, *L] float32: each step's CFO estimate (subcarriers);
      push, lost [S, *L] bool.  Step t resets the ring on lost[t], pushes
      est[t] into slot count mod 200 on push[t], and reports the ring's
      mean (`ring_mean`): mean [S, *L] float32.

On a CPU tensor `ring_scan` runs `ring_scan_plain`; on a CUDA tensor it
launches the kernel or raises.  `launches` counts kernel launches.  The
kernel's ring and count equal the plain version's; its mean sums the ring
in another order.  The kernel's schedule, in PyTorch (`schedule_model`, for
the tests): the counts by ballots a tile of 32 steps, the slots' walk, the
tile's sums in the kernel's order.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...ltecore.constants import MOVING_AVG_SZ
from . import build
from .pass_b import ring_push
from .tti_chain import _i32

launches = 0          # kernel launches
_fn = None

SUM_WARPS = 7         # cfo_ring.cu: warps that walk the ring and sum it
THREADS = 256         # a block a lane: those 7 warps and the scalars' warp
TILE = 32             # steps a tile (a warp's lanes)
PITCH = MOVING_AVG_SZ + 4   # floats a row of the [TILE, 204] shared tile
BLOCKS_PER_SM = 6     # its __launch_bounds__


# ------------------------------------------------------------ plain version
def ring_mean(ring, count):
    """The mean of a telemetry ring's live slots (0 when empty)."""
    n = torch.clamp(count, max=MOVING_AVG_SZ)
    return torch.where(n > 0, ring.sum(dim=-1) / torch.clamp(n, min=1), 0.0)


def ring_scan_plain(ring0, count0, est, push, lost):
    """Plain PyTorch ring: one step after another (see the module
    docstring).  returns (ring_f, count_f, mean)."""
    ring, count, means = ring0, count0, []
    for t in range(est.shape[0]):
        ring = torch.where(lost[t][..., None], 0.0, ring)
        count = torch.where(lost[t], 0, count)
        ring = torch.where(push[t][..., None],
                           ring_push(ring, count, est[t]), ring)
        count = count + push[t].to(torch.int32)
        means.append(ring_mean(ring, count))
    return ring, count, torch.stack(means)


# ------------------------------------------------------- schedule model --
def schedule_model(ring0, count0, est, push, lost):
    """The kernel's order of work in PyTorch (see csrc/cfo_ring.cu): per
    tile of 32 steps the counts from one warp's ballots (the pushes since
    the tile's last reset, or the carry plus every push), then each slot
    walked through the tile into a [32, 200] tile of the ring's contents,
    then each step's row summed as the kernel sums it (7 warps of 32
    slots, 4 partial sums each, the partials in order) and divided.
    returns (ring_f, count_f, mean): ring and count the plain version's,
    the mean within float32 rounding of it."""
    lead, s = tuple(count0.shape), est.shape[0]
    lanes, dev = math.prod(lead), est.device
    v = ring0.reshape(lanes, MOVING_AVG_SZ)
    count = count0.reshape(lanes).long()
    e, p, lo = (x.reshape(s, lanes) for x in (est, push, lost))
    slots = torch.arange(MOVING_AVG_SZ, device=dev)
    means = []
    for t0 in range(0, s, TILE):
        n = min(TILE, s - t0)
        pt, lt = p[t0:t0 + n].long(), lo[t0:t0 + n]
        i = torch.arange(n, device=dev)[:, None]
        # the scalars' ballots: the last reset at or before step i, pushes
        # in [that reset, i], else the carry and every push up to i
        last = torch.cummax(torch.where(lt, i, -1), dim=0).values
        upto = torch.cumsum(pt, dim=0)
        at_reset = torch.take_along_dim(upto - pt, last.clamp(min=0), dim=0)
        after = torch.where(last >= 0, upto - at_reset, count + upto)
        slot = torch.remainder(_i32(after - pt).long(), MOVING_AVG_SZ)
        live = torch.clamp(_i32(after), max=MOVING_AVG_SZ)
        count = after[-1]
        tile = []
        for u in range(n):          # the slots' walk through the tile
            v = torch.where(lt[u][:, None], 0.0, v)
            v = torch.where(pt[u].bool()[:, None]
                            & (slot[u][:, None] == slots),
                            e[t0 + u][:, None], v)
            tile.append(v)
        tile = torch.stack(tile)                           # [n, L, 200]
        total = None
        for w in range(SUM_WARPS):  # warp w: slots 32w.., 4 partial sums
            a = [torch.zeros((n, lanes), device=dev) for _ in range(4)]
            for j in range(32 * w, min(32 * w + 32, MOVING_AVG_SZ), 4):
                a = [a[c] + tile[..., j + c] for c in range(4)]
            part = (a[0] + a[1]) + (a[2] + a[3])
            total = part if total is None else total + part
        means.append(torch.where(live > 0, total / live.clamp(min=1), 0.0))
    mean = torch.cat(means) if means else est.new_zeros((0, lanes))
    return (v.reshape(lead + (MOVING_AVG_SZ,)), _i32(count).reshape(lead),
            mean.reshape((s,) + lead))


# ----------------------------------------------------------------- kernel --
def launch_plan(lanes: int, sms: int = 132) -> dict:
    """The kernel's launch for `lanes` lanes: a block of 256 threads a lane
    (thread j < 200 walks ring slot j, warp 7 the counts and the means),
    no cluster; static shared memory a block (the [32, 204] float tile, 7
    warps' partial sums of 32 steps, two tiles' slots, estimates and reset
    masks); blocks resident a SM as __launch_bounds__ asks; waves over
    `sms` SMs."""
    smem = 4 * (TILE * PITCH + SUM_WARPS * TILE + 2 * 2 * TILE + 2)
    return dict(blocks=lanes, threads=THREADS, cluster=1,
                smem_bytes=smem, blocks_per_sm=BLOCKS_PER_SM,
                waves=math.ceil(lanes / (BLOCKS_PER_SM * sms)))


def kernel_info() -> dict:
    """The compiled kernel on the current card: registers a thread, local
    (spill) bytes a thread, static shared memory a block, and blocks
    resident a SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return build.kernel_info("ring_kernel_info")


def _load():
    global _fn
    if _fn is None:
        fn = build.library().ring_scan
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def ring_scan_kernel(ring0, count0, est, push, lost):
    """Run the kernel (CUDA tensors only; plain version:
    `ring_scan_plain`).  returns (ring_f, count_f, mean)."""
    global launches
    dev = est.device
    if dev.type != "cuda":
        raise ValueError(f"CFO-ring kernel needs CUDA tensors, got {dev}")
    lead = tuple(count0.shape)
    s = est.shape[0] if est.ndim else 0
    for what, x, dt, shape in (
            ("ring0", ring0, torch.float32, lead + (MOVING_AVG_SZ,)),
            ("count0", count0, torch.int32, lead),
            ("est", est, torch.float32, (s,) + lead),
            ("push", push, torch.bool, (s,) + lead),
            ("lost", lost, torch.bool, (s,) + lead)):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"{what}: {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}, the kernel takes {dt} {shape} on "
                             f"{dev}")
    lanes = math.prod(lead)
    ring0, count0, est, push, lost = (x.contiguous() for x in
                                      (ring0, count0, est, push, lost))
    ring_f = torch.empty_like(ring0)
    count_f = torch.empty_like(count0)
    mean = torch.empty((s,) + lead, dtype=torch.float32, device=dev)
    rc = _load()(ring0.data_ptr(), count0.data_ptr(), est.data_ptr(),
                 push.data_ptr(), lost.data_ptr(), lanes, s,
                 ring_f.data_ptr(), count_f.data_ptr(), mean.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "ring_scan")
    launches += 1
    return ring_f, count_f, mean


# ------------------------------------------------------------ entry point --
def ring_scan(ring0, count0, est, push, lost):
    """The ring over S steps (see the module docstring): the plain version
    on a CPU tensor, the kernel on a CUDA one."""
    if est.device.type == "cpu":
        return ring_scan_plain(ring0, count0, est, push, lost)
    return ring_scan_kernel(ring0, count0, est, push, lost)
