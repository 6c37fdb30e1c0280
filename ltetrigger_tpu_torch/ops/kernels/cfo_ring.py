"""Pass C's CFO telemetry ring over a dispatch longer than the ring (200
slots) as the hand-written CUDA kernel and its plain PyTorch version.

Replaces the JAX package's device loop `ring_step` of `_mib_postpass`
(ltetrigger_tpu/models/trigger.py:962, its lax.scan at :972).  The CUDA
source is ltetrigger_tpu_torch/csrc/cfo_ring.cu; its header gives the
design and the bound.  Dispatches of at most 200 steps take the closed form
(trigger._ring_series), as in the JAX package.

  ring_scan(ring0, count0, est, push, lost) -> (ring_f, count_f, mean)
      ring0 [*L, 200] float32, count0 [*L] int32: the ring and its push
      count; est [S, *L] float32: each step's CFO estimate (subcarriers);
      push, lost [S, *L] bool.  Step t resets the ring on lost[t], pushes
      est[t] into slot count mod 200 on push[t], and reports the ring's
      mean (`ring_mean`): mean [S, *L] float32.

On a CPU tensor `ring_scan` runs `ring_scan_plain`; on a CUDA tensor it
launches the kernel or raises.  `launches` counts kernel launches.  The
kernel's ring and count equal the plain version's; its mean sums the ring
in another order.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...ltecore.constants import MOVING_AVG_SZ
from . import build
from .pass_b import ring_push

launches = 0          # kernel launches
_fn = None

WARPS = 4             # cfo_ring.cu: a warp a lane, 4 lanes a block
STAGE = 256           # steps staged in shared memory at once
BLOCKS_PER_SM = 8     # its __launch_bounds__


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


# ----------------------------------------------------------------- kernel --
def launch_plan(lanes: int, sms: int = 132) -> dict:
    """The kernel's launch for `lanes` lanes: a warp a lane, 4 a block, no
    cluster; static shared memory a block (each warp 256 staged steps of
    est and the push / lost flags, 5 bytes a step); blocks resident a SM
    as __launch_bounds__ asks; waves over `sms` SMs."""
    blocks = -(-lanes // WARPS)
    return dict(blocks=blocks, threads=32 * WARPS, cluster=1,
                smem_bytes=WARPS * STAGE * 5, blocks_per_sm=BLOCKS_PER_SM,
                waves=math.ceil(blocks / (BLOCKS_PER_SM * sms))
                if lanes else 0)


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
