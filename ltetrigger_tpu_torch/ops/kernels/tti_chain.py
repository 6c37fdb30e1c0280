"""Pass C's TTI soft-combining chain (the 40 ms PBCH accumulator folded over
each lane's K captured MIB candidates) as the hand-written CUDA kernel and
its plain PyTorch version.

Replaces the JAX package's device loop `chain` of `_decode_candidates`
(ltetrigger_tpu/models/trigger.py:848, its lax.scan at :879).  The CUDA
source is ltetrigger_tpu_torch/csrc/tti_chain.cu; its header gives the
design and the bound.

  tti_chain(acc0, n0, cell0, contrib, fresh, cell, valid, combine)
      -> (accs, qs, acc_f, n_f, cell_f)
      acc0 [*L, 3, 4, 120] float32: the accumulator (port, TTI-phase
      hypothesis, LLR); n0, cell0 [*L] int32: subframe-0 attempts combined
      and the cell id of the last capture; contrib [*L, K, 3, 4, 120]
      float32: each candidate's quarter LLRs (port, quarter, LLR); fresh,
      valid [*L, K] bool and cell [*L, K] int32: the candidates' restart
      flags, slots in use and cell ids; combine False restarts every slot.
      accs [*L, K, 3, 4, 120]: the accumulator after each slot; qs [*L, K,
      4] int32: the quarter each phase hypothesis reports at that slot;
      acc_f, n_f, cell_f: the carry after slot K - 1.

Phase h of a slot restarts its accumulator at quarter 0; a restart (a
fresh capture or another cell id) clears every phase; a slot with valid
False leaves the carry as it was and still writes its accs and qs rows.

On a CPU tensor `tti_chain` runs `tti_chain_plain`; on a CUDA tensor it
launches the kernel or raises.  `launches` counts kernel launches.  The
kernel's schedule, in PyTorch (`schedule_model`, for the tests): the lane
split over warps, the scalars by ballots, the valid slots' loads in a ring.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

launches = 0          # kernel launches
_fn = None

ACC = (3, 4, 120)     # a lane's accumulator: port x phase x LLR
COLS = 30             # tti_chain.cu: float4 columns of a 120-LLR row
WARP_COLS = 8         # columns a warp (x 4 phases = 32 threads)
PARTS = 12            # warps a lane: 3 ports x 4 column groups
CHUNK = 32            # slots whose scalars a warp holds at once
# its two launch shapes: warps a block, slots in flight, __launch_bounds__
NARROW = dict(warps=1, depth=32, blocks_per_sm=8)
WIDE = dict(warps=4, depth=4, blocks_per_sm=9)


# ------------------------------------------------------------ plain version
def tti_chain_plain(acc0, n0, cell0, contrib, fresh, cell, valid,
                    combine: bool):
    """Plain PyTorch chain: one slot after another (see the module
    docstring).  returns (accs, qs, acc_f, n_f, cell_f)."""
    acc, n, cur = acc0, n0, cell0
    ar4 = torch.arange(4, dtype=torch.int32, device=acc.device)
    accs, qs = [], []
    for j in range(contrib.shape[-4]):
        c_k = contrib[..., j, :, :, :]
        fresh_k, cell_k, valid_k = fresh[..., j], cell[..., j], valid[..., j]
        if not combine:
            fresh_k = torch.ones_like(fresh_k)
        restart = fresh_k | (cell_k != cur)
        n_k = torch.where(restart, 0, n)
        q = torch.remainder(n_k[..., None] + ar4, 4)          # [.., 4]
        sel = torch.take_along_dim(c_k, q[..., None, :, None].long(),
                                   dim=-2)
        acc_base = torch.where(restart[..., None, None, None], 0.0, acc)
        acc_new = torch.where((q == 0)[..., None, :, None], sel,
                              acc_base + sel)
        acc = torch.where(valid_k[..., None, None, None], acc_new, acc)
        n = torch.where(valid_k, n_k + 1, n)
        cur = torch.where(valid_k, cell_k, cur)
        accs.append(acc)
        qs.append(q)
    return torch.stack(accs, dim=-4), torch.stack(qs, dim=-2), acc, n, cur


# ------------------------------------------------------- schedule model --
def _bits(b: torch.Tensor) -> torch.Tensor:
    """A warp's ballot: [.., n] bool (lane i = b[.., i]) -> [..] int64."""
    return (b.long() << torch.arange(b.shape[-1], device=b.device)).sum(-1)


def _popc(m: torch.Tensor) -> torch.Tensor:
    return ((m[..., None] >> torch.arange(32, device=m.device)) & 1).sum(-1)


def _highest(m: torch.Tensor) -> torch.Tensor:
    """The highest set bit of each mask (0 where the mask is 0)."""
    b = torch.arange(32, device=m.device)
    return (((m[..., None] >> b) & 1) * b).amax(-1)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 as a 32-bit register wraps."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _warp_layout(device):
    """The kernel's thread layout, [12 warps of a lane, 32 threads]: port,
    float4 column and phase of each thread's accumulator float4, and
    whether it holds one (the last column group has 6 columns)."""
    part = torch.arange(PARTS, device=device)[:, None]
    ln = torch.arange(32, device=device)[None, :]
    col = (part % 4) * WARP_COLS + ln // 4
    port = (part // 4).expand(PARTS, 32)
    return port, col.clamp(max=COLS - 1), (ln % 4).expand(PARTS, 32), \
        col < COLS


def schedule_model(acc0, n0, cell0, contrib, fresh, cell, valid,
                   combine: bool, sms: int = 132):
    """The kernel's order of work in PyTorch (see csrc/tti_chain.cu):
    every lane split over 12 warps of 8 float4 columns x 4 phases; per
    chunk of 32 slots the scalars from two ballots (valid; valid and
    restart) with no slot waiting on the one before; `launch_plan`'s depth
    slots ahead in a ring: in one-warp blocks each thread's own row h of
    every slot, row q[h] taken from the column's thread q[h] as the slot
    is folded; in four-warp blocks each thread's row q[h] of the valid
    slots.  How warps pack into blocks changes no warp's work.  returns
    (accs, qs, acc_f, n_f, cell_f), bit for bit the plain version's."""
    lead, k = tuple(n0.shape), contrib.shape[-4]
    lanes, dev = math.prod(lead), contrib.device
    plan = launch_plan(lanes, sms)
    depth, own_row = plan["depth"], not plan["wide"]
    port, col, h, holds = _warp_layout(dev)
    blocks = contrib.reshape(lanes, k, 3, 4, COLS, 4)
    acc = acc0.reshape(lanes, 3, 4, COLS, 4)[:, port, h, col] \
        * holds[..., None]                                 # [L, 12, 32, 4]
    fl, vl = fresh.reshape(lanes, k), valid.reshape(lanes, k)
    cl = cell.reshape(lanes, k).long()
    n, cur = n0.reshape(lanes).long(), cell0.reshape(lanes).long()
    accs = torch.zeros((lanes, k, 3, 4, COLS, 4), device=dev)
    qs = torch.zeros((lanes, k, 4), dtype=torch.int32, device=dev)
    for k0 in range(0, k, CHUNK):
        kn = min(CHUNK, k - k0)
        c, v = cl[:, k0:k0 + kn], vl[:, k0:k0 + kn]
        i = torch.arange(kn, device=dev)
        big_v = _bits(v)
        before = big_v[:, None] & ((1 << i) - 1)           # [L, kn]
        prev = torch.take_along_dim(c, _highest(before), dim=-1)
        restart = ~torch.tensor(bool(combine), device=dev) \
            | fl[:, k0:k0 + kn] | (c != torch.where(before > 0, prev,
                                                     cur[:, None]))
        big_r = _bits(v & restart)
        rb = big_r[:, None] & ((1 << i) - 1)
        n_before = torch.where(
            rb > 0, _popc(before & ~((1 << _highest(rb)) - 1)),
            n[:, None] + _popc(before))
        nk = torch.where(restart, 0, n_before)
        qs[:, k0:k0 + kn] = _i32((nk[..., None] + torch.arange(4,
                                                             device=dev))
                                 & 3)
        last = _highest(big_v)
        n = torch.where(big_v > 0, nk.gather(-1, last[:, None])[:, 0] + 1, n)
        cur = torch.where(big_v > 0, c.gather(-1, last[:, None])[:, 0], cur)

        def load(j):
            """slot k0 + j's float4 of every thread: its own row h of every
            slot (one-warp blocks), else row q[h] of the valid slots (zeros
            where nothing is loaded)."""
            q = (nk[:, j, None, None] + h) & 3
            row, use = (h, holds) if own_row else (q, v[:, j, None, None]
                                                   & holds)
            x = blocks[torch.arange(lanes, device=dev)[:, None, None],
                       k0 + j, port, row, col]
            return x * use[..., None]
        ring = [load(j) if j < kn else None for j in range(depth)]
        for j in range(kn):
            x = ring[j % depth]
            q = (nk[:, j, None, None] + h) & 3
            if own_row:     # row q[h] from the column's thread q[h]
                src = (torch.arange(32, device=dev) & ~3) | q
                x = torch.take_along_dim(x, src[..., None], dim=2)
            if j + depth < kn:
                ring[j % depth] = load(j + depth)
            q0 = q == 0
            base = torch.where(restart[:, j, None, None, None], 0.0, acc)
            new = torch.where(q0[..., None], x, base + x)
            acc = torch.where(v[:, j, None, None, None], new, acc)
            accs[:, k0 + j, port[holds], h[holds], col[holds]] = acc[:, holds]
    acc_f = torch.zeros((lanes, 3, 4, COLS, 4), device=dev)
    acc_f[:, port[holds], h[holds], col[holds]] = acc[:, holds]
    return (accs.reshape(lead + (k,) + ACC), qs.reshape(lead + (k, 4)),
            acc_f.reshape(lead + ACC), _i32(n).reshape(lead),
            _i32(cur).reshape(lead))


# ----------------------------------------------------------------- kernel --
def launch_plan(lanes: int, sms: int = 132) -> dict:
    """The kernel's launch for `lanes` lanes: 12 warps a lane (a port x 8
    float4 columns x 4 phases each), packed one a block with 32 slots in
    flight a thread while the one-warp blocks fit one wave at 8 a SM (up
    to 88 lanes on 132 SMs), else four a block with 4 in flight (9 blocks
    a SM: 396 lanes a wave; `wide`); no cluster, no shared memory; blocks
    resident a SM as __launch_bounds__ asks; waves over `sms` SMs."""
    warps = lanes * PARTS
    shape = NARROW if warps <= NARROW["blocks_per_sm"] * sms else WIDE
    blocks = -(-warps // shape["warps"])
    return dict(blocks=blocks, threads=32 * shape["warps"], cluster=1,
                smem_bytes=0, depth=shape["depth"], wide=shape is WIDE,
                blocks_per_sm=shape["blocks_per_sm"],
                waves=math.ceil(blocks / (shape["blocks_per_sm"] * sms)))


def kernel_info(lanes: int = 1, sms: int = 132) -> dict:
    """The compiled kernel that `launch_plan(lanes, sms)` launches, on the
    current card: registers a thread, local (spill) bytes a thread, static
    shared memory a block, and blocks resident a SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return build.kernel_info("tti_kernel_info",
                             int(launch_plan(lanes, sms)["wide"]))


def _load():
    global _fn
    if _fn is None:
        fn = build.library().tti_chain
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int]
                       + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def tti_chain_kernel(acc0, n0, cell0, contrib, fresh, cell, valid,
                     combine: bool):
    """Run the kernel (CUDA tensors only; plain version:
    `tti_chain_plain`).  returns (accs, qs, acc_f, n_f, cell_f)."""
    global launches
    dev = contrib.device
    if dev.type != "cuda":
        raise ValueError(f"TTI-chain kernel needs CUDA tensors, got {dev}")
    lead = tuple(n0.shape)
    if contrib.ndim != len(lead) + 4 or tuple(contrib.shape[:len(lead)]) \
            != lead or tuple(contrib.shape[-3:]) != ACC:
        raise ValueError(f"contrib must be {lead} + (K, 3, 4, 120), got "
                         f"{tuple(contrib.shape)}")
    k = contrib.shape[len(lead)]
    if k < 1:
        raise ValueError("the chain needs at least one slot")
    for what, x, dt, shape in (
            ("acc0", acc0, torch.float32, lead + ACC),
            ("n0", n0, torch.int32, lead), ("cell0", cell0, torch.int32, lead),
            ("contrib", contrib, torch.float32, lead + (k,) + ACC),
            ("fresh", fresh, torch.bool, lead + (k,)),
            ("cell", cell, torch.int32, lead + (k,)),
            ("valid", valid, torch.bool, lead + (k,))):
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"{what}: {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}, the kernel takes {dt} {shape} on "
                             f"{dev}")
    lanes = math.prod(lead)
    acc0, contrib = _aligned(acc0), _aligned(contrib)
    n0, cell0, fresh, cell, valid = (x.contiguous() for x in
                                     (n0, cell0, fresh, cell, valid))
    accs = torch.empty(lead + (k,) + ACC, dtype=torch.float32, device=dev)
    qs = torch.empty(lead + (k, 4), dtype=torch.int32, device=dev)
    acc_f = torch.empty(lead + ACC, dtype=torch.float32, device=dev)
    n_f = torch.empty(lead, dtype=torch.int32, device=dev)
    cell_f = torch.empty(lead, dtype=torch.int32, device=dev)
    plan = launch_plan(lanes, _sms(dev))
    rc = _load()(acc0.data_ptr(), n0.data_ptr(), cell0.data_ptr(),
                 contrib.data_ptr(), fresh.data_ptr(), cell.data_ptr(),
                 valid.data_ptr(), int(bool(combine)), lanes, k,
                 int(plan["wide"]), accs.data_ptr(), qs.data_ptr(),
                 acc_f.data_ptr(), n_f.data_ptr(), cell_f.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tti_chain")
    launches += 1
    return accs, qs, acc_f, n_f, cell_f


# ------------------------------------------------------------ entry point --
def tti_chain(acc0, n0, cell0, contrib, fresh, cell, valid, combine: bool):
    """The TTI chain (see the module docstring): the plain version on a CPU
    tensor, the kernel on a CUDA one."""
    if contrib.device.type == "cpu":
        return tti_chain_plain(acc0, n0, cell0, contrib, fresh, cell, valid,
                               combine)
    return tti_chain_kernel(acc0, n0, cell0, contrib, fresh, cell, valid,
                            combine)
