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
launches the kernel or raises.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

launches = 0          # kernel launches
_fn = None

ACC = (3, 4, 120)     # a lane's accumulator: port x phase x LLR
THREADS = 384         # tti_chain.cu: a block per lane, a float4 a thread
BLOCKS_PER_SM = 3     # its __launch_bounds__


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


# ----------------------------------------------------------------- kernel --
def launch_plan(lanes: int, sms: int = 132) -> dict:
    """The kernel's launch for `lanes` lanes: one block of 384 threads a
    lane (a float4 of the accumulator each, 360 of them), no cluster;
    static shared memory a block (a chunk of 32 slots' n_k, cell id and
    flags); blocks resident a SM as __launch_bounds__ asks; waves over
    `sms` SMs."""
    return dict(blocks=lanes, threads=THREADS, cluster=1,
                smem_bytes=32 * (4 + 4 + 1), blocks_per_sm=BLOCKS_PER_SM,
                waves=math.ceil(lanes / (BLOCKS_PER_SM * sms)))


def kernel_info() -> dict:
    """The compiled kernel on the current card: registers a thread, local
    (spill) bytes a thread, static shared memory a block, and blocks
    resident a SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return build.kernel_info("tti_kernel_info")


def _load():
    global _fn
    if _fn is None:
        fn = build.library().tti_chain
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    rc = _load()(acc0.data_ptr(), n0.data_ptr(), cell0.data_ptr(),
                 contrib.data_ptr(), fresh.data_ptr(), cell.data_ptr(),
                 valid.data_ptr(), int(bool(combine)), lanes, k,
                 accs.data_ptr(), qs.data_ptr(), acc_f.data_ptr(),
                 n_f.data_ptr(), cell_f.data_ptr(),
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
