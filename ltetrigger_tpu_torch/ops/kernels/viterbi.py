"""The wrap-around tail-biting Viterbi decoder (K=7, rate 1/3, radix-4) as
the hand-written CUDA kernel, beside its plain PyTorch version.

Replaces the JAX package's device loop `viterbi_decode_wa`
(ltetrigger_tpu/ops/viterbi.py:120, three `lax.scan`s).  The plain version
is `ops/viterbi.viterbi_decode_wa` (60 serial steps of ~6 small ops); the
CUDA source is ltetrigger_tpu_torch/csrc/viterbi.cu, whose header gives the
design and the bound.

  viterbi_decode_wa(llr) -> (bits, metric)
      llr [B, 40, 3] float32 (+1 favours bit 0) -> bits [B, 40] int32,
      metric [B] float32.

On a CPU tensor it runs the plain version; on a CUDA tensor it launches
the kernel or raises.  `launches` counts kernel launches.

The kernel sums each branch metric in symbol order and the plain version
leaves the order to a library matrix product, so the two may decide a
near-tie differently: their bits agree wherever the two best final metrics
differ by more than rounding.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import viterbi as plain
from . import build

launches = 0          # kernel launches
_fn = None


class _Tables(ctypes.Structure):
    """viterbi.cu's VitTables: one word per state."""
    _fields_ = [("state", ctypes.c_uint32 * plain.N_STATES)]


@functools.lru_cache(maxsize=None)
def table_words() -> tuple:
    """The radix-4 tables (ops/viterbi._radix4_tables) packed one 32-bit
    word per state: the sign of OB2[ns, j, c] (1 = -1) at bit 6 j + c, and
    BITS2[ns, j] at bits 24 + 2 j."""
    OB2, BITS2 = plain._radix4_tables()
    words = []
    for ns in range(plain.N_STATES):
        w = 0
        for j in range(4):
            for c in range(6):
                w |= int(OB2[ns, j, c] < 0) << (6 * j + c)
            w |= int(BITS2[ns, j]) << (24 + 2 * j)
        words.append(w)
    return tuple(words)


@functools.lru_cache(maxsize=None)
def _tables() -> _Tables:
    return _Tables((ctypes.c_uint32 * plain.N_STATES)(*table_words()))


def _load():
    global _fn
    if _fn is None:
        fn = build.library().vit_decode_wa
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.POINTER(_Tables), ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def viterbi_decode_wa_kernel(llr: torch.Tensor):
    """Run the kernel (CUDA tensors only; plain version:
    ops/viterbi.viterbi_decode_wa).  returns (bits, metric)."""
    global launches
    if llr.device.type != "cuda":
        raise ValueError(f"Viterbi kernel needs CUDA tensors, got "
                         f"{llr.device}")
    if llr.dtype != torch.float32 or llr.ndim != 3 \
            or tuple(llr.shape[1:]) != (40, 3):
        raise ValueError(f"llr must be float32 [B, 40, 3], got {llr.dtype} "
                         f"{tuple(llr.shape)}")
    llr = llr.contiguous()
    b = llr.shape[0]
    bits = torch.empty((b, 40), dtype=torch.int32, device=llr.device)
    metric = torch.empty((b,), dtype=torch.float32, device=llr.device)
    rc = _load()(llr.data_ptr(), b, ctypes.byref(_tables()), bits.data_ptr(),
                 metric.data_ptr(),
                 torch.cuda.current_stream(llr.device).cuda_stream)
    build.check(rc, "vit_decode_wa")
    launches += 1
    return bits, metric


def viterbi_decode_wa(llr: torch.Tensor):
    """Wrap-around decode of [B, 40, 3] LLRs: the plain version on a CPU
    tensor, the kernel on a CUDA one.  returns (bits [B, 40] int32,
    metric [B] float32)."""
    if llr.device.type == "cpu":
        return plain.viterbi_decode_wa(llr)
    return viterbi_decode_wa_kernel(llr)

