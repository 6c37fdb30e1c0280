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

The kernel's schedule, in PyTorch (`schedule_model`, for the tests): the
distinct branch sums of the 20 distinct radix-4 steps (`distinct_sums`),
each (state, j) one of them times +-1 (`branch_keys`, from the 16 lane
words the kernel gets, `lane_words`), ACS with 2-bit decisions, and one
traceback from the best final state.  Its sums are taken in symbol order
(c = 0..5); the plain version leaves the order to a library matrix
product, so the two may decide a near-tie differently: their bits agree
wherever the two best final metrics differ by more than rounding.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import viterbi as plain
from . import build

launches = 0          # kernel launches
_fn = None

N_DISTINCT = 20       # 120 repeated LLRs / 6 a radix-4 step
N_KEYS = 32           # two-stage sums up to sign
LANES_PER_CODEWORD = 16
WARPS = 4             # per block; two codewords a warp
BLOCKS_PER_SM = 7     # viterbi.cu's __launch_bounds__
_SIGN_J = (1.0, -1.0, -1.0, 1.0)      # the sign of branch (k, j) over j


class _Lanes(ctypes.Structure):
    """viterbi.cu's VitLanes: one word per lane of a codeword."""
    _fields_ = [("lane", ctypes.c_uint32 * LANES_PER_CODEWORD)]


def _key_and_sign(signs) -> tuple[int, float]:
    """The two-stage sum of one OB2 row up to sign: key a*8 + b*2 + sigma
    with a, b each stage's sign pattern relative to its first symbol and
    sigma = the stages' relative sign; and the row's overall sign."""
    s = [int(x) for x in signs]
    a = (int(s[0] * s[1] < 0) << 1) | int(s[0] * s[2] < 0)
    b = (int(s[3] * s[4] < 0) << 1) | int(s[3] * s[5] < 0)
    return 8 * a + 2 * b + int(s[0] * s[3] < 0), float(s[0])


@functools.lru_cache(maxsize=None)
def lane_words() -> tuple:
    """The radix-4 tables (ops/viterbi._radix4_tables) as the kernel reads
    them, one 32-bit word per lane q (the butterfly of new states q + 16k,
    k = 0..3, whose predecessors are 4q + j): bits 4p..4p+3 the key pair
    P[p] of slot p = 2 (k & 1) + (j >> 1); bit 16 + p the element e[p] of
    that pair used where (j & 1) ^ (k >> 1) is 0 (the other where it is
    1); bit 20 set when the sign S0 is -1.  Branch (k, j) is then
    S0 * (-1 if k odd) * (+1, -1, -1, +1)[j] * sums[2 P[p] + elem]."""
    OB2, _ = plain._radix4_tables()
    words = []
    for q in range(LANES_PER_CODEWORD):
        pairs, elems, s0 = [None] * 4, [None] * 4, None
        for k in range(4):
            for j in range(4):
                key, sign = _key_and_sign(OB2[q + 16 * k, j])
                p = 2 * (k & 1) + (j >> 1)
                e = (key & 1) ^ (j & 1) ^ (k >> 1)
                s = sign * (-1.0 if k & 1 else 1.0) * _SIGN_J[j]
                assert pairs[p] in (None, key >> 1) and elems[p] in (None, e)
                assert s0 in (None, s), "one sign a lane"
                pairs[p], elems[p], s0 = key >> 1, e, s
        w = sum(pr << (4 * p) for p, pr in enumerate(pairs))
        w |= sum(e << (16 + p) for p, e in enumerate(elems))
        words.append(w | (int(s0 < 0) << 20))
    return tuple(words)


@functools.lru_cache(maxsize=None)
def branch_keys() -> tuple[np.ndarray, np.ndarray]:
    """(key [64, 4] int64, sign [64, 4] float32): branch (ns, j) is
    sign * sums[key], decoded from `lane_words` as the kernel does."""
    key = np.zeros((plain.N_STATES, 4), np.int64)
    sign = np.zeros((plain.N_STATES, 4), np.float32)
    for q, w in enumerate(lane_words()):
        s0 = -1.0 if (w >> 20) & 1 else 1.0
        for k in range(4):
            for j in range(4):
                p = 2 * (k & 1) + (j >> 1)
                elem = ((w >> (16 + p)) & 1) ^ (j & 1) ^ (k >> 1)
                key[q + 16 * k, j] = 2 * ((w >> (4 * p)) & 15) + elem
                sign[q + 16 * k, j] = s0 * (-1.0 if k & 1 else 1.0) \
                    * _SIGN_J[j]
    return key, sign


def distinct_sums(llr: torch.Tensor) -> torch.Tensor:
    """[B, 40, 3] LLRs -> [B, 20, 32]: the distinct branch sums of each
    distinct step up to sign.  Key 8 a + 2 b + sigma names the sign vector
    (1, t1, .., t5) with t1, t2 the bits of a, t3 = sigma and t4, t5 =
    t3 times the bits of b (a bit 1 is -1); its sum is taken in symbol
    order, r0 + t1 r1, then + t2 r2, .., + t5 r5, one rounding an add (the
    order of the plain version's product on the card)."""
    r = llr.reshape(llr.shape[0], N_DISTINCT, 6)
    k = torch.arange(N_KEYS, device=llr.device)
    bit = (lambda x: 1.0 - 2.0 * (x & 1).to(torch.float32))
    t3 = bit(k)
    t = (bit(k >> 4), bit(k >> 3), t3, t3 * bit(k >> 2), t3 * bit(k >> 1))
    acc = r[..., 0:1].expand(-1, -1, N_KEYS)
    for c in range(1, 6):
        acc = acc + t[c - 1] * r[..., c:c + 1]
    return acc


def schedule_model(llr: torch.Tensor):
    """The kernel's arithmetic in PyTorch: distinct sums, ACS with
    first-occurrence 2-bit decisions for steps 20-59, the best final state
    (first occurrence), traceback to step 20; bit 2 (t - 20) is bit 4 and
    bit 2 (t - 20) + 1 bit 5 of the state after step t (the two input bits
    that step shifted in).  returns (bits [B, 40] int32, metric [B])."""
    n = llr.shape[0]
    dev = llr.device
    key, sign = (torch.from_numpy(x).to(dev) for x in branch_keys())
    sums = distinct_sums(llr)
    pred = (4 * (torch.arange(plain.N_STATES, device=dev) & 15)[:, None]
            + torch.arange(4, device=dev))
    m = torch.zeros((n, plain.N_STATES), device=dev)
    decisions = []
    for t in range(3 * N_DISTINCT):
        cand = m[:, pred] + sums[:, t % N_DISTINCT][:, key] * sign
        if t >= N_DISTINCT:
            decisions.append(torch.argmax(cand, dim=-1))
        m = cand.amax(dim=-1)
    s = torch.argmax(m, dim=-1)
    metric = m.amax(dim=-1) / 3.0
    rows = torch.arange(n, device=dev)
    bits = torch.zeros((n, 40), dtype=torch.int32, device=dev)
    for t in range(3 * N_DISTINCT - 1, N_DISTINCT - 1, -1):
        if t < 2 * N_DISTINCT:
            i = 2 * (t - N_DISTINCT)
            bits[:, i] = ((s >> 4) & 1).to(torch.int32)
            bits[:, i + 1] = ((s >> 5) & 1).to(torch.int32)
        s = 4 * (s & 15) + decisions[t - N_DISTINCT][rows, s]
    return bits, metric


def launch_plan(b: int, sms: int = 132) -> dict:
    """The kernel's launch for b codewords: 16 lanes a codeword, two
    codewords a warp, 4 warps a block; static shared memory a block (each
    warp: the two codewords' sums 2 x 20 x 32 floats, path metrics 2 x 2 x
    64 floats, decisions 40 x 8 words); blocks resident a SM as
    __launch_bounds__ asks; waves over `sms` SMs."""
    blocks = -(-b // (2 * WARPS))
    smem = WARPS * 4 * (2 * N_DISTINCT * N_KEYS + 2 * 2 * 64 + 40 * 8)
    return dict(blocks=blocks, threads=32 * WARPS, cluster=1,
                smem_bytes=smem, blocks_per_sm=BLOCKS_PER_SM,
                waves=math.ceil(blocks / (BLOCKS_PER_SM * sms)) if b else 0)


@functools.lru_cache(maxsize=None)
def _lanes() -> _Lanes:
    return _Lanes((ctypes.c_uint32 * LANES_PER_CODEWORD)(*lane_words()))


def _load():
    global _fn
    if _fn is None:
        fn = build.library().vit_decode_wa
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.POINTER(_Lanes), ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def kernel_info() -> dict:
    """The compiled kernel on the current card: registers a thread, local
    (spill) bytes a thread, static shared memory a block, and blocks
    resident a SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return build.kernel_info("vit_kernel_info")


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
    rc = _load()(llr.data_ptr(), b, ctypes.byref(_lanes()), bits.data_ptr(),
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
