"""The channelizer's mixer and decimator as one hand-written CUDA kernel and
its plain PyTorch version.

Replaces no Pallas kernel: the JAX package's channelizer is jnp
(ltetrigger_tpu/ops/channelize.py:59 `_channelize_scan`).  The CUDA source
is ltetrigger_tpu_torch/csrc/channelize.cu; its header gives the design and
the bound.

  channelize_kernel(xpad, origins, ramps, ratio, n_out) -> pair [C, n_out]
      xpad: pair of [L] float32, the wide segment with one context block
      (BLOCK samples) before its payload and at least one after it;
      origins [C, >= ceil(L / BLOCK)] float32: the mod-1 mixer phase at the
      start of each BLOCK of xpad; ramps [C, BLOCK] float32: the mod-1
      in-block phase ramp; output n of centre c is xpad mixed by those
      phases, low-pass filtered (`resample.decimate`'s 16 x ratio taps) and
      taken at payload sample n x ratio.

Its plain version `channelize_plain` is the chunk loop (phases, rotation
and mixed stream of each chunk as tensors, then `resample.decimate`), which
`ops.channelize._channelize_scan` runs on a CPU pair; on a CUDA pair it
launches the kernel (one launch a call), which raises on what it does not
take.  `launches` counts kernel launches.  The kernel folds the
mixer into the taps (`modulated_taps`) and rotates at the narrow rate; its
order of work in PyTorch is `channelize_model`, for the tests.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import cplx, resample
from . import build

launches = 0          # kernel launches
_fn = None

BLOCK = 9600          # phase-table block; also the chunk's context
CHUNK_BLOCKS = 32     # blocks of payload a chunk of the plain version
TAPS_PER_PHASE = 16   # the decimator's taps: 16 x ratio
GROUP = 16            # channelize.cu: centres a block
TILE = 512            # outputs a block
MAX_PHASES = 16       # phases a piece


# the ratios the kernel takes: divisors of BLOCK whose filter's half span
# (8 x ratio) lies inside one block
RATIOS = tuple(r for r in range(1, BLOCK // 8) if BLOCK % r == 0)


# ------------------------------------------------------------ plain version
def n_chunks(n_out: int, ratio: int,
             chunk_blocks: int = CHUNK_BLOCKS) -> int:
    """Chunks `channelize_plain` runs for `n_out` outputs."""
    per = chunk_blocks * BLOCK // ratio
    return -(-n_out // per) if n_out > 0 else 0


def channelize_plain(xpad: cplx.Pair, origins: torch.Tensor,
                     ramps: torch.Tensor, ratio: int, n_out: int,
                     chunk_blocks: int = CHUNK_BLOCKS) -> cplx.Pair:
    """The chunk loop: each chunk is chunk_blocks payload blocks plus one
    context block a side, mixed (phase, rotation and product as [C, chunk]
    tensors) and decimated, with the context's share of the output
    (BLOCK // ratio samples) trimmed.  BLOCK // ratio and the chunk's
    output count are exact only when the ratio divides 9600; any other
    ratio is floored silently, as in the JAX package."""
    c = ramps.shape[0]
    chunk = chunk_blocks * BLOCK
    per = chunk // ratio
    trim = BLOCK // ratio
    outs = []
    for k in range(n_chunks(n_out, ratio, chunk_blocks)):
        seg = cplx.index(xpad, slice(k * chunk, (k + 1) * chunk + 2 * BLOCK))
        lp = seg[0].shape[-1]
        b0 = k * chunk_blocks
        nb = -(-lp // BLOCK)
        ph = (origins[:, b0:b0 + nb, None] + ramps[:, None, :]) \
            .reshape(c, nb * BLOCK)[:, :lp]
        rot = cplx.expi((2 * math.pi) * ph)
        shifted = cplx.mul((seg[0][None, :], seg[1][None, :]), rot)
        d = resample.decimate(shifted, ratio)
        cnt = min(per, n_out - k * per)
        outs.append(cplx.index(d, (slice(None), slice(trim, trim + cnt))))
    if not outs:
        return cplx.zeros((c, 0), ramps.device)
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([o[0] for o in outs], dim=-1),
            torch.cat([o[1] for o in outs], dim=-1))


# ---------------------------------------------------------- kernel model --
def modulated_taps(ramps: torch.Tensor, ratio: int) -> cplx.Pair:
    """The decimator's taps with the mixer folded in: pair of [C, 16 ratio],
    g_c[k] = h[k] exp(j 2 pi ramp_c(k - 8 ratio)), ramp_c(d) = ramps[c, d]
    and ramp_c(-d) = -ramps[c, d] (f32 mod-1 values of the ramp table)."""
    h = torch.from_numpy(resample._taps(ratio)).to(ramps.device)
    d = torch.arange(h.numel(), device=ramps.device) - 8 * ratio
    th = torch.where(d >= 0, ramps[:, d.clamp(min=0)],
                     -ramps[:, (-d).clamp(min=0)])
    rot = cplx.expi((2 * math.pi) * th)
    return (h * rot[0], h * rot[1])


def channelize_model(xpad: cplx.Pair, origins: torch.Tensor,
                     ramps: torch.Tensor, ratio: int,
                     n_out: int) -> cplx.Pair:
    """The kernel's order of work in PyTorch (see csrc/channelize.cu): the
    modulated taps, the polyphase sum (phase p outer, its 16 taps inner,
    X_p[m] = xpad[BLOCK - 8 ratio + m ratio + p], zeros past the end), then
    the rotation at the narrow rate: output n sits at wide index BLOCK + n
    ratio, whose phase is origins[c, 1 + n // M] + ramps[c, ratio (n % M)],
    M = BLOCK // ratio, summed in f32 as the plain version sums it.  At
    ratio 1, the mix alone."""
    dev, c = ramps.device, ramps.shape[0]
    n, m = torch.arange(n_out, device=dev), BLOCK // ratio
    rot = cplx.expi((2 * math.pi) * (origins[:, 1 + n // m]
                                     + ramps[:, ratio * (n % m)]))
    base = BLOCK - 8 * ratio
    span = n_out + TAPS_PER_PHASE - 1                 # X_p[m], m < span
    need = base + span * ratio
    x = tuple(torch.nn.functional.pad(comp, (0, max(0, need
                                                    - comp.shape[-1])))
              for comp in xpad)
    if ratio == 1:
        return cplx.mul((x[0][BLOCK:BLOCK + n_out],
                         x[1][BLOCK:BLOCK + n_out]), rot)
    g = modulated_taps(ramps, ratio)
    acc = (torch.zeros((c, n_out), device=dev),
           torch.zeros((c, n_out), device=dev))
    for p in range(ratio):
        xp = tuple(comp[base + p::ratio][:span] for comp in x)
        for q in range(TAPS_PER_PHASE):
            k = ratio * q + p
            w = tuple(comp[None, q:q + n_out] for comp in xp)
            acc = cplx.add(acc, cplx.mul((g[0][:, k:k + 1],
                                          g[1][:, k:k + 1]), w))
    return cplx.mul(acc, rot)


# ----------------------------------------------------------------- kernel --
def phases_per_piece(ratio: int) -> int:
    """The largest divisor of the ratio up to 16: the phases of the input
    a block stages at once."""
    return max(p for p in range(1, min(ratio, MAX_PHASES) + 1)
               if ratio % p == 0)


def launch_plan(centres: int, n_out: int, ratio: int) -> dict:
    """The decimating kernel's launch (ratio > 1; ratio 1 is the mix alone,
    a grid-stride kernel) for `centres` x `n_out` outputs: blocks of 256
    threads, each a tile of 512 outputs of 16 centres, the grid's centre
    groups fastest; dynamic shared memory a block (the staged input of one
    piece of phases, or the staged outputs, then the piece's taps)."""
    groups = -(-centres // GROUP)
    p = phases_per_piece(ratio)

    def skew(m):
        return m + (m >> 3)
    xpitch = skew(TILE + TAPS_PER_PHASE - 1) + 1
    xpitch += (18 - xpitch) % 32              # 18 mod 32: no bank conflict
    front = -(-max(2 * p * xpitch, 2 * GROUP * skew(TILE)) // 4) * 4
    return dict(threads=256, tile=TILE, groups=groups, phases=p,
                smem_bytes=4 * (front + 2 * p * TAPS_PER_PHASE * GROUP),
                blocks=groups * -(-n_out // TILE))


def kernel_info() -> dict:
    """The compiled kernel on the current card: registers a thread, local
    (spill) bytes a thread, dynamic shared memory a block at 16 phases a
    piece, and blocks resident a SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return build.kernel_info("chan_kernel_info")


def _load():
    global _fn
    if _fn is None:
        fn = build.library().chan_scan
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def channelize_kernel(xpad: cplx.Pair, origins: torch.Tensor,
                      ramps: torch.Tensor, ratio: int,
                      n_out: int) -> cplx.Pair:
    """Run the kernel (CUDA tensors only; plain version:
    `channelize_plain`).  returns pair of [C, n_out] float32."""
    global launches
    dev = ramps.device
    if dev.type != "cuda":
        raise ValueError(f"channelizer kernel needs CUDA tensors, got {dev}")
    if ratio not in RATIOS:
        raise ValueError(f"ratio {ratio}: the kernel takes a divisor of "
                         f"{BLOCK} below {BLOCK // 8}")
    c = ramps.shape[0]
    length = xpad[0].shape[-1] if xpad[0].ndim == 1 else -1
    nb = origins.shape[-1] if origins.ndim == 2 else -1
    for what, x, shape in (("xpad[0]", xpad[0], (length,)),
                           ("xpad[1]", xpad[1], (length,)),
                           ("origins", origins, (c, nb)),
                           ("ramps", ramps, (c, BLOCK))):
        if x.device != dev or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"{what}: {x.dtype} {tuple(x.shape)} on {x.device} "
                f"(contiguous {x.is_contiguous()}); the kernel takes "
                f"contiguous float32 {shape} on {dev}")
    # output n reads origins[:, 1 + n // (BLOCK // ratio)]
    if n_out > 0 and nb < 2 + (n_out - 1) // (BLOCK // ratio):
        raise ValueError(f"origins: {nb} blocks, {n_out} outputs at ratio "
                         f"{ratio} read {2 + (n_out - 1) // (BLOCK // ratio)}")
    if n_out < 0:
        raise ValueError(f"n_out {n_out} < 0")
    out = (torch.empty((c, n_out), dtype=torch.float32, device=dev),
           torch.empty((c, n_out), dtype=torch.float32, device=dev))
    if c == 0 or n_out == 0:
        return out
    rampn = ramps[:, ::ratio].contiguous()
    h = resample._taps_on(ratio, str(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _load()(xpad[0].data_ptr(), xpad[1].data_ptr(), length,
                 origins.data_ptr(), nb, ramps.data_ptr(), rampn.data_ptr(),
                 h.data_ptr(), c, ratio, n_out, out[0].data_ptr(),
                 out[1].data_ptr(), stream)
    build.check(rc, "chan_scan")
    launches += 1
    return out
