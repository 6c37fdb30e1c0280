"""PSS matched filter + power: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas kernel `pss_correlate_power_pallas`
(ltetrigger_tpu/ops/pallas/matched_filter.py) and, in the port, also runs
pass A of the grid engine (ltetrigger_tpu/models/trigger.py `_group_power`).
The CUDA source is ltetrigger_tpu_torch/csrc/matched_filter.cu; its header
gives the design and the bound.

Three entry points over one kernel:

  group_power(buf_re, buf_im, lo, g, dtype)   grid contract (pass A)
      [*B, N] pair -> [*B, g, 75, 3, 128]: power[.., t, b, r, m] is root r's
      matched-filter power at stream position lo + 9600 t + 128 b + m;
      samples at or past N read as zero.
  pss_correlate_power(window, dtype)          window contract
      [B, >= 9728] pair -> [B, 3, 9600] (the Pallas kernel's contract).
  pss_correlate_power_cfo_bins(window, bins, dtype)   the integer-CFO probe
      [..., >= 9728] pair -> [..., len(bins), 3, 9600]: the window contract
      against replica banks shifted by `bins` subcarriers, one launch a bin
      (the kernel takes its weights by pointer; only the bank differs).

On a CPU tensor each entry runs its plain PyTorch version; on a CUDA tensor
it launches the kernel or raises.  `launches` counts kernel launches.

bf16 means: inputs rounded to nearest-even bfloat16, products exact, float32
accumulation.  float32 inputs run as three TF32 tensor-core products on a
hi/lo split of both operands (`split_tf32`), which keeps the float32 result
to ~1e-6 relative; the plain version is one float32 matmul.

The kernel is compiled with nvcc at first use into ltetrigger_tpu_torch/
_build/ (keyed by a hash of the sources) and bound with ctypes.  Several
processes (the ranks of a mesh) may reach first use at once: each compiles
to a temporary name of its own and renames it into place, and a rename is
atomic, so no process ever loads a half-written library; at worst two of
them compile the same sources.  There is no lock file to go stale.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from ...ltecore.constants import SYMBOL_SZ
from .. import correlate

NBLK = correlate.NBLK                    # 75 blocks of 128 per half-frame
NPOW = correlate.N_ROOTS * SYMBOL_SZ     # 384 power columns per block
_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = 0          # kernel launches through either entry point
_lib = None


# ------------------------------------------------------------ plain version
def rows_power_plain(buf_re: torch.Tensor, buf_im: torch.Tensor, lo: int,
                     m: int, dtype=torch.bfloat16,
                     cfo_bin: float = 0) -> torch.Tensor:
    """Plain PyTorch version of one kernel launch: [*B, N] pair -> [*B, m,
    384], row j from the 256 samples at lo + 128 j (zeros past N).  One
    [m, 512] @ [512, 768] matmul per lane (the operand is materialized
    here), then the comp-major square-sum.  `cfo_bin` picks the replica
    bank (correlate._toeplitz_weights)."""
    batch = buf_re.shape[:-1]
    span = (m + 1) * SYMBOL_SZ

    def blocks(comp):
        s = comp[..., lo:lo + span]
        if s.shape[-1] < span:
            s = torch.nn.functional.pad(s, (0, span - s.shape[-1]))
        return s.reshape(batch + (m + 1, SYMBOL_SZ))

    r, i = blocks(buf_re), blocks(buf_im)
    x = torch.cat([r[..., :-1, :], i[..., :-1, :], r[..., 1:, :],
                   i[..., 1:, :]], dim=-1)               # [.., m, 512]
    W = correlate.weights_fat(str(buf_re.device), cfo_bin)
    if dtype == torch.bfloat16:
        x, W = correlate.round_bf16(x), correlate.round_bf16(W)
    c = x @ W                                            # [.., m, 768]
    return c[..., :NPOW] ** 2 + c[..., NPOW:] ** 2


def group_power_plain(buf_re: torch.Tensor, buf_im: torch.Tensor, lo: int,
                      g: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch pass A: `rows_power_plain` over g * 75 rows."""
    p = rows_power_plain(buf_re, buf_im, lo, g * NBLK, dtype)
    return p.reshape(buf_re.shape[:-1] + (g, NBLK, correlate.N_ROOTS,
                                          SYMBOL_SZ))


# ------------------------------------------------------------------ build --
def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> tuple[pathlib.Path, float]:
    """Compile csrc/*.cu into one shared library (cached by source hash).
    The compiler's report (registers, spills, shared memory per kernel) is
    kept beside it as <library>.log.

    returns (library path, seconds spent compiling; 0.0 on a cache hit)."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libltetrigger_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           *(str(s) for s in srcs)], capture_output=True,
                          text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}):\n"
                           f"{done.stdout}{done.stderr}")
    tmp_log = tmp.with_suffix(".log")
    tmp_log.write_text(done.stdout + done.stderr)
    os.replace(tmp_log, lib.with_suffix(".log"))
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


def _load():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.mf_group_power
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (hi, lo) with hi + lo == x exactly: hi is x with its low 13
    mantissa bits cleared (a TF32 number), lo the remainder.  The float32
    body multiplies x_hi W_hi + x_hi W_lo + x_lo W_hi on the tensor cores,
    which read the leading 11 mantissa bits of each operand."""
    hi = (x.view(torch.int32) & -8192).view(torch.float32)
    return hi, x - hi


def weights_by_root(device: str, cfo_bin: float = 0) -> torch.Tensor:
    """W_fat transposed to [768, 512] (K contiguous) with one root's re and
    im columns adjacent: row 256 r + 128 c + m is column 384 c + 128 r + m
    of W_fat (c = 0 re, 1 im; r the root)."""
    wt = correlate.weights_fat(device, cfo_bin).T        # [2 * 3 * 128, 512]
    k = wt.shape[-1]
    return wt.reshape(2, correlate.N_ROOTS, SYMBOL_SZ, k).permute(1, 0, 2, 3) \
        .reshape(2 * NPOW, k).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel_weights(device: str, bf16: bool, cfo_bin: float = 0) \
        -> torch.Tensor:
    """The kernel's weights for one replica bank: `weights_by_root` rounded
    to bfloat16, or its float32 (hi, lo) split stacked as [2, 768, 512]."""
    wt = weights_by_root(device, cfo_bin)
    if bf16:
        return wt.to(torch.bfloat16)
    return torch.stack(split_tf32(wt)).contiguous()


def rows_power(buf_re: torch.Tensor, buf_im: torch.Tensor, lo: int, m: int,
               dtype, cfo_bin: float = 0) -> torch.Tensor:
    """Run the kernel: [*B, N] pair -> [*B, m, 384] (m operand rows; plain
    version: `rows_power_plain`)."""
    global launches
    if buf_re.device.type != "cuda":
        raise ValueError(f"matched-filter kernel needs CUDA tensors, got "
                         f"{buf_re.device}")
    if buf_im.device != buf_re.device or buf_im.shape != buf_re.shape:
        raise ValueError("re and im must share device and shape")
    for t in (buf_re, buf_im):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("matched-filter kernel takes contiguous float32")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported matmul dtype {dtype}")
    n = buf_re.shape[-1]
    batch = buf_re.shape[:-1]
    nb = buf_re.numel() // max(n, 1)
    if n >= 2 ** 31 or nb >= 65536:
        raise ValueError(f"buffer [{nb}, {n}] exceeds the kernel's range")
    lib = _load()
    out = torch.empty(batch + (m, NPOW), device=buf_re.device,
                      dtype=torch.float32)
    bf16 = int(dtype == torch.bfloat16)
    wt = _kernel_weights(str(buf_re.device), bool(bf16), cfo_bin)
    # the staged operand: [2 nb, m + 1, 128] bfloat16, or float32 hi and lo
    scratch = torch.empty(2 * nb * (m + 1) * SYMBOL_SZ * (2 if bf16 else 8),
                          device=buf_re.device, dtype=torch.uint8)
    stream = torch.cuda.current_stream(buf_re.device).cuda_stream
    rc = lib.mf_group_power(buf_re.data_ptr(), buf_im.data_ptr(),
                            wt.data_ptr(), scratch.data_ptr(),
                            scratch.numel(), out.data_ptr(), nb, n, lo, m,
                            bf16, stream)
    if rc != 0:
        raise RuntimeError(f"mf_group_power launch failed: error {rc} (a "
                           f"cudaError, or 20000 + a CUresult)")
    launches += 1
    return out


# ----------------------------------------------------------- entry points --
def group_power(buf_re: torch.Tensor, buf_im: torch.Tensor, lo: int, g: int,
                dtype=torch.bfloat16) -> torch.Tensor:
    """Pass A power for g grid steps from `lo`: [*B, N] -> [*B, g, 75, 3,
    128] float32 (see the module docstring)."""
    if lo < 0:
        raise ValueError(f"grid start {lo} < 0")
    if buf_re.device.type == "cpu":
        return group_power_plain(buf_re, buf_im, lo, g, dtype)
    out = rows_power(buf_re, buf_im, lo, g * NBLK, dtype)
    return out.reshape(buf_re.shape[:-1] + (g, NBLK, correlate.N_ROOTS,
                                            SYMBOL_SZ))


def pss_correlate_power(window, dtype=torch.bfloat16,
                        cfo_bin: float = 0) -> torch.Tensor:
    """pair of [B, >= 9728] float32 -> [B, 3, 9600] float32 (the window
    contract of the Pallas kernel; plain version:
    correlate.pss_correlate_power_v2, and for cfo_bin != 0 one bin of
    correlate.pss_correlate_power_cfo_bins)."""
    wr, wi = window
    if wr.ndim != 2 or wr.shape[-1] < correlate.V2_WINDOW:
        raise ValueError(f"window must be [B, >= {correlate.V2_WINDOW}], "
                         f"got {tuple(wr.shape)}")
    if wr.device.type == "cpu":
        return correlate.pss_correlate_power_cfo_bins(
            window, (cfo_bin,), dtype)[:, 0]
    b = wr.shape[0]
    out = rows_power(wr, wi, 0, NBLK, dtype, cfo_bin)       # [B, 75, 384]
    return out.reshape(b, NBLK, correlate.N_ROOTS, SYMBOL_SZ) \
        .permute(0, 2, 1, 3).reshape(b, correlate.N_ROOTS,
                                     correlate.SEARCH_LEN)


def pss_correlate_power_cfo_bins(window, bins=(-2, -1, 0, 1, 2),
                                 dtype=torch.bfloat16) -> torch.Tensor:
    """pair of [..., >= 9728] float32 -> [..., len(bins), 3, 9600] float32:
    correlation power against the replica banks shifted by `bins`
    subcarriers, one kernel launch per bin on the card (plain version:
    correlate.pss_correlate_power_cfo_bins, two matmuls over all bins)."""
    wr, wi = window
    if wr.device.type == "cpu":
        return correlate.pss_correlate_power_cfo_bins(window, bins, dtype)
    batch = wr.shape[:-1]
    flat = (wr.reshape(-1, wr.shape[-1]).contiguous(),
            wi.reshape(-1, wi.shape[-1]).contiguous())
    power = torch.stack([pss_correlate_power(flat, dtype, b) for b in bins],
                        dim=1)                       # [B, bins, 3, 9600]
    return power.reshape(batch + power.shape[1:])
