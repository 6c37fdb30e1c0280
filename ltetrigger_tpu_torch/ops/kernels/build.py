"""First-use build of the port's CUDA kernels (ltetrigger_tpu_torch/csrc).

Every `csrc/*.cu` (with the `csrc/*.cuh` it includes) is compiled by its
own nvcc process, all started at once, and the objects are linked into one
shared library with a plain C interface under ltetrigger_tpu_torch/_build/,
named by a hash of the sources, the headers and the flags.  `library()`
loads it with ctypes once per process; each kernel's wrapper module
declares the argument types of its own entry point.

Several processes (the ranks of a mesh) may reach first use at once: each
compiles into a temporary directory of its own and renames the library into
place, and a rename is atomic, so no process ever loads a half-written
library; at worst two of them compile the same sources.  There is no lock
file to go stale.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# compile flags of every source; "-Xptxas -v" writes the register, spill and
# shared-memory report kept beside the library as <library>.log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(csrc: pathlib.Path = CSRC, out_dir: pathlib.Path = BUILD_DIR,
                 extra_flags: tuple = ()) -> pathlib.Path:
    """Where the library of the sources in `csrc`, compiled with
    NVCC_FLAGS + `extra_flags`, lives under `out_dir`: its name carries a
    hash of every source's and header's name and bytes and of the flags, so
    any edit, added file or flag names a new library."""
    h = hashlib.sha256()
    for s in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join([*NVCC_FLAGS, *extra_flags]).encode())
    return out_dir / f"libltetrigger_kernels_{h.hexdigest()[:16]}.so"


def build(out_dir: pathlib.Path = BUILD_DIR,
          extra_flags: tuple = ()) -> tuple[pathlib.Path, float]:
    """Compile csrc/*.cu with NVCC_FLAGS + `extra_flags` into one shared
    library under `out_dir` (cached by source hash).  The defaults build
    the port's own kernels; a tool that builds an instrumented variant
    (-D flags) passes its own directory and flags.

    returns (library path, seconds spent compiling; 0.0 on a cache hit)."""
    lib = library_path(CSRC, out_dir, extra_flags)
    if lib.exists():
        return lib, 0.0
    srcs = sorted(CSRC.glob("*.cu"))
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [*NVCC_FLAGS, *extra_flags]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [pathlib.Path(tmp) / f"{s.stem}.o" for s in srcs]
        procs = [subprocess.Popen([nvcc, *flags, "-c", str(s), "-o",
                                   str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        report = [p.communicate()[0] for p in procs]
        failed = [(s.name, p.returncode, r)
                  for s, p, r in zip(srcs, procs, report) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{r}" for name, rc, r in failed))
        tmp_lib = pathlib.Path(tmp) / lib.name
        done = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                               *(str(o) for o in objs)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({done.returncode}):\n"
                               f"{done.stdout}{done.stderr}")
        tmp_log = tmp_lib.with_suffix(".log")
        tmp_log.write_text("".join(report))
        os.replace(tmp_log, lib.with_suffix(".log"))
        os.replace(tmp_lib, lib)
    return lib, time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once."""
    global _lib
    if _lib is None:
        path, _ = build()
        _lib = ctypes.CDLL(str(path))
    return _lib


def kernel_info(entry: str, *args: int) -> dict:
    """What the card holds of one kernel, from its library's `entry`
    (`int entry(int out[4], int args...)`, the ints naming a variant):
    registers a thread, local (spill) bytes a thread, static shared memory
    a block, blocks resident a SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current card)."""
    fn = getattr(library(), entry)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int * 4)] \
        + [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    check(fn(ctypes.byref(out), *args), entry)
    return dict(zip(("regs", "local_bytes", "smem_bytes", "blocks_per_sm"),
                    out))


def check(rc: int, what: str) -> None:
    """Raise if an entry point returned an error (a cudaError, or 20000 + a
    CUresult)."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: error {rc} (a cudaError, "
                           f"or 20000 + a CUresult)")
