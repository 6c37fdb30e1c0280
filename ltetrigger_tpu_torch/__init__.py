"""ltetrigger_tpu_torch: LTE cell sensing on PyTorch and CUDA.

The PyTorch port of `ltetrigger_tpu`, module for module (same layout and
names, so each function's counterpart is easy to find).  The JAX package
stays the reference the port is tested against.  This package imports
`torch` and never `jax`, and nothing of the JAX package: it keeps its own
copies of that package's numpy-only layers (`ltecore`, `runtime`, `utils`),
held equal to the originals by tests/test_torch_shared.py.

Layers (bottom-up):
  ltecore/      LTE signal-model math in numpy: sequences, tables, coding,
                the host reference receiver and the frame synthesizer
  ops/          PyTorch ops on (re, im) float32 pairs: correlator, resampler,
                channelizer, DFT, CFO, CP/SSS, PBCH, Viterbi; device.py
                (the `device=` rule and pinned uploads)
  ops/kernels/  hand-written CUDA kernels and their plain PyTorch versions
  csrc/         the kernels' CUDA C++ sources (built at first use)
  models/       the grid engine (passes A, B, C), the one-shot `search`, and
                the streaming `Trigger`, `MultiTrigger`, `WidebandTrigger`
  parallel/     the process mesh on torch.distributed (one process per
                device; axes `ch` and `t`), `channel_scan(mesh=)`,
                `time_sharded_scan` with the halo exchange, `gather_events`
  runtime/      host-side state: the tracked-cell store, the chunk buffer
  utils/        engineering notation, StageTimer, torch.profiler tracing
  apps/         the CLIs: cell_search_file, live_monitor, wideband_scan,
                snr_sweep, run_flowgraph
  grc/          GRC block descriptors that run_flowgraph executes

Every entry point takes `device=` ("cuda" by default) and raises without a
card when CUDA is asked for; none continues on the CPU in its place.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy imports keep `import ltetrigger_tpu_torch` fast and torch-optional
    # for pure-numpy users of ltecore.
    if name in ("search", "Trigger"):
        from .models import api
        return getattr(api, name)
    if name == "MultiTrigger":
        from .models.multi import MultiTrigger
        return MultiTrigger
    if name == "WidebandTrigger":
        from .models.wideband import WidebandTrigger
        return WidebandTrigger
    if name in ("make_mesh", "init_distributed", "channel_scan",
                "time_sharded_scan", "halo_exchange_right", "gather_events"):
        from . import parallel
        return getattr(parallel, name)
    if name == "CellStore":
        from .runtime.cellstore import CellStore
        return CellStore
    raise AttributeError(name)
