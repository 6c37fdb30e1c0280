"""ltetrigger_tpu_torch: the one-shot LTE cell search on PyTorch and CUDA.

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
                DFT, CFO, CP/SSS, PBCH, Viterbi
  ops/kernels/  hand-written CUDA kernels and their plain PyTorch versions
  csrc/         the kernels' CUDA C++ sources (built at first use)
  models/       the grid engine (passes A, B, C) and `search`
  runtime/      host-side state: the tracked-cell store, the chunk buffer
  utils/        engineering notation, StageTimer, torch.profiler tracing
  apps/         the cell_search_file CLI
"""

__version__ = "0.1.0"
