#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ltetrigger_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card: torch version, device name, `nvidia-smi` name and power limit
     (exits non-zero without a CUDA device);
  2. builds the CUDA kernels from ltetrigger_tpu_torch/csrc (one nvcc a
     source, all at once; timed) and prints the compiler's register and
     spill report;
  3. the matched-filter kernel against its plain PyTorch version on the card
     (grid entry at 1 and 128 channels x 25 steps, window entry at B=8; f32
     and bf16 inputs; CUDA-event times), each beside its bound and beside
     one library matmul on the pre-built operand (`torch.matmul`, which the
     port never calls); a ramp stream, a buffer with N and lo unaligned and
     read past its end, row counts that are no multiple of the row tile;
     and bf16 against f32 decisions;
 3a. the pass-B kernel (csrc/pass_b.cu) against its plain version
     (`scan_group_plain`) on the card: C=128 x 4 groups of 25 steps of
     pass A's real power from fresh state; planted power (edge-bin peaks,
     ties in different blocks, acquisition, loss, reacquisition, a partial
     last group) at B = 8 / 1 / 8 / 16 and g=32; every row and state field
     equal, the EMA bit for bit; CUDA-event times of the kernel and the
     plain group beside the bound (the searched root-steps' power, the EMA
     and ring in and out), at C=128 also the plain group captured once in a
     CUDA graph and replayed (a measurement only, never a path); the
     kernel's registers, spills, shared memory and resident blocks a SM
     (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and each shape's
     waves, held to its launch plan;
 3b. the Viterbi kernel (csrc/viterbi.cu) against its plain version on
     seeded codewords at sigma 0.3 / 0.8 / 1.5, B = 48 and 73728 (the
     C=128 x 100 decode's count): bits equal except where the plain
     version's two best final metrics lie within 1e-4 relative, metric
     rtol 1e-5; bits equal to the kernel's schedule in PyTorch
     (`schedule_model`) on every codeword; the same times and bound, and
     the same residency lines;
     every kernel is timed twice: its wrapper call (CUDA events over 10
     host calls, `ms`) and the same call captured once in a CUDA graph and
     replayed (no host work, `replay_ms`);
     with `--parent DIR` (DIR holds an earlier tree of the repo whose
     pass-B, Viterbi, TTI-chain and CFO-ring entry points have this
     tree's signatures, e.g. a `git archive` of the parent commit):
     DIR/ltetrigger_tpu_torch copied into a temporary directory outside
     the repo and imported there as a package of its own, whose wrappers
     and build.py build and launch its kernels; they are held to the same
     plain versions and timed beside the kernels on the same inputs,
     parent, kernel, kernel, parent (3a-3d), a wrapper call and replayed;
 3c. the TTI-chain kernel (csrc/tti_chain.cu) against its plain version
     (`tti_chain_plain`) and its schedule in PyTorch (`schedule_model`)
     at C=128 x 3 lanes x K=16, 16 x 3 lanes x K=16 and 1 x 3 lanes x
     K = 4 and 32, seeded LLRs with signed zeros, fresh restarts, cell-id
     changes, invalid tail slots, combine True and False: accs, qs, the
     accumulator, n and cell bit for bit; the same times, bound (bytes:
     the LLRs of each slot in use read and the accumulator after every
     slot written once) and a residency line for each launch shape (one-
     and four-warp blocks);
 3d. the CFO-ring kernel (csrc/cfo_ring.cu) against its plain version
     (`ring_scan_plain`) at 48 lanes x S = 201, 400 and 1000 (5 wraps,
     several resets) and 3072 lanes x S = 400 (the residency shape, four
     waves): ring and count exact, the mean within atol 1e-5
     subcarriers, all three bit for bit its schedule in PyTorch
     (`schedule_model`); times, the bound (bytes and adds), one lane
     alone, residency;
  4. the main path: `search(device="cuda")` over 1 s of four synthetic cells
     at 1.92 / 7.68 / 15.36 / 30.72 Msps, then the CLI on a capture file,
     with the three kernels' launch counts set to 0 before them and read
     after (each must have launched);
  5. one scan_engine dispatch of 128 channels x 100 half-frame steps (about
     1 GB of stream on the card), detections checked in every channel, and a
     small dispatch checked field for field against the CPU run; then the
     dispatch's time pass by pass;
  6. the streaming `Trigger(device="cuda")`: 2 s of a synthetic cell in
     19200-sample chunks, once per transport f32 / i16 / i8; the f32 events
     equal those of the same Trigger on the CPU field for field, i16 / i8
     find the same cell, pipeline=0 and pipeline=2 publish the same; stream
     samples per second of wall time, the StageTimer summary, kernel launches
     and host syncs per dispatch, and the most dispatches in flight; the
     same stream in 307200-sample chunks (deep dispatches); then
     one dispatch per step bucket (4/8/16/32) with its launches counted, and
     the kernel against its plain version on the 2.5 M-sample mirror (N=1
     and N=8 rows, g=32, lo no multiple of 128) and on one CFO bank at B=4;
  7. `MultiTrigger(8, device="cuda")` over 8 different cells, 2 s each, for
     i16 and i4: per-stream events equal those of 8 single Triggers on the
     card; in the i4 run one stream ends early and is continued with
     fill_gap; samples per second per stream;
  8. a cell offset by 1.5 subcarriers: `search(cfo_search_range=2)` finds it
     and plain `search` does not, a `Trigger(cfo_search_range=2)` acquires
     it, 9 kernel launches per probe, the banks' kernel output against the
     plain version;
  9. a checkpoint: `save_state` on the card, `load_state` into a fresh
     Trigger, and the continued run publishes what the uninterrupted one
     does;
 9a-9e. the long-running monitor (`python3 chip_smoke.py --monitor` runs
     phases 1, 2 and these alone, then 9d's idle share, and ends with
     {"ok": null, "partial": "monitor"}):
 9a. a soak: one 10-s block of cell 125 (its first second without the
     cell, under noise 20 dB over it: an interferer) fed 29 times as views,
     556.8 M samples, through `Trigger(transport="i8", pipeline=2)` in
     307200-sample calls with REBASE_AT at its real 2^29: the rebase fires
     once, in-stream; the events are exactly the gap schedule (a track after
     every gap, a drop in every gap but the first, the same fields), a drop
     and a track lie within 2 s of stream of the rebase, the cell is tracked
     at the end; samples/s of wall time, the StageTimer, launches and host
     syncs a dispatch before and after the rebase, dispatches in flight, the
     rebasing call's time beside its ten neighbours';
 9b. the first 41.8 M samples of that stream one subcarrier off through a
     Trigger with cfo_search_range=4 (i8, pipeline=0: the upload segments
     are the stream's alone) with REBASE_AT 2^23 (4 rebases) and 2^29: the
     same events field for field, bin and telemetry;
 9c. `MultiTrigger(8, i4)` and `WidebandTrigger(8 carriers at 15.36 Msps,
     wide i8)`, 7 blocks of 1.6 s (21.5 M samples a stream), each stream
     its own cell and its own 0.25-s gap (noise 20 dB over the cell, in its
     channel), pipeline=0, REBASE_AT 2^21 (10 rebases) and 2^29: the same
     events stream by stream, every stream tracked at the end, `_wabs` the
     rebases' deltas; each class's pair is a path of its own for `ran()`;
 9d. a producer thread hands 38400-sample chunks of the soak's stream to a
     queue of 64 at 1.92 Msps of wall time for 10 s, 8 chunks at once (a
     burst, as an SDR hands over a buffer); the monitor calls process()
     when a chunk is there and poll() otherwise, and after each call pulls
     nothing while `backlog` exceeds half a half-frame, polling for at most
     2 ms: a bound below the one half-frame of read-ahead that process()
     leaves standing in one process (pass C's host waits drain every
     dispatch before it returns), so the gate holds (held > 0) and only new
     samples release it; the queue never overflows and the events equal
     the same samples fed flat-out; the backlog's median / p99 / max in ms,
     how often the gate held and how often the polls drained it; phase 29
     paces 3 s more under torch.profiler for the device's idle share;
 9e. 144 M samples through `Trigger.process` in 19200-sample calls as
     fast as this thread makes them, then flush(): the median call of the
     last decile at most 3x the first's, the cell tracked; the worst call
     of the second half, the backlog, resident memory, flush()'s drain;
 10. the channelizer: 0.25 s of a 30.72 Msps band to 16 centres on the card
     against the same code on the CPU; CUDA-event time, wide samples/s;
 11. `wideband_scan` of that band, three synthetic cells at three of the 16
     centres: exactly those three detected, cell id and PRB right;
 11b. `wideband_scan(seconds=2.0)` of the same band made 2 s long: one
     dispatch of 16 channels x 400 steps, past the 200-slot ring, so the
     CFO-ring kernel runs on every channel beside the other four: exactly
     the planted cells and fields, its wall time (best of 3); the ring
     kernel's launch on that dispatch's own est / push / lost (captured by
     wrapping the module's kernel function) equals `ring_scan_plain` on
     them (ring and count exact, the mean within atol 1e-5);
 12. `WidebandTrigger(15.36 Msps, 8 centres)`, 2 s, eight 50-PRB cells: f32
     events equal the CPU run's (the CPU runs the first 0.6 s) and equal the
     card's `MultiTrigger(8)` fed the one-shot channelizer's rows; i8 and i4
     find all eight; narrow samples/s per carrier, StageTimer, one kernel
     launch a dispatch, host waits a dispatch equal to MultiTrigger's, the
     most dispatches in flight;
 13. 16 carriers at 30.72 Msps, i8, 1 s: all 16 found; samples/s a carrier;
 14. a wideband checkpoint across a cut, with four cells that come up after
     it; `live_monitor --wideband` and `wideband_scan` as subprocesses on a
     capture file;
 15. `snr_sweep`, 21 points x 8 trials x 0.5 s (168 channels x 100 steps):
     P(detect) 1 at and above 0 dB, 0 at and below -26 dB (the knee of a
     noise-free synthetic frame looped for 0.5 s lies near -20 dB, in the
     JAX package too); `pbch_sweep`, 5 x 8;
 16. `run_flowgraph`: both examples/*_torch.grc demos on the card (needs
     PyYAML: without it one line says so and the phase does not start);
 17. the kernel against its plain version at this slice's shapes: the
     16-row mirror at g=32, the sweep's 168 channels, the 16-channel scan;
 18. the process mesh with NCCL at world size 1, in this process:
     `init_distributed` on a free local port, `make_mesh()` is {ch: 1,
     t: 1}; `channel_scan(mesh=)` of 16 channels x 50 steps equals
     `channel_scan()` field for field (its all_gather runs through NCCL);
     `time_sharded_scan` of 1 s of a cell on the one-shard mesh;
     `MultiTrigger(8, mesh=)` and `WidebandTrigger(mesh=)` publish what
     phases 7 and 12 did; a checkpoint saved with the mesh loads without it;
 19. the kernel against its plain version at the shapes a rank gets: 64 and
     32 channels at g=25, a 2-row and a 4-row mirror at g=32;
 20. several ranks on the one card: this script again as 2 and then 4
     subprocesses (`--rank`), gloo between them, every rank on cuda:0.
     `ch` = 2 and 4: `channel_scan` of phase 5's 128 channels x 100 steps,
     the gathered output equal to one process's field for field, a detection
     in all 128 channels, kernel launches per rank, the wall time per rank
     and for all beside one process's in the same call; then every rank
     scans all 128 channels at the same time (2x and 4x the work).  `t` = 4:
     `time_sharded_scan` of 2 s of a cell (0.5 s blocks), found in every
     block; a stream whose last peak of every block lies 200 samples before
     the seam, found through the halo, integers equal to the same call on 4
     CPU ranks.  `ch` = 4: `MultiTrigger(8, mesh=)` i16 and
     `WidebandTrigger(8 centres, mesh=)` f32, gathered events equal to
     phases 7 and 12, samples/s per stream; a sharded checkpoint across a
     cut, loaded by a trigger without a mesh.  Then the multi-process
     monitor (`python3 chip_smoke.py --mesh` runs the build, 9c and these
     alone and ends with {"ok": null, "partial": "mesh"}):
     (a) `ch` = 4: `MultiTrigger(8, i4, mesh=)` and `WidebandTrigger(8
     centres at 15.36 Msps, wide i8, mesh=)` at pipeline=2 through phase
     9c's 21.5 M samples a stream with REBASE_AT 2^21 in every rank: each
     rank's callbacks' events, merged, equal 9c's one-process events stream
     by stream, every rank rebases as often as 9c's run, every stream is
     tracked at the end, `_wabs` is the rebases' deltas on every rank; a
     flush and a `save_state` before every call from two before the first
     call that passes each of the first two multiples of REBASE_AT to four
     after it; one of those checkpoints (the first at which the ranks had
     rebased differently, else the first that settled a rebase) loaded into
     a trigger without a mesh and continued to the end publishes the rest;
     each rank's rebase calls, samples/s a stream and the checkpoints' ms;
     (b) `ch` = 4: a producer thread a rank, 10 s of those streams at 1.92
     Msps a stream, in bursts as in 9d, into `MultiTrigger(8, i4, mesh=)`
     with the bound at two half-frames: above the read-ahead, below it plus
     the dispatch in flight that ranks sharing the card leave; held > 0 on
     every rank, the events equal the same samples fed flat-out, each
     rank's lag median / p99 / max; (c) `ch` = 2 and 4: `channel_scan(mesh=)`
     with 128 channels a rank (phase 5's buffer repeated: C = 256 and 512 x
     100 steps), the gathered output equal to one process's channel_scan of
     the same C field for field, a detection in every channel, the times
     beside one process's.  Every rank records the CPUs it may run on, its
     torch threads and each plan's wall and CPU seconds.  Each spawn has a
     420 s limit, a failing rank ends the others and the run, the ranks'
     output is printed with a `[rank r/n]` prefix;
 21. one rank per card over NCCL, only where there are two or more cards
     (one line says so otherwise): the `ch` and `t` cases of phase 20 and
     its (a) and (c); `python3 chip_smoke.py --cards` runs phases 1, 2, 9c
     and this one alone;
 22-28. the example tools, examples/*_torch.py, in this process where no
     ranks or environment variables are needed:
 22. `bench_sweep_torch` at C = 32, 256 and 1024 (0.55 s, 0.55 s and, under
     its 6 GB cap, 0.275 s = 55 steps): cell 123 found at every point;
 23. `bench_attrib_torch passes` at C = 128 and 512 (host ms and device ms
     of each rung), the C=128 `ABC_decode` rung equal to `scan_engine` on
     the same buffer field for field; `decode` and `micro` at C=128 (pass
     C's front end, codeword search and Viterbi; its small stages);
 24. `bench_attrib_torch groups` at C=512 with budgets 4096 and 16384, a
     subprocess each: g = 5 and 25; every kernel's launches from the
     subprocesses' JSON (`launches_by_kernel`), held to `ran()`;
 25. `bench_stream_torch`: 0.5 s through a Trigger per transport (f32, i16,
     i8) and through MultiTrigger(8) (i16, i4), cell 123 found in each;
 26. `seam_sweep_torch` on 4 gloo ranks sharing the card, 0 and -30 dB x 2
     trials: P(detect) 1 and 0 for the continuous and the sharded scan;
     rank 0's launches of every kernel from its JSON, held to `ran()`;
 27. `make_snr_curve_torch --trials 2 --step 4` into a temporary directory:
     both files written, all ten knees present;
 28. the kernel against its plain version at the grid shapes these tools
     add: C=256 g=10, C=512 g=5, C=512 g=25, C=1024 g=1;
 29. what uses torch.profiler, last, because a process that has run it may
     launch more slowly afterwards: the small launches' host enqueue time
     and each launch's device kernels by name; a streaming dispatch's device
     kernels, device time and idle share; the 128 x 100 dispatch's device
     time and its largest kernels;
 30. the port must not have imported jax or the JAX package, nor loaded a
     module from a file outside its own directory.

Nothing of phases 1-21 was cut to make room for the later ones.
`python3 chip_smoke.py --kernels [--parent DIR]` runs phases 1-3d alone
and ends with {"ok": null, "partial": "kernels"}: it drives no path.

Every path is driven with the five kernels' launch counts (matched filter
"mf", pass B "pb", TTI chain "tti", Viterbi "vit", CFO ring "ring") set to
0 just before it and read just after; each must have launched the first
four, the TTI chain exactly as often as the Viterbi (one of each a decoding
dispatch), and the CFO ring on phase 11b's path alone (the only dispatch
past 200 steps); each rank x plan of phases 20 and 21 is a path of its
own; the paths that run in other processes (the ranks, the example tools'
groups and seam sweep) report every kernel's count in their JSON, and the
attribution tool's `decode` / `micro` stages launch the Viterbi alone.  The
line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import importlib.util
import io
import json
import math
import pathlib
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

TOL = dict(rtol=1e-4, atol=1e-5)      # float32 sums in another order
# H100 SXM data sheet, dense: device memory, bf16 tensor cores, float32 on
# the SM cores (the type of a float32 product, however the kernel gets there)
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
# the float32 peak counts an FMA as two operations: an add, a product or a
# compare alone is one instruction, so such work runs at most at half of it
PEAK_F32_OP = PEAK_F32 / 2
C_BIG, STEPS_BIG = 128, 100
CELLS = ((123, 6, 1.92e6), (124, 25, 7.68e6), (125, 50, 15.36e6),
         (369, 100, 30.72e6))
# the 8 streams of the MultiTrigger phases (cell id, PRB) and the 8 carriers
# of the WidebandTrigger phases (the same ids, 50 PRB, at 15.36 Msps)
CELLS8 = ((10, 6), (41, 15), (72, 25), (103, 50), (134, 75), (165, 100),
          (196, 25), (227, 50))
RATE8 = 15.36e6
CENTERS8 = [(k - 3.5) * 1.92e6 for k in range(8)]


def log(*a):
    print(*a, flush=True)


class Counts(dict):
    """Kernel launches by kernel: "mf" (matched filter), "pb" (pass B),
    "tti" (TTI chain), "vit" (Viterbi), "ring" (CFO ring); counts add key
    by key."""

    def __add__(self, other):
        return Counts({k: self.get(k, 0) + other.get(k, 0)
                       for k in (*self, *other)})

    def __radd__(self, other):
        return self if other == 0 else self + other

    def __str__(self):
        return " / ".join(f"{self.get(k, 0)} {k}" for k in KERNELS)


KERNELS = ("mf", "pb", "tti", "vit", "ring")
# the kernels every path launches; "ring" runs only past 200 steps
PATH_KERNELS = ("mf", "pb", "tti", "vit")
LONG_PATH = "wideband_scan 2 s"     # phase 11b: the one such dispatch


def ran(n: dict, long: bool = False) -> bool:
    """A path's launches `n`: every kernel of PATH_KERNELS launched, the TTI
    chain as often as the Viterbi, and the CFO ring where (and only where)
    a dispatch ran past 200 steps (`long`)."""
    return (all(n.get(k, 0) for k in PATH_KERNELS)
            and n.get("tti", 0) == n.get("vit", 0)
            and (n.get("ring", 0) > 0) == long)


def reset_launches() -> None:
    from ltetrigger_tpu_torch.ops.kernels import modules
    for m in modules().values():
        m.launches = 0


def read_launches() -> Counts:
    from ltetrigger_tpu_torch.ops.kernels import launch_counts
    return Counts(launch_counts())


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean milliseconds per call on the card (CUDA events, 2 warm-ups)."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def replay_ms(fn, iters: int = 10, calls: int = 1) -> float:
    """Mean device milliseconds a call of `fn` with the host's launch work
    taken out: `calls` calls of `fn` captured once in a CUDA graph (after
    two warm-ups on a side stream) and the graph replayed (CUDA events),
    over `calls`.  With one call a graph, a launch shorter than the host's
    graph launch measures that; with many, the launches run back to
    back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    cg = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cg):
        for _ in range(calls):
            fn()
    ms = cuda_ms(cg.replay, iters) / calls
    del cg
    return ms


def bound(b: int, m: int, dt) -> tuple[float, str]:
    """Least milliseconds the card could take for b lanes x m rows, and what
    sets it: stream, W read once and power written once over the memory rate,
    against the product's and the square-sum's operations over the peak rate
    of the input type."""
    nbytes = 4 * (2 * b * (m + 1) * 128 + 512 * 768 + b * m * 384)
    ops = 2 * b * m * 512 * 768 + 3 * b * m * 384
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / (PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32)
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def operand(buf, lo: int, m: int) -> torch.Tensor:
    """The [b * m, 512] float32 operand of the library matmul, pre-built:
    row j = [re | im | re + 128 | im + 128] from lo + 128 j."""
    blocks = [c[:, lo:lo + 128 * (m + 1)].reshape(c.shape[0], m + 1, 128)
              for c in buf]
    return torch.cat([blocks[0][:, :-1], blocks[1][:, :-1], blocks[0][:, 1:],
                      blocks[1][:, 1:]], dim=-1).reshape(-1, 512)


def kernel_label(mangled: str) -> str:
    """A kernel's name from its mangled one (every kernel of csrc/ is named
    <prefix>_..._kernel), with a template's arguments up to their end."""
    m = re.search(r"(?:mf|pb|vit|tti|ring)_\w*?kernel", mangled)
    if not m:
        return mangled
    rest = mangled[m.end():]
    return m.group(0) + (rest.split("EE")[0] if rest[:1] == "I" else "")


def enqueue_us(fn, reps: int = 100) -> float:
    """Mean host microseconds to enqueue one call of `fn` (no wait for the
    card inside the timed region)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def profiled(fn, reps: int) -> list:
    """The device events (kernels and copies, averaged by name) of `reps`
    calls of `fn` under torch.profiler, after a warm-up call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_kernels(fn, reps: int = 5) -> dict:
    """Mean device milliseconds per call of `fn`, by device kernel name
    (torch.profiler)."""
    return {e.key: e.device_time_total / 1e3 / reps
            for e in profiled(fn, reps)}


def device_events(fn) -> tuple[int, float]:
    """(device kernels and copies, device milliseconds) of one call of `fn`
    under torch.profiler, after a warm-up call."""
    dev_ev = profiled(fn, 1)
    return (sum(e.count for e in dev_ev),
            sum(e.device_time_total for e in dev_ev) / 1e3)


EDGE_BINS = (0, 63, 64, 127, 128, 9535, 9598, 9599)


def planted_power(dev, n: int, g: int, strong, seed: int) -> torch.Tensor:
    """[n, g, 75, 3, 128] float32 pass-A power on the card: unit
    exponential noise; where strong[t], roots 0 and 1 of each lane a peak
    with a short lobe at an edge bin of their own (EDGE_BINS), root 2 two
    equal maxima in different blocks, equal at every step (a tie that
    lasts); silent steps carry noise only."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = -torch.log1p(-torch.rand((n, g, 3, 9600), generator=gen, device=dev))
    on = torch.tensor(list(strong), device=dev)
    for lane in range(n):
        b1 = 1000 + 17 * lane
        p[lane, :, 2, b1] = torch.where(on, 40.0, p[lane, :, 2, b1])
        p[lane, :, 2, b1 + 128 * (3 + lane % 5)] = p[lane, :, 2, b1]
        for r in (0, 1):
            pk = EDGE_BINS[(3 * lane + r) % len(EDGE_BINS)]
            for d in range(4):
                for b in {pk - d, pk + d} & set(range(9600)):
                    p[lane, :, r, b] = torch.where(on, 60.0 * 0.6 ** d,
                                                   p[lane, :, r, b])
    return p.reshape(n, g, 3, 75, 128).permute(0, 1, 3, 2, 4).contiguous()


def searched(state0, rows, n_active: int, track_every: int) -> int:
    """How many (lane, root, step) of a group ran the search (read their
    power and walked the peak): the timer replayed from the rows."""
    trk = state0.tracking.cpu().numpy()
    timer = state0.timer.cpu().numpy()
    tracking, lost = rows[3].cpu().numpy(), rows[5].cpu().numpy()
    n = 0
    for t in range(n_active):
        s = ~trk | (timer == 0)
        n += int(s.sum())
        timer = np.where(lost[t], 0, np.where(s, track_every, timer - 1))
        trk = tracking[t]
    return n


def roofline(ops: float, nbytes: float) -> tuple[float, str]:
    """(ms, what sets it): the larger of float32 operations at one an
    instruction and bytes over the memory rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_OP
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def pass_b_bound(lanes: int, g: int, n_search: int) -> tuple[float, str]:
    """Least milliseconds for one group: the searched steps' power read
    once, the EMA and PSR ring read and written once, the rows written once,
    over the memory rate; ~6 float32 operations a searched bin (two
    products, a sum, the argmax, the lobe test, the side max), none of them
    an FMA, over the float32 rate of one operation an instruction."""
    nbytes = 4 * n_search * 9600 + 2 * 4 * lanes * 3 * (9600 + 200) \
        + 19 * g * lanes * 3
    return roofline(6 * n_search * 9600, nbytes)


def viterbi_bound(b: int) -> tuple[float, str]:
    """Least milliseconds for b codewords: the float32 operations the
    decode needs over the float32 rate of one operation an instruction
    (adds and compares, no FMA), against the LLRs read and the bits and
    metric written once over the memory rate.  A radix-4 step needs the
    distinct branch metrics once (each stage's four +-r0 +- r1 +- r2 up to
    sign, 6 adds a stage, then one add for each two-stage sum the tables
    use up to sign), then 256 candidate adds and 3 compares a state; the
    end takes 63 compares and a division."""
    return roofline(b * (60 * (vit_branch_ops() + 256 + 64 * 3) + 64),
                    b * (480 + 160 + 4))


def vit_branch_ops() -> int:
    """Adds a radix-4 step spends on its distinct branch metrics: 6 for
    each stage's four sums up to sign, and one for each two-stage sum up
    to sign that the tables of ops/viterbi use."""
    from ltetrigger_tpu_torch.ops import viterbi
    ob2, _ = viterbi._radix4_tables()
    signs = {tuple(int(v) for v in row) for row in ob2.reshape(-1, 6)}
    return 12 + len({max(x, tuple(-v for v in x)) for x in signs})


def tti_bound(valid: torch.Tensor) -> tuple[float, str]:
    """Least milliseconds for the TTI chain over `valid` [*L, K]: the LLRs
    of each slot in use read once, the accumulator after every slot
    written once, the carry read and written once, the flags and cell ids
    read and the quarters written once, over the memory rate; one add an
    element of a slot in use where its phase does not restart (three of
    the four phases of every slot in use), over the float32 rate of one
    operation an instruction."""
    lanes, k = valid[..., 0].numel(), valid.shape[-1]
    used = int(valid.sum())
    nbytes = 4 * 1440 * (used + lanes * k + 2 * lanes) \
        + lanes * (16 + k * (6 + 16))
    return roofline(used * 3 * 360, nbytes)


def ring_bound(count0, push, lost) -> tuple[float, str]:
    """Least milliseconds for the CFO ring over S steps of L lanes: the
    ring and count read and written once, est / push / lost read and the
    means written once, over the memory rate; the mean of each step
    summing the slots the ring has reached (min(count, 200) values: one
    add fewer, and a division), over the float32 rate of one operation an
    instruction.  The counts are replayed on the host from push / lost."""
    count = count0.reshape(-1).cpu().numpy().astype(np.int64)
    p = push.reshape(push.shape[0], -1).cpu().numpy()
    l_ = lost.reshape(lost.shape[0], -1).cpu().numpy()
    ops = 0
    for t in range(p.shape[0]):
        count = np.where(l_[t], 0, count) + p[t]
        live = np.minimum(count, 200)
        ops += int(np.where(live > 0, live, 0).sum())
    lanes, s = count.size, p.shape[0]
    nbytes = 2 * lanes * (200 * 4 + 4) + s * lanes * (4 + 1 + 1 + 4)
    return roofline(ops, nbytes)


def chain_inputs(lead: tuple, k: int, seed: int, dev):
    """TTI-chain inputs of lanes `lead` x K slots (as
    tests/test_torch_tti_chain.py makes them): LLRs with signed zeros among
    them, fresh restarts (p 0.2), cell ids from a set of two (changes
    mid-chain), a random prefix of valid slots, n in [0, 9)."""
    rng = np.random.default_rng(seed)
    contrib = rng.normal(size=lead + (k, 3, 4, 120)).astype(np.float32)
    contrib[rng.random(contrib.shape) < 0.01] = -0.0
    acc0 = rng.normal(size=lead + (3, 4, 120)).astype(np.float32)
    arrays = (acc0, rng.integers(0, 9, size=lead).astype(np.int32),
              rng.integers(10, 12, size=lead).astype(np.int32), contrib,
              rng.random(lead + (k,)) < 0.2,
              rng.integers(10, 12, size=lead + (k,)).astype(np.int32),
              np.arange(k) < rng.integers(0, k + 1, size=lead + (1,)))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def ring_inputs(lanes: int, s: int, seed: int, dev, lost_p: float = 0.01):
    """CFO-ring inputs (as tests/test_torch_cfo_ring.py makes them): counts
    in [0, 400), a ring of values in the slots they reached, estimates in
    [-0.5, 0.5) subcarriers, rare losses (p `lost_p`) and pushes (p 0.8)
    on the other steps."""
    rng = np.random.default_rng(seed)
    count0 = rng.integers(0, 400, size=(lanes,)).astype(np.int32)
    ring0 = np.where(np.arange(200) < count0[:, None],
                     rng.uniform(-0.5, 0.5, (lanes, 200)), 0.0)
    lost = rng.random((s, lanes)) < lost_p
    arrays = (ring0.astype(np.float32), count0,
              rng.uniform(-0.5, 0.5, (s, lanes)).astype(np.float32),
              (rng.random((s, lanes)) < 0.8) & ~lost, lost)
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def near_tie(llr: torch.Tensor, rel: float = 1e-4) -> torch.Tensor:
    """[B] bool: the plain decoder's two best final path metrics differ by
    at most `rel` of the best's magnitude, where two correct decoders may
    keep different paths."""
    from ltetrigger_tpu_torch.ops import viterbi
    top = viterbi.final_metrics(llr)[0].topk(2, dim=-1).values
    return top[:, 0] - top[:, 1] <= rel * top[:, 0].abs().clamp(min=1.0)


def parent_kernels(tree: pathlib.Path) -> tuple[dict, float]:
    """The pass-B, Viterbi, TTI-chain and CFO-ring wrappers of another tree
    of the repo (e.g. a `git archive` of the parent commit):
    tree/ltetrigger_tpu_torch copied into a temporary directory and
    imported there as a package of its own, `parent_ltetrigger_tpu_torch`,
    so that its own wrappers pack their own arguments and its own build.py
    builds its own csrc at first use.  Its entry points have the signatures
    of this tree's.  returns ({"pb": scan_group_kernel, "vit":
    viterbi_decode_wa_kernel, "tti": tti_chain_kernel, "ring":
    ring_scan_kernel}, seconds of its build)."""
    name = "parent_ltetrigger_tpu_torch"
    pkg = pathlib.Path(tempfile.mkdtemp(prefix="parent_kernels_")) / name
    shutil.copytree(tree / "ltetrigger_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    build = importlib.import_module(f"{name}.ops.kernels.build")
    pb = importlib.import_module(f"{name}.ops.kernels.pass_b")
    vk = importlib.import_module(f"{name}.ops.kernels.viterbi")
    tk = importlib.import_module(f"{name}.ops.kernels.tti_chain")
    rk = importlib.import_module(f"{name}.ops.kernels.cfo_ring")
    t0 = time.perf_counter()
    build.library()
    return ({"pb": pb.scan_group_kernel, "vit": vk.viterbi_decode_wa_kernel,
             "tti": tk.tti_chain_kernel, "ring": rk.ring_scan_kernel},
            time.perf_counter() - t0)


def timed3(fn) -> tuple[float, float, float]:
    """(a wrapper call, one call a graph replayed, one of 20 calls a graph
    replayed) in milliseconds; one call a graph over 200 graph launches,
    since the host's graph launch, ~5 us with a jitter of as much, sets
    it for a short kernel, 20 calls a graph over 50."""
    return (cuda_ms(fn), replay_ms(fn, iters=200),
            replay_ms(fn, iters=50, calls=20))


def paired_ms(kern, old=None) -> dict:
    """`kern` timed by `timed3`: {"ms", "replay_ms", "graph20_ms"}; with
    `old` (a parent tree's call on the same inputs) in the order parent,
    kernel, kernel, parent, adding "again" (the kernel's second three) and
    "parent" (both of the parent's)."""
    first = timed3(old) if old is not None else None
    ms, dms, gms = timed3(kern)
    out = dict(ms=ms, replay_ms=dms, graph20_ms=gms)
    if old is not None:
        out["again"] = timed3(kern)
        out["parent"] = [first, timed3(old)]
    return out


def pairs_text(t: dict) -> str:
    """`paired_ms`'s times as text: "a [b, c]" (a wrapper call, replayed
    one call a graph and 20 a graph) and, with a parent, parent / kernel
    / kernel / parent."""
    def one(x):
        return f"{x[0]:.4f} [{x[1]:.4f}, {x[2]:.4f}]"
    own = (t["ms"], t["replay_ms"], t["graph20_ms"])
    text = f"kernel {one(own)} ms (a wrapper call [replayed from a CUDA " \
        f"graph, one call a graph; 20 a graph])"
    if "parent" not in t:
        return text
    return text + (f"; parent / kernel / kernel / parent "
                   f"{one(t['parent'][0])} / {one(own)} / {one(t['again'])}"
                   f" / {one(t['parent'][1])} ms")


def residency(label: str, info: dict, plan_of, shapes, smi: str) -> None:
    """Print what the card holds of a kernel and each shape's waves, and
    hold the occupancy API to the blocks a SM of the first shape's launch
    plan (every shape takes the same compiled kernel)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = plan_of(shapes[0][1], sms)
    per_wave = info["blocks_per_sm"] * sms
    log(f"{label}: {info['regs']} registers a thread, {info['local_bytes']} "
        f"B of local (spill) memory a thread, {info['smem_bytes']} B of "
        f"static shared memory a block (plan {plan['smem_bytes']}), "
        f"{info['blocks_per_sm']} blocks resident a SM (occupancy API; plan "
        f"{plan['blocks_per_sm']}), {plan['threads']} threads a block, "
        f"cluster {plan['cluster']}; waves on {sms} SMs: " + ", ".join(
            f"{what} {-(-plan_of(n, sms)['blocks'] // per_wave)}"
            for what, n in shapes) + f" [{smi}]")
    assert info["blocks_per_sm"] >= plan["blocks_per_sm"], (label, info)


def conv_encode_batch(bits: np.ndarray, polys) -> np.ndarray:
    """Tail-biting K=7 rate-1/3 encode of [B, 40] bits -> [B, 3, 40] (the
    register convention of ltecore.coding.conv_encode, vectorised)."""
    out = np.zeros((bits.shape[0], 3, bits.shape[1]), np.uint8)
    for j, g in enumerate(polys):
        for d in range(7):
            if (g >> (6 - d)) & 1:
                out[:, j] ^= np.roll(bits, d, axis=1).astype(np.uint8)
    return out


def upsample(x: np.ndarray, factor: int) -> np.ndarray:
    """FFT zero-padding interpolation by an integer factor."""
    if factor == 1:
        return x.astype(np.complex64)
    F = np.fft.fft(x.astype(np.complex128))
    n = x.size
    Fw = np.zeros(n * factor, dtype=np.complex128)
    Fw[:n // 2] = F[:n // 2]
    Fw[-n // 2:] = F[-n // 2:]
    return (np.fft.ifft(Fw) * factor).astype(np.complex64)


def stream_cell(synth, cell_id: int, prb: int, seconds: float, seed: int,
                cfo_subcarriers: float = 0.0, gap=None) -> np.ndarray:
    """`seconds` of one synthetic cell at 1.92 Msps plus seeded noise,
    optionally offset in frequency by `cfo_subcarriers` x 15 kHz; `gap` =
    (from s, to s): the cell is absent there and the noise alone remains."""
    x = np.tile(synth.synthesize_frame(cell_id, nof_prb_field=prb),
                int(round(seconds * 100)))
    if gap is not None:
        x[int(round(gap[0] * 1.92e6)):int(round(gap[1] * 1.92e6))] = 0
    if cfo_subcarriers:
        x = x * np.exp(2j * np.pi * cfo_subcarriers / 128.0
                       * np.arange(x.size, dtype=np.float64))
    rng = np.random.default_rng(seed)
    x = x + 0.05 * (rng.normal(size=x.size) + 1j * rng.normal(size=x.size))
    return x.astype(np.complex64)


def fields(cells, keys=None) -> list:
    """Cells as dicts without the wall-clock stamp (or only `keys`)."""
    out = []
    for c in cells:
        d = c.to_dict()
        d.pop("tracking_start_time")
        out.append({k: d[k] for k in keys} if keys else d)
    return out


def feed(trigger, sig: np.ndarray, chunk: int = 19200):
    """Every chunk through process(), then flush(): (published, wall s)."""
    t0 = time.perf_counter()
    got = []
    for i in range(0, len(sig), chunk):
        got += trigger.process(sig[i:i + chunk])
    got += trigger.flush()
    if trigger.device.type == "cuda":
        torch.cuda.synchronize()
    return got, time.perf_counter() - t0


def make_band(dev, synth, rate: float, cells, seconds: float,
              seed: int) -> np.ndarray:
    """`seconds` of a band at `rate` (complex64, unit rms before the noise):
    each of `cells` = (centre Hz, cell id, PRB field, start s[, stop s]) is
    one synthetic frame, interpolated to the band's rate, looped and mixed
    to its centre with a float64 phase, and absent before its start time
    (or, given a stop time, between the two); plus seeded noise 31 dB under
    the band.  Made on the card, returned on the host."""
    ratio = int(round(rate / 1.92e6))
    n = int(round(seconds * rate))
    t = torch.arange(n, dtype=torch.float64, device=dev)
    acc = torch.zeros(n, dtype=torch.complex64, device=dev)
    for center, cid, prb, *absent in cells:
        off_from, off_to = absent if len(absent) == 2 else (0.0, absent[0])
        frame = torch.from_numpy(upsample(
            synth.synthesize_frame(cid, nof_prb_field=prb), ratio)).to(dev)
        x = frame.repeat(-(-n // frame.shape[0]))[:n]
        ph = torch.remainder(t * (center / rate), 1.0) * (2 * math.pi)
        rot = torch.complex(torch.cos(ph), torch.sin(ph)).to(torch.complex64)
        x = x * rot
        x[int(round(off_from * rate)):int(round(off_to * rate))] = 0
        acc += x
        del x, ph, rot
    acc /= acc.abs().square().mean().sqrt()
    g = torch.Generator(device=dev).manual_seed(seed)
    acc += 0.02 * torch.complex(
        torch.randn(n, generator=g, device=dev),
        torch.randn(n, generator=g, device=dev))
    return acc.cpu().numpy()


def feed_wide(w, wide: np.ndarray, chunk: int):
    """Every chunk through process_wide(), then flush(): (published as
    (stream, fields) pairs, wall s)."""
    t0 = time.perf_counter()
    got = []
    for i in range(0, len(wide), chunk):
        got += w.process_wide(wide[i:i + chunk])
    got += w.flush()
    if w.device.type == "cuda":
        torch.cuda.synchronize()
    return tagged(got), time.perf_counter() - t0


def tagged(pub) -> list:
    """(stream, Cell) pairs as (stream, fields) pairs."""
    return [(n, fields([c])[0]) for n, c in pub]


def waits_per_call(calls) -> list:
    """Run each of `calls` under torch.cuda.set_sync_debug_mode("warn"):
    the number of synchronizing calls PyTorch reported for each."""
    counts = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for call in calls:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                call()
            counts.append(len(caught))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return counts


def big_buffer(dev, synth, trig):
    """[C_BIG, LOOKBACK + 100 half-frames + WINDOW] pair: channel c carries
    cell 3c + (c % 3) (all roots, many cell ids) plus seeded noise."""
    n = STEPS_BIG * 9600
    cells = [3 * c + c % 3 for c in range(C_BIG)]
    one = np.stack([synth.synthesize_frame(cid, nof_prb_field=50)
                    for cid in cells]).astype(np.complex64)      # [C, 19200]
    g = torch.Generator(device=dev).manual_seed(7)
    comps = []
    for part in (one.real, one.imag):
        x = torch.from_numpy(np.ascontiguousarray(part)).to(dev)
        x = x.repeat(1, n // 19200)
        x = x + 0.1 * torch.randn(x.shape, generator=g, device=dev)
        comps.append(torch.nn.functional.pad(
            x, (trig.LOOKBACK, trig.WINDOW)).contiguous())
    return tuple(comps), cells


def band_of_eight(dev, synth) -> np.ndarray:
    """2 s of the 15.36 Msps band of phases 12 and 20: the cells of CELLS8,
    50 PRB each, one at each of CENTERS8."""
    return make_band(dev, synth, RATE8,
                     [(c, cid, 50, 0.0)
                      for c, (cid, _) in zip(CENTERS8, CELLS8)], 2.0, seed=52)


def late_streams(sigs, cut: int) -> np.ndarray:
    """The 8 streams of phase 7 with streams 4-7 silent before `cut`: their
    cells come up after a checkpoint taken there."""
    out = np.stack(sigs)
    out[4:, :cut] = 0
    return out


def feed_all(m, sigs, start: int = 0, stop: int | None = None) -> list:
    """sigs[:, start:stop] through process_all() in 19200-sample chunks,
    then flush(): the published (stream, Cell) pairs."""
    stop = sigs.shape[1] if stop is None else stop
    got = []
    for i in range(start, stop, 19200):
        got += m.process_all(list(sigs[:, i:min(i + 19200, stop)]))
    return got + m.flush()


def straddle_stream(synth, n_blocks: int, frames_per_block: int) -> np.ndarray:
    """A stream for `n_blocks` time shards in which the last PSS peak of
    every block lies 200 samples before the block's end: its half-frame, SSS
    and PBCH are read from the right neighbour's halo."""
    frame = synth.synthesize_frame(123, nof_prb_field=6).astype(np.complex64)
    shift = 9400 - 832
    n = n_blocks * frames_per_block
    return np.tile(frame, n + 1)[19200 - shift:19200 - shift + n * 19200] \
        .copy()


def pair_np(x: np.ndarray):
    return (np.ascontiguousarray(x.real, np.float32),
            np.ascontiguousarray(x.imag, np.float32))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ======================================================================
# the long-running monitor (phases 9a-9e)
# ======================================================================
RATE1 = 1.92e6
HALF_FRAME = 9600
SOAK_CELL = (125, 50)           # the soak's cell: id, PRB field
SOAK_BLOCK_S, SOAK_GAP_S = 10.0, 1.0
SOAK_BLOCKS = 29                # 556.8 M samples: past 2^29 in block 27
TRANSPARENT_SAMPLES = 136 * 307200      # phase 9b: ~41.8 M, 4 rebases
MONITOR8_BLOCKS = 7             # phase 9c: 21.5 M samples a stream
PACED_S = 10.0                  # phases 9d, 20 (b): seconds of real time
PACED_BURST = 8                 # chunks the producer hands over at once
PACED_HOLD_S = 0.002            # the gate's longest hold after one chunk
# the gate's bound on backlog: in one process below the read-ahead of one
# half-frame that process() leaves standing (nothing else is ever left:
# pass C's host waits drain each dispatch before it returns); on ranks that
# share a card above it and below it plus a 4-step dispatch in flight
PACED_LIMIT_1, PACED_LIMIT_RANKS = HALF_FRAME // 2, 2 * HALF_FRAME
INGEST_SAMPLES = 144_000_000    # phase 9e: 7.5 blocks, ending tracked
MESH_REBASE_AT = 2 ** 21        # phases 9c and 20 (a): 10 rebases


def gapped_stream(synth, cell, seconds: float, gap, seed: int) -> np.ndarray:
    """`seconds` of `cell` (id, PRB field) at 1.92 Msps in weak noise, with
    the cell absent during `gap` = (from s, to s) and noise 20 dB above it
    there instead (an interferer: a tracked cell is dropped within a few
    searches; weak noise alone takes ~1.7 s to decay the tracked peak)."""
    x = stream_cell(synth, *cell, seconds, seed=seed, gap=gap)
    lo, hi = (int(round(g * RATE1)) for g in gap)
    rng = np.random.default_rng(seed + 1)
    x[lo:hi] += (10.0 / math.sqrt(2)) * (rng.normal(size=hi - lo)
                                         + 1j * rng.normal(size=hi - lo))
    return x


def soak_block(synth) -> np.ndarray:
    """One block of the soak's stream (SOAK_BLOCK_S), fed again and again:
    SOAK_GAP_S without the cell of SOAK_CELL, then the cell until the block
    ends."""
    return gapped_stream(synth, SOAK_CELL, SOAK_BLOCK_S, (0.0, SOAK_GAP_S),
                         seed=90)


def add_bursts(dev, wide: np.ndarray, rate: float, bursts, level: float,
               seed: int) -> np.ndarray:
    """`wide` plus, for each (centre Hz, from s, to s) of `bursts`, complex
    noise of rms `level` over the 1.92 MHz channel at that centre during
    that time (1.92 Msps noise interpolated to `rate` by FFT zero-padding
    and mixed to the centre with a float64 phase).  Made on the card."""
    ratio = int(round(rate / RATE1))
    x = torch.from_numpy(wide).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for center, a, b in bursts:
        n0 = int(round(a * rate))
        m = int(round((b - a) * RATE1))
        nz = torch.complex(torch.randn(m, generator=g, device=dev),
                           torch.randn(m, generator=g, device=dev)) \
            * (level / math.sqrt(2))
        f = torch.fft.fft(nz.to(torch.complex128))
        fw = torch.zeros(m * ratio, dtype=torch.complex128, device=dev)
        fw[:m // 2], fw[-(m // 2):] = f[:m // 2], f[-(m // 2):]
        n = n0 + torch.arange(m * ratio, dtype=torch.float64, device=dev)
        ph = torch.remainder(n * (center / rate), 1.0) * (2 * math.pi)
        x[n0:n0 + m * ratio] += (torch.fft.ifft(fw) * ratio
                                 * torch.polar(torch.ones_like(ph), ph)) \
            .to(torch.complex64)
    return x.cpu().numpy()


def blocks_of(block: np.ndarray, n_blocks: int, chunk: int):
    """The stream `block` repeated `n_blocks` times, as views of `chunk`
    samples (the last of each block may be shorter)."""
    for _ in range(n_blocks):
        for i in range(0, block.size, chunk):
            yield block[i:i + chunk]


def rss_mib() -> float:
    """This process's resident memory now, MiB (Linux)."""
    for line in pathlib.Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024
    return float("nan")


def logged_trigger(api, events: list, fed: list, **kw):
    """A Trigger whose callbacks append (kind, absolute stream position of
    the drained dispatch, fields or cell id) to `events`: `fed[0]` is the
    caller's count of samples fed so far, so the position is exact across
    a rebase."""
    t = None

    def pos():
        return fed[0] - t.backlog

    t = api.Trigger(
        psr_threshold=4,
        on_track=lambda c: events.append(("track", pos(), fields([c])[0])),
        on_drop=lambda cid: events.append(("drop", pos(), cid)), **kw)
    return t


def stages_text(t) -> str:
    return ", ".join(f"{k} {v['mean_ms']:.3f} x {v['count']}"
                     for k, v in t.timer.summary().items())


def dispatches(t) -> int:
    """A streaming trigger's dispatches so far (its StageTimer's scans)."""
    return t.timer.summary().get("scan", {}).get("count", 0)


def check_schedule(events: list, n_blocks: int, block_s: float,
                   gap_s: float, cell_id: int, slack_s: float = 0.6):
    """The soak's events are exactly its gap schedule: the cell tracked
    after every gap, dropped in every gap but the first (it was never
    tracked before), each within `slack_s` of stream after the gap's edge;
    every track carries the same fields."""
    kinds = [k for k, _, _ in events]
    assert kinds == ["track"] + ["drop", "track"] * (n_blocks - 1), kinds
    tracks = [(p, f) for k, p, f in events if k == "track"]
    drops = [(p, cid) for k, p, cid in events if k == "drop"]
    assert all(f == tracks[0][1] for _, f in tracks), tracks
    assert tracks[0][1]["cell_id"] == cell_id, tracks[0]
    assert all(cid == cell_id for _, cid in drops), drops
    for b, (p, _) in enumerate(tracks):
        edge = (b * block_s + gap_s) * RATE1
        assert edge <= p <= edge + slack_s * RATE1, (b, p, edge)
    for b, (p, _) in enumerate(drops, start=1):
        edge = b * block_s * RATE1
        assert edge <= p <= edge + slack_s * RATE1, (b, p, edge)
    return tracks, drops


def monitor_soak(api, trig, block: np.ndarray, gap_s: float, n_blocks: int,
                 chunk: int, dev) -> dict:
    """Phase 9a: `n_blocks` x `block` (its first `gap_s` without the cell)
    through one i8 Trigger with two dispatches in flight, fed flat-out in
    `chunk`-sample calls; the int32-guard rebase at the class's real
    REBASE_AT (2^29) fires in-stream exactly once.  Returns what the phase
    prints."""
    events, fed = [], [0]
    t = logged_trigger(api, events, fed, transport="i8", pipeline=2,
                       device=dev)
    calls, rebase = [], None
    trig.host_syncs.clear()
    t0 = time.perf_counter()
    for x in blocks_of(block, n_blocks, chunk):
        fed[0] += x.size
        base0 = t._base
        c0 = time.perf_counter()
        t.process(x)
        calls.append(time.perf_counter() - c0)
        if t._base < base0:
            assert rebase is None, "a second rebase"
            rebase = dict(call=len(calls) - 1, fed=fed[0], base=base0,
                          after=t._base, launches=read_launches(),
                          syncs=sum(trig.host_syncs.values()),
                          dispatches=dispatches(t))
    t.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert rebase is not None, "the rebase never fired"
    assert rebase["base"] >= t.REBASE_AT > rebase["after"] >= 0, rebase
    assert rebase["fed"] > t.REBASE_AT, rebase
    tracks, drops = check_schedule(events, n_blocks, block.size / RATE1,
                                   gap_s, SOAK_CELL[0])
    near = 2.0 * RATE1
    assert any(abs(p - rebase["fed"]) <= near for p, _ in tracks) and any(
        abs(p - rebase["fed"]) <= near for p, _ in drops), \
        (rebase["fed"], [p for p, _ in tracks], [p for p, _ in drops])
    assert t.tracking[SOAK_CELL[0] % 3] \
        and t.cellstore.latest_cell().cell_id == SOAK_CELL[0]
    launches, syncs, disp = read_launches(), sum(trig.host_syncs.values()), \
        dispatches(t)
    i = rebase["call"]
    around = calls[max(i - 5, 0):i] + calls[i + 1:i + 6]
    return dict(
        t=t, fed=fed[0], wall=wall, rebase=rebase, events=events,
        launches=launches, syncs=syncs, dispatches=disp,
        per_before={k: v / rebase["dispatches"]
                    for k, v in rebase["launches"].items()},
        per_after={k: (launches[k] - rebase["launches"][k])
                   / (disp - rebase["dispatches"]) for k in launches},
        syncs_before=rebase["syncs"] / rebase["dispatches"],
        syncs_after=(syncs - rebase["syncs"]) / (disp - rebase["dispatches"]),
        rebase_ms=1e3 * calls[i], around_ms=1e3 * np.median(around),
        around_max_ms=1e3 * max(around),
        nearest=(min(abs(p - rebase["fed"]) for p, _ in drops) / RATE1,
                 min(abs(p - rebase["fed"]) for p, _ in tracks) / RATE1))


def rebase_pair(make, feed_fn, rebase_at: int) -> tuple:
    """One stream through two fresh triggers, REBASE_AT lowered to
    `rebase_at` on the first and left on the second: ((trigger, events)
    for both, the rebases of the first).  After the flush both stand at
    the same stream position, so the rebases are the difference of their
    drained positions over `rebase_at`."""
    out = []
    for at in (rebase_at, None):
        events = []
        t = make(events)
        if at is not None:
            t.REBASE_AT = at
        for call in feed_fn(t):
            call()
        t.flush()
        out.append((t, events))
    (low, _), (real, _) = out
    shift = real._pos_lb - low._pos_lb
    assert (shift == shift.flat[0]).all() and shift.flat[0] % rebase_at == 0
    return (*out, int(shift.flat[0]) // rebase_at)


def rebase_transparent(api, block: np.ndarray, n_samples: int, chunk: int,
                       dev, rebase_at: int) -> dict:
    """Phase 9b: the first `n_samples` of the soak's stream, moved by +2
    half-subcarriers (one subcarrier), through a Trigger with
    cfo_search_range=4, with REBASE_AT lowered and not: the same events
    field for field and the same telemetry.  pipeline=0 and i8: the upload
    segments, and so the quantisation, are those of the stream alone."""
    assert chunk % 128 == 0 and block.size % 128 == 0
    rot = np.exp(2j * np.pi * np.arange(chunk) / 128.0).astype(np.complex64)

    def feed_fn(t):
        done = 0
        for x in blocks_of(block, -(-n_samples // block.size), chunk):
            x = x[:n_samples - done]
            if not x.size:
                return
            done += x.size
            yield lambda x=x: t.process(x * rot[:x.size])

    def make(events):
        return api.Trigger(
            psr_threshold=4, transport="i8", pipeline=0, cfo_search_range=4,
            device=dev, on_track=lambda c: events.append(("track",
                                                          fields([c])[0])),
            on_drop=lambda cid: events.append(("drop", cid)))

    t0 = time.perf_counter()
    (low, ev_low), (real, ev_real), k_low = rebase_pair(make, feed_fn,
                                                        rebase_at)
    wall = time.perf_counter() - t0
    assert k_low >= 3, k_low
    assert ev_low == ev_real and ev_real, (ev_low, ev_real)
    assert int(low._cfo_bins[0]) == int(real._cfo_bins[0]) == 2, \
        (low._cfo_bins, real._cfo_bins)
    assert low._base + k_low * rebase_at == real._base
    for name in ("tracking_score", "tracking", "cap_overflow"):
        assert (getattr(low, name) == getattr(real, name)).all(), name
    for name in ("max_psr", "mean_psr", "mean_cfo"):
        np.testing.assert_allclose(getattr(low, name), getattr(real, name),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    return dict(rebases=k_low, events=ev_real, wall=wall,
                bins=int(real._cfo_bins[0]))


MONITOR8_BLOCK_S = 1.6          # 10 chunks of 307200 at 1.92 Msps
MONITOR8_CHUNK = 307200         # phases 9c and 20 (a): samples a call


def monitor8_gaps(k: int) -> tuple:
    """Stream k's gap in every 1.6-s block of phase 9c: 0.25 s, later by
    0.12 s from stream to stream (the last ends 0.41 s before the block)."""
    return (0.1 + 0.12 * k, 0.35 + 0.12 * k)


def monitor8_inputs(synth, dev) -> tuple:
    """Phase 9c's inputs, also the mesh monitor's (phase 20): one 1.6-s
    block of 8 streams at 1.92 Msps [8, n], each its own cell of CELLS8 with
    a gap of its own (monitor8_gaps) and noise 20 dB over the cell in it,
    and the same 8 carriers in one block of a 15.36 Msps band at CENTERS8,
    each channel's noise burst in its gap."""
    blocks = np.stack([gapped_stream(synth, cell, MONITOR8_BLOCK_S,
                                     monitor8_gaps(k), seed=70 + 2 * k)
                       for k, cell in enumerate(CELLS8)])
    wide = add_bursts(
        dev, make_band(dev, synth, RATE8,
                       [(c, cid, 50, *monitor8_gaps(k)) for k, (c, (cid, _))
                        in enumerate(zip(CENTERS8, CELLS8))],
                       MONITOR8_BLOCK_S, seed=79), RATE8,
        [(c, *monitor8_gaps(k)) for k, c in enumerate(CENTERS8)],
        10.0 / math.sqrt(len(CELLS8)), seed=80)
    return blocks, wide


def monitor8(synth, dev, MultiTrigger, WidebandTrigger) -> tuple:
    """Phase 9c: `rebase_streams` on `monitor8_inputs` at MESH_REBASE_AT;
    returns its result and what phase 20 (a) is held to: the inputs, and
    each class's events (JSON-shaped), rebases and wall time of the run with
    the lowered REBASE_AT."""
    blocks, wide = monitor8_inputs(synth, dev)
    r = rebase_streams(MultiTrigger, WidebandTrigger, blocks, wide, dev,
                       MONITOR8_BLOCKS, MESH_REBASE_AT, MONITOR8_CHUNK)
    return r, dict(blocks=blocks, band=wide, **{
        key: dict(events=json.loads(json.dumps(r[key][0][1])),
                  rebases=r[key][2], wall=r[key][3])
        for key in ("multi", "wide")})


def tagged_log(events: list) -> dict:
    """Callbacks of a MultiTrigger / WidebandTrigger that append (stream,
    "track", fields) and (stream, "drop", cell id) to `events`."""
    return dict(on_track=lambda s, c: events.append(
                    (s, "track", fields([c])[0])),
                on_drop=lambda s, cid: events.append((s, "drop", cid)))


def multi_calls(m, blocks: np.ndarray, n_blocks: int, chunk: int):
    """`blocks` [N, n] repeated `n_blocks` times through m.process_all() in
    `chunk`-sample views: one callable a call."""
    for _ in range(n_blocks):
        for i in range(0, blocks.shape[1], chunk):
            yield lambda i=i: m.process_all(list(blocks[:, i:i + chunk]))


def wide_calls(w, wide: np.ndarray, n_blocks: int, chunk: int):
    """`wide` repeated `n_blocks` times through w.process_wide() in
    `chunk`-sample views: one callable a call."""
    for _ in range(n_blocks):
        for i in range(0, wide.size, chunk):
            yield lambda i=i: w.process_wide(wide[i:i + chunk])


def rebase_streams(MultiTrigger, WidebandTrigger, blocks: np.ndarray,
                   wide: np.ndarray, dev, n_blocks: int, rebase_at: int,
                   chunk: int) -> dict:
    """Phase 9c: `MultiTrigger(8, i4)` and `WidebandTrigger(8 carriers of
    CENTERS8, wide i8)` fed `n_blocks` x the blocks of `monitor8_inputs`,
    REBASE_AT lowered to `rebase_at` and not: the same events stream by
    stream, every carrier tracked at the end, the wide stream's `_wabs` the
    sum of the rebases' deltas.  pipeline=0, as in phase 9b.  Each class's
    pair runs with the launch counts set to 0 just before it: {"multi" /
    "wide": (the pair, the rebases, the wall time, its launches)}."""
    n = len(CELLS8)
    out = {}
    reset_launches()
    t0 = time.perf_counter()
    pair = rebase_pair(lambda ev: MultiTrigger(
        n, psr_threshold=4, transport="i4", pipeline=0, device=dev,
        **tagged_log(ev)), lambda m: multi_calls(m, blocks, n_blocks, chunk),
        rebase_at)
    out["multi"] = pair + (time.perf_counter() - t0, read_launches())

    ratio = int(round(RATE8 / RATE1))
    reset_launches()
    t0 = time.perf_counter()
    pair = rebase_pair(lambda ev: WidebandTrigger(
        RATE8, CENTERS8, transport="i8", psr_threshold=4, pipeline=0,
        device=dev, **tagged_log(ev)),
        lambda w: wide_calls(w, wide, n_blocks, chunk * ratio), rebase_at)
    out["wide"] = pair + (time.perf_counter() - t0, read_launches())

    for key, ((low, ev_low), (real, ev_real), k_low, _, _) in out.items():
        assert k_low >= 8, (key, k_low)
        assert ev_low == ev_real, key
        for s, (cid, _) in enumerate(CELLS8):
            kinds = [k for st, k, _ in ev_real if st == s]
            assert kinds[0] == "track" and kinds.count("drop") \
                >= n_blocks - 1 and kinds[-1] == "track", (key, s, kinds)
            assert {f["cell_id"] for st, k, f in ev_real
                    if st == s and k == "track"} == {cid}, (key, s)
            assert low.tracking[s].any() and real.tracking[s].any(), (key, s)
        assert (low.tracking_score == real.tracking_score).all(), key
        np.testing.assert_allclose(low.mean_psr, real.mean_psr, rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    (low, _), (real, _), k_low, _, _ = out["wide"]
    assert low._wabs == k_low * rebase_at * ratio and real._wabs == 0, \
        (low._wabs, k_low)
    assert low._wbase + low._wabs == real._wbase
    return out


def paced_monitor(t, feed_chunk, n_chunks: int, chunk: int,
                  limit: int) -> dict:
    """A producer thread hands chunk indices 0 .. n_chunks - 1 of `chunk`
    samples a stream to a queue of 64 at 1.92 Msps of wall time,
    PACED_BURST of them at once when the last has arrived (as an SDR hands
    over a buffer); this thread calls feed_chunk(k) when a chunk is there
    and t.poll() otherwise.  After each feed, the backlog gate: while the
    largest stream's `backlog` exceeds `limit` the monitor pulls nothing
    and polls, for at most PACED_HOLD_S a chunk.  `held` counts the chunks after which the
    gate held, `drained` those of them whose backlog the polls brought
    within the limit (outputs in flight harvested); the rest was the
    standing read-ahead, which only more samples move.  The queue must
    never overflow.  Returns the backlog after every feed in ms, the
    queue's depth, the counts and the wall time."""
    import queue
    import threading

    q = queue.Queue(maxsize=64)
    overflow = []

    def produce():
        due = time.perf_counter()
        for k0 in range(0, n_chunks, PACED_BURST):
            ks = range(k0, min(k0 + PACED_BURST, n_chunks))
            due += len(ks) * chunk / RATE1
            time.sleep(max(due - time.perf_counter(), 0.0))
            for k in ks:
                try:
                    q.put_nowait(k)
                except queue.Full:
                    overflow.append(k)
        q.put(None)

    def backlog() -> int:
        return int(np.max(t.backlog))

    lags, depth, polls, held, drained = [], [], 0, 0, 0
    producer = threading.Thread(target=produce, daemon=True)
    t0 = time.perf_counter()
    producer.start()
    while True:
        try:
            k = q.get(timeout=0.001)
        except queue.Empty:
            t.poll()
            polls += 1
            continue
        if k is None:
            break
        depth.append(q.qsize())
        feed_chunk(k)
        lags.append(backlog())
        if lags[-1] > limit:
            held += 1
            until = time.perf_counter() + PACED_HOLD_S
            while backlog() > limit and time.perf_counter() < until:
                t.poll()
            drained += backlog() <= limit
    t.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    producer.join(timeout=60)
    assert not producer.is_alive(), "the producer never finished"
    assert not overflow, f"the queue overflowed at chunks {overflow[:5]}"
    return dict(lags=np.asarray(lags) / RATE1 * 1e3, depth=max(depth),
                polls=polls, held=held, drained=drained, wall=wall,
                n=n_chunks * chunk)


def paced_trigger(api, block: np.ndarray, seconds: float, chunk: int,
                  dev) -> dict:
    """Phase 9d: `paced_monitor` of `seconds` of `block` into an i8 Trigger
    (pipeline=2) in `chunk`-sample pieces, with the bound below the standing
    read-ahead of one half-frame (PACED_LIMIT_1).  Adds the trigger and its
    events to the result."""
    events, fed = [], [0]
    t = logged_trigger(api, events, fed, transport="i8", pipeline=2,
                       device=dev)

    def feed_chunk(k):
        fed[0] += chunk
        t.process(block[k * chunk:(k + 1) * chunk])

    n_chunks = int(round(seconds * RATE1)) // chunk
    assert n_chunks * chunk <= block.size
    return dict(paced_monitor(t, feed_chunk, n_chunks, chunk, PACED_LIMIT_1),
                t=t, events=events)


def flat_out(api, block: np.ndarray, n: int, chunk: int, dev) -> list:
    """The first `n` samples of `block` through an i8 Trigger in
    `chunk`-sample calls, then flush(): its events as paced_monitor logs
    them."""
    events, fed = [], [0]
    t = logged_trigger(api, events, fed, transport="i8", pipeline=2,
                       device=dev)
    for i in range(0, n, chunk):
        fed[0] += chunk
        t.process(block[i:i + chunk])
    t.flush()
    return events


def unpaced_ingest(api, block: np.ndarray, n_calls: int, chunk: int,
                   dev) -> dict:
    """Phase 9e: `n_calls` x `chunk` samples of the soak's stream through
    Trigger.process as fast as this thread can call it, then one flush():
    every call's cost, the backlog, the resident memory, the flush's
    drain."""
    assert block.size % chunk == 0
    t = api.Trigger(psr_threshold=4, transport="i8", pipeline=2, device=dev)
    per = block.size // chunk
    cost = np.empty(n_calls)
    backlog_max, rss0 = 0, rss_mib()
    t0 = time.perf_counter()
    for k in range(n_calls):
        i = (k % per) * chunk
        c0 = time.perf_counter()
        t.process(block[i:i + chunk])
        cost[k] = time.perf_counter() - c0
        if k % 64 == 0:
            backlog_max = max(backlog_max, t.backlog)
    ingest = time.perf_counter() - t0
    standing, rss1 = t.backlog, rss_mib()
    f0 = time.perf_counter()
    t.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    flush_s = time.perf_counter() - f0
    d = n_calls // 10
    first, last = np.median(cost[:d]), np.median(cost[-d:])
    assert last <= 3 * first, (first, last)
    assert t.tracking[SOAK_CELL[0] % 3], "the cell is not tracked"
    return dict(t=t, n=n_calls * chunk, ingest=ingest, first_us=1e6 * first,
                last_us=1e6 * last, worst_ms=1e3 * cost[n_calls // 2:].max(),
                mean_us=1e6 * cost.mean(), backlog_max=backlog_max,
                standing=standing, flush_s=flush_s, rss=(rss0, rss1))


def monitor_phases(dev, smi: str, synth, api, trig, MultiTrigger,
                   WidebandTrigger) -> tuple:
    """Phases 9a-9e, the long-running monitor, each path driven with the
    launch counts set to 0 just before it: returns ({path: launches}, the
    soak's block, which phase 29 paces again under the profiler, and 9c's
    inputs and one-process events, which phase 20 (a) is held to)."""
    paths = {}
    t0 = time.perf_counter()
    block = soak_block(synth)
    log(f"the soak's stream: one {SOAK_BLOCK_S:.0f}-s block of cell "
        f"{SOAK_CELL[0]} ({SOAK_CELL[1]} PRB) at 1.92 Msps, the first "
        f"{SOAK_GAP_S:.0f} s of it noise 20 dB over the cell instead, made "
        f"in {time.perf_counter() - t0:.1f} s and fed {SOAK_BLOCKS} times "
        f"as views ({SOAK_BLOCKS * block.size} samples)")

    # 9a. the real 2^29 rebase in a 4.8-minute stream
    reset_launches()
    r = monitor_soak(api, trig, block, SOAK_GAP_S, SOAK_BLOCKS, 307200, dev)
    paths["Trigger soak to the 2^29 rebase"] = r["launches"]
    t, rb = r["t"], r["rebase"]
    log(f"9a soak: Trigger i8 pipeline=2, {r['fed']} samples in 307200-"
        f"sample calls, {r['fed'] / r['wall'] / 1e6:.3f} M samples/s of "
        f"wall time ({r['wall']:.1f} s); the rebase fired once, in call "
        f"{rb['call']} at {rb['fed']} samples fed (_base {rb['base']} -> "
        f"{rb['after']}, REBASE_AT {t.REBASE_AT}); {len(r['events'])} events, "
        f"exactly the gap schedule (a track after each of {SOAK_BLOCKS} gaps,"
        f" a drop in each but the first), the nearest drop "
        f"{r['nearest'][0]:.3f}"
        f" s and track {r['nearest'][1]:.3f} s of stream from the rebase; "
        f"cell {SOAK_CELL[0]} tracked at the end; the rebasing call "
        f"{r['rebase_ms']:.1f} ms against a median {r['around_ms']:.1f} "
        f"(max {r['around_max_ms']:.1f}) of the 10 calls around it; "
        f"a dispatch's launches before -> after the rebase "
        + ", ".join(f"{r['per_before'][k]:.3f} -> {r['per_after'][k]:.3f} "
                    f"{k}" for k in KERNELS)
        + f", host syncs {r['syncs_before']:.3f} -> {r['syncs_after']:.3f}; "
        f"{r['dispatches']} dispatches, at most {t.max_in_flight} in flight; "
        f"stages (mean ms x count): {stages_text(t)} [{smi}]")
    del t, r

    # 9b. the rebase is transparent: REBASE_AT 2^23 against 2^29
    reset_launches()
    r = rebase_transparent(api, block, TRANSPARENT_SAMPLES, 307200, dev,
                           2 ** 23)
    paths["Trigger rebase 2^23 against 2^29"] = read_launches()
    log(f"9b: {TRANSPARENT_SAMPLES} samples of the soak's stream 1 "
        f"subcarrier off "
        f"(+2 half-subcarriers), Trigger i8 pipeline=0 cfo_search_range=4 "
        f"with REBASE_AT 2^23 ({r['rebases']} rebases) and 2^29 (none): the "
        f"same {len(r['events'])} events field for field, the same bin "
        f"{r['bins']}, telemetry equal; both runs {r['wall']:.1f} s [{smi}]")

    # 9c. MultiTrigger(8, i4) and WidebandTrigger(8, wide i8), REBASE_AT 2^21
    r, mon8 = monitor8(synth, dev, MultiTrigger, WidebandTrigger)
    paths["MultiTrigger rebases 2^21"] = r["multi"][-1]
    paths["WidebandTrigger rebases 2^21"] = r["wide"][-1]
    n_narrow = MONITOR8_BLOCKS * int(MONITOR8_BLOCK_S * RATE1)
    log(f"9c: {n_narrow} samples a stream, 8 streams, each its own cell and a "
        f"gap of its own in every {MONITOR8_BLOCK_S} s; " + "; ".join(
            f"{key} with REBASE_AT 2^21 ({k} rebases) and 2^29: the same "
            f"{len(ev)} events stream by stream, every stream tracked at the "
            f"end, both runs {wall:.1f} s, {n} kernel launches"
            for key, ((_, ev), _, k, wall, n) in
            (("MultiTrigger(8) i4", r["multi"]),
             ("WidebandTrigger(8 carriers at 15.36 Msps) wide i8",
              r["wide"])))
        + f"; the wide stream's _wabs = {r['wide'][0][0]._wabs} = "
        f"{r['wide'][2]} x 2^21 x 8 [{smi}]")
    del r

    # 9d. a producer thread paced at real time, in bursts
    reset_launches()
    r = paced_trigger(api, block, PACED_S, 38400, dev)
    paths["Trigger paced by a producer thread"] = read_launches()
    want = flat_out(api, block, r["n"], 38400, dev)
    assert [(k, f) for k, _, f in r["events"]] \
        == [(k, f) for k, _, f in want] and want, (r["events"], want)
    assert r["t"].tracking[SOAK_CELL[0] % 3]
    assert r["held"] > 0, "the backlog gate never held the monitor back"
    lag = r["lags"]
    log(f"9d paced: a producer thread put {r['n']} samples (38400 a chunk) "
        f"into a queue of 64 at 1.92 Msps for {PACED_S:.0f} s, "
        f"{PACED_BURST} chunks at once; after each call the monitor pulled "
        f"nothing while backlog > {PACED_LIMIT_1} (below the standing "
        f"read-ahead), polling for at most {PACED_HOLD_S * 1e3:.0f} ms: held "
        f"after {r['held']} of {len(lag)} calls, drained to the bound by the "
        f"polls {r['drained']} times; polled {r['polls']} times while "
        f"waiting; backlog after each call median / p99 / max "
        f"{np.median(lag):.1f} / {np.percentile(lag, 99):.1f} / "
        f"{lag.max():.1f} ms, the queue at most {r['depth']} deep, never "
        f"overflowing; {r['wall']:.2f} s of wall time; the events equal the "
        f"same samples fed flat-out ({[k for k, _, _ in want]}), cell "
        f"{SOAK_CELL[0]} tracked [{smi}]")
    del r

    # 9e. unpaced ingest of 200 M samples
    reset_launches()
    n_calls = INGEST_SAMPLES // 19200
    r = unpaced_ingest(api, block, n_calls, 19200, dev)
    paths["Trigger unpaced ingest"] = read_launches()
    log(f"9e unpaced: {r['n']} samples in {n_calls} process() calls of 19200 "
        f"in {r['ingest']:.1f} s ({r['n'] / r['ingest'] / 1e6:.3f} M "
        f"samples/s); a call's cost, median of the first / last decile "
        f"{r['first_us']:.1f} / {r['last_us']:.1f} us (mean "
        f"{r['mean_us']:.1f}), the worst of the second half "
        f"{r['worst_ms']:.1f} ms; backlog at most {r['backlog_max']} samples "
        f"while feeding, {r['standing']} standing at the end; resident "
        f"{r['rss'][0]:.0f} -> {r['rss'][1]:.0f} MiB; flush() drained "
        f"{r['standing']} samples in {1e3 * r['flush_s']:.1f} ms; cell "
        f"{SOAK_CELL[0]} tracked [{smi}]")
    return paths, block, mon8


def paced_idle_share(api, block: np.ndarray, dev, smi: str) -> None:
    """Phase 29's part of 9d: 3 s of the paced run under torch.profiler
    (device activity only): the device's busy time against the wall."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        r = paced_trigger(api, block, 3.0, 38400, dev)
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev_events) / 1e6
    lag = r["lags"]
    log(f"9d under torch.profiler (device activity only): a paced run of 3 s "
        f"({r['wall']:.2f} s of wall time), "
        f"{sum(e.count for e in dev_events)} device kernels and copies, "
        f"{busy * 1e3:.1f} ms of device time, device idle share "
        f"{1 - busy / r['wall']:.4f}; backlog median / max "
        f"{np.median(lag):.1f} / {lag.max():.1f} ms [{smi}]")


# ======================================================================
# one rank of phases 20 and 21 (`chip_smoke.py --rank ...`)
# ======================================================================
def mesh_save_calls(chunk: int) -> set:
    """The calls before which phase 20 (a) checkpoints: for each of the
    first two rebases, from two calls before the first call whose samples
    pass k x MESH_REBASE_AT (no rank can rebase earlier) to four calls after
    it."""
    out = set()
    for k in (1, 2):
        first = -(-k * MESH_REBASE_AT // chunk)
        out.update(range(first - 2, first + 5))
    return out


def mesh_monitor(t, calls, save_at: set, ckpt: pathlib.Path,
                 events: list) -> dict:
    """Phase 20 (a) on one rank: every call of `calls` through `t` (a
    MultiTrigger or WidebandTrigger on a mesh whose callbacks append to
    `events`), then flush(); before each call index in `save_at` a flush()
    and a save_state() into ckpt/<index>.npz (collectives: every rank passes
    the same indices).  Returns the calls at which the rank rebased, as
    [call, "process" or "save"], each save's rebases before it, the events
    published before it and its time, and the wall time."""
    rebases, saves = [], []
    t0 = time.perf_counter()
    for c, call in enumerate(calls):
        if c in save_at:
            t.flush()
            base, s0 = t._base, time.perf_counter()
            t.save_state(str(ckpt / f"{c}.npz"))
            saves.append(dict(call=c, rebases_before=len(rebases),
                              events=len(events),
                              ms=1e3 * (time.perf_counter() - s0)))
            if t._base < base:
                rebases.append([c, "save"])
        base = t._base
        call()
        if t._base < base:
            rebases.append([c, "process"])
    t.flush()
    torch.cuda.synchronize()
    return dict(rebases=rebases, saves=saves,
                wall_s=time.perf_counter() - t0)


def rank_main(args) -> int:
    """python3 chip_smoke.py --rank RANK WORLD PORT DIR BACKEND PLAN

    BACKEND gloo: every rank on cuda:0; nccl: rank k on cuda:k.  PLAN is a
    comma-separated list of "scan" (the 128 x 100 buffer over ch = WORLD),
    "shards" (t = WORLD), "stream" (ch = WORLD, needs DIR/sigs.npy and
    DIR/band8.npy), "monitor" (phase 20 (a): the mesh monitor through
    rebases, needs DIR/monitor8.npy and DIR/monitor_wide.npy), "paced" (20
    (b): a paced producer, needs DIR/monitor8.npy) and "scan128" (20 (c):
    128 channels a rank).  Each path runs with the launch counts set to 0
    just before it and read just after it (`launches`, by path); `plans`
    holds each plan's wall and CPU seconds.  What the rank measured goes to
    DIR/rank<RANK>.json, the gathered results (rank 0) to files beside it.
    No phase carries on without a card."""
    import os
    rank, world, port = int(args[0]), int(args[1]), int(args[2])
    out, backend, plan = pathlib.Path(args[3]), args[4], args[5].split(",")
    if not torch.cuda.is_available():
        print("chip_smoke rank: no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist
    from ltetrigger_tpu_torch.ltecore import synth
    from ltetrigger_tpu_torch.models import trigger as trig
    from ltetrigger_tpu_torch.models.multi import MultiTrigger
    from ltetrigger_tpu_torch.models.wideband import WidebandTrigger
    from ltetrigger_tpu_torch.parallel import (channel_scan, gather_events,
                                               init_distributed, make_mesh,
                                               time_sharded_scan)
    from ltetrigger_tpu_torch.parallel import mesh as meshmod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    dev = init_distributed(
        f"127.0.0.1:{port}", world, rank, backend=backend, timeout=300,
        device="cuda:0" if backend == "gloo" else f"cuda:{rank}")
    res = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": str(dev), "cpus": len(os.sched_getaffinity(0)),
           "threads": torch.get_num_threads(), "launches": {}, "plans": {}}

    def barrier(mesh):
        meshmod.all_gather_object(None, mesh, None)
        torch.cuda.synchronize()

    @contextlib.contextmanager
    def plan_clock(name):
        w0, c0 = time.perf_counter(), time.process_time()
        yield
        res["plans"][name] = {"wall_s": time.perf_counter() - w0,
                              "cpu_s": time.process_time() - c0}

    def counted(name, fn):
        """fn() with the launch counts set to 0 just before it; its
        launches become path `name`."""
        reset_launches()
        got = fn()
        torch.cuda.synchronize()
        res["launches"][name] = read_launches()
        return got

    def timed_scans(name, buf, full=None):
        """channel_scan(buf, mesh=ch) after a warm-up, 3 times, each a path
        `name` counted from 0, and between them the engine alone over this
        rank's rows (and, with `full`, over all of `full` on every rank at
        once): ({"call_ms", "engine_ms", "full_ms"}, the last output)."""
        lo, hi = ch.local_slice(buf[0].shape[0])
        local = tuple(c[lo:hi] for c in buf)
        channel_scan(buf, STEPS_BIG, 4.0, mesh=ch)          # warm-up
        ms = {"call_ms": [], "engine_ms": [], "full_ms": []}

        def clock(key, fn):
            barrier(ch)
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            ms[key].append(1e3 * (time.perf_counter() - t0))
            return got

        def engine(rows):
            return trig.scan_engine(rows, trig.init_state(
                batch=(rows[0].shape[0],), device=dev), STEPS_BIG, 4.0,
                grid0=trig.LOOKBACK)

        for _ in range(3):
            _, got = clock("call_ms", lambda: counted(
                name, lambda: channel_scan(buf, STEPS_BIG, 4.0, mesh=ch)))
            clock("engine_ms", lambda: engine(local))
            if full is not None:
                clock("full_ms", lambda: engine(full))
        return ms, got

    try:
        ch = make_mesh(world, 1)
        if "scan" in plan:
            with plan_clock("scan"):
                big, _ = big_buffer(dev, synth, trig)
                res["scan"], got = timed_scans("scan", big, full=big)
                if rank == 0:
                    np.save(out / f"scan_ch{world}.npy",
                            trig.pack_output(got).cpu().numpy())
                del big, got

        if "shards" in plan:
            with plan_clock("shards"):
                tm = make_mesh(1, world)
                per = 200 // world              # frames a block: 2 s in all
                cell = stream_cell(synth, 125, 50, 2.0, seed=11)
                time_sharded_scan(pair_np(cell[:world * 19200]), tm, 4.0)
                barrier(tm)
                seam = straddle_stream(synth, world, per)
                reset_launches()
                t0 = time.perf_counter()
                got = time_sharded_scan(pair_np(cell), tm, 4.0)
                torch.cuda.synchronize()
                res["shards_ms"] = 1e3 * (time.perf_counter() - t0)
                ev = got.track_event.cpu().numpy()      # [t, steps, R]
                assert ev.shape == (world, 2 * per, 3), ev.shape
                assert ev.any(axis=(1, 2)).all(), ev.any(axis=(1, 2))
                assert set(got.cell_id.cpu().numpy()[ev].tolist()) == {125}
                got = time_sharded_scan(pair_np(seam), tm, 4.0)
                torch.cuda.synchronize()
                res["launches"]["shards"] = read_launches()
                host = trig.unpack_output(trig.pack_output(got))
                assert host.track_event.any(axis=(1, 2)).all()
                for shard in range(world - 1):  # the step across the seam
                    assert host.psr[shard, -1, 123 % 3] > 4.0, \
                        host.psr[shard, -1]
                    assert host.cell_id[shard, -1, 123 % 3] == 123
                res["straddle_events"] = int(host.track_event.sum())
                if backend == "gloo":           # the same call on CPU ranks
                    ref = time_sharded_scan(pair_np(seam),
                                            make_mesh(1, world, device="cpu"),
                                            4.0)
                    ref = trig.unpack_output(trig.pack_output(ref))
                    lane = 123 % 3      # the other roots' lanes hold no cell:
                    for f in trig.StepOutput._fields:  # their ids are ties
                        g, r = getattr(host, f), getattr(ref, f)
                        if f in trig._F32_FIELDS:
                            np.testing.assert_allclose(
                                g[..., lane], r[..., lane], rtol=1e-3,
                                atol=1e-3)
                        elif f in ("cell_id", "normal_cp"):
                            assert (g[..., lane] == r[..., lane]).all(), f
                        else:
                            assert (g == r).all(), f
                    res["straddle_equals_cpu_ranks"] = True

        if "stream" in plan:
            with plan_clock("stream"):
                sigs = np.load(out / "sigs.npy")
                band8 = np.load(out / "band8.npy")
                wchunk = 19200 * 8

                def timed(key, make, feed):
                    feed(make(), 20)                    # warm-up
                    t = make()
                    barrier(ch)
                    t0 = time.perf_counter()
                    got = counted(key, lambda: feed(t, None))
                    res[key] = {
                        "wall_s": time.perf_counter() - t0,
                        "dispatches": t.timer.summary()["scan"]["count"],
                        "in_flight": t.max_in_flight, "rows": t.n,
                        "stages": {k: [v["mean_ms"], v["count"]]
                                   for k, v in t.timer.summary().items()}}
                    return t, got

                m, got = timed(
                    "multi",
                    lambda: MultiTrigger(8, psr_threshold=4, transport="i16",
                                         mesh=ch),
                    lambda t, n: feed_all(t, sigs, 0, n and n * 19200))
                merged = gather_events(got, ch)
                assert {n for n, _ in got} <= set(m.local_streams)

                def feed_w(t, n):
                    stop = band8.size if n is None else n * wchunk
                    got = []
                    for i in range(0, stop, wchunk):
                        got += t.process_wide(band8[i:i + wchunk])
                    return got + t.flush()

                w, got = timed(
                    "wide",
                    lambda: WidebandTrigger(RATE8, CENTERS8, psr_threshold=4,
                                            transport="f32", mesh=ch),
                    feed_w)
                wide_merged = gather_events(got, ch)
                # a sharded checkpoint at a cut, for a trigger without a mesh
                cut = 45 * 19200
                late = late_streams(sigs, cut)
                first = MultiTrigger(8, psr_threshold=4, transport="f32",
                                     mesh=ch)
                before = gather_events(feed_all(first, late, 0, cut), ch)
                first.save_state(str(out / "sharded.npz"))
                if rank == 0:
                    (out / "stream_events.json").write_text(json.dumps({
                        "multi": tagged(merged), "wide": tagged(wide_merged),
                        "before": tagged(before)}))
                del sigs, band8

        if "monitor" in plan:
            with plan_clock("monitor"):
                blocks = np.load(out / "monitor8.npy")
                wide = np.load(out / "monitor_wide.npy")
                ratio = int(round(RATE8 / RATE1))
                save_at = mesh_save_calls(MONITOR8_CHUNK)
                for key, make, calls in (
                        ("multi", lambda ev: MultiTrigger(
                            len(CELLS8), psr_threshold=4, transport="i4",
                            mesh=ch, **tagged_log(ev)),
                         lambda t: multi_calls(t, blocks, MONITOR8_BLOCKS,
                                               MONITOR8_CHUNK)),
                        ("wide", lambda ev: WidebandTrigger(
                            RATE8, CENTERS8, transport="i8", psr_threshold=4,
                            mesh=ch, **tagged_log(ev)),
                         lambda t: wide_calls(t, wide, MONITOR8_BLOCKS,
                                              MONITOR8_CHUNK * ratio))):
                    events = []
                    t = make(events)
                    t.REBASE_AT = MESH_REBASE_AT
                    ckpt = out / f"ckpt_{key}"
                    ckpt.mkdir(exist_ok=True)
                    barrier(ch)
                    rec = counted(f"monitor {key}", lambda: mesh_monitor(
                        t, calls(t), save_at, ckpt, events))
                    assert all(t.tracking[i].any() for i in range(t.n)), \
                        (key, t.tracking)
                    if key == "wide":
                        assert t._wabs == len(rec["rebases"]) \
                            * MESH_REBASE_AT * ratio, (t._wabs, rec)
                    rec.update(events=events, streams=list(t.local_streams),
                               samples=MONITOR8_BLOCKS * blocks.shape[1])
                    parts = meshmod.all_gather_object(rec, ch, "ch")
                    if rank == 0:
                        (out / f"monitor_{key}.json").write_text(
                            json.dumps(parts))
                    res[f"monitor_{key}"] = {k: rec[k] for k in
                                             ("rebases", "wall_s")}
                    del t
                del blocks, wide

        if "paced" in plan:
            with plan_clock("paced"):
                blocks = np.load(out / "monitor8.npy")
                chunk = 38400
                per = blocks.shape[1] // chunk

                def chunks(k):
                    i = (k % per) * chunk
                    return list(blocks[:, i:i + chunk])

                n_chunks = int(round(PACED_S * RATE1)) // chunk
                runs = {}
                for key in ("paced", "flat-out"):
                    events = []
                    m = MultiTrigger(len(CELLS8), psr_threshold=4,
                                     transport="i4", mesh=ch,
                                     **tagged_log(events))
                    barrier(ch)
                    if key == "paced":
                        r = counted(key, lambda: paced_monitor(
                            m, lambda k: m.process_all(chunks(k)), n_chunks,
                            chunk, PACED_LIMIT_RANKS))
                    else:
                        for k in range(n_chunks):
                            m.process_all(chunks(k))
                        m.flush()
                    runs[key] = events
                assert runs["paced"] == runs["flat-out"] and events, runs
                assert r["held"] > 0, "the backlog gate never held this rank"
                lag = r["lags"]
                res["paced"] = dict(
                    held=r["held"], drained=r["drained"], polls=r["polls"],
                    depth=r["depth"], wall_s=r["wall"], calls=len(lag),
                    events=len(events),
                    lag_ms=[float(np.median(lag)),
                            float(np.percentile(lag, 99)), float(lag.max())])
                del blocks

        if "scan128" in plan:
            with plan_clock("scan128"):
                big, _ = big_buffer(dev, synth, trig)
                glob = tuple(x.repeat(world, 1) for x in big)
                del big
                res["scan128"], got = timed_scans("scan 128 a rank", glob)
                if rank == 0:
                    np.save(out / f"scan128_ch{world}.npy",
                            trig.pack_output(got).cpu().numpy())
                del glob, got
        (out / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()
    return 0


def run_ranks(world: int, out: pathlib.Path, backend: str, plan: str,
              timeout: float = 420.0) -> list:
    """Phase 20 / 21's spawn: `world` ranks of this script under one time
    limit.  A rank that fails ends the others at once; every rank's output
    is printed; any exit code but 0 raises.  returns what each rank
    measured."""
    port = free_port()
    logs = [open(out / f"{plan.replace(',', '_')}_{world}_rank{r}.log", "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--rank",
         str(r), str(world), str(port), str(out), backend, plan],
        stdout=logs[r], stderr=subprocess.STDOUT,
        cwd=pathlib.Path(__file__).resolve().parent) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(proc.poll() is None for proc in procs) \
                and time.monotonic() < deadline \
                and all(proc.poll() in (None, 0) for proc in procs):
            time.sleep(0.1)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    for r, f in enumerate(logs):
        f.seek(0)
        for line in f.read().splitlines():
            if "socket.cpp" not in line:        # c10d's hostname warning
                log(f"  [rank {r}/{world}] {line}")
        f.close()
    codes = [proc.returncode for proc in procs]
    assert codes == [0] * world, \
        f"ranks exited with {codes} (limit {timeout:.0f} s)"
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)]


def one_process_scan(big, channel_scan, trig) -> tuple:
    """`channel_scan` of the 128 x 100 buffer in this process, after a
    warm-up: (packed output on the host, best of 3 in ms)."""
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = channel_scan(big, STEPS_BIG, 4.0)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return trig.pack_output(out).cpu().numpy(), min(times[1:])


def rank_paths(ranks: list, label: str) -> dict:
    """Every rank's launches, path by path, as {path: Counts}: each rank x
    plan is a path of its own, counted from 0 just before it."""
    return {f"{label}: rank {r['rank']}/{r['world']} {name}": Counts(n)
            for r in ranks for name, n in r["launches"].items()}


def ranks_line(ranks: list, smi: str) -> None:
    """Each rank's host resources and, plan by plan, its wall and CPU
    seconds: a CPU/wall ratio near the rank's threads means it was busy on
    the host all along, far below one that it waited (for the card, for
    the others)."""
    r0 = ranks[0]
    log(f"{len(ranks)} ranks ({r0['backend']}): CPUs a rank may run on "
        f"{sorted({r['cpus'] for r in ranks})}, torch threads "
        f"{sorted({r['threads'] for r in ranks})}; a plan's wall / CPU s a "
        f"rank: " + "; ".join(
            f"{name} " + ", ".join(f"{r['plans'][name]['wall_s']:.2f} / "
                                   f"{r['plans'][name]['cpu_s']:.2f}"
                                   for r in ranks)
            for name in r0["plans"]) + f" [{smi}]")


def check_scan(got_path: pathlib.Path, want, cells_big, trig) -> None:
    """A gathered channel_scan output (packed, on disk) against one
    process's: field for field, and a detection in every channel (channel
    c carries cell cells_big[c % 128])."""
    got = trig.unpack_output(np.load(got_path))
    ref = trig.unpack_output(want)
    for f in trig.StepOutput._fields:
        g, r = getattr(got, f), getattr(ref, f)
        if f in trig._F32_FIELDS:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4, err_msg=f)
        else:
            assert (g == r).all(), f
    for c in range(got.track_event.shape[1]):
        cid = cells_big[c % len(cells_big)]
        s = np.nonzero(got.track_event[:, c, cid % 3])[0]
        assert s.size and got.cell_id[s[0], c, cid % 3] == cid, (c, cid)


def scan_on_ranks(world: int, out: pathlib.Path, backend: str, plan: str,
                  want, cells_big, one_ms: float, smi: str, trig) -> list:
    """`channel_scan` of 128 x 100 over `world` ranks (and what else `plan`
    names): the gathered output against `want` (one process's packed
    output), a detection in every channel, and the times.  returns what
    each rank measured."""
    ranks = run_ranks(world, out, backend, plan)
    check_scan(out / f"scan_ch{world}.npy", want, cells_big, trig)
    call = max(min(r["scan"]["call_ms"]) for r in ranks)
    engine = max(min(r["scan"]["engine_ms"]) for r in ranks)
    full = max(min(r["scan"]["full_ms"]) for r in ranks)
    log(f"channel_scan 128 x 100 over ch = {world} ({ranks[0]['backend']}, "
        f"{'one card' if backend == 'gloo' else 'a card a rank'}): gathered "
        f"output = one process's field for field, detections in all "
        f"{C_BIG} channels; per rank (best of 3, ms) engine alone "
        + ", ".join(f"{min(r['scan']['engine_ms']):.1f}" for r in ranks)
        + "; whole call with the gather "
        + ", ".join(f"{min(r['scan']['call_ms']):.1f}" for r in ranks)
        + f"; slowest rank {engine:.1f} / {call:.1f} ms against "
        f"{one_ms:.1f} ms in one process: {one_ms / engine:.2f}x / "
        f"{one_ms / call:.2f}x the channels/s; every rank all {C_BIG} "
        f"channels at the same time (engine alone) "
        + ", ".join(f"{min(r['scan']['full_ms']):.1f}" for r in ranks)
        + f" ms: {world * one_ms / full:.2f}x the channels/s; "
        f"{Counts(ranks[0]['launches']['scan'])} kernel launches a rank "
        f"[{smi}]")
    return ranks


def scan128_line(ranks, out, want128, cells_big, smi, trig) -> None:
    """Phase 20 (c) / 21: channel_scan with 128 channels a rank (C = 128 x
    world) against one process's channel_scan of the same C."""
    world = len(ranks)
    want, one_ms = want128[world]
    check_scan(out / f"scan128_ch{world}.npy", want, cells_big, trig)
    call = max(min(r["scan128"]["call_ms"]) for r in ranks)
    engine = max(min(r["scan128"]["engine_ms"]) for r in ranks)
    log(f"channel_scan(mesh=) with 128 channels a rank, C = "
        f"{C_BIG * world} x {STEPS_BIG} over ch = {world} "
        f"({ranks[0]['backend']}, "
        f"{'one card' if ranks[0]['backend'] == 'gloo' else 'a card a rank'}"
        f"): gathered output = one process's field for field, a detection in "
        f"all {C_BIG * world} channels; per rank (best of 3, ms) engine "
        f"alone " + ", ".join(f"{min(r['scan128']['engine_ms']):.1f}"
                             for r in ranks)
        + "; whole call with the gather "
        + ", ".join(f"{min(r['scan128']['call_ms']):.1f}" for r in ranks)
        + f"; slowest rank {engine:.1f} / {call:.1f} ms against {one_ms:.1f}"
        f" ms for C = {C_BIG * world} in one process: {one_ms / call:.2f}x "
        f"the channels/s [{smi}]")


def by_stream(events: list) -> list:
    """Events in `gather_events`' order: stably by stream."""
    return sorted(events, key=lambda e: e[0])


def check_mesh_monitor(out: pathlib.Path, mon8: dict, MultiTrigger,
                       WidebandTrigger, dev, smi: str) -> None:
    """Phase 20 (a) / 21 against phase 9c: for each class the ranks'
    events, merged, equal 9c's one-process events stream by stream; every
    rank rebased as often as 9c's run; a checkpoint from around the ranks'
    rebases (the first at which the ranks had rebased differently, else the
    first that settled a rebase) loaded into a trigger without a mesh and
    continued to the end publishes the rest.  Prints each rank's rebase
    calls, samples/s a stream and the checkpoints' times."""
    ratio = int(round(RATE8 / RATE1))
    for key in ("multi", "wide"):
        parts = json.loads((out / f"monitor_{key}.json").read_text())
        want = by_stream(mon8[key]["events"])
        got = by_stream([e for p in parts for e in p["events"]])
        assert got == want, (key, got, want)
        assert [len(p["rebases"]) for p in parts] \
            == [mon8[key]["rebases"]] * len(parts), \
            (key, [p["rebases"] for p in parts])
        saves = list(zip(*[p["saves"] for p in parts]))
        settled = [s for s in saves if any(
            [s[0]["call"], "save"] in p["rebases"] for p in parts)]
        pick = next((s for s in saves
                     if len({x["rebases_before"] for x in s}) > 1),
                    settled[0] if settled else saves[0])
        c = pick[0]["call"]
        before = by_stream([e for p, x in zip(parts, pick)
                            for e in p["events"][:x["events"]]])
        events = []
        if key == "multi":
            t = MultiTrigger(len(CELLS8), psr_threshold=4, transport="i4",
                             device=dev, **tagged_log(events))
            calls = multi_calls(t, mon8["blocks"], MONITOR8_BLOCKS,
                                MONITOR8_CHUNK)
        else:
            t = WidebandTrigger(RATE8, CENTERS8, transport="i8",
                                psr_threshold=4, device=dev,
                                **tagged_log(events))
            calls = wide_calls(t, mon8["band"], MONITOR8_BLOCKS,
                               MONITOR8_CHUNK * ratio)
        t.REBASE_AT = MESH_REBASE_AT
        t.load_state(str(out / f"ckpt_{key}" / f"{c}.npz"))
        for i, call in enumerate(calls):
            if i >= c:
                call()
        t.flush()
        resumed = json.loads(json.dumps(events))
        assert by_stream(before + resumed) == want, (key, c)
        save_ms = [x["ms"] for s in saves for x in s]
        log(f"{key} over ch = {len(parts)}: gathered events = phase 9c's "
            f"one process's ({len(want)}) stream by stream through "
            f"{mon8[key]['rebases']} rebases on every rank, every stream "
            f"tracked at the end"
            + (", _wabs the rebases' deltas on every rank" if key == "wide"
               else "")
            + "; rebase calls a rank (s: in a save_state) "
            + "; ".join(" ".join(f"{c_}{'s' if w == 'save' else ''}"
                                 for c_, w in p["rebases"]) for p in parts)
            + f"; M samples/s a stream a rank "
            + ", ".join(f"{p['samples'] / p['wall_s'] / 1e6:.3f}"
                        for p in parts)
            + f" (9c, one process, pipeline=0: both runs "
            f"{mon8[key]['wall']:.1f} s); {len(saves)} checkpoints at calls "
            f"{saves[0][0]['call']}-{saves[-1][0]['call']} around the first "
            f"two rebases, save_state median / max "
            f"{np.median(save_ms):.1f} / {max(save_ms):.1f} ms; the one at "
            f"call {c} (ranks' rebases before it "
            f"{[x['rebases_before'] for x in pick]}) resumed without a mesh "
            f"publishes the rest ({len(resumed)} events) [{smi}]")


def paced_line(ranks: list, smi: str) -> None:
    """Phase 20 (b): each rank's paced producer."""
    log(f"paced MultiTrigger(8, i4, mesh=) over ch = {len(ranks)}: a "
        f"producer thread a rank, {PACED_S:.0f} s at 1.92 Msps a stream in "
        f"38400-sample chunks, {PACED_BURST} at once; the monitor pulled "
        f"nothing while backlog > {PACED_LIMIT_RANKS}, polling for at most "
        f"{PACED_HOLD_S * 1e3:.0f} ms; per rank held / drained / calls "
        + ", ".join(f"{r['paced']['held']} / {r['paced']['drained']} / "
                    f"{r['paced']['calls']}" for r in ranks)
        + "; lag median / p99 / max ms "
        + ", ".join("{:.1f} / {:.1f} / {:.1f}".format(*r["paced"]["lag_ms"])
                    for r in ranks)
        + "; queue depth at most "
        + ", ".join(str(r["paced"]["depth"]) for r in ranks)
        + f"; each rank's events equal the same samples fed flat-out [{smi}]")


def shards_line(ranks, smi: str) -> None:
    world = ranks[0]["world"]
    log(f"time_sharded_scan over t = {world} ({ranks[0]['backend']}): 2 s "
        f"of cell 125 in {world} blocks, found in every block, "
        + ", ".join(f"{r['shards_ms']:.1f}" for r in ranks)
        + f" ms a rank; the stream whose last peak of every block lies 200 "
        f"samples before the seam: found in every block through the halo "
        f"({ranks[0]['straddle_events']} events)"
        + (", integers equal to the same call on CPU ranks"
           if ranks[0].get("straddle_equals_cpu_ranks") else "")
        + f"; {Counts(ranks[0]['launches']['shards'])} kernel launches a "
        f"rank [{smi}]")


def write_rank_inputs(tmp: pathlib.Path, sigs, band8, mon8) -> None:
    """What the ranks of phases 20 and 21 read."""
    np.save(tmp / "sigs.npy", np.stack(sigs))
    np.save(tmp / "band8.npy", band8)
    np.save(tmp / "monitor8.npy", mon8["blocks"])
    np.save(tmp / "monitor_wide.npy", mon8["band"])


def cards_phase(out, want, cells_big, one_ms, want128, mon8, smi, trig,
                MultiTrigger, WidebandTrigger, dev) -> dict:
    """Phase 21 (`out` holds the ranks' inputs).  returns {path: launches}
    of every rank x plan (empty when the phase did not start)."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"one rank per card over NCCL: not started, this machine has "
            f"{n} card; this run says nothing of NCCL between cards")
        return {}
    world = 4 if n >= 4 else 2
    ranks = scan_on_ranks(world, out, "nccl",
                          "scan,shards,stream,monitor,scan128", want,
                          cells_big, one_ms, smi, trig)
    shards_line(ranks, smi)
    merged = json.loads((out / "stream_events.json").read_text())
    ids = list(enumerate(c for c, _ in CELLS8))
    for key in ("multi", "wide"):
        assert [(k, f["cell_id"]) for k, f in merged[key]] == ids, merged[key]
    assert [k for k, _ in merged["before"]] == [0, 1, 2, 3], merged["before"]
    log(f"MultiTrigger(8, mesh=) i16 and WidebandTrigger(8 centres, mesh=) "
        f"f32 over ch = {world}, a card a rank: the gathered events are the "
        f"8 cells in stream order; M samples/s per stream, per rank: "
        + ", ".join(f"{3840000 / r['multi']['wall_s'] / 1e6:.3f}"
                    for r in ranks) + " and "
        + ", ".join(f"{3840000 / r['wide']['wall_s'] / 1e6:.3f}"
                    for r in ranks)
        + f"; a checkpoint written through NCCL's all_gather_object [{smi}]")
    check_mesh_monitor(out, mon8, MultiTrigger, WidebandTrigger, dev, smi)
    scan128_line(ranks, out, want128, cells_big, smi, trig)
    ranks_line(ranks, smi)
    return rank_paths(ranks, "a card a rank (NCCL)")


def mesh_phase(tmp: pathlib.Path, want128, cells_big, mon8, smi, trig,
               MultiTrigger, WidebandTrigger, dev, want=None,
               one_ms=None) -> tuple:
    """Phase 20: this script as 2 and then 4 gloo ranks sharing the card
    (`tmp` holds their inputs).  With `want` (one process's 128 x 100
    output) and its ms, every plan; without, the plans of the mesh monitor
    and of 128 channels a rank alone (`--mesh`).  Checks (a)-(c) and
    returns ({path: launches} of every rank x plan, the 2 ranks' and the 4
    ranks' records)."""
    if want is not None:
        ranks2 = scan_on_ranks(2, tmp, "gloo", "scan,scan128", want,
                               cells_big, one_ms, smi, trig)
        ranks4 = scan_on_ranks(4, tmp, "gloo",
                               "scan,shards,stream,monitor,paced,scan128",
                               want, cells_big, one_ms, smi, trig)
    else:
        ranks2 = run_ranks(2, tmp, "gloo", "scan128")
        ranks4 = run_ranks(4, tmp, "gloo", "monitor,paced,scan128")
    for ranks in (ranks2, ranks4):
        scan128_line(ranks, tmp, want128, cells_big, smi, trig)
    check_mesh_monitor(tmp, mon8, MultiTrigger, WidebandTrigger, dev, smi)
    paced_line(ranks4, smi)
    for ranks in (ranks2, ranks4):
        ranks_line(ranks, smi)
    label = "ranks on one card (gloo)"
    return ({**rank_paths(ranks2, label), **rank_paths(ranks4, label)},
            ranks2, ranks4)


def one_process_scans(big, worlds, channel_scan, trig) -> dict:
    """{world: one process's channel_scan of the 128-channel buffer
    repeated `world` times (packed output, best of 3 ms)}: what 128
    channels a rank over `world` ranks is held to."""
    out = {}
    for world in worlds:
        glob = tuple(x.repeat(world, 1) for x in big)
        out[world] = one_process_scan(glob, channel_scan, trig)
        del glob
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        return rank_main(sys.argv[2:])
    only_cards = sys.argv[1:2] == ["--cards"]
    only_kernels = sys.argv[1:2] == ["--kernels"]
    only_monitor = sys.argv[1:2] == ["--monitor"]
    only_mesh = sys.argv[1:2] == ["--mesh"]
    parent_tree = None
    if "--parent" in sys.argv:
        parent_tree = pathlib.Path(sys.argv[sys.argv.index("--parent") + 1])
        assert (parent_tree / "ltetrigger_tpu_torch" / "csrc").is_dir(), \
            parent_tree
    # ---- 1. the card ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    from ltetrigger_tpu_torch.apps import cell_search_file as cli
    from ltetrigger_tpu_torch.apps import snr_sweep as sweep
    from ltetrigger_tpu_torch.apps import wideband_scan as wscan
    from ltetrigger_tpu_torch.ltecore import synth
    from ltetrigger_tpu_torch.models import api, trigger as trig
    from ltetrigger_tpu_torch.models.multi import MultiTrigger
    from ltetrigger_tpu_torch.models.wideband import WidebandTrigger
    from ltetrigger_tpu_torch.ops import channelize as chan
    from ltetrigger_tpu_torch.ops import correlate, cplx, viterbi
    from ltetrigger_tpu_torch.ops.kernels import build as kbuild
    from ltetrigger_tpu_torch.ops.kernels import matched_filter as mf
    from ltetrigger_tpu_torch.ops.kernels import pass_b as pb
    from ltetrigger_tpu_torch.ops.kernels import viterbi as vk
    from ltetrigger_tpu_torch.ops.kernels import cfo_ring as rk
    from ltetrigger_tpu_torch.ops.kernels import tti_chain as tk
    from ltetrigger_tpu_torch.parallel import (channel_scan, gather_events,
                                               init_distributed, make_mesh,
                                               time_sharded_scan)
    from ltetrigger_tpu_torch.parallel import mesh as meshmod
    import torch.distributed as dist

    # ---- 2. build ----
    path, build_s = kbuild.build()
    log(f"build: {path.name} from "
        f"{', '.join(x.name for x in sorted(kbuild.CSRC.glob('*.cu')))} in "
        f"{build_s:.2f} s (one nvcc a source, all at once)")
    report = path.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(report):
        if "Compiling entry function" in line:      # then: properties, spills
            log(f"  {kernel_label(line.split(chr(39))[1])}: " + "; ".join(
                x.replace("ptxas info    :", "").strip()
                for x in report[i + 2:i + 4]))      # and registers

    parent = None
    if parent_tree is not None:
        parent, parent_s = parent_kernels(parent_tree)
        log(f"parent kernels: {parent_tree}/ltetrigger_tpu_torch imported "
            f"from a temporary copy as parent_ltetrigger_tpu_torch, its "
            f"library built by its own build.py in {parent_s:.2f} s")

    if only_cards or only_mesh:     # phases 1, 2, 9c and 21 (or 20) alone
        big, cells_big = big_buffer(dev, synth, trig)
        want, one_ms = one_process_scan(big, channel_scan, trig)
        want128 = one_process_scans(big, (2, 4), channel_scan, trig)
        del big
        _, mon8 = monitor8(synth, dev, MultiTrigger, WidebandTrigger)
        with tempfile.TemporaryDirectory(dir=kbuild.BUILD_DIR) as tmp:
            tmp = pathlib.Path(tmp)
            write_rank_inputs(
                tmp, [stream_cell(synth, cid, prb, 2.0, seed=20 + i)
                      for i, (cid, prb) in enumerate(CELLS8)],
                band_of_eight(dev, synth), mon8)
            if only_mesh:
                paths, _, _ = mesh_phase(tmp, want128, cells_big, mon8, smi,
                                         trig, MultiTrigger, WidebandTrigger,
                                         dev)
            else:
                paths = cards_phase(tmp, want, cells_big, one_ms, want128,
                                    mon8, smi, trig, MultiTrigger,
                                    WidebandTrigger, dev)
        log(smi)
        ok = bool(paths) and all(ran(n) for n in paths.values())
        if only_mesh:
            assert ok, paths
            print(json.dumps({"ok": None, "partial": "mesh"}))
            return 0
        print(json.dumps({"ok": ok, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0 if ok else 1

    if only_monitor:    # phases 1, 2, 9a-9e and 9d's idle share alone
        paths, block, _ = monitor_phases(dev, smi, synth, api, trig,
                                         MultiTrigger, WidebandTrigger)
        for path, n in paths.items():
            assert ran(n), f"{path}: {n}"
        paced_idle_share(api, block, dev, smi)
        log(smi)
        print(json.dumps({"ok": None, "partial": "monitor"}))
        return 0

    # ---- 3. kernel against plain version ----
    big, cells_big = big_buffer(dev, synth, trig)
    small = tuple(c[:1].contiguous() for c in big)
    lo = trig.LOOKBACK
    w_fat = correlate.weights_fat("cuda")
    rows = {}
    worst = 0.0

    def case(label, buf, m, dt, kernel, plain, at=lo, w_fat=w_fat):
        """One shape and input type: kernel held to plain version, both
        timed, beside the bound and the library matmul."""
        nonlocal worst
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, **TOL)
        err = (got - ref).abs().max().item()
        worst = max(worst, err)
        del ref
        ms = cuda_ms(kernel)
        dms = replay_ms(kernel)
        pms = cuda_ms(plain)
        x = operand(buf, at, m)
        w = w_fat
        if dt == torch.bfloat16:
            x, w = x.to(dt), w.to(dt)
        lms = cuda_ms(lambda: torch.matmul(x, w))
        del x
        bms, by = bound(buf[0].shape[0], m, dt)
        rows[(label, str(dt))] = dict(
            shape=label, dtype=str(dt), ms=ms, replay_ms=dms, plain_ms=pms,
            library_ms=lms, bound_ms=bms, bound_by=by, max_abs_err=err)
        log(f"{label} {dt}: kernel {ms:.4f} ms a wrapper call ({dms:.4f} "
            f"replayed from a CUDA graph), plain {pms:.4f} ms, library "
            f"matmul {lms:.4f} ms, bound {bms:.4f} ms ({by}), max_abs_err "
            f"{err:.3e}")
        return got

    for label, buf in (("grid C=1 g=25", small), (f"grid C={C_BIG} g=25",
                                                  big)):
        for dt in (torch.float32, torch.bfloat16):
            case(label, buf, 25 * 75, dt,
                 lambda: mf.group_power(*buf, lo, 25, dt),
                 lambda: mf.group_power_plain(*buf, lo, 25, dt))
    win = tuple(c[:8, lo:lo + correlate.V2_WINDOW].contiguous() for c in big)
    win_at_lo = tuple(c[:8] for c in big)      # same samples, read from lo
    win_power = {}
    for dt in (torch.float32, torch.bfloat16):
        win_power[dt] = case(
            "window B=8", win_at_lo, 75, dt,
            lambda: mf.pss_correlate_power(win, dt),
            lambda: correlate.pss_correlate_power_v2(win, dt))

    # shapes that stress the addressing: a ramp (a row read one block off
    # shows), N and lo unaligned with reads past N, ragged row counts
    n_odd = 30003
    ramp = tuple(((torch.arange(5 * n_odd, device=dev, dtype=torch.float32)
                   % p) / p - 0.5).reshape(5, n_odd) for p in (977, 1013))
    noise = tuple(c[:40, 1:20002].contiguous() for c in big)
    for label, buf, at, m in (("ramp", ramp, 3, 233),
                              ("ramp past N", ramp, 20001, 130),
                              ("one row", ramp, 2, 1),
                              ("128-row tile, ragged", noise, 1002, 147)):
        for dt in (torch.float32, torch.bfloat16):
            got = mf.rows_power(*buf, at, m, dt)
            ref = mf.rows_power_plain(*buf, at, m, dt)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, **TOL)
            worst = max(worst, (got - ref).abs().max().item())
    log("ramp, unaligned N and lo, reads past N, ragged row counts: kernel "
        "equals plain version")

    pk32, psr32 = correlate.peak_and_psr(win_power[torch.float32])
    pk16, psr16 = correlate.peak_and_psr(win_power[torch.bfloat16])
    hit = psr32 > 4.0                  # the roots that carry a cell
    assert int(hit.sum()) >= 8, f"only {int(hit.sum())} detected roots"
    assert torch.equal(pk32[hit], pk16[hit]), "bf16 moved a peak"
    torch.testing.assert_close(psr16[hit], psr32[hit], rtol=5e-3, atol=0)
    log(f"bf16 vs f32: {int(hit.sum())} detected roots, identical peaks, "
        f"PSR within rtol 5e-3")

    # ---- 3a. the pass-B kernel against its plain version ----
    pb_rows, pb_worst = {}, 0.0

    def pass_b_case(label, state0, powers, n_acts, grid0, ta, te,
                    graph=False):
        """Kernel and plain version over consecutive groups from state0:
        every row and state field equal, the EMA bit for bit; the first
        group timed beside its bound (and, with `graph`, the plain group
        captured once in a CUDA graph and replayed)."""
        nonlocal pb_worst
        st_k = st_p = state0
        grid, acquired, lost = grid0, False, False
        for power, n_act in zip(powers, n_acts):
            st_k, rk = pb.scan_group_kernel(st_k, power, grid, n_act, 4.0,
                                            ta, te)
            st_p, rp = pb.scan_group_plain(st_p, power, grid, n_act, 4.0,
                                           ta, te)
            torch.cuda.synchronize()
            for f, x, y in zip(("peak", "psr", "score", "tracking", "emit",
                                "lost", "consumed"), rk, rp):
                assert x.dtype == y.dtype and torch.equal(x, y), (label, f)
            for f in trig.TriggerState._fields:
                assert torch.equal(getattr(st_k, f), getattr(st_p, f)), \
                    (label, f)
            if grid == grid0:
                n_search = searched(state0, rp, n_act, te)
            acquired |= bool(rk[3].any())
            lost |= bool(rk[5].any())
            grid += n_act * 9600
        pb_worst = max(pb_worst, (st_k.ema - st_p.ema).abs().max().item())

        def kern():
            return pb.scan_group_kernel(state0, powers[0], grid0, n_acts[0],
                                        4.0, ta, te)

        def plain():
            return pb.scan_group_plain(state0, powers[0], grid0, n_acts[0],
                                       4.0, ta, te)
        old = None
        if parent is not None:
            def old():
                return parent["pb"](state0, powers[0], grid0, n_acts[0], 4.0,
                                    ta, te)
            st_o, ro = old()
            st_p, rp = plain()
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(ro, rp)), label
            assert all(torch.equal(getattr(st_o, f), getattr(st_p, f))
                       for f in trig.TriggerState._fields), label
        t = paired_ms(kern, old)
        pms = cuda_ms(plain, iters=3)
        gms = replay_ms(plain) if graph else None
        lanes = state0.score.numel() // 3
        bms, by = pass_b_bound(lanes, powers[0].shape[-4], n_search)
        pb_rows[label] = dict(shape=label, **t, plain_ms=pms, graph_ms=gms,
                              bound_ms=bms, bound_by=by, max_abs_err=0.0,
                              searched=n_search)
        log(f"pass B {label}: kernel = plain version over {len(powers)} "
            f"groups (rows and state exact, EMA bit for bit; acquired "
            f"{acquired}, lost {lost})"
            + ("; the parent's = plain too" if old is not None else "")
            + f"; group 0: {pairs_text(t)}, plain {pms:.4f} ms"
            + (f", plain captured in a CUDA graph {gms:.4f} ms"
               if gms is not None else "")
            + f", bound {bms:.4f} ms ({by}, {n_search} searched root-steps "
            f"of {lanes * 3 * n_acts[0]}) [{smi}]")
        return acquired, lost

    # C=128, g=25: pass A's real power over the 128 x 100 dispatch's groups
    power128 = [mf.group_power(*big, lo + 25 * 9600 * i, 25, torch.bfloat16)
                for i in range(4)]
    pass_b_case(f"C={C_BIG} g=25 (real power)",
                trig.init_state(batch=(C_BIG,), device=dev), power128,
                [25] * 4, lo, trig.DEFAULT_TRACK_AFTER,
                trig.DEFAULT_TRACK_EVERY, graph=True)
    del power128
    # planted power: ties, edge peaks; acquisition, loss, reacquisition
    # (track_after 4, track_every 3), the last group partial
    for n_rows, g, n_last in ((8, 32, 20), (1, 32, 32), (8, 32, 32),
                              (16, 32, 11)):
        strong = [t < 12 or t >= 40 for t in range(3 * g)]
        powers = [planted_power(dev, n_rows, g, strong[i * g:(i + 1) * g],
                                seed=i) for i in range(3)]
        acq, lost = pass_b_case(
            f"B={n_rows} g={g} (planted; last group n_active={n_last})",
            trig.init_state(batch=(n_rows,), device=dev), powers,
            [g, g, n_last], lo, 4, 3)
        assert acq and lost, (n_rows, acq, lost)
        del powers
    pb_info = pb.kernel_info()
    residency("pass-B kernel pb_scan_kernel", pb_info, pb.launch_plan,
              [(f"B={n}", n) for n in (1, 8, 16, 32, 64, 128, 256)], smi)

    # ---- 3b. the Viterbi kernel against its plain version ----
    from ltetrigger_tpu_torch.ltecore import coding
    vit_rows, vit_worst = {}, 0.0
    check = np.random.default_rng(1).integers(0, 2, size=(8, 40))
    assert (conv_encode_batch(check, coding.CONV_POLYS)
            == np.stack([coding.conv_encode(b) for b in check])).all()
    for b in (48, 73728):
        for sigma in (0.3, 0.8, 1.5):
            rng = np.random.default_rng(int(b + 10 * sigma))
            sent = rng.integers(0, 2, size=(b, 40))
            coded = conv_encode_batch(sent, coding.CONV_POLYS)
            llr = (1.0 - 2.0 * coded.transpose(0, 2, 1)) \
                + sigma * rng.normal(size=(b, 40, 3))
            x = torch.from_numpy(llr.astype(np.float32)).to(dev)
            kb, km = vk.viterbi_decode_wa_kernel(x)
            pbits, pm = viterbi.viterbi_decode_wa(x)
            mbits, mm = vk.schedule_model(x)
            torch.cuda.synchronize()
            differ = (kb != pbits).any(dim=1)
            tie = near_tie(x)
            assert not (differ & ~tie).any(), \
                (b, sigma, int((differ & ~tie).sum()))
            torch.testing.assert_close(km, pm, rtol=1e-5, atol=0)
            assert torch.equal(kb, mbits), (b, sigma, "schedule model")
            torch.testing.assert_close(km, mm, rtol=1e-5, atol=0)
            err = (km - pm).abs().max().item()
            vit_worst = max(vit_worst, err)
            ok = (kb.cpu().numpy() == sent).all(axis=1).mean()

            def kern():
                return vk.viterbi_decode_wa_kernel(x)
            old = None
            if parent is not None:
                def old():
                    return parent["vit"](x)
                ob, om = old()
                torch.cuda.synchronize()
                old_bad = int((((ob != pbits).any(dim=1)) & ~tie).sum())
                assert old_bad == 0, (b, sigma, "parent", old_bad)
                torch.testing.assert_close(om, pm, rtol=1e-5, atol=0)
            t = paired_ms(kern, old)
            pms = cuda_ms(lambda: viterbi.viterbi_decode_wa(x), iters=3)
            bms, by = viterbi_bound(b)
            vit_rows[(b, sigma)] = dict(
                shape=f"B={b} sigma={sigma}", **t, plain_ms=pms,
                bound_ms=bms, bound_by=by, max_abs_err=err,
                bits_differ=int(differ.sum()), near_ties=int(tie.sum()))
            log(f"Viterbi B={b} sigma={sigma}: kernel = plain version "
                f"({int(differ.sum())} codewords differ, all near-ties; "
                f"{int(tie.sum())} near-ties)"
                + ("; the parent's too" if old is not None else "")
                + f"; kernel = its schedule in PyTorch bit for bit, metric "
                f"max_abs_err {err:.3e}, {ok:.3f} of the blocks decoded; "
                f"{pairs_text(t)}, plain {pms:.4f} ms, bound {bms:.4f} ms "
                f"({by}) [{smi}]")
            del x, kb, km, pbits, pm, mbits, mm

    vit_info = vk.kernel_info()
    residency("Viterbi kernel vit_wa_kernel", vit_info, vk.launch_plan,
              [("B=48", 48), ("B=73728", 73728)], smi)

    # ---- 3c. the TTI-chain kernel against its plain version ----
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    one_elem = torch.zeros(1, device=dev)
    floor = timed3(lambda: one_elem.add_(1.0))
    log(f"launch floor, one 1-element add: {floor[0]:.4f} ms a call "
        f"[{floor[1]:.4f} replayed one call a graph, {floor[2]:.4f} one of "
        f"20 a graph] [{smi}]")
    tti_rows = {}
    for lead, k in (((C_BIG, 3), 16), ((16, 3), 16), ((1, 3), 4),
                    ((1, 3), 32)):
        for combine in (True, False):
            ins = chain_inputs(lead, k, seed=k + 2 * combine, dev=dev)
            got = tk.tti_chain_kernel(*ins, combine)
            ref = tk.tti_chain_plain(*ins, combine)
            model = tk.schedule_model(*ins, combine, sms=sms)
            torch.cuda.synchronize()
            for g, r, m, what in zip(got, ref, model, ("accs", "qs", "acc",
                                                       "n", "cell")):
                assert g.dtype == r.dtype and torch.equal(g, r), \
                    (lead, k, combine, what)
                assert torch.equal(g, m), (lead, k, combine, what, "model")
            assert torch.equal(torch.signbit(got[0]), torch.signbit(ref[0]))
            old = None
            if parent is not None:
                def old():
                    return parent["tti"](*ins, combine)
                for g, r, what in zip(old(), ref, ("accs", "qs", "acc", "n",
                                                   "cell")):
                    assert torch.equal(g, r), (lead, k, "parent", what)
            fresh, cells, valid = ins[4], ins[5], ins[6]
            changes = int((cells[..., 1:] != cells[..., :-1]).sum())
            plan = tk.launch_plan(lead[0] * lead[1], sms)
            label = (f"{lead[0]} x {lead[1]} lanes K={k} "
                     f"combine={combine}")
            t = paired_ms(lambda: tk.tti_chain_kernel(*ins, combine), old)
            pms = cuda_ms(lambda: tk.tti_chain_plain(*ins, combine), iters=3)
            bms, by = tti_bound(valid)
            tti_rows[label] = dict(
                shape=label, **t, plain_ms=pms, bound_ms=bms, bound_by=by,
                max_abs_err=0.0, blocks=plan["blocks"],
                threads=plan["threads"], depth=plan["depth"],
                restarts=int(fresh.sum()), cell_changes=changes,
                invalid=int((~valid).sum()))
            log(f"TTI chain {label}: kernel = plain version = its schedule "
                f"in PyTorch, bit for bit (accs, qs, acc, n, cell; "
                f"{int(fresh.sum())} fresh restarts, {changes} cell-id "
                f"changes, {int((~valid).sum())} invalid slots); "
                f"{plan['blocks']} blocks of {plan['threads']} threads, "
                f"{plan['depth']} slots in flight; {pairs_text(t)}, plain "
                f"{pms:.4f} ms, bound {bms:.4f} ms ({by}) [{smi}]")
            del ins, got, ref, model
    tti_info = {n: tk.kernel_info(n, sms) for n in (3, 384)}
    residency("TTI-chain kernel tti_chain_kernel, one-warp blocks",
              tti_info[3], tk.launch_plan,
              [("3 lanes", 3), ("48 lanes", 48), ("88 lanes", 88)], smi)
    residency("TTI-chain kernel tti_chain_kernel, four-warp blocks",
              tti_info[384], tk.launch_plan, [("384 lanes", 384)], smi)

    # ---- 3d. the CFO-ring kernel against its plain version ----
    ring_rows, ring_worst = {}, 0.0
    # S=1000 with losses 10x rarer: about one reset a lane, counts past
    # 1000 (five wraps of the ring)
    for lanes, s_ring, lost_p in ((48, 201, 0.01), (48, 400, 0.01),
                                  (48, 1000, 0.001), (3072, 400, 0.01)):
        ins = ring_inputs(lanes, s_ring, seed=s_ring, dev=dev, lost_p=lost_p)
        ring_k, count_k, mean_k = rk.ring_scan_kernel(*ins)
        ring_p, count_p, mean_p = rk.ring_scan_plain(*ins)
        ring_m, count_m, mean_m = rk.schedule_model(*ins)
        torch.cuda.synchronize()
        assert torch.equal(ring_k, ring_p) and torch.equal(count_k, count_p)
        torch.testing.assert_close(mean_k, mean_p, rtol=0, atol=1e-5)
        assert torch.equal(ring_k, ring_m) and torch.equal(count_k, count_m)
        assert torch.equal(mean_k, mean_m), (lanes, s_ring, "model")
        err = (mean_k - mean_p).abs().max().item()
        ring_worst = max(ring_worst, err)
        old = None
        if parent is not None:
            def old():
                return parent["ring"](*ins)
            o_ring, o_count, o_mean = old()
            assert torch.equal(o_ring, ring_p) and \
                torch.equal(o_count, count_p), (lanes, s_ring, "parent")
            torch.testing.assert_close(o_mean, mean_p, rtol=0, atol=1e-5)
        one = (ins[0][:1], ins[1][:1],
               *(x[:, :1].contiguous() for x in ins[2:]))
        t = paired_ms(lambda: rk.ring_scan_kernel(*ins), old)
        chain_ms = replay_ms(lambda: rk.ring_scan_kernel(*one), iters=50,
                             calls=20)
        pms = cuda_ms(lambda: rk.ring_scan_plain(*ins), iters=3)
        bms, by = ring_bound(ins[1], ins[3], ins[4])
        label = f"{lanes} lanes S={s_ring}"
        wraps = (ins[1].long() + ins[3].long().cumsum(0)
                 * (ins[4].long().cumsum(0) == 0)).max().item() // 200
        ring_rows[label] = dict(shape=label, **t, plain_ms=pms,
                                bound_ms=bms, bound_by=by, chain_ms=chain_ms,
                                max_abs_err=err, losses=int(ins[4].sum()))
        log(f"CFO ring {label}: kernel = plain version (ring and count "
            f"exact, mean max_abs_err {err:.3e} subcarriers; "
            f"{int(ins[4].sum())} losses, {int(ins[3].sum())} pushes, up "
            f"to {wraps} wraps before a lane's first loss) = its "
            f"schedule in PyTorch, bit for bit; {pairs_text(t)}, plain "
            f"{pms:.4f} ms, bound {bms:.5f} ms ({by}); one lane alone "
            f"{chain_ms:.4f} ms (one of 20 a graph) [{smi}]")
        del ins, one, ring_m, count_m, mean_m
    ring_info = rk.kernel_info()
    residency("CFO-ring kernel ring_scan_kernel", ring_info, rk.launch_plan,
              [("48 lanes", 48), ("3072 lanes", 3072)], smi)
    if only_kernels:    # phases 1-3d alone: no path driven, no success line
        log(json.dumps({"pass_b": list(pb_rows.values()),
                        "viterbi": list(vit_rows.values()),
                        "tti": list(tti_rows.values()),
                        "ring": list(ring_rows.values()),
                        "pb_info": pb_info, "vit_info": vit_info,
                        "tti_info": tti_info, "ring_info": ring_info,
                        "launch_floor": floor}))
        log(smi)
        print(json.dumps({"ok": None, "partial": "kernels"}))
        return 0

    # ---- 4. the main path: search over four rates, then the CLI ----
    captures = []
    for cid, prb, rate in CELLS:
        frame = synth.synthesize_frame(cid, nof_prb_field=prb)
        captures.append(upsample(frame, int(rate // 1.92e6)))
    with tempfile.TemporaryDirectory(dir=kbuild.BUILD_DIR) as tmp:
        cap_path = f"{tmp}/cell125_15.36M.c64"
        captures[2].tofile(cap_path)
        reset_launches()
        for (cid, prb, rate), iq in zip(CELLS, captures):
            t0 = time.perf_counter()
            n0 = mf.launches
            cells = api.search(iq, rate, psr_threshold=4, max_seconds=1.0,
                               device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            assert cells, f"cell {cid}: nothing found"
            c = cells[0]
            got = (c.cell_id, c.cp_len, c.nof_phich_resources, c.nof_prb,
                   c.nof_tx_ports, c.phich_len)
            assert got == (cid, "Normal", "1", prb, 1, "Normal"), got
            log(f"search {rate / 1e6:.2f} Msps: cell {cid} {prb} PRB found "
                f"in {wall * 1e3:.1f} ms wall, {mf.launches - n0} kernel "
                f"launch(es)")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main([cap_path, "-s", "15.36M", "--repeat",
                           "--time-out", "1"])
        launches = read_launches()
        assert rc == 0 and '"status": "FOUND"' in out.getvalue(), \
            out.getvalue()
        assert json.loads(out.getvalue().split("done.")[1])["cell_id"] == 125
    assert ran(launches), f"a kernel of the main path never " \
        f"launched: {launches}"
    path_launches = {"search and CLI": launches}
    log(f"CLI printed FOUND; the main path launched the kernels {launches} "
        f"times")

    # ---- 5. one dispatch of 128 channels x 100 steps ----
    def dispatch():
        return trig.scan_engine(big, trig.init_state(batch=(C_BIG,),
                                                     device=dev),
                                STEPS_BIG, 4.0)

    reset_launches()
    st, out = dispatch()                  # warm-up (allocator, caches)
    torch.cuda.synchronize()
    per_dispatch = read_launches()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        st, out = dispatch()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = ms_dispatch = 1e3 * min(times)
    ev = out.track_event.cpu().numpy()              # [S, C, R]
    ids = out.cell_id.cpu().numpy()
    for c, cid in enumerate(cells_big):
        s = np.nonzero(ev[:, c, cid % 3])[0]
        assert s.size, f"channel {c}: cell {cid} never published"
        assert ids[s[0], c, cid % 3] == cid, (c, cid, ids[s[0], c, cid % 3])
    assert np.isfinite(out.psr.cpu().numpy()).all()
    sps = C_BIG * STEPS_BIG * 9600 / (ms / 1e3)
    log(f"scan_engine C={C_BIG} x {STEPS_BIG} steps: {ms:.1f} ms/dispatch "
        f"(best of {len(times)}: "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times)}), "
        f"{sps / 1e9:.3f} G IQ samples/s, {per_dispatch} kernel launches a "
        f"dispatch, detections in all {C_BIG} "
        f"channels [{smi}]")

    # a small dispatch, card against the CPU run (plain versions)
    sig = (big[0][:1, :12 * 9600 + 2000].cpu(), big[1][:1, :12 * 9600
                                                     + 2000].cpu())
    _, ref = trig.scan_engine(sig, trig.init_state(batch=(1,), device="cpu"),
                             12, 4.0)
    _, got = trig.scan_engine(tuple(c.to(dev) for c in sig),
                              trig.init_state(batch=(1,), device=dev),
                              12, 4.0)
    for f in trig.StepOutput._fields:
        g, r = getattr(got, f).cpu(), getattr(ref, f)
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
        else:
            assert torch.equal(g, r), f
    log("12-step dispatch: card equals CPU field for field")

    # the dispatch pass by pass (host clock around synchronised work)
    def timed(fn, reps=3):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return ts

    group = trig._pick_group(STEPS_BIG, C_BIG)
    t_a = timed(lambda: [trig._group_power(big, lo + i * group * 9600, group)
                         for i in range(STEPS_BIG // group)])
    t_ab = timed(lambda: trig.scan_pass(
        big, trig.init_state(batch=(C_BIG,), device=dev), STEPS_BIG, 4.0))
    t_all = timed(dispatch)
    log(f"per pass, C={C_BIG} x {STEPS_BIG} (ms, {len(t_a)} reps each): "
        f"pass A alone ({STEPS_BIG // group} launches of g={group}) "
        f"{', '.join(f'{t:.2f}' for t in t_a)}; passes A+B "
        f"{', '.join(f'{t:.1f}' for t in t_ab)}; whole dispatch "
        f"{', '.join(f'{t:.1f}' for t in t_all)}")

    # ---- 6. the streaming Trigger ----
    def counted(run):
        """run() with the launch and host-sync counts set to 0 before it:
        (result, kernel launches by kernel, host syncs by name)."""
        reset_launches()
        trig.host_syncs.clear()
        res = run()
        return res, read_launches(), dict(trig.host_syncs)

    sig = stream_cell(synth, 125, 50, 2.0, seed=11)
    feed(api.Trigger(psr_threshold=4, device="cuda"), sig[:20 * 19200])
    events = {}
    path_launches["Trigger"] = Counts()
    for transport in ("f32", "i16", "i8"):
        t = api.Trigger(psr_threshold=4, transport=transport, device="cuda")
        (got, wall), n_launch, syncs = counted(lambda: feed(t, sig))
        n_disp = dispatches(t)
        assert n_launch["mf"] == n_launch["pb"] == n_disp > 0 \
            and n_launch["vit"] > 0, (n_launch, n_disp)
        assert got and t.tracking[125 % 3], transport
        events[transport] = got
        path_launches["Trigger"] += n_launch
        log(f"Trigger {transport}: {sig.size / wall / 1e6:.3f} M samples/s "
            f"of wall time ({sig.size} samples in {wall * 1e3:.1f} ms), "
            f"{n_disp} dispatches, kernel launches a dispatch "
            + " / ".join(f"{n_launch[k] / n_disp:.2f} {k}" for k in KERNELS)
            + " and " + ", ".join(f"{v / n_disp:.2f} '{k}'"
                                  for k, v in sorted(syncs.items()))
            + f" host syncs a dispatch, at most {t.max_in_flight} "
            f"dispatch(es) in flight; stages (mean ms x count): "
            + ", ".join(f"{k} {v['mean_ms']:.3f} x {v['count']}"
                        for k, v in t.timer.summary().items())
            + f" [{smi}]")
    on_cpu, _ = feed(api.Trigger(psr_threshold=4, transport="f32",
                                 device="cpu"), sig)
    assert fields(events["f32"]) == fields(on_cpu) and on_cpu, \
        (fields(events["f32"]), fields(on_cpu))
    decisive = ("cell_id", "nof_prb", "nof_tx_ports", "cp_len")
    for transport in ("i16", "i8"):
        assert fields(events[transport], decisive) \
            == fields(on_cpu, decisive), transport
    t_sync = api.Trigger(psr_threshold=4, transport="f32", pipeline=0,
                         device="cuda")
    got_sync, wall = feed(t_sync, sig)
    assert fields(got_sync) == fields(events["f32"])
    log(f"Trigger f32 on the card = on the CPU, field for field "
        f"({fields(on_cpu)}); i16 and i8 find the same cell; pipeline=0 "
        f"publishes the same at {sig.size / wall / 1e6:.3f} M samples/s, at "
        f"most {t_sync.max_in_flight} in flight [{smi}]")

    # the same stream in chunks of 32 half-frames: deep dispatches
    t_deep = api.Trigger(psr_threshold=4, transport="f32", device="cuda")
    (got_deep, wall), n_launch, syncs = counted(
        lambda: feed(t_deep, sig, chunk=32 * 9600))
    assert fields(got_deep) == fields(events["f32"])
    assert n_launch["mf"] == n_launch["pb"] == dispatches(t_deep)
    path_launches["Trigger"] += n_launch
    log(f"Trigger f32 fed 307200-sample chunks: "
        f"{sig.size / wall / 1e6:.3f} M samples/s of wall time, "
        f"{n_launch['mf']} dispatches of 1 matched-filter and 1 pass-B "
        f"launch ({n_launch}), "
        f"{sum(syncs.values()) / n_launch['mf']:.2f} host syncs a dispatch, at "
        f"most {t_deep.max_in_flight} in flight; stages (mean ms x count): "
        + ", ".join(f"{k} {v['mean_ms']:.3f} x {v['count']}"
                    for k, v in t_deep.timer.summary().items())
        + f" [{smi}]")

    # every host wait of each dispatch, as PyTorch itself reports them,
    # beside the waits the engine names (trigger.host_syncs): from the first
    # chunk on, so that the dispatches that decode a candidate are among them
    t = api.Trigger(psr_threshold=4, transport="f32", device="cuda")
    per_call = []

    def one_chunk(i):
        def call():
            n0, named0 = dispatches(t), dict(trig.host_syncs)
            t.process(sig[i * 19200:(i + 1) * 19200])
            per_call.append((dispatches(t) - n0,
                             {k: v - named0.get(k, 0)
                              for k, v in trig.host_syncs.items()
                              if v - named0.get(k, 0)}))
        return call

    trig.host_syncs.clear()
    reported = waits_per_call([one_chunk(i) for i in range(20)])
    t.flush()
    single = [(w, named) for w, (n, named) in zip(reported, per_call)
              if n == 1]
    decoding = [(w, named) for w, named in single if "cp" in named]
    tracking = [(w, named) for w, named in single
                if set(named) == {"emit", "capture"}]
    assert decoding and tracking, per_call
    for w, named in single:
        assert w == sum(named.values()), (w, named)
    log(f"sync debug mode, {len(single)} single-dispatch calls: a decoding "
        f"dispatch reports {decoding[0][0]} synchronizing calls "
        f"({decoding[0][1]}), a tracking one {tracking[0][0]} "
        f"({tracking[0][1]}); every call reports exactly the waits the "
        f"engine names")

    # one dispatch per step bucket on the mirror's shape, N=1 and N=8, and
    # the kernel against its plain version there: a 2.5 M-sample row, lo no
    # multiple of 128, 32 x 75 rows
    cap = t._cap
    at = trig.LOOKBACK + 37 * 9600 + 77
    for n_rows in (1, 8):
        g = torch.Generator(device=dev).manual_seed(n_rows)
        mirror = tuple(torch.randn((n_rows, cap), generator=g, device=dev)
                       for _ in range(2))
        per_bucket = {}
        for steps in (4, 8, 16, 32):
            n0 = mf.launches
            api._stream_scan(mirror, trig.init_state(
                start_pos=at, batch=(n_rows,), device=dev), 4.0, cap, 0,
                steps, trig.DEFAULT_TRACK_AFTER, trig.DEFAULT_TRACK_EVERY,
                grid0=at)
            per_bucket[steps] = mf.launches - n0
        assert set(per_bucket.values()) == {1}, per_bucket
        log(f"mirror N={n_rows}: kernel launches per dispatch by step "
            f"bucket {per_bucket}")
        case(f"mirror N={n_rows} g=32", mirror, 32 * 75, torch.bfloat16,
             lambda: mf.group_power(*mirror, at, 32, torch.bfloat16),
             lambda: mf.group_power_plain(*mirror, at, 32, torch.bfloat16),
             at=at)
        del mirror
    probe_win = tuple(c[:4, lo:lo + correlate.V2_WINDOW].contiguous()
                      for c in big)
    case("probe bin 1.5, window B=4", tuple(c[:4] for c in big), 75,
         torch.bfloat16,
         lambda: mf.pss_correlate_power(probe_win, torch.bfloat16, 1.5),
         lambda: correlate.pss_correlate_power_cfo_bins(
             probe_win, (1.5,), torch.bfloat16)[:, 0],
         w_fat=correlate.weights_fat("cuda", 1.5))

    # ---- 7. MultiTrigger over 8 streams ----
    cells8 = CELLS8
    sigs = [stream_cell(synth, cid, prb, 2.0, seed=20 + i)
            for i, (cid, prb) in enumerate(cells8)]
    singles = []
    for s in sigs:
        got, _ = feed(api.Trigger(psr_threshold=4, transport="i16",
                                  device="cuda"), s)
        singles.append(fields(got))
    assert [s[0]["cell_id"] for s in singles] == [c for c, _ in cells8], \
        singles
    path_launches["MultiTrigger"] = Counts()
    for transport in ("i16", "i4"):
        m = MultiTrigger(8, psr_threshold=4, transport=transport,
                         device="cuda")
        half = sigs[0].size // 2 if transport == "i4" else sigs[0].size

        def drive():
            """All 8 streams in step; past `half`, stream 7 has ended and
            is continued with fill_gap."""
            t0 = time.perf_counter()
            got = []
            for i in range(0, sigs[0].size, 19200):
                if i < half:
                    got += m.process_all([s[i:i + 19200] for s in sigs])
                    continue
                for k in range(7):
                    got += m.process(k, sigs[k][i:i + 19200])
                got += m.fill_gap(7, 19200)
            got += m.flush()
            torch.cuda.synchronize()
            return got, time.perf_counter() - t0

        (got, wall), n_launch, syncs = counted(drive)
        n_disp = dispatches(m)
        assert n_launch["mf"] == n_launch["pb"] == n_disp > 0 \
            and n_launch["vit"] > 0, (n_launch, n_disp)
        path_launches["MultiTrigger"] += n_launch
        if transport == "i16":
            events7, sps7 = tagged(got), sigs[0].size / wall
        keys = None if transport == "i16" else decisive
        for k in range(8):
            mine = fields([c for n, c in got if n == k], keys)
            want = [{kk: d[kk] for kk in keys} if keys else d
                    for d in singles[k]]
            if transport == "i4" and k == 7:    # silence after `half`
                assert mine[:1] == want[:1], (k, mine, want)
            else:
                assert mine == want, (transport, k, mine, want)
        assert int(m.backlog.max()) <= 9600, m.backlog
        log(f"MultiTrigger(8) {transport}: "
            f"{sigs[0].size / wall / 1e6:.3f} M samples/s per stream of wall "
            f"time ({8 * sigs[0].size / wall / 1e6:.3f} M in all), "
            f"{n_disp} dispatches, kernel launches a dispatch "
            + " / ".join(f"{n_launch[k] / n_disp:.2f} {k}" for k in KERNELS)
            + f", at most {m.max_in_flight} in flight; per-stream "
            f"events equal 8 single Triggers'"
            + ("; stream 7 ended at 1 s and was continued with fill_gap, "
               "the group kept flowing" if transport == "i4" else "")
            + "; stages (mean ms x count): "
            + ", ".join(f"{k} {v['mean_ms']:.3f} x {v['count']}"
                        for k, v in m.timer.summary().items())
            + f" [{smi}]")

    # ---- 8. a cell 1.5 subcarriers (22.5 kHz) off ----
    off = stream_cell(synth, 200, 50, 1.0, seed=31, cfo_subcarriers=1.5)
    assert api.search(off, 1.92e6, max_seconds=0.5, device="cuda") == []
    found, n_launch, _ = counted(lambda: api.search(
        off, 1.92e6, max_seconds=0.5, cfo_search_range=2, device="cuda"))
    assert found and found[0].cell_id == 200 and found[0].nof_prb == 50, found
    assert n_launch["mf"] >= 10, n_launch
    log(f"search(cfo_search_range=2) finds cell 200 at +1.5 subcarriers, "
        f"plain search does not; {n_launch} kernel launches (9 probe bins "
        f"+ the scan)")
    path_launches["CFO probe"] = n_launch
    t = api.Trigger(psr_threshold=4, cfo_search_range=2, device="cuda")
    (got, _), n_launch, syncs = counted(lambda: feed(t, off))
    probes = syncs.get("probe", 0)
    assert got and got[0].cell_id == 200 and t._cfo_bins[0] == 3, \
        (got, t._cfo_bins)
    assert probes > 0 and n_launch["mf"] == dispatches(t) + 9 * probes, \
        (n_launch, dispatches(t), probes)
    path_launches["CFO probe"] += n_launch
    log(f"Trigger(cfo_search_range=2) acquires it at bin "
        f"{t._cfo_bins[0] / 2}: {probes} probe(s) of 9 kernel launches, "
        f"{dispatches(t)} dispatches of 1")
    bins = api._probe_bins(2)
    got = mf.pss_correlate_power_cfo_bins(probe_win, bins)
    ref = correlate.pss_correlate_power_cfo_bins(probe_win, bins)
    torch.testing.assert_close(got, ref, **TOL)
    worst = max(worst, (got - ref).abs().max().item())
    log(f"the 9 banks at B=4: kernel equals plain version "
        f"{tuple(got.shape)}")
    del got, ref

    # ---- 9. checkpoint on the card ----
    rng = np.random.default_rng(42)
    loud = (3.0 * (rng.normal(size=40 * 19200)
                   + 1j * rng.normal(size=40 * 19200))).astype(np.complex64)
    two = np.concatenate([stream_cell(synth, 125, 50, 0.6, seed=41), loud,
                          stream_cell(synth, 300, 25, 1.0, seed=43)])
    cut = 45 * 19200
    whole = api.Trigger(psr_threshold=4, transport="f32", device="cuda")
    before, _ = feed(whole, two[:cut])
    after, _ = feed(whole, two[cut:])
    first = api.Trigger(psr_threshold=4, transport="f32", device="cuda")
    feed(first, two[:cut])
    with tempfile.TemporaryDirectory(dir=kbuild.BUILD_DIR) as tmp:
        first.save_state(f"{tmp}/ckpt.npz")
        second = api.Trigger(psr_threshold=4, transport="f32", device="cuda")
        second.load_state(f"{tmp}/ckpt.npz")
    resumed, _ = feed(second, two[cut:])
    assert fields(resumed) == fields(after) and after, (resumed, after)
    np.testing.assert_allclose(second.mean_psr, whole.mean_psr, rtol=1e-4)
    assert (second.tracking_score == whole.tracking_score).all()
    log(f"checkpoint: the Trigger resumed from save_state publishes what "
        f"the uninterrupted one does ({fields(after, decisive)} after "
        f"{fields(before, decisive)})")

    # ---- 9a-9e. the long-running monitor ----
    t0 = time.perf_counter()
    monitor_paths, soak, mon8 = monitor_phases(dev, smi, synth, api, trig,
                                               MultiTrigger, WidebandTrigger)
    path_launches.update(monitor_paths)
    log(f"phases 9a-9e in {time.perf_counter() - t0:.1f} s")

    # ---- 10. the channelizer: 0.25 s of 30.72 Msps to 16 centres ----
    rate16 = 30.72e6
    centers16 = [(k - 7.5) * 1.92e6 for k in range(16)]
    planted = {2: (101, 25), 7: (202, 50), 13: (303, 100)}
    band16 = make_band(dev, synth, rate16,
                       [(centers16[k], cid, prb, 0.0)
                        for k, (cid, prb) in planted.items()], 0.25, seed=51)
    on_card = chan.channelize(band16, rate16, centers16, device="cuda")
    on_cpu = chan.channelize(band16, rate16, centers16, device="cpu")
    chan_err = 0.0
    for g, r in zip(on_card, on_cpu):
        assert g.shape == r.shape == (16, band16.size // 16), g.shape
        torch.testing.assert_close(g.cpu(), r, **TOL)
        chan_err = max(chan_err, (g.cpu() - r).abs().max().item())
    del on_card, on_cpu
    pair16 = cplx.from_numpy(band16, dev)
    ms = cuda_ms(lambda: chan.channelize(pair16, rate16, centers16), iters=5)
    del pair16
    log(f"channelize {band16.size} wide samples at 30.72 Msps to 16 centres: "
        f"card equals CPU (max_abs_err {chan_err:.3e} on a unit-rms band), "
        f"{ms:.2f} ms a call from a pair on the card (CUDA events), "
        f"{band16.size / ms / 1e3:.1f} M wide samples/s [{smi}]")

    # ---- 11. wideband_scan of that band ----
    wscan.wideband_scan(band16, rate16, centers16, seconds=0.25,
                        device="cuda")                     # warm-up
    t0 = time.perf_counter()
    recs, n_launch, _ = counted(lambda: wscan.wideband_scan(
        band16, rate16, centers16, seconds=0.25, device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert [r["detected"] for r in recs] == [k in planted for k in range(16)], \
        recs
    for k, (cid, prb) in planted.items():
        assert (recs[k]["cell_id"], recs[k]["nof_prb"]) == (cid, prb), recs[k]
    assert ran(n_launch), n_launch
    path_launches["wideband_scan, snr_sweep, pbch_sweep"] = n_launch
    log(f"wideband_scan 0.25 s x 16 centres: exactly the planted cells "
        f"{ {k: recs[k]['cell_id'] for k in planted} } detected, "
        f"{n_launch} kernel launch(es), {wall * 1e3:.1f} ms wall [{smi}]")

    # ---- 11b. the same band made 2 s long: one dispatch of 400 steps ----
    band2 = make_band(dev, synth, rate16,
                      [(centers16[k], cid, prb, 0.0)
                       for k, (cid, prb) in planted.items()], 2.0, seed=53)

    def scan2():
        return wscan.wideband_scan(band2, rate16, centers16, seconds=2.0,
                                   device="cuda")
    # the warm-up keeps what the ring kernel was given and gave back
    ring_kernel, seen = rk.ring_scan_kernel, []

    def keep(*a):
        res = ring_kernel(*a)
        seen.append((tuple(x.clone() for x in a),
                     tuple(x.clone() for x in res)))
        return res
    rk.ring_scan_kernel = keep
    try:
        scan2()
    finally:
        rk.ring_scan_kernel = ring_kernel
    assert len(seen) == 1, len(seen)
    (ring0_, count0_, est_, push_, lost_), (ring_k, count_k, mean_k) = seen[0]
    assert tuple(est_.shape) == (400, 16, 3), tuple(est_.shape)
    ring_p, count_p, mean_p = rk.ring_scan_plain(ring0_, count0_, est_,
                                                 push_, lost_)
    torch.cuda.synchronize()
    assert torch.equal(ring_k, ring_p) and torch.equal(count_k, count_p)
    torch.testing.assert_close(mean_k, mean_p, rtol=0, atol=1e-5)
    scan_err = (mean_k - mean_p).abs().max().item()
    ring_worst = max(ring_worst, scan_err)
    n_push, n_lost = int(push_.sum()), int(lost_.sum())
    del seen, ring0_, count0_, est_, push_, lost_, ring_k, count_k, mean_k
    del ring_p, count_p, mean_p
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs, n_launch, syncs2 = counted(scan2)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    assert [r["detected"] for r in recs] == [k in planted for k in range(16)], \
        recs
    for k, (cid, prb) in planted.items():
        got = tuple(recs[k][f] for f in ("cell_id", "nof_prb", "nof_tx_ports",
                                          "cp_len", "phich_len",
                                          "nof_phich_resources"))
        assert got == (cid, prb, 1, "Normal", "Normal", "1"), recs[k]
    assert ran(n_launch, long=True) and n_launch["ring"] == 1, n_launch
    path_launches[LONG_PATH] = n_launch
    wall2_ms = 1e3 * min(walls)
    log(f"wideband_scan 2 s x 16 centres (one dispatch of 16 x 400 steps): "
        f"exactly the planted cells and fields "
        f"{ {k: recs[k]['cell_id'] for k in planted} }; the ring kernel on "
        f"the dispatch's own est / push / lost ({n_push} pushes, {n_lost} "
        f"losses) = ring_scan_plain (ring and count exact, mean "
        f"max_abs_err {scan_err:.3e}); {n_launch} kernel launch(es), host "
        f"waits {syncs2}; wall (best of 3) {wall2_ms:.1f} ms: "
        f"{', '.join(f'{1e3 * w:.1f}' for w in walls)} [{smi}]")

    # ---- 12. WidebandTrigger: 8 carriers from one 15.36 Msps stream ----
    rate8, centers8 = RATE8, CENTERS8
    ids8 = [c for c, _ in cells8]
    band8 = band_of_eight(dev, synth)
    wchunk = 19200 * 8                       # one radio frame of band
    n_narrow = band8.size // 8
    feed_wide(WidebandTrigger(rate8, centers8, psr_threshold=4,
                              device="cuda"), band8[:20 * wchunk], wchunk)
    wide_events, wide_trigs = {}, {}
    path_launches["WidebandTrigger"] = Counts()
    for transport in ("f32", "i8", "i4"):
        w = WidebandTrigger(rate8, centers8, psr_threshold=4,
                            transport=transport, device="cuda")
        (got, wall), n_launch, syncs = counted(
            lambda: feed_wide(w, band8, wchunk))
        n_disp = dispatches(w)
        assert n_launch["mf"] == n_launch["pb"] == n_disp > 0 \
            and n_launch["vit"] > 0, (n_launch, n_disp)
        assert sorted((n, f["cell_id"]) for n, f in got) \
            == list(enumerate(ids8)), (transport, got)
        assert int(w.backlog.max()) <= 9600, w.backlog
        wide_events[transport], wide_trigs[transport] = got, w
        if transport == "f32":
            sps12 = n_narrow / wall
        path_launches["WidebandTrigger"] += n_launch
        log(f"WidebandTrigger(8 x 15.36 Msps) {transport}: "
            f"{n_narrow / wall / 1e6:.3f} M narrow samples/s per carrier of "
            f"wall time ({band8.size / wall / 1e6:.3f} M wide samples/s), "
            f"{n_disp} dispatches, kernel launches a dispatch "
            + " / ".join(f"{n_launch[k] / n_disp:.2f} {k}" for k in KERNELS)
            + " and " + ", ".join(f"{v / n_disp:.2f} '{k}'"
                                  for k, v in sorted(syncs.items()))
            + f" host syncs a dispatch, at most {w.max_in_flight} in "
            f"flight; all 8 cells found; stages (mean ms x count): "
            + ", ".join(f"{k} {v['mean_ms']:.3f} x {v['count']}"
                        for k, v in w.timer.summary().items())
            + f" [{smi}]")
    cpu_events, _ = feed_wide(
        WidebandTrigger(rate8, centers8, psr_threshold=4, transport="f32",
                        device="cpu"), band8[:60 * wchunk], wchunk)
    assert wide_events["f32"] == cpu_events and len(cpu_events) == 8, \
        (wide_events["f32"], cpu_events)
    for transport in ("i8", "i4"):
        assert [(n, {k: f[k] for k in decisive})
                for n, f in wide_events[transport]] \
            == [(n, {k: f[k] for k in decisive}) for n, f in cpu_events], \
            transport
    # the card's MultiTrigger(8) fed the one-shot channelizer's rows
    rows8 = chan.channelize(band8, rate8, centers8, device="cuda")
    narrow8 = (rows8[0].cpu().numpy() + 1j * rows8[1].cpu().numpy()) \
        .astype(np.complex64)
    del rows8
    m = MultiTrigger(8, psr_threshold=4, transport="f32", device="cuda")
    t0 = time.perf_counter()
    got = []
    for i in range(0, n_narrow, 19200):
        got += m.process_all(list(narrow8[:, i:i + 19200]))
    got += m.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert tagged(got) == wide_events["f32"], (tagged(got),
                                               wide_events["f32"])
    np.testing.assert_array_equal(m.tracking_score,
                                  wide_trigs["f32"].tracking_score)
    log(f"WidebandTrigger f32 on the card = on the CPU (first 0.6 s) = "
        f"MultiTrigger(8) on the card fed the channelizer's rows, field for "
        f"field; that MultiTrigger(8) f32 run: "
        f"{n_narrow / wall / 1e6:.3f} M samples/s per stream, stages: "
        + ", ".join(f"{k} {v['mean_ms']:.3f} x {v['count']}"
                    for k, v in m.timer.summary().items()) + f" [{smi}]")
    # host waits per dispatch while tracking, as PyTorch reports them
    w = WidebandTrigger(rate8, centers8, psr_threshold=4, transport="i8",
                        device="cuda")
    m = MultiTrigger(8, psr_threshold=4, transport="i16", device="cuda")
    for i in range(20):
        w.process_wide(band8[i * wchunk:(i + 1) * wchunk])
        m.process_all(list(narrow8[:, i * 19200:(i + 1) * 19200]))
    nw, nm = dispatches(w), dispatches(m)
    waits_w = sum(waits_per_call(
        [lambda i=i: w.process_wide(band8[i * wchunk:(i + 1) * wchunk])
         for i in range(20, 30)]))
    waits_m = sum(waits_per_call(
        [lambda i=i: m.process_all(
            list(narrow8[:, i * 19200:(i + 1) * 19200]))
         for i in range(20, 30)]))
    nw, nm = dispatches(w) - nw, dispatches(m) - nm
    w.flush()
    m.flush()
    assert nw > 0 and nm > 0 and waits_w * nm == waits_m * nw, \
        (nw, nm, waits_w, waits_m)
    log(f"sync debug mode while tracking: WidebandTrigger {waits_w} "
        f"synchronizing calls over {nw} dispatches, MultiTrigger {waits_m} "
        f"over {nm}")
    del narrow8

    # ---- 13. 16 carriers at 30.72 Msps ----
    ids16 = [7 + 31 * k for k in range(16)]
    band = make_band(dev, synth, rate16,
                     [(c, cid, 50, 0.0) for c, cid in zip(centers16, ids16)],
                     1.0, seed=53)
    w = WidebandTrigger(rate16, centers16, psr_threshold=4, transport="i8",
                        device="cuda")
    (got, wall), n_launch, syncs = counted(
        lambda: feed_wide(w, band, 19200 * 16))
    n_disp = dispatches(w)
    assert n_launch["mf"] == n_launch["pb"] == n_disp > 0 \
        and n_launch["vit"] > 0, (n_launch, n_disp)
    assert sorted((n, f["cell_id"]) for n, f in got) \
        == list(enumerate(ids16)), got
    path_launches["WidebandTrigger"] += n_launch
    log(f"WidebandTrigger(16 x 30.72 Msps) i8: "
        f"{band.size / 16 / wall / 1e6:.3f} M narrow samples/s per carrier "
        f"of wall time ({band.size / wall / 1e6:.3f} M wide samples/s), "
        f"{n_disp} dispatches of 1 matched-filter and 1 pass-B launch "
        f"({n_launch}), at most "
        f"{w.max_in_flight} in flight; all 16 cells found; stages (mean ms "
        f"x count): "
        + ", ".join(f"{k} {v['mean_ms']:.3f} x {v['count']}"
                    for k, v in w.timer.summary().items()) + f" [{smi}]")
    del band

    # ---- 14. a wideband checkpoint, and the CLIs on a capture file ----
    late = make_band(dev, synth, rate8,
                     [(c, cid, 50, 0.0 if k < 4 else 0.5)
                      for k, (c, cid) in enumerate(zip(centers8, ids8))],
                     1.0, seed=54)
    cut = 26 * wchunk + 12345

    def wb():
        return WidebandTrigger(rate8, centers8, psr_threshold=4,
                               transport="f32", device="cuda")

    whole = wb()
    before = tagged(whole.process_wide(late[:cut]) + whole.flush())
    after, _ = feed_wide(whole, late[cut:], wchunk)
    first = wb()
    first.process_wide(late[:cut])
    with tempfile.TemporaryDirectory(dir=kbuild.BUILD_DIR) as tmp:
        first.save_state(f"{tmp}/wide.npz")
        second = wb()
        second.load_state(f"{tmp}/wide.npz")
        resumed, _ = feed_wide(second, late[cut:], wchunk)
        assert sorted(n for n, _ in before) == [0, 1, 2, 3], before
        assert resumed == after \
            and sorted(n for n, _ in after) == [4, 5, 6, 7], (resumed, after)
        np.testing.assert_allclose(second.mean_psr, whole.mean_psr,
                                   rtol=1e-4)
        assert (second.tracking_score == whole.tracking_score).all()
        log("wideband checkpoint: the WidebandTrigger resumed from "
            "save_state publishes the four late cells as the uninterrupted "
            "one does")
        cap_path = f"{tmp}/band8.c64"
        band8[:50 * wchunk].tofile(cap_path)
        spec = ",".join(f"{c / 1e6:g}M" for c in centers8)
        for mod, args in (
                ("live_monitor", ["--wideband", "--refresh", "10"]),
                ("wideband_scan", ["--seconds", "0.25"])):
            t0 = time.perf_counter()
            done = subprocess.run(
                [sys.executable, "-m", f"ltetrigger_tpu_torch.apps.{mod}",
                 cap_path, "-s", "15.36M", f"--centers={spec}", *args],
                capture_output=True, text=True, timeout=300,
                cwd=pathlib.Path(__file__).resolve().parent)
            assert done.returncode == 0, done.stderr[-2000:]
            if mod == "live_monitor":
                lines = [json.loads(x) for x in done.stdout.splitlines()]
                found = sorted((e["stream"], e["cell_id"]) for e in lines
                               if e["event"] == "track")
                assert any(e["event"] == "status" for e in lines)
            else:
                found = [(k, r["cell_id"]) for k, r in
                         enumerate(json.loads(done.stdout)) if r["detected"]]
            assert found == list(enumerate(ids8)), (mod, found)
            log(f"{mod} as a subprocess on a 0.5 s capture at 15.36 Msps: "
                f"all 8 cells, {time.perf_counter() - t0:.1f} s with start-up")
    del late

    # ---- 15. snr_sweep and pbch_sweep ----
    frame77 = synth.synthesize_frame(77, nof_prb_field=25)
    snrs = list(range(-30, 11, 2))
    sweep.snr_sweep(frame77, 1.92e6, snrs[:2], seconds=0.1, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    curve, n_launch, _ = counted(lambda: sweep.snr_sweep(
        frame77, 1.92e6, snrs, seconds=0.5, n_trials=8, seed=0,
        device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert len(curve) == 21 and ran(n_launch), n_launch
    for rec in curve:
        if rec["snr_db"] >= 0:
            assert rec["prob"] == 1.0 and rec["cell_id"] == 77, rec
        if rec["snr_db"] <= -26:
            assert rec["prob"] == 0.0, rec
    path_launches["wideband_scan, snr_sweep, pbch_sweep"] += n_launch
    log(f"snr_sweep 21 points x 8 trials x 0.5 s (168 channels): "
        f"{wall * 1e3:.1f} ms wall, {n_launch} kernel launches, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on the "
        f"card; P(detect) by SNR dB: "
        + ", ".join(f"{r['snr_db']:g}: {r['prob']:g}" for r in curve)
        + f" [{smi}]")
    t0 = time.perf_counter()
    pcurve, n_launch, _ = counted(lambda: sweep.pbch_sweep(
        [-40, -30, -27, -20, 0], n_trials=8, seed=0, device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert pcurve[-1]["prob"] == 1.0 and pcurve[0]["prob"] == 0.0, pcurve
    path_launches["wideband_scan, snr_sweep, pbch_sweep"] += n_launch
    log(f"pbch_sweep 5 points x 8 trials x 6 TTIs: {wall * 1e3:.1f} ms wall "
        f"with the frames' synthesis on the host, {n_launch} kernel "
        f"launches; P(publish) by PBCH dB: "
        + ", ".join(f"{r['pbch_rel_db']:g}: {r['prob']:g}" for r in pcurve))

    # ---- 16. run_flowgraph: the two demos ----
    if importlib.util.find_spec("yaml") is None:
        log("run_flowgraph: PyYAML is not installed here, so the phase is "
            "not run")
    else:
        import yaml
        from ltetrigger_tpu_torch.apps import run_flowgraph as flow
        examples = pathlib.Path(__file__).resolve().parent / "examples"
        path_launches["run_flowgraph"] = Counts()
        with tempfile.TemporaryDirectory(dir=kbuild.BUILD_DIR) as tmp:
            synth.synthesize_frame(123, nof_prb_field=6) \
                .astype(np.complex64).tofile(f"{tmp}/cell123.c64")
            for demo in ("ltetrigger_demo_torch.grc",
                         "snr_ltetrigger_demo_torch.grc"):
                fg = yaml.safe_load((examples / demo).read_text())
                for b in fg["blocks"]:
                    if b["id"] == "blocks_file_source":
                        b["parameters"]["file"] = f"{tmp}/cell123.c64"
                pathlib.Path(f"{tmp}/{demo}").write_text(yaml.safe_dump(fg))
                out, n_launch, _ = counted(
                    lambda: flow.FlowgraphRunner(f"{tmp}/{demo}")
                    .run(time_out=1.0))
                cells = out["cellstore_0"]
                assert cells and cells[0]["cell_id"] == 123 \
                    and cells[0]["nof_prb"] == 6, out
                assert ran(n_launch), n_launch
                path_launches["run_flowgraph"] += n_launch
                log(f"run_flowgraph {demo}: cell 123 in the flowgraph's "
                    f"cell store, {n_launch} kernel launches")

    # ---- 17. the kernel at this slice's shapes ----
    shapes = (("mirror N=16 g=32", 16, cap, at, 32),
              ("grid C=168 (sweep, 0.5 s)", 168,
               trig.LOOKBACK + 960000 + trig.WINDOW, lo,
               trig._pick_group(100, 168)),
              ("grid C=16 (scan, 0.25 s) g=25", 16,
               trig.LOOKBACK + 480000 + trig.WINDOW, lo, 25))
    for label, n_rows, length, start, g in shapes:
        gen = torch.Generator(device=dev).manual_seed(n_rows + g)
        buf = tuple(torch.randn((n_rows, length), generator=gen, device=dev)
                    for _ in range(2))
        if "sweep" in label:
            label = label.replace(")", f") g={g}")
        case(label, buf, g * 75, torch.bfloat16,
             lambda: mf.group_power(*buf, start, g, torch.bfloat16),
             lambda: mf.group_power_plain(*buf, start, g, torch.bfloat16),
             at=start)
        del buf

    # ---- 18. the process mesh: NCCL at world size 1, in this process ----
    dev1 = init_distributed(f"127.0.0.1:{free_port()}", 1, 0, timeout=120)
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        mesh1 = make_mesh()
        assert mesh1.shape == {"ch": 1, "t": 1} and mesh1.device == dev1
        x = torch.arange(6.0, device=dev).reshape(2, 3)
        assert torch.equal(meshmod.all_gather(x, mesh1, "ch", dim=1), x)
        sixteen = tuple(c[:16, :trig.LOOKBACK + 50 * 9600 + trig.WINDOW]
                        .contiguous() for c in big)
        (st_m, out_m), n_launch, _ = counted(
            lambda: channel_scan(sixteen, 50, 4.0, mesh=mesh1))
        st_0, out_0 = channel_scan(sixteen, 50, 4.0)
        for got, ref in ((out_m, out_0), (st_m, st_0)):
            for f in ref._fields:
                g, r = getattr(got, f), getattr(ref, f)
                assert g.dtype == r.dtype and torch.equal(g, r), f
        assert out_m.track_event.any(dim=0).any(dim=-1).all()
        path_launches["mesh of one rank (NCCL)"] = n_launch
        t0 = time.perf_counter()
        shards, n_launch, _ = counted(lambda: time_sharded_scan(
            pair_np(stream_cell(synth, 125, 50, 1.0, seed=11)), mesh1, 4.0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev = shards.track_event.cpu().numpy()
        assert ev.shape == (1, 200, 3) and ev.any()
        assert set(shards.cell_id.cpu().numpy()[ev].tolist()) == {125}
        path_launches["mesh of one rank (NCCL)"] += n_launch
        log(f"NCCL world of 1: make_mesh() = {mesh1.shape}; "
            f"channel_scan(mesh=) of 16 x 50 = channel_scan() field for "
            f"field, state too; time_sharded_scan of 1 s finds cell 125 in "
            f"its one block of 200 steps ({wall * 1e3:.1f} ms wall, "
            f"{n_launch} kernel launches)")
        m = MultiTrigger(8, psr_threshold=4, transport="i16", mesh=mesh1)
        got, n_launch, _ = counted(lambda: feed_all(m, np.stack(sigs)))
        assert tagged(gather_events(got, mesh1)) \
            == sorted(events7, key=lambda e: e[0]), (tagged(got), events7)
        path_launches["mesh of one rank (NCCL)"] += n_launch
        w = WidebandTrigger(rate8, centers8, psr_threshold=4,
                            transport="f32", mesh=mesh1)
        (got, _), n_launch, _ = counted(lambda: feed_wide(w, band8, wchunk))
        assert sorted(got, key=lambda e: e[0]) \
            == sorted(wide_events["f32"], key=lambda e: e[0]), got
        path_launches["mesh of one rank (NCCL)"] += n_launch
        # a checkpoint saved with the mesh, loaded without it
        cut = 45 * 19200
        late8 = late_streams(sigs, cut)
        whole = MultiTrigger(8, psr_threshold=4, transport="f32",
                             device="cuda")
        before_ref = tagged(feed_all(whole, late8, 0, cut))
        after_ref = tagged(feed_all(whole, late8, cut))
        first = MultiTrigger(8, psr_threshold=4, transport="f32", mesh=mesh1)
        before = tagged(feed_all(first, late8, 0, cut))
        with tempfile.TemporaryDirectory(dir=kbuild.BUILD_DIR) as tmp:
            first.save_state(f"{tmp}/mesh.npz")
            second = MultiTrigger(8, psr_threshold=4, transport="f32",
                                  device="cuda")
            second.load_state(f"{tmp}/mesh.npz")
        resumed = tagged(feed_all(second, late8, cut))
        assert before == before_ref and resumed == after_ref, \
            (before, resumed, after_ref)
        assert sorted(n for n, _ in before) == [0, 1, 2, 3] \
            and sorted(n for n, _ in resumed) == [4, 5, 6, 7]
        assert (second.tracking_score == whole.tracking_score).all()
        log("NCCL world of 1: MultiTrigger(8, mesh=) i16 and "
            "WidebandTrigger(mesh=) f32 publish what phases 7 and 12 did; a "
            "checkpoint saved with the mesh resumes without it (4 late "
            "cells)")
    finally:
        dist.destroy_process_group()

    # ---- 19. the kernel at the shapes a rank gets ----
    for c in (64, 32):
        part = tuple(x[:c] for x in big)
        case(f"grid C={c} g=25 (a rank of {C_BIG // c})", part, 25 * 75,
             torch.bfloat16,
             lambda: mf.group_power(*part, lo, 25, torch.bfloat16),
             lambda: mf.group_power_plain(*part, lo, 25, torch.bfloat16))
    for n_rows in (2, 4):
        gen = torch.Generator(device=dev).manual_seed(40 + n_rows)
        mirror = tuple(torch.randn((n_rows, cap), generator=gen, device=dev)
                       for _ in range(2))
        case(f"mirror N={n_rows} g=32 (a rank of {8 // n_rows})", mirror,
             32 * 75, torch.bfloat16,
             lambda: mf.group_power(*mirror, at, 32, torch.bfloat16),
             lambda: mf.group_power_plain(*mirror, at, 32, torch.bfloat16),
             at=at)
        del mirror

    # ---- 20. several ranks on the one card (gloo), then 21. a card a rank
    t20 = time.perf_counter()
    want, one_ms = one_process_scan(big, channel_scan, trig)
    log(f"channel_scan 128 x 100 in one process: {one_ms:.1f} ms (best of "
        f"3; phase 5's scan_engine: {ms_dispatch:.1f} ms) [{smi}]")
    want128 = one_process_scans(big, (2, 4), channel_scan, trig)
    log("channel_scan of the 128 x 100 buffer repeated, in one process: "
        + ", ".join(f"C = {C_BIG * w} {ms:.1f} ms"
                    for w, (_, ms) in want128.items()) + f" (best of 3) "
        f"[{smi}]")
    big = small = win = None            # room for the ranks' own buffers
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=kbuild.BUILD_DIR) as tmp:
        tmp = pathlib.Path(tmp)
        write_rank_inputs(tmp, sigs, band8, mon8)
        rank_launches, ranks2, ranks4 = mesh_phase(
            tmp, want128, cells_big, mon8, smi, trig, MultiTrigger,
            WidebandTrigger, dev, want, one_ms)
        path_launches.update(rank_launches)
        shards_line(ranks4, smi)
        merged = json.loads((tmp / "stream_events.json").read_text())
        merged = {k: [(n, f) for n, f in v] for k, v in merged.items()}
        assert merged["multi"] == sorted(events7, key=lambda e: e[0]), \
            (merged["multi"], events7)
        assert merged["wide"] == sorted(wide_events["f32"],
                                        key=lambda e: e[0]), merged["wide"]
        assert merged["before"] == sorted(before_ref, key=lambda e: e[0])
        second = MultiTrigger(8, psr_threshold=4, transport="f32",
                              device="cuda")
        second.load_state(str(tmp / "sharded.npz"))
        resumed = tagged(feed_all(second, late8, cut))
        assert resumed == after_ref, (resumed, after_ref)
        assert (second.tracking_score == whole.tracking_score).all()
        for key, label, one in (("multi", "MultiTrigger(8, mesh=) i16", sps7),
                                ("wide", "WidebandTrigger(8 centres, mesh=) "
                                 "f32", sps12)):
            n_each = sigs[0].size
            slow = max(r[key]["wall_s"] for r in ranks4)
            log(f"{label} over ch = 4 on one card: gathered events equal "
                f"one process's; per rank ({ranks4[0][key]['rows']} streams "
                f"each) M samples/s per stream "
                + ", ".join(f"{n_each / r[key]['wall_s'] / 1e6:.3f}"
                            for r in ranks4)
                + f", slowest {n_each / slow / 1e6:.3f} against "
                f"{one / 1e6:.3f} in one process; dispatches a rank "
                + ", ".join(str(r[key]["dispatches"]) for r in ranks4)
                + "; rank 0 stages (mean ms x count): "
                + ", ".join(f"{k} {v[0]:.3f} x {v[1]}"
                            for k, v in ranks4[0][key]["stages"].items())
                + f" [{smi}]")
        log("a checkpoint saved by the 4 ranks at the cut resumes in a "
            "trigger without a mesh: the 4 late cells, same scores")
        rank_table = {
            "one_process_ms": one_ms,
            "one_process_128_a_rank_ms": {w: ms for w, (_, ms)
                                          in want128.items()},
            **{f"ch{len(rs)}": {
                **{k: [min(r["scan"][k]) for r in rs]
                   for k in ("engine_ms", "full_ms", "call_ms")},
                "launches": [r["launches"]["scan"]["mf"] for r in rs],
                "call_128_a_rank_ms": [min(r["scan128"]["call_ms"])
                                       for r in rs]}
               for rs in (ranks2, ranks4)}}
        log(f"phase 20 (one card, 2 and 4 ranks) in "
            f"{time.perf_counter() - t20:.1f} s")
        path_launches.update(cards_phase(
            tmp, want, cells_big, one_ms, want128, mon8, smi, trig,
            MultiTrigger, WidebandTrigger, dev))
    del band8, late8, mon8
    torch.cuda.empty_cache()

    # ---- 22-28. the example tools (examples/*_torch.py) ----
    examples = pathlib.Path(__file__).resolve().parent / "examples"
    sys.path.insert(0, str(examples))
    import bench_attrib_torch as attrib
    import bench_stream_torch as bstream
    import bench_sweep_torch as bsweep
    import make_snr_curve_torch as curvemod

    def quiet(fn):
        """fn() with its standard output kept: (result, the JSON lines it
        printed)."""
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = fn()
        return res, [json.loads(x) for x in out.getvalue().splitlines()
                     if x.startswith("{")]

    # 22. the channel-count sweep
    sweep_recs = []
    reset_launches()
    for c in (32, 256, 1024):
        sec, steps = bsweep.capped(c, 0.55, 100)
        sweep_recs.append(quiet(lambda: bsweep.run_point(
            c, steps, sec, 3, "cuda"))[0])
    path_launches["bench_sweep_torch"] = read_launches()
    assert all(r["detections_ok"] for r in sweep_recs), sweep_recs
    log("bench_sweep_torch (channel_scan, best of 3): " + "; ".join(
        f"C={r['channels']} x {r['n_steps']} steps {r['ms_per_dispatch']:.1f}"
        f" ms, {r['msps']:.1f} M samples/s (first call "
        f"{r['compile_s']:.2f} s)" for r in sweep_recs)
        + f"; cell 123 found at every point; {read_launches()} kernel "
        f"launches "
        f"[{smi}]")

    # 23. the pass ladder at C=128 and 512, pass C's stages at C=128
    ladder = {}
    reset_launches()
    for c in (C_BIG, 512):
        (rows_c, out_c), _ = quiet(lambda: attrib.cmd_passes(
            attrib.parse(["passes", "--channels", str(c)])))
        ladder[c] = rows_c
        if c == C_BIG:              # the full rung is the engine's dispatch
            buf = bsweep.make_buffer(c, 0.55, dev)
            _, want = trig.scan_engine(buf, trig.init_state(batch=(c,),
                                                            device=dev),
                                       100, 4.0, grid0=trig.LOOKBACK)
            del buf
            for f in trig.StepOutput._fields:
                g_, w_ = getattr(out_c, f), getattr(want, f)
                if g_.dtype.is_floating_point:
                    torch.testing.assert_close(g_, w_, rtol=1e-6, atol=1e-6)
                else:
                    assert torch.equal(g_, w_), f
            assert out_c.track_event[:, :, 123 % 3].any(dim=0).all()
        del out_c
        log(f"bench_attrib_torch passes C={c} x 100 (host ms / device ms, "
            f"best of 3): " + "; ".join(
                f"{r['variant']} {r['ms_per_dispatch']:.2f} / "
                f"{r['device_ms']:.2f} "
                f"({Counts(r['launches_by_kernel'])} launches)"
                for r in rows_c)
            + (": ABC_decode = scan_engine field for field" if c == C_BIG
               else "") + f" [{smi}]")
    path_launches["bench_attrib_torch passes"] = read_launches()
    reset_launches()
    stages, _ = quiet(lambda: attrib.main(["decode", "--channels",
                                           str(C_BIG)]))
    ops, _ = quiet(lambda: attrib.main(["micro", "--channels", str(C_BIG)]))
    path_launches["bench_attrib_torch decode and micro"] = read_launches()
    log(f"bench_attrib_torch decode C={C_BIG} (host ms / device ms): "
        + "; ".join(f"{r['stage']} x {r['batch']} {r['ms']:.2f} / "
                    f"{r['device_ms']:.2f}" for r in stages)
        + f"; micro: " + "; ".join(f"{r['op']} {r['ms']:.3f} / "
                                    f"{r['device_ms']:.3f}" for r in ops)
        + f" [{smi}]")

    # 24. GROUP_BUDGET 4096 and 16384 at C=512, a subprocess each
    groups, _ = quiet(lambda: attrib.cmd_groups(attrib.parse(
        ["groups", "--channels", "512", "--budgets", "4096,16384"])))
    got_g = {b: next(x["config"]["group"] for x in recs if "config" in x)
             for b, recs in groups}
    assert got_g == {4096: 5, 16384: 25}, got_g
    path_launches["bench_attrib_torch groups (subprocesses)"] = sum(
        Counts(x["launches_by_kernel"]) for _, recs in groups for x in recs
        if "launches_by_kernel" in x)
    log("bench_attrib_torch groups C=512: " + "; ".join(
        f"budget {b} g={got_g[b]}: " + ", ".join(
            f"{x['variant']} {x['ms_per_dispatch']:.1f}" for x in recs
            if "variant" in x) for b, recs in groups) + " ms; "
        f"{path_launches['bench_attrib_torch groups (subprocesses)']} kernel "
        f"launches in both subprocesses [{smi}]")

    # 25. the streaming stage timer: Trigger per transport, MultiTrigger(8)
    reset_launches()
    singles, _ = quiet(lambda: bstream.single_main(0.5, 4, ["f32", "i16",
                                                            "i8"], 3, dev))
    multis, _ = quiet(lambda: bstream.multi_main(8, 0.5, 4, ["i16", "i4"], 3,
                                                 dev))
    path_launches["bench_stream_torch"] = read_launches()
    assert all(r["detections_ok"] for r in singles + multis), \
        (singles, multis)
    log("bench_stream_torch 0.5 s, 4-half-frame chunks, best of 3 passes: "
        + "; ".join(f"Trigger {r['transport']} {r['best_sps'] / 1e6:.3f} M "
                    f"samples/s" for r in singles)
        + "; " + "; ".join(f"MultiTrigger(8) {r['transport']} "
                           f"{r['best_sps_per_stream'] / 1e6:.3f} M per "
                           f"stream" for r in multis)
        + f"; cell 123 found in every run [{smi}]")

    # 26. the seam sweep on 4 gloo ranks sharing the card
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, str(examples / "seam_sweep_torch.py"), "--ranks",
         "4", "--backend", "gloo", "--snr-min", "-30", "--snr-max", "0",
         "--step", "30", "--trials", "2", "--device", "cuda"],
        capture_output=True, text=True, timeout=420,
        cwd=pathlib.Path(__file__).resolve().parent)
    assert done.returncode == 0, done.stderr[-3000:]
    seam = json.loads(done.stdout.splitlines()[-1])
    p = {r["snr_db"]: (r["p_continuous"], r["p_sharded"])
         for r in seam["curve"]}
    assert p == {-30.0: (0.0, 0.0), 0.0: (1.0, 1.0)}, seam
    assert seam["n_shards"] == 4 and seam["launches_by_kernel"]["mf"] > 0, seam
    path_launches["seam_sweep_torch (rank 0 of 4)"] = Counts(
        seam["launches_by_kernel"])
    log(f"seam_sweep_torch on 4 gloo ranks on one card: P(detect) "
        f"continuous / sharded {p} over 2 trials, "
        f"{time.perf_counter() - t0:.1f} s with start-up, "
        f"{path_launches['seam_sweep_torch (rank 0 of 4)']} kernel launches "
        f"on rank 0 [{smi}]")

    # 27. the SNR curve, two trials a point, 4 dB steps
    reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=kbuild.BUILD_DIR) as tmp:
        payload, _ = quiet(lambda: curvemod.main(
            ["--trials", "2", "--step", "4", "--out-dir", tmp]))
        written = sorted(x.name for x in pathlib.Path(tmp).iterdir())
    assert written == ["SNR_CURVE_torch.md", "snr_curve_torch.json"], written
    knees = dict(payload["knee_db"], **payload["pbch_limited"]["knee_db"])
    assert len(knees) == 10 and None not in knees.values(), knees
    path_launches["make_snr_curve_torch"] = read_launches()
    # every path decoded, so each kernel launched on it (see `ran`; the
    # two tools run in subprocesses report every kernel's launches in their
    # JSON), and the attribution tool's stages time the Viterbi alone
    for path, n in path_launches.items():
        if path == "bench_attrib_torch decode and micro":
            ok = n.get("vit", 0) > 0 and not n.get("tti", 0) \
                and not n.get("ring", 0)
        else:
            ok = ran(n, long=path == LONG_PATH)
        assert ok, f"{path}: a kernel never launched, or the TTI chain " \
            f"and Viterbi disagree, or the ring ran where no dispatch " \
            f"passed 200 steps (or not where one did): {n}"
    log(f"make_snr_curve_torch --trials 2 --step 4: both files written, "
        f"knees (dB) {knees}, {time.perf_counter() - t0:.1f} s, "
        f"{read_launches()} kernel launches [{payload['device']}]")

    # 28. the kernel at the shapes these tools add
    for label, n_rows, seconds, g in (
            ("grid C=256 g=10 (sweep)", 256, 0.55, 10),
            ("grid C=512 g=5 (passes, budget 4096)", 512, 0.55, 5),
            ("grid C=512 g=25 (budget 16384)", 512, 0.55, 25),
            ("grid C=1024 g=1 (sweep, 0.275 s)", 1024, 0.275, 1)):
        gen = torch.Generator(device=dev).manual_seed(n_rows + g)
        length = trig.LOOKBACK + int(seconds * 1.92e6) + trig.WINDOW
        buf = tuple(torch.randn((n_rows, length), generator=gen, device=dev)
                    for _ in range(2))
        case(label, buf, g * 75, torch.bfloat16,
             lambda: mf.group_power(*buf, lo, g, torch.bfloat16),
             lambda: mf.group_power_plain(*buf, lo, g, torch.bfloat16))
        del buf
        torch.cuda.empty_cache()

    big, _ = big_buffer(dev, synth, trig)       # the profiler's shapes
    small = tuple(c[:1].contiguous() for c in big)
    win = tuple(c[:8, lo:lo + correlate.V2_WINDOW].contiguous() for c in big)

    # ---- 29. under the profiler: the small launches' host side, then each
    # launch's device kernels by name ----
    launch_shapes = ((f"grid C={C_BIG} g=25",
                      lambda dt: mf.group_power(*big, lo, 25, dt)),
              ("grid C=1 g=25", lambda dt: mf.group_power(*small, lo, 25, dt)),
              ("window B=8", lambda dt: mf.pss_correlate_power(win, dt)))
    host = {(label, dt): enqueue_us(lambda: fn(dt))
            for label, fn in launch_shapes[1:]
            for dt in (torch.float32, torch.bfloat16)}
    for label, fn in launch_shapes:
        for dt in (torch.float32, torch.bfloat16):
            parts = device_kernels(lambda: fn(dt))
            log(f"device kernels of one {label} {dt} launch: " + ", ".join(
                f"{('mf_' + k.split('mf_')[1][:16]) if 'mf_' in k else k[:24]}"
                f" {v:.4f} ms" for k, v in sorted(parts.items()))
                + (f"; host enqueue {host[(label, dt)]:.1f} us a call"
                   if (label, dt) in host else ""))

    # a streaming dispatch on the device's side: kernels and busy time
    t = api.Trigger(psr_threshold=4, transport="f32", device="cuda")
    feed(t, sig[:40 * 19200])
    n0 = dispatches(t)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(40, 60):
            t.process(sig[i * 19200:(i + 1) * 19200])
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    n_disp = dispatches(t) - n0
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev_events) / 1e3
    log(f"Trigger f32 under torch.profiler, {n_disp} dispatches while "
        f"tracking: {sum(e.count for e in dev_events) / n_disp:.0f} device "
        f"kernels and copies a dispatch (~725 before the pass-B kernel, "
        f"PERF.md), {busy / n_disp:.3f} ms of device "
        f"time of {wall / n_disp:.3f} ms of wall time a dispatch, device "
        f"idle share {1 - busy / wall:.3f} [{smi}]")

    # a paced monitor (phase 9d) on the device's side: its idle share
    paced_idle_share(api, soak, dev, smi)
    del soak

    # the 128 x 100 dispatch on the device's side: busy time by kernel
    parts = device_kernels(dispatch, reps=1)
    busy = sum(parts.values())
    n_ev, _ = device_events(dispatch)
    log(f"scan_engine C={C_BIG} x {STEPS_BIG} under torch.profiler: "
        f"{n_ev} device kernels and copies a dispatch, "
        f"{busy:.1f} ms of device time a dispatch against {ms_dispatch:.1f} "
        f"ms of wall time in phase 5 (busy share {busy / ms_dispatch:.2f}); "
        f"the largest: " + ", ".join(
            f"{k[:40]} {v:.1f} ms" for k, v in
            sorted(parts.items(), key=lambda kv: -kv[1])[:6]) + f" [{smi}]")

    # the 2-s band scan of phase 11b on the device's side
    n_ev, busy = device_events(scan2)
    log(f"wideband_scan 2 s x 16 centres under torch.profiler: {n_ev} "
        f"device kernels and copies, {busy:.1f} ms of device time against "
        f"{wall2_ms:.1f} ms of wall time in phase 11b (busy share "
        f"{busy / wall2_ms:.2f}) [{smi}]")

    # ---- 30. nothing of JAX ----
    bad = [m for m in sys.modules if m.split(".")[0] in
           ("jax", "jaxlib", "ltetrigger_tpu")]
    assert not bad, f"imported {bad[:5]}"
    import ltetrigger_tpu_torch
    root = pathlib.Path(ltetrigger_tpu_torch.__file__).resolve().parent
    ported = [m for n, m in list(sys.modules.items())
              if n.split(".")[0] == "ltetrigger_tpu_torch"]
    assert len(ported) > 20, len(ported)
    for m in ported:
        f = pathlib.Path(m.__file__).resolve()
        assert root in f.parents, f"{m.__name__} loaded from {f}"
    log(f"{len(ported)} modules of the port, all under {root.name}/; no jax")

    log(json.dumps({"rows": list(rows.values()), "ranks": rank_table}))
    c128 = rows[(f"grid C={C_BIG} g=25", str(torch.bfloat16))]
    b128 = pb_rows[f"C={C_BIG} g=25 (real power)"]
    v73k = vit_rows[(73728, 0.8)]
    t128 = tti_rows[f"{C_BIG} x 3 lanes K=16 combine=True"]
    r400 = ring_rows["48 lanes S=400"]

    def by_path(k):
        return {path: n.get(k, 0) for path, n in path_launches.items()
                if n.get(k, 0)}

    log(smi)
    print(json.dumps({"kernels": [{
        "name": "matched_filter.group_power",
        "route": "cuda",
        "source": "ltetrigger_tpu_torch/csrc/matched_filter.cu",
        "replaces": "ltetrigger_tpu/ops/pallas/matched_filter.py:59",
        "launches": sum(by_path("mf").values()),
        "launches_by_path": by_path("mf"),
        "max_abs_err": worst,
        "ms": c128["ms"],
        "replay_ms": c128["replay_ms"],
        "plain_ms": c128["plain_ms"],
        "bound_ms": c128["bound_ms"],
        "bound_by": c128["bound_by"],
        "library_ms": c128["library_ms"],
        "shapes": list(rows.values()),
    }, {
        "name": "pass_b.scan_group",
        "route": "cuda",
        "source": "ltetrigger_tpu_torch/csrc/pass_b.cu",
        "replaces": "ltetrigger_tpu/models/trigger.py:422",
        "launches": sum(by_path("pb").values()),
        "launches_by_path": by_path("pb"),
        "max_abs_err": pb_worst,
        "ms": b128["ms"],
        "replay_ms": b128["replay_ms"],
        "plain_ms": b128["plain_ms"],
        "graph_ms": b128["graph_ms"],
        "bound_ms": b128["bound_ms"],
        "bound_by": b128["bound_by"],
        "library_ms": None,
        "shapes": list(pb_rows.values()),
    }, {
        "name": "viterbi.viterbi_decode_wa",
        "route": "cuda",
        "source": "ltetrigger_tpu_torch/csrc/viterbi.cu",
        "replaces": "ltetrigger_tpu/ops/viterbi.py:168",
        "launches": sum(by_path("vit").values()),
        "launches_by_path": by_path("vit"),
        "max_abs_err": vit_worst,
        "ms": v73k["ms"],
        "replay_ms": v73k["replay_ms"],
        "plain_ms": v73k["plain_ms"],
        "bound_ms": v73k["bound_ms"],
        "bound_by": v73k["bound_by"],
        "library_ms": None,
        "shapes": list(vit_rows.values()),
    }, {
        "name": "tti_chain.tti_chain",
        "route": "cuda",
        "source": "ltetrigger_tpu_torch/csrc/tti_chain.cu",
        "replaces": "ltetrigger_tpu/models/trigger.py:879",
        "launches": sum(by_path("tti").values()),
        "launches_by_path": by_path("tti"),
        "max_abs_err": 0.0,
        "ms": t128["ms"],
        "replay_ms": t128["replay_ms"],
        "plain_ms": t128["plain_ms"],
        "bound_ms": t128["bound_ms"],
        "bound_by": t128["bound_by"],
        "library_ms": None,
        "shapes": list(tti_rows.values()),
    }, {
        "name": "cfo_ring.ring_scan",
        "route": "cuda",
        "source": "ltetrigger_tpu_torch/csrc/cfo_ring.cu",
        "replaces": "ltetrigger_tpu/models/trigger.py:972",
        "launches": sum(by_path("ring").values()),
        "launches_by_path": by_path("ring"),
        "max_abs_err": ring_worst,
        "ms": r400["ms"],
        "replay_ms": r400["replay_ms"],
        "plain_ms": r400["plain_ms"],
        "bound_ms": r400["bound_ms"],
        "bound_by": r400["bound_by"],
        "chain_ms": r400["chain_ms"],
        "library_ms": None,
        "shapes": list(ring_rows.values()),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
