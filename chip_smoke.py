#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ltetrigger_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card: torch version, device name, `nvidia-smi` name and power limit
     (exits non-zero without a CUDA device);
  2. builds the CUDA kernels from ltetrigger_tpu_torch/csrc (timed) and
     prints the compiler's register and spill report;
  3. the matched-filter kernel against its plain PyTorch version on the card
     (grid entry at 1 and 128 channels x 25 steps, window entry at B=8; f32
     and bf16 inputs; CUDA-event times), each beside its bound and beside
     one library matmul on the pre-built operand (`torch.matmul`, which the
     port never calls); a ramp stream, a buffer with N and lo unaligned and
     read past its end, row counts that are no multiple of the row tile;
     and bf16 against f32 decisions;
  4. the main path: `search(device="cuda")` over 1 s of four synthetic cells
     at 1.92 / 7.68 / 15.36 / 30.72 Msps, then the CLI on a capture file,
     with the kernel's launch count read around them;
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
 10. the channelizer: 0.25 s of a 30.72 Msps band to 16 centres on the card
     against the same code on the CPU; CUDA-event time, wide samples/s;
 11. `wideband_scan` of that band, three synthetic cells at three of the 16
     centres: exactly those three detected, cell id and PRB right;
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
     cut, loaded by a trigger without a mesh.  Every rank has a timeout and
     a rank that fails fails the run;
 21. one rank per card over NCCL, only where there are two or more cards
     (one line says so otherwise): the `ch` and `t` cases of phase 20;
     `python3 chip_smoke.py --cards` runs phases 1, 2 and this one alone;
 22-28. the example tools, examples/*_torch.py, in this process where no
     ranks or environment variables are needed:
 22. `bench_sweep_torch` at C = 32, 256 and 1024 (0.55 s, 0.55 s and, under
     its 6 GB cap, 0.275 s = 55 steps): cell 123 found at every point;
 23. `bench_attrib_torch passes` at C = 128 and 512 (host ms and device ms
     of each rung), the C=128 `ABC_decode` rung equal to `scan_engine` on
     the same buffer field for field; `decode` and `micro` at C=128 (pass
     C's front end, codeword search and Viterbi; its small stages);
 24. `bench_attrib_torch groups` at C=512 with budgets 4096 and 16384, a
     subprocess each: g = 5 and 25;
 25. `bench_stream_torch`: 0.5 s through a Trigger per transport (f32, i16,
     i8) and through MultiTrigger(8) (i16, i4), cell 123 found in each;
 26. `seam_sweep_torch` on 4 gloo ranks sharing the card, 0 and -30 dB x 2
     trials: P(detect) 1 and 0 for the continuous and the sharded scan;
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

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import importlib.util
import io
import json
import math
import pathlib
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


def device_kernels(fn, reps: int = 5) -> dict:
    """Mean device milliseconds per call of `fn`, by device kernel name
    (torch.profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = e.device_time_total / 1e3 / reps
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
                cfo_subcarriers: float = 0.0) -> np.ndarray:
    """`seconds` of one synthetic cell at 1.92 Msps plus seeded noise,
    optionally offset in frequency by `cfo_subcarriers` x 15 kHz."""
    x = np.tile(synth.synthesize_frame(cell_id, nof_prb_field=prb),
                int(round(seconds * 100)))
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
    each of `cells` = (centre Hz, cell id, PRB field, start s) is one
    synthetic frame, interpolated to the band's rate, looped from its start
    time on and mixed to its centre with a float64 phase; plus seeded noise
    31 dB under the band.  Made on the card, returned on the host."""
    ratio = int(round(rate / 1.92e6))
    n = int(round(seconds * rate))
    t = torch.arange(n, dtype=torch.float64, device=dev)
    acc = torch.zeros(n, dtype=torch.complex64, device=dev)
    for center, cid, prb, start_s in cells:
        frame = torch.from_numpy(upsample(
            synth.synthesize_frame(cid, nof_prb_field=prb), ratio)).to(dev)
        x = frame.repeat(-(-n // frame.shape[0]))[:n]
        ph = torch.remainder(t * (center / rate), 1.0) * (2 * math.pi)
        rot = torch.complex(torch.cos(ph), torch.sin(ph)).to(torch.complex64)
        x = x * rot
        x[:int(round(start_s * rate))] = 0
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
# one rank of phases 20 and 21 (`chip_smoke.py --rank ...`)
# ======================================================================
def rank_main(args) -> int:
    """python3 chip_smoke.py --rank RANK WORLD PORT DIR BACKEND PLAN

    BACKEND gloo: every rank on cuda:0; nccl: rank k on cuda:k.  PLAN is a
    comma-separated list of "scan" (ch = WORLD), "shards" (t = WORLD) and
    "stream" (ch = WORLD, needs DIR/sigs.npy and DIR/band8.npy).  What the
    rank measured goes to DIR/rank<RANK>.json, the gathered results (rank
    0) to files beside it.  No phase carries on without a card."""
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
    from ltetrigger_tpu_torch.ops.kernels import matched_filter as mf
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
           "device": str(dev)}

    def barrier(mesh):
        meshmod.all_gather_object(None, mesh, None)
        torch.cuda.synchronize()

    try:
        ch = make_mesh(world, 1)
        if "scan" in plan:
            big, _ = big_buffer(dev, synth, trig)
            lo, hi = ch.local_slice(C_BIG)
            local = tuple(c[lo:hi] for c in big)
            channel_scan(big, STEPS_BIG, 4.0, mesh=ch)         # warm-up
            t_call, t_engine, t_full = [], [], []
            for _ in range(3):
                barrier(ch)
                t0 = time.perf_counter()
                mf.launches = 0
                _, got = channel_scan(big, STEPS_BIG, 4.0, mesh=ch)
                torch.cuda.synchronize()
                t_call.append(1e3 * (time.perf_counter() - t0))
                res["scan_launches"] = mf.launches
                barrier(ch)
                t0 = time.perf_counter()
                trig.scan_engine(local, trig.init_state(batch=(hi - lo,),
                                                        device=dev),
                                 STEPS_BIG, 4.0, grid0=trig.LOOKBACK)
                torch.cuda.synchronize()
                t_engine.append(1e3 * (time.perf_counter() - t0))
                # every rank all 128 channels at once: WORLD x the work
                barrier(ch)
                t0 = time.perf_counter()
                trig.scan_engine(big, trig.init_state(batch=(C_BIG,),
                                                      device=dev),
                                 STEPS_BIG, 4.0, grid0=trig.LOOKBACK)
                torch.cuda.synchronize()
                t_full.append(1e3 * (time.perf_counter() - t0))
            res.update(scan_call_ms=t_call, scan_engine_ms=t_engine,
                       scan_full_ms=t_full, scan_rows=[lo, hi])
            if rank == 0:
                np.save(out / f"scan_ch{world}.npy",
                        trig.pack_output(got).cpu().numpy())
            del big, local, got

        if "shards" in plan:
            tm = make_mesh(1, world)
            per = 200 // world              # frames a block: 2 s in all
            cell = stream_cell(synth, 125, 50, 2.0, seed=11)
            time_sharded_scan(pair_np(cell[:world * 19200]), tm, 4.0)
            barrier(tm)
            t0 = time.perf_counter()
            mf.launches = 0
            got = time_sharded_scan(pair_np(cell), tm, 4.0)
            torch.cuda.synchronize()
            res["shards_ms"] = 1e3 * (time.perf_counter() - t0)
            res["shards_launches"] = mf.launches
            ev = got.track_event.cpu().numpy()      # [t, steps, R]
            assert ev.shape == (world, 2 * per, 3), ev.shape
            assert ev.any(axis=(1, 2)).all(), ev.any(axis=(1, 2))
            assert set(got.cell_id.cpu().numpy()[ev].tolist()) == {125}
            seam = straddle_stream(synth, world, per)
            mf.launches = 0
            got = time_sharded_scan(pair_np(seam), tm, 4.0)
            res["shards_launches"] += mf.launches
            host = trig.unpack_output(trig.pack_output(got))
            assert host.track_event.any(axis=(1, 2)).all()
            for shard in range(world - 1):  # the step that crosses the seam
                assert host.psr[shard, -1, 123 % 3] > 4.0, host.psr[shard, -1]
                assert host.cell_id[shard, -1, 123 % 3] == 123
            res["straddle_events"] = int(host.track_event.sum())
            if backend == "gloo":           # the same call on 4 CPU ranks
                ref = time_sharded_scan(pair_np(seam),
                                        make_mesh(1, world, device="cpu"),
                                        4.0)
                ref = trig.unpack_output(trig.pack_output(ref))
                lane = 123 % 3      # the other roots' lanes hold no cell:
                for f in trig.StepOutput._fields:   # their ids are ties
                    g, r = getattr(host, f), getattr(ref, f)
                    if f in trig._F32_FIELDS:
                        np.testing.assert_allclose(g[..., lane], r[..., lane],
                                                   rtol=1e-3, atol=1e-3)
                    elif f in ("cell_id", "normal_cp"):
                        assert (g[..., lane] == r[..., lane]).all(), f
                    else:
                        assert (g == r).all(), f
                res["straddle_equals_cpu_ranks"] = True

        if "stream" in plan:
            sigs = np.load(out / "sigs.npy")
            band8 = np.load(out / "band8.npy")
            wchunk = 19200 * 8

            def timed(make, feed):
                feed(make(), 20)                        # warm-up
                t = make()
                barrier(ch)
                t0 = time.perf_counter()
                mf.launches = 0
                got = feed(t, None)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                return t, got, {
                    "wall_s": wall, "launches": mf.launches,
                    "dispatches": t.timer.summary()["scan"]["count"],
                    "in_flight": t.max_in_flight, "rows": t.n,
                    "stages": {k: [v["mean_ms"], v["count"]]
                               for k, v in t.timer.summary().items()}}

            m, got, res["multi"] = timed(
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

            w, got, res["wide"] = timed(
                lambda: WidebandTrigger(RATE8, CENTERS8, psr_threshold=4,
                                        transport="f32", mesh=ch), feed_w)
            wide_merged = gather_events(got, ch)
            # a sharded checkpoint at a cut, for a trigger without a mesh
            cut = 45 * 19200
            late = late_streams(sigs, cut)
            first = MultiTrigger(8, psr_threshold=4, transport="f32", mesh=ch)
            before = gather_events(feed_all(first, late, 0, cut), ch)
            first.save_state(str(out / "sharded.npz"))
            if rank == 0:
                (out / "stream_events.json").write_text(json.dumps({
                    "multi": tagged(merged), "wide": tagged(wide_merged),
                    "before": tagged(before)}))
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


def scan_on_ranks(world: int, out: pathlib.Path, backend: str, plan: str,
                  want, cells_big, one_ms: float, smi: str, trig) -> list:
    """`channel_scan` of 128 x 100 over `world` ranks (and what else `plan`
    names): the gathered output against `want` (one process's packed
    output), a detection in every channel, and the times.  returns what
    each rank measured."""
    ranks = run_ranks(world, out, backend, plan)
    got = trig.unpack_output(np.load(out / f"scan_ch{world}.npy"))
    ref = trig.unpack_output(want)
    for f in trig.StepOutput._fields:
        g, r = getattr(got, f), getattr(ref, f)
        if f in trig._F32_FIELDS:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4, err_msg=f)
        else:
            assert (g == r).all(), f
    for c, cid in enumerate(cells_big):
        s = np.nonzero(got.track_event[:, c, cid % 3])[0]
        assert s.size and got.cell_id[s[0], c, cid % 3] == cid, (c, cid)
    call = max(min(r["scan_call_ms"]) for r in ranks)
    engine = max(min(r["scan_engine_ms"]) for r in ranks)
    full = max(min(r["scan_full_ms"]) for r in ranks)
    assert all(r["scan_launches"] > 0 for r in ranks)
    log(f"channel_scan 128 x 100 over ch = {world} ({ranks[0]['backend']}, "
        f"{'one card' if backend == 'gloo' else 'a card a rank'}): gathered "
        f"output = one process's field for field, detections in all "
        f"{C_BIG} channels; per rank (best of 3, ms) engine alone "
        + ", ".join(f"{min(r['scan_engine_ms']):.1f}" for r in ranks)
        + "; whole call with the gather "
        + ", ".join(f"{min(r['scan_call_ms']):.1f}" for r in ranks)
        + f"; slowest rank {engine:.1f} / {call:.1f} ms against "
        f"{one_ms:.1f} ms in one process: {one_ms / engine:.2f}x / "
        f"{one_ms / call:.2f}x the channels/s; every rank all {C_BIG} "
        f"channels at the same time (engine alone) "
        + ", ".join(f"{min(r['scan_full_ms']):.1f}" for r in ranks)
        + f" ms: {world * one_ms / full:.2f}x the channels/s; "
        f"{ranks[0]['scan_launches']} kernel launches a rank [{smi}]")
    return ranks


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
        + f"; {ranks[0]['shards_launches']} kernel launches a rank [{smi}]")


def cards_phase(out, want, cells_big, one_ms, smi, trig) -> int:
    """Phase 21 (`out` holds sigs.npy and band8.npy).  returns the kernel
    launches of all ranks (0 when the phase did not start)."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"one rank per card over NCCL: not started, this machine has "
            f"{n} card; this run says nothing of NCCL between cards")
        return 0
    world = 4 if n >= 4 else 2
    ranks = scan_on_ranks(world, out, "nccl", "scan,shards,stream", want,
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
    return sum(r["scan_launches"] + r["shards_launches"]
               + r["multi"]["launches"] + r["wide"]["launches"]
               for r in ranks)


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        return rank_main(sys.argv[2:])
    only_cards = sys.argv[1:2] == ["--cards"]
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
    from ltetrigger_tpu_torch.ops import correlate, cplx
    from ltetrigger_tpu_torch.ops.kernels import matched_filter as mf
    from ltetrigger_tpu_torch.parallel import (channel_scan, gather_events,
                                               init_distributed, make_mesh,
                                               time_sharded_scan)
    from ltetrigger_tpu_torch.parallel import mesh as meshmod
    import torch.distributed as dist

    # ---- 2. build ----
    path, build_s = mf.build()
    log(f"build: {path.name} in {build_s:.2f} s")
    report = path.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(report):
        if "Compiling entry function" in line:      # then: properties, spills
            kname = line.split("'")[1]              # and registers
            kname = kname[kname.find("mf_"):].split("EE")[0]
            log(f"  {kname}: " + "; ".join(
                x.replace("ptxas info    :", "").strip()
                for x in report[i + 2:i + 4]))

    if only_cards:      # phases 1, 2 and 21 alone
        big, cells_big = big_buffer(dev, synth, trig)
        want, one_ms = one_process_scan(big, channel_scan, trig)
        del big
        with tempfile.TemporaryDirectory(dir=mf.BUILD_DIR) as tmp:
            np.save(f"{tmp}/sigs.npy", np.stack(
                [stream_cell(synth, cid, prb, 2.0, seed=20 + i)
                 for i, (cid, prb) in enumerate(CELLS8)]))
            np.save(f"{tmp}/band8.npy", band_of_eight(dev, synth))
            n = cards_phase(pathlib.Path(tmp), want, cells_big, one_ms, smi,
                            trig)
        log(smi)
        print(json.dumps({"ok": n > 0, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0 if n > 0 else 1

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
        pms = cuda_ms(plain)
        x = operand(buf, at, m)
        w = w_fat
        if dt == torch.bfloat16:
            x, w = x.to(dt), w.to(dt)
        lms = cuda_ms(lambda: torch.matmul(x, w))
        del x
        bms, by = bound(buf[0].shape[0], m, dt)
        rows[(label, str(dt))] = dict(
            shape=label, dtype=str(dt), ms=ms, plain_ms=pms, library_ms=lms,
            bound_ms=bms, bound_by=by, max_abs_err=err)
        log(f"{label} {dt}: kernel {ms:.4f} ms, plain {pms:.4f} ms, library "
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

    # ---- 4. the main path: search over four rates, then the CLI ----
    captures = []
    for cid, prb, rate in CELLS:
        frame = synth.synthesize_frame(cid, nof_prb_field=prb)
        captures.append(upsample(frame, int(rate // 1.92e6)))
    with tempfile.TemporaryDirectory(dir=mf.BUILD_DIR) as tmp:
        cap_path = f"{tmp}/cell125_15.36M.c64"
        captures[2].tofile(cap_path)
        mf.launches = 0
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
        launches = mf.launches
        assert rc == 0 and '"status": "FOUND"' in out.getvalue(), \
            out.getvalue()
        assert json.loads(out.getvalue().split("done.")[1])["cell_id"] == 125
    assert launches > 0, "the main path never launched the kernel"
    path_launches = {"search and CLI": launches}
    log(f"CLI printed FOUND; main path launched the kernel {launches} times")

    # ---- 5. one dispatch of 128 channels x 100 steps ----
    def dispatch():
        return trig.scan_engine(big, trig.init_state(batch=(C_BIG,),
                                                     device=dev),
                                STEPS_BIG, 4.0)

    n0 = mf.launches
    st, out = dispatch()                  # warm-up (allocator, caches)
    torch.cuda.synchronize()
    per_dispatch = mf.launches - n0
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
    _, ref = trig.scan_engine(sig, trig.init_state(batch=(1,)), 12, 4.0)
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
        (result, kernel launches, host syncs by name)."""
        mf.launches = 0
        trig.host_syncs.clear()
        res = run()
        return res, mf.launches, dict(trig.host_syncs)

    def dispatches(t) -> int:
        return t.timer.summary().get("scan", {}).get("count", 0)

    sig = stream_cell(synth, 125, 50, 2.0, seed=11)
    feed(api.Trigger(psr_threshold=4, device="cuda"), sig[:20 * 19200])
    events = {}
    path_launches["Trigger"] = 0
    for transport in ("f32", "i16", "i8"):
        t = api.Trigger(psr_threshold=4, transport=transport, device="cuda")
        (got, wall), n_launch, syncs = counted(lambda: feed(t, sig))
        n_disp = dispatches(t)
        assert n_launch == n_disp > 0, (n_launch, n_disp)
        assert got and t.tracking[125 % 3], transport
        events[transport] = got
        path_launches["Trigger"] += n_launch
        log(f"Trigger {transport}: {sig.size / wall / 1e6:.3f} M samples/s "
            f"of wall time ({sig.size} samples in {wall * 1e3:.1f} ms), "
            f"{n_disp} dispatches, {n_launch / n_disp:.2f} kernel launches "
            f"and " + ", ".join(f"{v / n_disp:.2f} '{k}'"
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
    assert n_launch == dispatches(t_deep)
    path_launches["Trigger"] += n_launch
    log(f"Trigger f32 fed 307200-sample chunks: "
        f"{sig.size / wall / 1e6:.3f} M samples/s of wall time, "
        f"{n_launch} dispatches of 1 kernel launch, "
        f"{sum(syncs.values()) / n_launch:.2f} host syncs a dispatch, at "
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
    path_launches["MultiTrigger"] = 0
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
        assert n_launch == n_disp > 0, (n_launch, n_disp)
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
            f"{n_disp} dispatches, {n_launch / n_disp:.2f} kernel launches "
            f"a dispatch, at most {m.max_in_flight} in flight; per-stream "
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
    assert n_launch >= 10, n_launch
    log(f"search(cfo_search_range=2) finds cell 200 at +1.5 subcarriers, "
        f"plain search does not; {n_launch} kernel launches (9 probe bins "
        f"+ the scan)")
    path_launches["CFO probe"] = n_launch
    t = api.Trigger(psr_threshold=4, cfo_search_range=2, device="cuda")
    (got, _), n_launch, syncs = counted(lambda: feed(t, off))
    probes = syncs.get("probe", 0)
    assert got and got[0].cell_id == 200 and t._cfo_bins[0] == 3, \
        (got, t._cfo_bins)
    assert probes > 0 and n_launch == dispatches(t) + 9 * probes, \
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
    with tempfile.TemporaryDirectory(dir=mf.BUILD_DIR) as tmp:
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
    assert n_launch > 0
    path_launches["wideband_scan, snr_sweep, pbch_sweep"] = n_launch
    log(f"wideband_scan 0.25 s x 16 centres: exactly the planted cells "
        f"{ {k: recs[k]['cell_id'] for k in planted} } detected, "
        f"{n_launch} kernel launch(es), {wall * 1e3:.1f} ms wall [{smi}]")

    # ---- 12. WidebandTrigger: 8 carriers from one 15.36 Msps stream ----
    rate8, centers8 = RATE8, CENTERS8
    ids8 = [c for c, _ in cells8]
    band8 = band_of_eight(dev, synth)
    wchunk = 19200 * 8                       # one radio frame of band
    n_narrow = band8.size // 8
    feed_wide(WidebandTrigger(rate8, centers8, psr_threshold=4,
                              device="cuda"), band8[:20 * wchunk], wchunk)
    wide_events, wide_trigs = {}, {}
    path_launches["WidebandTrigger"] = 0
    for transport in ("f32", "i8", "i4"):
        w = WidebandTrigger(rate8, centers8, psr_threshold=4,
                            transport=transport, device="cuda")
        (got, wall), n_launch, syncs = counted(
            lambda: feed_wide(w, band8, wchunk))
        n_disp = dispatches(w)
        assert n_launch == n_disp > 0, (n_launch, n_disp)
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
            f"{n_disp} dispatches, {n_launch / n_disp:.2f} kernel launches "
            f"and " + ", ".join(f"{v / n_disp:.2f} '{k}'"
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
    assert n_launch == n_disp > 0, (n_launch, n_disp)
    assert sorted((n, f["cell_id"]) for n, f in got) \
        == list(enumerate(ids16)), got
    path_launches["WidebandTrigger"] += n_launch
    log(f"WidebandTrigger(16 x 30.72 Msps) i8: "
        f"{band.size / 16 / wall / 1e6:.3f} M narrow samples/s per carrier "
        f"of wall time ({band.size / wall / 1e6:.3f} M wide samples/s), "
        f"{n_disp} dispatches of 1 kernel launch, at most "
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
    with tempfile.TemporaryDirectory(dir=mf.BUILD_DIR) as tmp:
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
    assert len(curve) == 21 and n_launch > 0
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
        path_launches["run_flowgraph"] = 0
        with tempfile.TemporaryDirectory(dir=mf.BUILD_DIR) as tmp:
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
                assert n_launch > 0
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
        with tempfile.TemporaryDirectory(dir=mf.BUILD_DIR) as tmp:
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
    want, one_ms = one_process_scan(big, channel_scan, trig)
    log(f"channel_scan 128 x 100 in one process: {one_ms:.1f} ms (best of "
        f"3; phase 5's scan_engine: {ms_dispatch:.1f} ms) [{smi}]")
    big = small = win = None            # room for the ranks' own buffers
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=mf.BUILD_DIR) as tmp:
        tmp = pathlib.Path(tmp)
        np.save(tmp / "sigs.npy", np.stack(sigs))
        np.save(tmp / "band8.npy", band8)
        ranks2 = scan_on_ranks(2, tmp, "gloo", "scan", want, cells_big,
                               one_ms, smi, trig)
        ranks4 = scan_on_ranks(4, tmp, "gloo", "scan,shards,stream", want,
                               cells_big, one_ms, smi, trig)
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
        path_launches["ranks on one card (all ranks)"] = sum(
            r["scan_launches"] for r in ranks2) + sum(
            r["scan_launches"] + r["shards_launches"] + r["multi"]["launches"]
            + r["wide"]["launches"] for r in ranks4)
        rank_table = {
            "one_process_ms": one_ms,
            "ch2": {"engine_ms": [min(r["scan_engine_ms"]) for r in ranks2],
                    "full_ms": [min(r["scan_full_ms"]) for r in ranks2],
                    "call_ms": [min(r["scan_call_ms"]) for r in ranks2],
                    "launches": [r["scan_launches"] for r in ranks2]},
            "ch4": {"engine_ms": [min(r["scan_engine_ms"]) for r in ranks4],
                    "full_ms": [min(r["scan_full_ms"]) for r in ranks4],
                    "call_ms": [min(r["scan_call_ms"]) for r in ranks4],
                    "launches": [r["scan_launches"] for r in ranks4]}}
        n_cards = cards_phase(tmp, want, cells_big, one_ms, smi, trig)
        if n_cards:
            path_launches["a card a rank (NCCL, all ranks)"] = n_cards
    del band8, late8
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
    mf.launches = 0
    for c in (32, 256, 1024):
        sec, steps = bsweep.capped(c, 0.55, 100)
        sweep_recs.append(quiet(lambda: bsweep.run_point(
            c, steps, sec, 3, "cuda"))[0])
    path_launches["bench_sweep_torch"] = mf.launches
    assert all(r["detections_ok"] for r in sweep_recs), sweep_recs
    log("bench_sweep_torch (channel_scan, best of 3): " + "; ".join(
        f"C={r['channels']} x {r['n_steps']} steps {r['ms_per_dispatch']:.1f}"
        f" ms, {r['msps']:.1f} M samples/s (first call "
        f"{r['compile_s']:.2f} s)" for r in sweep_recs)
        + f"; cell 123 found at every point; {mf.launches} kernel launches "
        f"[{smi}]")

    # 23. the pass ladder at C=128 and 512, pass C's stages at C=128
    ladder = {}
    mf.launches = 0
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
                f"{r['device_ms']:.2f} ({r['launches']} launches)"
                for r in rows_c)
            + (": ABC_decode = scan_engine field for field" if c == C_BIG
               else "") + f" [{smi}]")
    stages, _ = quiet(lambda: attrib.main(["decode", "--channels",
                                           str(C_BIG)]))
    ops, _ = quiet(lambda: attrib.main(["micro", "--channels", str(C_BIG)]))
    path_launches["bench_attrib_torch passes"] = mf.launches
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
        x["launches"] for _, recs in groups for x in recs if "launches" in x)
    log("bench_attrib_torch groups C=512: " + "; ".join(
        f"budget {b} g={got_g[b]}: " + ", ".join(
            f"{x['variant']} {x['ms_per_dispatch']:.1f}" for x in recs
            if "variant" in x) for b, recs in groups) + f" ms [{smi}]")

    # 25. the streaming stage timer: Trigger per transport, MultiTrigger(8)
    mf.launches = 0
    singles, _ = quiet(lambda: bstream.single_main(0.5, 4, ["f32", "i16",
                                                            "i8"], 3, dev))
    multis, _ = quiet(lambda: bstream.multi_main(8, 0.5, 4, ["i16", "i4"], 3,
                                                 dev))
    path_launches["bench_stream_torch"] = mf.launches
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
    assert seam["n_shards"] == 4 and seam["launches"] > 0, seam
    path_launches["seam_sweep_torch (rank 0 of 4)"] = seam["launches"]
    log(f"seam_sweep_torch on 4 gloo ranks on one card: P(detect) "
        f"continuous / sharded {p} over 2 trials, "
        f"{time.perf_counter() - t0:.1f} s with start-up, "
        f"{seam['launches']} kernel launches on rank 0 [{smi}]")

    # 27. the SNR curve, two trials a point, 4 dB steps
    mf.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=mf.BUILD_DIR) as tmp:
        payload, _ = quiet(lambda: curvemod.main(
            ["--trials", "2", "--step", "4", "--out-dir", tmp]))
        written = sorted(x.name for x in pathlib.Path(tmp).iterdir())
    assert written == ["SNR_CURVE_torch.md", "snr_curve_torch.json"], written
    knees = dict(payload["knee_db"], **payload["pbch_limited"]["knee_db"])
    assert len(knees) == 10 and None not in knees.values(), knees
    path_launches["make_snr_curve_torch"] = mf.launches
    log(f"make_snr_curve_torch --trials 2 --step 4: both files written, "
        f"knees (dB) {knees}, {time.perf_counter() - t0:.1f} s, "
        f"{mf.launches} kernel launches [{payload['device']}]")

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
        f"kernels and copies a dispatch, {busy / n_disp:.3f} ms of device "
        f"time of {wall / n_disp:.3f} ms of wall time a dispatch, device "
        f"idle share {1 - busy / wall:.3f} [{smi}]")

    # the 128 x 100 dispatch on the device's side: busy time by kernel
    parts = device_kernels(dispatch, reps=1)
    busy = sum(parts.values())
    log(f"scan_engine C={C_BIG} x {STEPS_BIG} under torch.profiler: "
        f"{busy:.1f} ms of device time a dispatch against {ms_dispatch:.1f} "
        f"ms of wall time in phase 5 (busy share {busy / ms_dispatch:.2f}); "
        f"the largest: " + ", ".join(
            f"{k[:40]} {v:.1f} ms" for k, v in
            sorted(parts.items(), key=lambda kv: -kv[1])[:6]) + f" [{smi}]")

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
    log(smi)
    print(json.dumps({"kernels": [{
        "name": "matched_filter.group_power",
        "route": "cuda",
        "source": "ltetrigger_tpu_torch/csrc/matched_filter.cu",
        "replaces": "ltetrigger_tpu/ops/pallas/matched_filter.py:59",
        "launches": sum(path_launches.values()),
        "launches_by_path": path_launches,
        "max_abs_err": worst,
        "ms": c128["ms"],
        "plain_ms": c128["plain_ms"],
        "bound_ms": c128["bound_ms"],
        "bound_by": c128["bound_by"],
        "library_ms": c128["library_ms"],
        "shapes": list(rows.values()),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
