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
     dispatch's time pass by pass, the small launches' host enqueue time,
     and each launch's device kernels by name (torch.profiler);
  6. the port must not have imported jax or the JAX package, nor loaded a
     module from a file outside its own directory.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL = dict(rtol=1e-4, atol=1e-5)      # float32 sums in another order
# H100 SXM data sheet, dense: device memory, bf16 tensor cores, float32 on
# the SM cores (the type of a float32 product, however the kernel gets there)
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
C_BIG, STEPS_BIG = 128, 100
CELLS = ((123, 6, 1.92e6), (124, 25, 7.68e6), (125, 50, 15.36e6),
         (369, 100, 30.72e6))


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


def main() -> int:
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
    from ltetrigger_tpu_torch.ltecore import synth
    from ltetrigger_tpu_torch.models import api, trigger as trig
    from ltetrigger_tpu_torch.ops import correlate
    from ltetrigger_tpu_torch.ops.kernels import matched_filter as mf

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

    # ---- 3. kernel against plain version ----
    big, cells_big = big_buffer(dev, synth, trig)
    small = tuple(c[:1].contiguous() for c in big)
    lo = trig.LOOKBACK
    w_fat = correlate.weights_fat("cuda")
    rows = {}
    worst = 0.0

    def case(label, buf, m, dt, kernel, plain):
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
        x = operand(buf, lo, m)
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
    ms = 1e3 * min(times)
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

    # the small launches' host side, then (last, because a process that has
    # run the profiler may launch more slowly afterwards) each launch's
    # device kernels by name
    shapes = ((f"grid C={C_BIG} g=25",
               lambda dt: mf.group_power(*big, lo, 25, dt)),
              ("grid C=1 g=25", lambda dt: mf.group_power(*small, lo, 25, dt)),
              ("window B=8", lambda dt: mf.pss_correlate_power(win, dt)))
    host = {(label, dt): enqueue_us(lambda: fn(dt))
            for label, fn in shapes[1:]
            for dt in (torch.float32, torch.bfloat16)}
    for label, fn in shapes:
        for dt in (torch.float32, torch.bfloat16):
            parts = device_kernels(lambda: fn(dt))
            log(f"device kernels of one {label} {dt} launch: " + ", ".join(
                f"{('mf_' + k.split('mf_')[1][:16]) if 'mf_' in k else k[:24]}"
                f" {v:.4f} ms" for k, v in sorted(parts.items()))
                + (f"; host enqueue {host[(label, dt)]:.1f} us a call"
                   if (label, dt) in host else ""))

    # ---- 6. nothing of JAX ----
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

    log(json.dumps({"rows": list(rows.values())}))
    c128 = rows[(f"grid C={C_BIG} g=25", str(torch.bfloat16))]
    log(smi)
    print(json.dumps({"kernels": [{
        "name": "matched_filter.group_power",
        "route": "cuda",
        "source": "ltetrigger_tpu_torch/csrc/matched_filter.cu",
        "replaces": "ltetrigger_tpu/ops/pallas/matched_filter.py:59",
        "launches": launches,
        "max_abs_err": worst,
        "ms": c128["ms"],
        "plain_ms": c128["plain_ms"],
        "bound_ms": c128["bound_ms"],
        "bound_by": c128["bound_by"],
        "library_ms": c128["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
