#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ltetrigger_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card: torch version, device name, `nvidia-smi` name and power limit
     (exits non-zero without a CUDA device);
  2. builds the CUDA kernels from ltetrigger_tpu_torch/csrc (timed);
  3. the matched-filter kernel against its plain PyTorch version on the card
     (grid entry at 1 and 128 channels x 25 steps, window entry at B=8; f32
     and bf16 inputs; CUDA-event times), and bf16 against f32 decisions;
  4. the main path: `search(device="cuda")` over 1 s of four synthetic cells
     at 1.92 / 7.68 / 15.36 / 30.72 Msps, then the CLI on a capture file,
     with the kernel's launch count read around them;
  5. one scan_engine dispatch of 128 channels x 100 half-frame steps (about
     1 GB of stream on the card), detections checked in every channel, and a
     small dispatch checked field for field against the CPU run;
  6. the port must not have imported jax or the JAX package.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL = dict(rtol=1e-4, atol=1e-5)      # float32 sums in another order
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

    # ---- 3. kernel against plain version ----
    big, cells_big = big_buffer(dev, synth, trig)
    small = tuple(c[:1].contiguous() for c in big)
    lo = trig.LOOKBACK
    rows = {}
    worst = 0.0
    for label, buf in (("C=1", small), (f"C={C_BIG}", big)):
        for dt in (torch.float32, torch.bfloat16):
            got = mf.group_power(*buf, lo, 25, dt)
            ref = mf.group_power_plain(*buf, lo, 25, dt)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, **TOL)
            err = (got - ref).abs().max().item()
            worst = max(worst, err)
            ms = cuda_ms(lambda: mf.group_power(*buf, lo, 25, dt))
            pms = cuda_ms(lambda: mf.group_power_plain(*buf, lo, 25, dt))
            rows[(label, str(dt))] = (ms, pms, err)
            log(f"group_power {label} g=25 {dt}: kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms, max_abs_err {err:.3e}")
            del got, ref
    win = tuple(c[:8, lo:lo + correlate.V2_WINDOW].contiguous() for c in big)
    win_power = {}
    for dt in (torch.float32, torch.bfloat16):
        got = mf.pss_correlate_power(win, dt)
        ref = correlate.pss_correlate_power_v2(win, dt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, **TOL)
        err = (got - ref).abs().max().item()
        worst = max(worst, err)
        ms = cuda_ms(lambda: mf.pss_correlate_power(win, dt))
        pms = cuda_ms(lambda: correlate.pss_correlate_power_v2(win, dt))
        log(f"window entry B=8 {dt}: kernel {ms:.4f} ms, plain {pms:.4f} ms,"
            f" max_abs_err {err:.3e}")
        win_power[dt] = got
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
                f"in {wall * 1e3:.1f} ms wall")
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

    st, out = dispatch()                  # warm-up (allocator, caches)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
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
        f"{sps / 1e9:.3f} G IQ samples/s, detections in all {C_BIG} "
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

    # ---- 6. nothing of JAX ----
    bad = [m for m in sys.modules if m.split(".")[0] in
           ("jax", "ltetrigger_tpu")]
    assert not bad, f"imported {bad[:5]}"

    c128 = rows[(f"C={C_BIG}", str(torch.bfloat16))]
    log(smi)
    print(json.dumps({"kernels": [{
        "name": "matched_filter.group_power",
        "route": "cuda",
        "source": "ltetrigger_tpu_torch/csrc/matched_filter.cu",
        "replaces": "ltetrigger_tpu/ops/pallas/matched_filter.py:59",
        "launches": launches,
        "max_abs_err": worst,
        "ms": c128[0],
        "plain_ms": c128[1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
