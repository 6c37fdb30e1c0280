#!/usr/bin/env python
"""Live cell monitor: stream IQ in, live telemetry + tracked cells out.

The PyTorch port of ltetrigger_tpu/apps/live_monitor.py, with the same
output, plus `--device` (default cuda).  Any SDR process pipes raw complex64
at 1.92 Msps into stdin or a FIFO,

    rtl_sdr ... | csdr convert_u8_c | ... | \\
        python -m ltetrigger_tpu_torch.apps.live_monitor -

and the monitor prints a status line per refresh plus JSON events for every
tracked/dropped cell.  The probe surface (per-root tracking_score, mean_psr,
mean_cfo, max_psr, latest_cell) is what the reference's GRC function probes
polled.  Several paths monitor several carriers through ONE device pipeline
(`MultiTrigger`); with `--wideband` the single source is a wide band at
`-s`, channelized on the device to `--centers` (`WidebandTrigger`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _psd_db(chunk: np.ndarray, nbins: int = 32) -> list[float]:
    """Coarse PSD of the latest chunk (dB, DC-centered, `nbins` bins): one
    waterfall LINE per status refresh (a UI renders the status stream's
    psd_db rows as the waterfall)."""
    n = (len(chunk) // nbins) * nbins
    if n == 0:
        return [0.0] * nbins
    spec = np.fft.fftshift(np.abs(np.fft.fft(chunk[:n])) ** 2)
    p = spec.reshape(nbins, -1).mean(axis=1) / max(n, 1)
    return np.round(10.0 * np.log10(p + 1e-30), 1).tolist()


def _emit(out, event: str, **fields) -> None:
    print(json.dumps({"event": event, **fields}), file=out, flush=True)


def _stages(trig) -> dict:
    """Per-stage timing (prep/scan/drain mean ms)."""
    return {name: round(st["mean_ms"], 3)
            for name, st in trig.timer.summary().items()}


def run(stream, psr_threshold: float = 4.0, chunk_samples: int = 19200,
        refresh_every: int = 10, out=sys.stdout, max_chunks=None,
        transport: str = "i16", device="cuda") -> None:
    """One source -> one `Trigger`, until the source ends (or `max_chunks`)."""
    from ..models import api

    trig = api.Trigger(
        psr_threshold=psr_threshold, transport=transport, device=device,
        on_track=lambda cell: _emit(out, "track", **cell.to_dict()),
        on_drop=lambda cell_id: _emit(out, "drop", cell_id=cell_id))
    n = 0
    t0 = time.time()
    while max_chunks is None or n < max_chunks:
        raw = stream.read(chunk_samples * 8)
        if not raw:
            break
        samples = np.frombuffer(raw, dtype=np.complex64)
        trig.process(samples)          # events drain async (pipeline mode)
        n += 1
        if n % refresh_every == 0:
            _emit(out, "status",
                  t=round(time.time() - t0, 1),
                  psd_db=_psd_db(samples),
                  tracking_score=trig.tracking_score.tolist(),
                  tracking=trig.tracking.tolist(),
                  mean_psr=np.round(trig.mean_psr, 2).tolist(),
                  max_psr=np.round(trig.max_psr, 2).tolist(),
                  mean_cfo=np.round(trig.mean_cfo, 4).tolist(),
                  cells=[c.cell_id for c in trig.cellstore.cells()],
                  stages=_stages(trig))
    trig.flush()                       # surface any still-pending events


def run_multi(streams, psr_threshold: float = 4.0,
              chunk_samples: int = 19200, refresh_every: int = 10,
              out=sys.stdout, max_chunks=None,
              transport: str = "i16", device="cuda") -> None:
    """N sources -> ONE MultiTrigger pipeline (one SDR per carrier; the
    reference needs one process per carrier).  Sources are read
    round-robin one chunk each; a source that ends is padded with silence
    (fill_gap semantics) so the group keeps flowing."""
    from ..models.multi import MultiTrigger

    trig = MultiTrigger(
        len(streams), psr_threshold=psr_threshold, transport=transport,
        device=device,
        on_track=lambda i, cell: _emit(out, "track", stream=i,
                                       **cell.to_dict()),
        on_drop=lambda i, cell_id: _emit(out, "drop", stream=i,
                                         cell_id=cell_id))
    ended = [False] * len(streams)
    n = 0
    t0 = time.time()
    while max_chunks is None or n < max_chunks:
        chunks = []
        for i, st in enumerate(streams):
            raw = b"" if ended[i] else st.read(chunk_samples * 8)
            if not raw:
                ended[i] = True
                chunks.append(np.zeros(chunk_samples, np.complex64))
            else:
                chunks.append(np.frombuffer(raw, dtype=np.complex64))
        if all(ended):
            break
        trig.process_all(chunks)
        n += 1
        if n % refresh_every == 0:
            _emit(out, "status",
                  t=round(time.time() - t0, 1),
                  tracking_score=trig.tracking_score.tolist(),
                  tracking=trig.tracking.tolist(),
                  mean_psr=np.round(trig.mean_psr, 2).tolist(),
                  mean_cfo=np.round(trig.mean_cfo, 4).tolist(),
                  backlog=trig.backlog.tolist(),
                  cells=[[c.cell_id for c in s.cells()]
                         for s in trig.stores],
                  stages=_stages(trig))
    trig.flush()


def run_wideband(stream, sample_rate: float, centers,
                 psr_threshold: float = 4.0, chunk_samples: int = 0,
                 refresh_every: int = 10, out=sys.stdout, max_chunks=None,
                 transport: str = "i8", device="cuda") -> None:
    """ONE wideband source -> N monitored carriers (WidebandTrigger): one
    SDR and one upload stream replace N per-carrier pipes (the reference
    needs one process AND one SDR per carrier).  `stream` carries raw
    complex64 at `sample_rate` (an integer multiple of 1.92 MHz)."""
    from ..models.wideband import WidebandTrigger

    ratio = int(round(sample_rate / 1.92e6))
    if not chunk_samples:
        chunk_samples = 19200 * ratio          # one radio frame of band

    trig = WidebandTrigger(
        sample_rate, centers, psr_threshold=psr_threshold,
        transport=transport, device=device,
        on_track=lambda i, cell: _emit(out, "track", stream=i,
                                       center_offset_hz=centers[i],
                                       **cell.to_dict()),
        on_drop=lambda i, cell_id: _emit(out, "drop", stream=i,
                                         center_offset_hz=centers[i],
                                         cell_id=cell_id))
    n = 0
    t0 = time.time()
    while max_chunks is None or n < max_chunks:
        raw = stream.read(chunk_samples * 8)
        if not raw:
            break
        wide_chunk = np.frombuffer(raw, dtype=np.complex64)
        trig.process_wide(wide_chunk)
        n += 1
        if n % refresh_every == 0:
            _emit(out, "status",
                  t=round(time.time() - t0, 1),
                  psd_db=_psd_db(wide_chunk),     # whole-band waterfall line
                  centers_hz=centers,
                  tracking_score=trig.tracking_score.tolist(),
                  tracking=trig.tracking.tolist(),
                  mean_psr=np.round(trig.mean_psr, 2).tolist(),
                  mean_cfo=np.round(trig.mean_cfo, 4).tolist(),
                  backlog=trig.backlog.tolist(),
                  cells=[[c.cell_id for c in s.cells()]
                         for s in trig.stores],
                  stages=_stages(trig))
    trig.flush()


def main(argv=None) -> int:
    from ..utils.eng_notation import str_to_num

    p = argparse.ArgumentParser(prog="live_monitor")
    p.add_argument("sources", nargs="+",
                   help="'-' for stdin, or path(s) (FIFO / growing file) of "
                        "raw complex64 at 1.92 Msps; several paths monitor "
                        "several carriers through ONE device pipeline")
    p.add_argument("--threshold", type=float, default=4.0)
    p.add_argument("--chunk", type=int, default=0,
                   help="samples per read (default: one radio frame)")
    p.add_argument("--refresh", type=int, default=10,
                   help="status line every N chunks")
    p.add_argument("--transport", default=None,
                   choices=("f32", "i16", "i8", "i4"),
                   help="host->device sample encoding (default: i16, and i8 "
                        "for --wideband; i4: several sources or --wideband "
                        "only)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; fails if "
                        "CUDA is absent)")
    p.add_argument("--wideband", action="store_true",
                   help="the single source is a WIDE band; channelize on "
                        "device to --centers (one SDR, N carriers)")
    p.add_argument("-s", "--sample-rate", type=str, default="1.92M",
                   help="wideband input rate, eng notation (with "
                        "--wideband; integer multiple of 1.92M)")
    p.add_argument("--centers", type=str, default="0",
                   help="comma-separated carrier offsets from band center, "
                        "eng notation (with --wideband), e.g. "
                        "-5.76M,-1.92M,1.92M,5.76M")
    args = p.parse_args(argv)
    if args.wideband and len(args.sources) != 1:
        p.error("--wideband takes exactly one source")

    streams = [sys.stdin.buffer if s == "-" else open(s, "rb")
               for s in args.sources]
    common = dict(psr_threshold=args.threshold,
                  refresh_every=args.refresh, device=args.device,
                  out=sys.stdout)
    narrow = dict(common, chunk_samples=args.chunk or 19200,
                  transport=args.transport or "i16")
    try:
        if args.wideband:
            centers = [str_to_num(tok) for tok in args.centers.split(",")
                       if tok.strip()]
            run_wideband(streams[0], str_to_num(args.sample_rate), centers,
                         chunk_samples=args.chunk,
                         transport=args.transport or "i8", **common)
        elif len(streams) == 1:
            run(streams[0], **narrow)
        else:
            run_multi(streams, **narrow)
    except KeyboardInterrupt:
        pass
    finally:
        for st in streams:
            if st is not sys.stdin.buffer:
                st.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
