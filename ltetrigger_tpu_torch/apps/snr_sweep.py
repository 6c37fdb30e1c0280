#!/usr/bin/env python
"""Detection-probability-vs-SNR sweep.

The PyTorch port of ltetrigger_tpu/apps/snr_sweep.py, with the same records
and flags, plus `--device` (default cuda).  The whole sweep is ONE batched
scan: each (SNR point x noise trial) becomes a channel of the multi-channel
scan engine, so a 20-point, 8-trial curve is one `channel_scan` call.

The noise is drawn on the device from `torch.Generator(device).manual_seed(
seed)`.  It is not the JAX package's PRNG stream, and a card's generator
differs from the CPU's, so a curve is reproducible for one seed on one kind
of device and comparable between packages or devices only statistically.

Library use:
    from ltetrigger_tpu_torch.apps.snr_sweep import snr_sweep
    curve = snr_sweep(iq, sample_rate, snrs_db=range(-10, 11, 2), n_trials=8)

CLI:
    python -m ltetrigger_tpu_torch.apps.snr_sweep capture.iq -s 1.92M \\
        --snr-min -10 --snr-max 10 --snr-step 2 [--seconds 0.5] [--seed 0] \\
        [--trials 8] [--no-combine] [--fading] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _noisy_buffers(parts, gains, sigmas, generator):
    """Padded [C, LOOKBACK + N + WINDOW] scan buffers, made on the device:
    channel c carries sum_k gains[k][c] * parts[k] plus white noise of
    standard deviation sigmas[c] per component.

    parts: list of (re, im) pairs of [N] tensors; gains: list of [C] tensors
    (or None for 1); sigmas: [C] tensor; generator: a `torch.Generator` on
    the tensors' device, which the noise is drawn from (re first, then im)."""
    import torch

    from ..models import trigger as trig

    c = sigmas.shape[0]
    n = parts[0][0].shape[0]
    out = []
    for comp in (0, 1):
        buf = torch.zeros((c, trig.LOOKBACK + n + trig.WINDOW),
                          device=sigmas.device)
        body = buf[:, trig.LOOKBACK:trig.LOOKBACK + n]
        body.normal_(generator=generator)
        body.mul_(sigmas[:, None])
        for part, gain in zip(parts, gains):
            body.add_(part[comp][None] if gain is None
                      else gain[:, None] * part[comp][None])
        out.append(buf)
    return tuple(out)


def _on_device(x: np.ndarray, dev):
    from ..ops import cplx
    return cplx.from_numpy(x.astype(np.complex64), dev)


def snr_sweep(iq: np.ndarray, sample_rate: float, snrs_db,
              seconds: float = 0.5, psr_threshold: float = 4.0,
              seed: int = 0, n_trials: int = 1, combine: bool = True,
              channel_taps=None, device="cuda", mesh=None) -> list[dict]:
    """Detection stats per SNR point. SNR = signal power / noise power.

    n_trials > 1 runs that many independent noise realizations per SNR
    point (all as channels of one scan) and reports the detection
    probability.  combine=False disables MIB soft-combining across the
    40 ms PBCH TTI (stateless per-subframe decoding) for sensitivity A/B
    measurement.  channel_taps (list of (delay_samples, complex_gain))
    passes the signal through a static multipath channel before noise: SNR
    stays defined at the receiver (post-channel signal power is
    renormalized to 1).  Runs on `device` ("cuda" by default; raises if CUDA
    is absent); see the module docstring for what `seed` reproduces.  With
    a `parallel.Mesh` every rank calls it with the same arguments, builds
    the channels on `mesh.device` and scans its share of them
    (`channel_scan(mesh=)`); every rank returns the whole curve.
    """
    import torch

    from ..ltecore.constants import SAMPLE_RATE
    from ..models import api, trigger as trig
    from ..ops import resample
    from ..parallel import channel_scan

    dev = api.resolve_device(device if mesh is None else mesh.device)
    snrs_db = list(snrs_db)
    ratio = int(round(sample_rate / SAMPLE_RATE))
    d = resample.decimate(_on_device(iq, dev), ratio)
    base = (d[0].cpu().numpy() + 1j * d[1].cpu().numpy()) \
        .astype(np.complex64)
    total = int(seconds * SAMPLE_RATE)
    reps = -(-total // base.size)
    sig = np.tile(base, reps)[:total]
    if channel_taps is not None:
        from ..ltecore.synth import multipath_channel
        sig = multipath_channel(sig, channel_taps)
    sig = sig / np.sqrt(np.mean(np.abs(sig) ** 2) + 1e-30)

    # the noise is generated ON THE DEVICE: the host uploads one clean
    # signal (~MBs) instead of (n_snr x n_trials) noisy copies
    sigmas = np.repeat(
        np.sqrt(np.power(10.0, -np.asarray(snrs_db, np.float64) / 10.0)
                / 2.0), n_trials).astype(np.float32)
    buffers = _noisy_buffers(
        [_on_device(sig, dev)], [None], torch.from_numpy(sigmas).to(dev),
        torch.Generator(device=dev).manual_seed(seed))

    n_steps = total // trig.HALF_FRAME_LENGTH
    _, out = channel_scan(buffers, n_steps,
                          api.ensure_safe_threshold(psr_threshold),
                          mesh=mesh, combine=combine)

    host = trig.unpack_output(trig.pack_output(out))   # [steps, C, R] each
    results = []
    for i, snr_db in enumerate(snrs_db):
        lanes = slice(i * n_trials, (i + 1) * n_trials)
        ev = host.track_event[:, lanes, :]      # [steps, trials, R]
        det_per_trial = ev.any(axis=(0, 2))     # [trials]
        detected = bool(det_per_trial.any())
        rec = {
            "snr_db": float(snr_db),
            "detected": detected,
            "prob": float(det_per_trial.mean()),
            "n_trials": n_trials,
            "max_psr": float(host.psr[:, lanes, :].max()),
            "mean_psr": float(host.psr[:, lanes, :].mean()),
        }
        if detected:
            s, t, r = np.argwhere(ev)[0]
            rec["cell_id"] = int(host.cell_id[s, i * n_trials + t, r])
            rec["steps_to_detect"] = int(s)
        results.append(rec)
    return results


def pbch_sweep(pbch_rel_db, cell_id: int = 77, nof_prb_field: int = 50,
               n_ttis: int = 6, n_trials: int = 8,
               snr_sync_db: float = 0.0, psr_threshold: float = 4.0,
               seed: int = 0, combine: bool = True,
               device="cuda", mesh=None) -> list[dict]:
    """P(MIB publish) vs PBCH resource-element level, in the PBCH-LIMITED
    regime: PSS/SSS/CRS ride at `snr_sync_db` (default 0 dB, where
    acquisition always succeeds), and ONLY the PBCH REs are attenuated by
    `pbch_rel_db` (dB relative to nominal).  This isolates what the
    overall-SNR sweep cannot show: those curves are acquisition-limited, so
    MIB soft-combining across the 40 ms TTI can never move their knees.
    Here the publish decision IS the MIB decode.

    The stream cycles the true PBCH quarter sequence over `n_ttis` full
    TTIs (4 frames each, payload advancing per TTI), so combining has real
    40 ms structure to integrate.  combine=False is the stateless
    per-subframe decoder (same A/B as snr_sweep).

    Device shape: ONE scan over [n_points * n_trials] channels, built on
    `device` from two uploaded streams (the sync-only and the PBCH-only
    component; the PBCH level is a per-channel linear gain).  `mesh`: as in
    `snr_sweep`."""
    import torch

    from ..ltecore.synth import synthesize_frame_ports
    from ..models import api, trigger as trig
    from ..parallel import channel_scan

    dev = api.resolve_device(device if mesh is None else mesh.device)
    pbch_rel_db = list(pbch_rel_db)
    f0, f1 = [], []
    for f in range(4 * n_ttis):
        kw = dict(sfn=f, quarter=f % 4)
        f0.append(synthesize_frame_ports(cell_id, nof_prb_field,
                                         pbch_scale=0.0, **kw)[0])
        f1.append(synthesize_frame_ports(cell_id, nof_prb_field,
                                         pbch_scale=1.0, **kw)[0])
    s0 = np.concatenate(f0)
    d = np.concatenate(f1) - s0                  # the PBCH REs alone
    norm = np.sqrt(np.mean(np.abs(s0) ** 2))     # SAME scale for both parts
    s0, d = s0 / norm, d / norm
    sigma = float(np.sqrt(10.0 ** (-snr_sync_db / 10.0) / 2.0))
    gains = np.repeat(10.0 ** (np.asarray(pbch_rel_db, np.float64) / 20.0),
                      n_trials).astype(np.float32)

    buffers = _noisy_buffers(
        [_on_device(s0, dev), _on_device(d, dev)],
        [None, torch.from_numpy(gains).to(dev)],
        torch.full((gains.size,), sigma, device=dev),
        torch.Generator(device=dev).manual_seed(seed))

    n_steps = s0.size // trig.HALF_FRAME_LENGTH
    _, out = channel_scan(buffers, n_steps,
                          api.ensure_safe_threshold(psr_threshold),
                          mesh=mesh, combine=combine)

    host = trig.unpack_output(trig.pack_output(out))   # [steps, C, R] each
    results = []
    for i, rel_db in enumerate(pbch_rel_db):
        lanes = slice(i * n_trials, (i + 1) * n_trials)
        good = host.track_event[:, lanes, :] \
            & (host.cell_id[:, lanes, :] == cell_id)
        per_trial = good.any(axis=(0, 2))
        rec = {
            "pbch_rel_db": float(rel_db),
            "prob": float(per_trial.mean()),
            "n_trials": n_trials,
            "snr_sync_db": float(snr_sync_db),
        }
        if per_trial.any():
            rec["median_steps_to_publish"] = int(np.median(
                [np.argwhere(good[:, t, :])[0][0]
                 for t in range(n_trials) if good[:, t, :].any()]))
        results.append(rec)
    return results


def main(argv=None) -> int:
    from .cell_search_file import eng_float, filetype

    p = argparse.ArgumentParser(prog="snr_sweep")
    p.add_argument("filename", type=filetype)
    p.add_argument("-s", "--sample-rate", type=eng_float, required=True)
    p.add_argument("--snr-min", type=float, default=-10)
    p.add_argument("--snr-max", type=float, default=10)
    p.add_argument("--snr-step", type=float, default=2)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--threshold", type=eng_float, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trials", type=int, default=1)
    p.add_argument("--no-combine", action="store_true",
                   help="disable MIB soft-combining across the PBCH TTI")
    p.add_argument("--fading", action="store_true",
                   help="pass the signal through the default ETU-class "
                        "frequency-selective multipath profile before noise")
    p.add_argument("--device", default="cuda",
                   help="torch device to sweep on [default=%(default)s]")
    args = p.parse_args(argv)

    taps = None
    if args.fading:
        from ..ltecore.synth import default_port_channels
        taps = default_port_channels(1)[0]

    iq = np.fromfile(args.filename, dtype=np.complex64)
    snrs = np.arange(args.snr_min, args.snr_max + 1e-9, args.snr_step)
    curve = snr_sweep(iq, args.sample_rate, snrs, seconds=args.seconds,
                      psr_threshold=args.threshold, seed=args.seed,
                      n_trials=args.trials, combine=not args.no_combine,
                      channel_taps=taps, device=args.device)
    print(json.dumps(curve, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
