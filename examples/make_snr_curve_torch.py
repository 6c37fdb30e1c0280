#!/usr/bin/env python
"""The PyTorch port's detection-SNR curve: detection probability against
SNR, combine against single-subframe MIB decoding, at the operating points
where combining could matter end to end, written as `snr_curve_torch.json`
and `SNR_CURVE_torch.md` into `--out-dir` (default: the working directory).

The port's counterpart of examples/make_snr_curve.py, with its four
configurations (PSR threshold 4, the reference default, and 1.5, its
documented floor; AWGN and the default ETU-class fading profile), each
combine and single, through the port's `apps.snr_sweep.snr_sweep`, the
PBCH-limited pair through `pbch_sweep`, and the same markdown sections.

The stream is cell 123 (6 PRB, 1.92 Msps, unit power) from the port's
`ltecore.synth`, looped (`--capture PATH` reads a complex64 capture of that
cell instead).  A noise-free synthetic frame has its knee near -19 dB, so
the default SNR axis is lower than the JAX tool's, which was set around the
capture's knee.  The noise is drawn on the device (see apps/snr_sweep.py),
so a curve is reproducible for one seed on one kind of device.

    python examples/make_snr_curve_torch.py [--trials 8] [--step 1] \\
        [--device cuda] [--out-dir DIR]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from bench_sweep_torch import frame_iq  # noqa: E402

CONFIGS = [
    ("awgn_t4", 4.0, False),
    ("awgn_t1.5", 1.5, False),
    ("fading_t4", 4.0, True),
    ("fading_t1.5", 1.5, True),
]


def knee(curve):
    """Lowest SNR with prob >= 0.5 such that all higher SNRs also reach
    0.5 (monotone above)."""
    best = None
    for rec in sorted(curve, key=lambda r: -r["snr_db"]):
        if rec["prob"] >= 0.5:
            best = rec["snr_db"]
        else:
            break
    return best


def device_label(dev) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device's type."""
    if dev.type != "cuda":
        return dev.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def render(payload: dict) -> str:
    """SNR_CURVE_torch.md from the JSON payload."""
    knees, curves = payload["knee_db"], payload["curves"]
    pbch = payload["pbch_limited"]
    lines = [
        "# Detection probability vs SNR — combine vs single, AWGN vs fading",
        "",
        f"Device: {payload['device']}.  {payload['n_trials']} independent "
        "noise",
        f"realizations per point, {payload['seconds_per_trial']} s of looped "
        f"{payload['capture']}",
        "per trial, one batched scan per curve on the PyTorch port",
        "(ltetrigger_tpu_torch/apps/snr_sweep.py).  `combine` = MIB",
        "soft-combining across the 40 ms PBCH TTI; `single` = stateless",
        "per-subframe decoding.  Thresholds: 4 = reference default; 1.5 =",
        "the reference's documented floor (python/downlink_trigger_c.py:10).",
        "Fading = static 3-tap ETU-class frequency-selective profile",
        "(ltecore/synth.py, >6 dB in-band ripple).",
        "",
    ]
    for name, thresh, fading in CONFIGS:
        ck, sk = f"{name}_combine", f"{name}_single"
        lines += [f"## {name}  (threshold {thresh:g}, "
                  f"{'fading' if fading else 'AWGN'})", "",
                  "| SNR (dB) | P(detect), combine | P(detect), single |",
                  "|---|---|---|"]
        cs = {r["snr_db"]: r for r in curves[ck]}
        ss = {r["snr_db"]: r for r in curves[sk]}
        for snr in sorted(cs):
            lines.append(f"| {snr:g} | {cs[snr]['prob']:.2f} "
                         f"| {ss[snr]['prob']:.2f} |")
        lines += ["", f"Knee: combine **{knees[ck]} dB**, single "
                  f"**{knees[sk]} dB**.", ""]

    pk = pbch["knee_db"]
    lines += [
        "## pbch_limited  (sync at 0 dB, ONLY PBCH REs attenuated, "
        f"{pbch['n_ttis']} TTIs)", "",
        "The regime the overall-SNR sweeps cannot reach: acquisition always",
        "succeeds (PSS/SSS/CRS at 0 dB) and the publish decision is purely",
        "the MIB decode.  Axis = PBCH RE level relative to nominal",
        "(apps/snr_sweep.py::pbch_sweep; quarters cycle the true 40 ms TTI",
        "sequence, payload advancing per TTI).", "",
        "| PBCH level (dB rel) | P(publish), combine | P(publish), single |",
        "|---|---|---|"]
    pc = {r["pbch_rel_db"]: r for r in pbch["curves"]["pbch_combine"]}
    ps = {r["pbch_rel_db"]: r for r in pbch["curves"]["pbch_single"]}
    for x in sorted(pc):
        lines.append(f"| {x:g} | {pc[x]['prob']:.2f} | {ps[x]['prob']:.2f} |")
    gain = (f"**{pk['pbch_single'] - pk['pbch_combine']:g} dB**"
            if None not in (pk["pbch_single"], pk["pbch_combine"])
            else "an unresolved margin (a knee lies off the axis)")
    lines += ["", f"Knee: combine **{pk['pbch_combine']} dB**, "
              f"single **{pk['pbch_single']} dB** — the 40 ms",
              f"soft-combiner buys {gain} of PBCH sensitivity once",
              "acquisition is not the bottleneck.", ""]

    wins = [(n, knees[f"{n}_combine"], knees[f"{n}_single"])
            for n, _, _ in CONFIGS
            if knees[f"{n}_combine"] is not None
            and (knees[f"{n}_single"] is None
                 or knees[f"{n}_combine"] < knees[f"{n}_single"])]
    lines += ["## Interpretation", ""]
    if wins:
        for n, kc, ks in wins:
            lines.append(
                f"- **Combining wins end-to-end at `{n}`**: knee "
                f"{kc:g} dB vs {ks if ks is not None else 'no detection'} "
                "dB without combining.")
        lines.append("")
        lines.append("Where the knees are equal the limit is PSS "
                     "acquisition (the PSR hysteresis gate), not MIB "
                     "decoding — whenever PSS tracks, a single subframe "
                     "decodes.")
    else:
        lines += [
            "In the overall-SNR sweeps the combine and single knees are",
            "equal at every operating point — the end-to-end detection",
            "limit there is PSS acquisition (the PSR hysteresis gate), not",
            "MIB decoding; whenever PSS tracks, a single subframe decodes.",
            "The `pbch_limited` section above is the controlled regime",
            "where the decode IS the limit, and there the TTI soft-combiner",
            "shows its gain — srsLTE's own 4-frame combining (reference",
            "lib/mib_impl.cc:75-76,162) exists for exactly this",
            "interference/coverage-limited case.",
        ]
    lines += ["", f"(first device sync paid before measurement: "
              f"{payload['first_sync_s']:.3f} s)"]
    return "\n".join(lines) + "\n"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trials", type=int, default=8)
    p.add_argument("--snr-min", type=float, default=-26)
    p.add_argument("--snr-max", type=float, default=0)
    p.add_argument("--step", type=float, default=1)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--capture", default=None)
    p.add_argument("--out-dir", default=".")
    args = p.parse_args(argv)

    import torch

    from ltetrigger_tpu_torch.apps.snr_sweep import pbch_sweep, snr_sweep
    from ltetrigger_tpu_torch.ltecore.synth import default_port_channels
    from ltetrigger_tpu_torch.ops.device import resolve_device

    dev = resolve_device(args.device)
    iq = frame_iq(args.capture)
    snrs = np.arange(args.snr_min, args.snr_max + 1e-9, args.step)
    taps = default_port_channels(1)[0]

    t0 = time.perf_counter()
    torch.ones(8, device=dev).sum().item()          # the first device sync
    stall = time.perf_counter() - t0

    curves = {}
    for name, thresh, fading in CONFIGS:
        for combine in (True, False):
            key = f"{name}_{'combine' if combine else 'single'}"
            curves[key] = snr_sweep(iq, 1.92e6, snrs, seconds=args.seconds,
                                    psr_threshold=thresh,
                                    n_trials=args.trials, combine=combine,
                                    channel_taps=taps if fading else None,
                                    device=dev)
            print(key, "knee:", knee(curves[key]), flush=True)

    # the PBCH-LIMITED regime: sync pinned at 0 dB, ONLY the PBCH REs
    # attenuated, 6 full TTIs of exposure (where TTI soft-combining CAN show
    # a gain: the overall-SNR curves above are acquisition-limited)
    pbch_axis = list(np.arange(-36.0, -17.9, 1.5))
    pbch_curves = {}
    for combine in (True, False):
        key = f"pbch_{'combine' if combine else 'single'}"
        pbch_curves[key] = pbch_sweep(pbch_axis, n_ttis=6,
                                      n_trials=args.trials, combine=combine,
                                      device=dev)
        print(key, "knee:", knee([{"snr_db": r["pbch_rel_db"],
                                   "prob": r["prob"]}
                                  for r in pbch_curves[key]]), flush=True)

    payload = {
        "device": device_label(dev),
        "capture": (os.path.basename(args.capture) if args.capture else
                    "synthetic 6-PRB frame of cell 123") +
                   " (looped, unit signal power)",
        "seconds_per_trial": args.seconds,
        "n_trials": args.trials,
        "fading_taps": [[d, [g.real, g.imag]] for d, g in taps],
        "knee_db": {k: knee(v) for k, v in curves.items()},
        "curves": curves,
        "pbch_limited": {
            "knee_db": {k: knee([{"snr_db": r["pbch_rel_db"],
                                  "prob": r["prob"]} for r in v])
                        for k, v in pbch_curves.items()},
            "curves": pbch_curves, "n_ttis": 6, "snr_sync_db": 0.0},
        "first_sync_s": stall,
    }
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "snr_curve_torch.json"), "w") as f:
        json.dump(payload, f, indent=2)
    text = render(payload)
    with open(os.path.join(args.out_dir, "SNR_CURVE_torch.md"), "w") as f:
        f.write(text)
    print(text)
    return payload


if __name__ == "__main__":
    main()
