#!/usr/bin/env python
"""What the time-sharded scan's seams cost, on the PyTorch port: detection
probability near the knee, the continuous scan of a stream against the
`time_sharded_scan` of the same noisy stream over the process mesh.

The port's counterpart of examples/seam_sweep.py.  `time_sharded_scan` does
not carry the trigger's state across the `t` axis's seams (each block
acquires on its own; parallel/sharded.py says why), so the EMA'd power and
the TTI soft-combining restart at every seam.  This measures that cost:
the same noise realisations through `parallel.channel_scan` (one channel,
the whole stream) and through `parallel.time_sharded_scan` over `t` = the
number of ranks, signal present throughout so every seam cuts it.

The stream is cell 123 (6 PRB, 1.92 Msps, unit power) from the port's
`ltecore.synth`, looped; `--capture PATH` reads a complex64 capture of that
cell instead.  A noise-free synthetic frame has its knee near -19 dB; the
capture's lies higher.

    torchrun --nproc-per-node=4 examples/seam_sweep_torch.py [--trials 16]
    python examples/seam_sweep_torch.py --ranks 4 --backend gloo [...]

`--ranks N` spawns N local ranks itself (ranks that share one card need
gloo); without it and without torchrun the world is this one process (t =
1).  `--device` defaults to cuda and raises where there is no card.  Every
rank draws the same seeded noise; rank 0 prints a JSON line per SNR and the
summary line (with `n_shards` and `launches_by_kernel`, every hand
kernel's launches on rank 0: "mf", "pb", "tti", "vit", "ring", "chan",
"front") as its last.
"""

import argparse
import json
import os
import socket
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from bench_sweep_torch import CELL_ID, frame_iq  # noqa: E402


def seam_sweep(snrs_db, mesh, n_trials: int = 16, steps_per_shard: int = 12,
               psr_threshold: float = 4.0, seed: int = 0,
               iq: np.ndarray | None = None) -> list:
    """-> per SNR {snr_db, p_continuous, p_sharded, n_trials} over the same
    noise.  A collective over `mesh` (`t` = its time axis): every rank
    calls it with the same arguments and gets the same records."""
    from ltetrigger_tpu_torch.models import trigger as trig
    from ltetrigger_tpu_torch.parallel import channel_scan, time_sharded_scan

    n_shards = mesh.shape["t"]
    iq = frame_iq() if iq is None else iq
    block = steps_per_shard * trig.HALF_FRAME_LENGTH
    total = n_shards * block
    sig = np.tile(iq, -(-total // iq.size))[:total]
    sig = sig / np.sqrt(np.mean(np.abs(sig) ** 2))
    zh = np.zeros((1, trig.LOOKBACK), np.float32)
    zt = np.zeros((1, trig.WINDOW), np.float32)

    rng = np.random.default_rng(seed)
    out = []
    for snr_db in snrs_db:
        sigma = float(np.sqrt(10.0 ** (-snr_db / 10.0) / 2.0))
        det_c, det_s = 0, 0
        for _ in range(n_trials):
            noisy = (sig + sigma * (rng.normal(size=total)
                                    + 1j * rng.normal(size=total))) \
                .astype(np.complex64)
            pair = (np.ascontiguousarray(noisy.real, np.float32),
                    np.ascontiguousarray(noisy.imag, np.float32))
            # continuous: one channel through the same engine
            buf = tuple(np.concatenate([zh, c[None], zt], axis=1)
                        for c in pair)
            _, oc = channel_scan(buf, total // trig.HALF_FRAME_LENGTH,
                                 psr_threshold, device=mesh.device)
            det_c += bool((oc.track_event & (oc.cell_id == CELL_ID)).any())
            # sharded: the same samples through the t axis
            os_ = time_sharded_scan(pair, mesh, psr_threshold)
            det_s += bool((os_.track_event & (os_.cell_id == CELL_ID)).any())
        out.append({"snr_db": float(snr_db),
                    "p_continuous": det_c / n_trials,
                    "p_sharded": det_s / n_trials,
                    "n_trials": n_trials})
        if mesh.coords["t"] == 0 and mesh.coords["ch"] == 0:
            print(json.dumps(out[-1]), flush=True)
    return out


def knee(xs, key):
    best = None
    for r in sorted(xs, key=lambda r: -r["snr_db"]):
        if r[key] >= 0.5:
            best = r["snr_db"]
        else:
            break
    return best


def _run(args) -> dict:
    """This rank's sweep on a (1, world) mesh; rank 0 prints the summary."""
    import torch

    from ltetrigger_tpu_torch.parallel import make_mesh

    from ltetrigger_tpu_torch.ops.kernels import launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    world = torch.distributed.get_world_size() \
        if torch.distributed.is_initialized() else 1
    mesh = make_mesh(1, world, device=args.device)
    snrs = list(np.arange(args.snr_min, args.snr_max + 1e-9, args.step))
    res = seam_sweep(snrs, mesh, n_trials=args.trials,
                     steps_per_shard=args.steps_per_shard, seed=args.seed,
                     iq=frame_iq(args.capture))
    summary = {"knee_continuous_db": knee(res, "p_continuous"),
               "knee_sharded_db": knee(res, "p_sharded"),
               "n_shards": world, "launches_by_kernel": launch_counts(),
               "curve": res}
    if mesh.coords["t"] == 0:
        print(json.dumps(summary), flush=True)
    return summary


def _rank(rank: int, args, port: int) -> None:
    """One spawned rank (`--ranks`)."""
    import torch
    import torch.distributed as dist

    from ltetrigger_tpu_torch.parallel import init_distributed

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.ranks))
    init_distributed(f"127.0.0.1:{port}", args.ranks, rank,
                     device=args.device, backend=args.backend, timeout=300)
    try:
        _run(args)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trials", type=int, default=16)
    p.add_argument("--snr-min", type=float, default=-22)
    p.add_argument("--snr-max", type=float, default=-16)
    p.add_argument("--step", type=float, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps-per-shard", type=int, default=12)
    p.add_argument("--ranks", type=int, default=None,
                   help="spawn this many local ranks [default: torchrun's "
                        "world, or this process alone]")
    p.add_argument("--backend", default=None,
                   help="gloo or nccl [default: nccl on cards, gloo on the "
                        "CPU]")
    p.add_argument("--device", default="cuda")
    p.add_argument("--capture", default=None)
    args = p.parse_args(argv)

    from ltetrigger_tpu_torch.ops.device import resolve_device
    resolve_device(args.device)
    if args.ranks is not None:
        import torch.multiprocessing as mp
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        mp.start_processes(_rank, args=(args, port), nprocs=args.ranks,
                           start_method="spawn")
        return None
    if "RANK" in os.environ:                    # under torchrun
        import torch.distributed as dist

        from ltetrigger_tpu_torch.parallel import init_distributed
        init_distributed(device=args.device, backend=args.backend)
        try:
            return _run(args)
        finally:
            dist.destroy_process_group()
    return _run(args)


if __name__ == "__main__":
    main()
