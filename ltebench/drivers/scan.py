"""Driver of the capture scans: `parallel.sharded.channel_scan` over a
batch of C channel captures held on the card, each call from fresh state
and ending in the host readback `trigger.unpack_output(
trigger.pack_output(out))` that `apps/wideband_scan` uses.

Configuration: channels, steps (half-frames a capture), pool (distinct
batches cycled), psr_threshold, track_after, track_every.
The window calls back to back over the pool; `scan_msps` is every call's
samples over the window's wall time.  A sample of the calls drawn from the
seed, with the last call, is kept and held to the reference after the
window (`reference.check.scan_checks`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ltebench import slices
from ltebench.gen import traffic as gen
from ltebench.reference import check as refcheck

HALF_FRAME = 9600
KEEP = 4            # calls kept for the check, besides the last one


def setup(ctx: dict) -> dict:
    cfg, mix, dev = ctx["config"], ctx["traffic"], ctx["device"]
    c, steps = int(cfg["channels"]), int(cfg["steps"])
    rng = gen.rng_for(ctx["seed"])
    cells = [gen.draw_cells(mix, rng, c) for _ in range(int(cfg["pool"]))]
    pool = [gen.capture_batch(cb, steps * HALF_FRAME, ctx["seed"], dev,
                              salt=b) for b, cb in enumerate(cells)]

    from ltetrigger_tpu_torch.models import trigger as trig
    from ltetrigger_tpu_torch.parallel.sharded import channel_scan

    thr = float(cfg["psr_threshold"])
    kw = dict(track_after=int(cfg["track_after"]),
              track_every=int(cfg["track_every"]))
    fault = ctx.get("fault")

    def call(b: int):
        buffers = pool[b]
        if fault == "half_batch":       # half of the channels left out
            half = c // 2
            buffers = tuple(x[:half] for x in buffers)
        states, out = channel_scan(buffers, steps, thr, device=dev, **kw)
        host = trig.unpack_output(trig.pack_output(out))
        if fault == "half_batch":
            host = type(host)(*(np.concatenate(
                [a, np.zeros_like(a)], axis=1) for a in host))
            states = states._replace(peak=torch.cat(
                [states.peak, torch.full_like(states.peak, -1)]))
        elif fault == "state_unchanged":    # every step repeats step 0
            host = type(host)(*(np.repeat(a[:1], a.shape[0], axis=0)
                                for a in host))
        elif fault == "answer_altered":     # a published id off by one
            cid = host.cell_id.copy()
            cid[host.track_event] = (cid[host.track_event] + 1) % 504
            host = host._replace(cell_id=cid)
        return states, host

    for b in range(len(pool)):      # every shape the window uses, built
        call(b)
    slices.sync_fn(dev)()
    return dict(pool=pool, cells=cells, call=call, trig=trig, steps=steps,
                channels=c, thr=thr, kw=kw)


def window(ctx: dict, st: dict) -> dict:
    dev, seconds = ctx["device"], ctx["seconds"]
    trig, call = st["trig"], st["call"]
    sync = slices.sync_fn(dev)
    sl = slices.Slice(ctx["trace"], 0.4 * seconds, min(2.0, 0.25 * seconds),
                      sync)
    rng = gen.rng_for(ctx["seed"], 7)
    kept, seen = [], 0
    syncs0 = sum(trig.host_syncs.values())
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    calls = 0
    call_s = []
    cpu0 = time.thread_time()
    while True:
        now = time.perf_counter() - t0
        if not sl.open_until(now, seconds):
            break
        sl.step(now)
        b = calls % len(st["pool"])
        c0 = time.perf_counter()
        with slices.span("ltebench.scan_call"):
            states, host = call(b)
        call_s.append(time.perf_counter() - c0)
        sl.count()
        # reservoir sample of the calls, from the seed
        seen += 1
        if len(kept) < KEEP:
            kept.append((b, host, states.peak.cpu()))
        else:
            j = int(rng.integers(0, seen))
            if j < KEEP:
                kept[j] = (b, host, states.peak.cpu())
        last = (b, host, states)
        calls += 1
    t1 = time.perf_counter()
    cpu = time.thread_time() - cpu0
    sl.close()
    b, host, states = last
    kept.append((b, host, states.peak.cpu()))
    st.update(kept=kept, slice_result=sl.result, call_s=call_s,
              syncs=sum(trig.host_syncs.values()) - syncs0, calls=calls)
    samples = calls * st["channels"] * st["steps"] * HALF_FRAME
    return dict(scan_msps=samples / (t1 - t0) / 1e6, setup_s=setup_s,
                attempted=calls, failed=0, window_s=t1 - t0,
                info=dict(calls=calls, thread_cpu_share=cpu / (t1 - t0),
                          **slices.quantiles_ms("call", call_s)))


def free(ctx: dict, st: dict) -> None:
    """The program's state goes; the inputs (the benchmark's own) stay."""
    st.pop("call", None)
    if ctx["device"].type == "cuda":
        torch.cuda.empty_cache()


def check(ctx: dict, st: dict, limits: dict) -> dict:
    return refcheck.scan_checks(ctx, st, limits)
