"""Driver of the band sweeps: `apps.wideband_scan.scan_band` over a wide
capture in host memory, channelized to every EARFCN of a band and scanned
at once, each call from fresh state; then the app's own record builder,
`scan_records`.

Configuration: sample_rate, center_hz, first_hz, raster_hz, earfcn [first,
last], band_hz [lo, hi], seconds (the capture's length), pool (distinct
captures cycled), psr_threshold, track_after, track_every.  Tests at a small
size on the CPU may set `neighbours`: then only each carrier's raster point
and this many on each side are scanned.
The window calls back to back over the pool; the timed call takes the
capture as a numpy complex64 array in pageable host memory, so the upload,
the channelizer, `channel_scan` and the readback are all inside it.
`scan_msps` counts the wide capture's samples.  A sample of the calls drawn
from the seed, with the last call, is kept and held to the reference after
the window (`reference.band` for the lanes, then `reference.passab`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ltebench import band_trace, slices
from ltebench.gen import band as bandgen, traffic as gen
from ltebench.gen.cells import LOOKBACK, WINDOW
from ltebench.reference import band as refband, check as refcheck, passab

HALF_FRAME = 9600
SENSING_RATE = 1_920_000
KEEP = 4            # calls kept for the check, besides the last one


def _num(value, limit) -> dict:
    return {"value": float(value), "limit": float(limit)}


def _centres(cfg: dict, carriers: list) -> list:
    """The raster indices one capture scans: every point of the band, or
    (`neighbours`) each carrier's and its neighbours'."""
    n = cfg["earfcn"][1] - cfg["earfcn"][0] + 1
    if "neighbours" not in cfg:
        return list(range(n))
    k = int(cfg["neighbours"])
    return sorted({j for c in carriers
                   for j in range(c["earfcn_index"] - k,
                                  c["earfcn_index"] + k + 1) if 0 <= j < n})


def setup(ctx: dict) -> dict:
    # the program's entry points first: a program without them fails here,
    # before any input is made
    from ltetrigger_tpu_torch.apps.wideband_scan import (scan_band,
                                                          scan_records)

    cfg, mix, dev = ctx["config"], ctx["traffic"], ctx["device"]
    rate, seconds = float(cfg["sample_rate"]), float(cfg["seconds"])
    n_wide = int(round(seconds * rate))
    rng = gen.rng_for(ctx["seed"])
    carriers = bandgen.draw_carriers(mix, cfg, rng, int(cfg["pool"]))
    offsets = bandgen.raster(cfg)
    index = [_centres(cfg, cs) for cs in carriers]
    centres = [[float(offsets[k]) for k in ix] for ix in index]
    pool = [bandgen.capture(cs, n_wide, rate, ctx["seed"], dev, salt=b)
            for b, cs in enumerate(carriers)]
    fault = ctx.get("fault")
    # the control: the program is handed the capture rounded to bf16
    fed = pool if fault != "bf16_capture" else [
        np.ascontiguousarray(torch.complex(
            torch.from_numpy(p.real.copy()).bfloat16().float(),
            torch.from_numpy(p.imag.copy()).bfloat16().float()).numpy())
        for p in pool]

    thr = float(cfg["psr_threshold"])
    kw = dict(track_after=int(cfg["track_after"]),
              track_every=int(cfg["track_every"]))

    def call(b: int):
        cs = centres[b]
        if fault == "half_batch":       # half of the centres left out
            cs = cs[:len(cs) // 2]
        lanes, states, host = scan_band(fed[b], rate, cs, seconds=seconds,
                                        psr_threshold=thr, device=dev, **kw)
        records = scan_records(host, cs)
        if fault == "half_batch":
            pad = len(centres[b]) - len(cs)
            host = type(host)(*(np.concatenate(
                [a, np.zeros(a.shape[:1] + (pad,) + a.shape[2:], a.dtype)],
                axis=1) for a in host))
            states = states._replace(peak=torch.cat(
                [states.peak, torch.full((pad,) + states.peak.shape[1:], -1,
                                         dtype=states.peak.dtype,
                                         device=states.peak.device)]))
        elif fault == "state_unchanged":    # every step repeats step 0
            host = type(host)(*(np.repeat(a[:1], a.shape[0], axis=0)
                                for a in host))
        elif fault == "answer_altered":     # a published id off by one
            cid = host.cell_id.copy()
            cid[host.track_event] = (cid[host.track_event] + 1) % 504
            host = host._replace(cell_id=cid)
        return lanes, states, host, records

    for b in range(len(pool)):      # every shape the window uses, built
        call(b)
    slices.sync_fn(dev)()
    return dict(pool=pool, carriers=carriers, index=index, centres=centres,
                call=call, n_wide=n_wide, rate=rate,
                steps=int(seconds * SENSING_RATE) // HALF_FRAME, thr=thr,
                kw=kw)


def window(ctx: dict, st: dict) -> dict:
    dev, seconds = ctx["device"], ctx["seconds"]
    call = st["call"]
    sync = slices.sync_fn(dev)
    sl = band_trace.Slice(ctx["trace"], 0.4 * seconds,
                          min(2.0, 0.25 * seconds), sync)
    rng = gen.rng_for(ctx["seed"], 7)
    kept, seen = [], 0
    lanes_of = {}       # the latest lanes of each capture, for the check
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    calls = 0
    call_s = []
    while True:
        now = time.perf_counter() - t0
        if not sl.open_until(now, seconds):
            break
        sl.step(now)
        b = calls % len(st["pool"])
        lanes_of.pop(b, None)   # an older call's lanes of this capture go
        c0 = time.perf_counter()
        with slices.span("ltebench.band_call"):
            lanes, states, host, _ = call(b)
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
        last = (b, host, states.peak.cpu())
        lanes_of[b] = lanes
        del lanes, states
        calls += 1
    t1 = time.perf_counter()
    sl.close()
    kept.append(last)
    info = dict(calls=calls, **slices.quantiles_ms("call", call_s))
    st.update(kept=kept, lanes=lanes_of, slice_result=sl.result,
              call_s=call_s, calls=calls, info=info)
    return dict(scan_msps=calls * st["n_wide"] / (t1 - t0) / 1e6,
                setup_s=setup_s, attempted=calls, failed=0,
                window_s=t1 - t0, info=info)


def free(ctx: dict, st: dict) -> None:
    """The program's state goes (the latest lanes of each capture stay for
    the check); the inputs (the benchmark's own) stay."""
    st.pop("call", None)
    if ctx["device"].type == "cuda":
        torch.cuda.empty_cache()


def check(ctx: dict, st: dict, limits: dict) -> dict:
    """The capture scans' numbers (`reference.check`) over every scanned
    centre of the kept calls, each centre's planted cell its carrier or
    none, and `chan_rel_err`: the latest lanes of each capture (the last
    call's among them) against the reference channelizer's, the largest
    relative L2 error of any centre.  Pass A's reference reads the
    reference lanes in bf16, with the program's rounding at ties
    (`reference.band.pass_a_inputs`)."""
    dev = ctx["device"]
    cfg = ctx["config"]
    tie = float(limits["psr_rel_gap"])
    total = st["steps"] * HALF_FRAME
    lanes_of = st.pop("lanes")
    t0 = time.perf_counter()
    gap = mism = peak_bad = wrong = missed = ties = undue = tracked = 0
    round_ties = reach = 0
    err = 0.0
    for b in sorted({k[0] for k in st["kept"]}):
        x = torch.from_numpy(st["pool"][b]).to(dev)
        ref = refband.lanes(x, st["rate"], st["centres"][b],
                            st["n_wide"] // (round(st["rate"])
                                             // SENSING_RATE))
        del x
        got = lanes_of.pop(b, None)
        if got is not None:
            err = max(err, float(refband.rel_err(got, ref).max()))
        (re, im), rt = refband.pass_a_inputs(ref, got, total,
                                             float(limits["chan_rel_err"]))
        round_ties += rt
        del ref, got
        re, im = (torch.nn.functional.pad(part, (LOOKBACK, WINDOW))
                  for part in (re, im))
        power = passab.correlation_power(re, im, LOOKBACK, st["steps"],
                                         cfg["precision"]["pass_a"])
        del re, im
        cells = bandgen.centre_cells(st["carriers"][b],
                                     len(st["index"][b]), st["index"][b])
        for kb, host, peak in st["kept"]:
            if kb != b:
                continue
            r = passab.pass_b(
                lambda t: power[:, t], st["steps"], (len(cells),),
                power.device, st["thr"], st["kw"]["track_after"],
                st["kw"]["track_every"],
                port_over=torch.from_numpy(host.score > 0).to(power.device),
                tie_rel=tie)
            g, m = refcheck.pass_ab_numbers(host.psr, host.score,
                                            host.tracking, r)
            gap, mism = max(gap, g), mism + m
            ties += int(r["ties"].sum())
            trk = r["tracking"][-1].cpu().numpy()
            peak_bad += int(((peak.numpy() != r["peak"].cpu().numpy())
                             & trk).sum())
            due = refcheck.due_cells(cells, r["tracking"])
            w, ms = refcheck.scan_events(host, cells, due)
            wrong, missed = wrong + w, missed + ms
            undue += sum(c["cell_id"] >= 0 for c in cells) - sum(due)
            ever = r["tracking"].any(dim=0).any(dim=-1).cpu().numpy()
            own = [c["earfcn_index"] for c in st["carriers"][b]]
            for c, cell in enumerate(cells):
                if cell["cell_id"] < 0 and ever[c]:
                    tracked += 1
                    reach = max(reach, min(abs(st["index"][b][c] - k)
                                           for k in own))
        del power
    st["ties"], st["undue"] = ties, undue
    # lanes that the reference tracks (and the program with it: no state
    # mismatch) at no carrier's raster point, and the farthest of them from
    # a carrier's, in raster points; unpublished, or `wrong_events` says so
    st["info"].update(tracked_elsewhere=tracked,
                      tracked_elsewhere_reach=reach, round_ties=round_ties,
                      check_s=time.perf_counter() - t0)
    return {"psr_rel_gap": _num(gap, limits["psr_rel_gap"]),
            "state_mismatch": _num(mism, limits["state_mismatch"]),
            "peak_mismatch": _num(peak_bad, limits["peak_mismatch"]),
            "wrong_events": _num(wrong, limits["wrong_events"]),
            "missed": _num(missed, limits["missed"]),
            "chan_rel_err": _num(err, limits["chan_rel_err"])}
