"""Driver of the live band monitor cells: `models.wideband.WidebandTrigger`
fed chunks of one wide loop held in host memory, closed loop on the main
thread, through the pipeline's own calls `process_wide` and `poll`.

Configuration: sample_rate (the wide rate), center_hz, first_hz,
raster_hz, earfcn [first, last], band_hz, chunk_samples (wide),
loop_seconds, transport, pipeline, cfo_search_range, psr_threshold,
track_after, track_every.  The mix gives the carriers and their roles
(`gen/wideband.py`).  Tests at a small size on the CPU may set
`neighbours`: then only each carrier's raster point and this many on each
side are monitored (as the band sweep's driver does); and `min_feeds`: then
the window closes no sooner than that many feeds, so that a loaded host
reaches what the window has to reach (the faults, a keyed carrier's
events).

Set-up makes the loop from the seed and builds the trigger with an
`on_output` hook that keeps every drained dispatch
(`reference.monitor.Record`).  It warms up first with each scan depth (4,
8, 16 and 32 steps), asked for once by one `process_wide` of that many
half-frames and one chunk more, the feeding rule going on until each has
been harvested and `SETTLE` chunks more have been fed; then it reads the
mirror once (`resident_lanes`, while it still holds stream position 0: the
first upload and a deep dispatch's remainder start off the block grid that
the 10-ms chunks keep, so their lanes differ from the later loops' in the
last bit, and the check takes the first steps from this read); then the
feeding rule goes on for at least one whole loop and until the steady
carrier is published at its raster point; all within `monitor.WARM_LOOPS`
loops.  The window feeds the next chunk (`process_wide`) while min(backlog)
is at most `monitor.BACKLOG_CAP` narrow samples and calls `poll()`
otherwise, as a source that blocks on a full buffer.
`scan_msps` counts the wide samples of the half-frame steps whose outputs
were harvested inside the window (steps x 9600 x ratio), over the window's
wall time, as the band sweep counts wide samples: real time is the wide
rate.  `real_time_factor` and `thread_cpu_share` (the main thread's CPU
time over the window's wall time) are under `info`.  After the window a
flush drains what is in flight.  Once the peak memory has been read, the
lanes the mirror holds are read (`resident_lanes`), feeding on until the
reads hold the whole loop (`free`; `reads_differ` under `info` counts the
samples two reads hold otherwise, 0 where the lanes repeat with the loop),
and every harvested step from stream position 0, those after the window
included, is held to the plain reference (`reference.wideband`) with the
program's last peak.

A program without the hook, `api.stream_counts` or
`WidebandTrigger.resident_lanes` cannot run the cell: set-up raises before
any input is made (the check takes the program's rounding of the lanes at
bf16 ties from those reads, `reference.wideband`).  Faults (tests of the
check), each armed when the window opens and counted under `info["fired"]`
where it changed something: "chunk_skipped" (one chunk of the wide stream
is never fed), "centres_swapped" (the outputs of the steady carrier's
centre and the next one swapped), "answer_altered" (every published or
retracted id off by one).  The control (`control_wideband.py`) feeds the
program the wide stream rounded to bf16 ("bf16_stream"); the reference
reads it as made.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ltebench import slices, wide_trace
from ltebench.drivers import band as banddrv, monitor as mondrv
from ltebench.gen import band as bandgen, wideband as widegen
from ltebench.reference import monitor as refmon, wideband as refwide

HALF_FRAME = mondrv.HALF_FRAME
SENSING_RATE = 1_920_000
CENTRES_AT_ONCE = 57        # the check's lanes a block on a card
READS = 32                  # reads of the mirror after the window, at most
SETTLE = 8                  # feeds after the deep dispatches, then a read


def _program():
    """(api, WidebandTrigger) of a program that has the hook, the counters
    and the mirror's accessor."""
    api, _ = mondrv._program()
    from ltetrigger_tpu_torch.models.wideband import WidebandTrigger
    if not hasattr(WidebandTrigger, "resident_lanes"):
        raise RuntimeError("this program's WidebandTrigger has no "
                           "resident_lanes: the check cannot read its "
                           "lanes, so it cannot run the live band cells")
    return api, WidebandTrigger


def _step(trig, feed: mondrv._Feed) -> bool:
    """One turn of the feeding rule: True if it fed, False if it polled."""
    if trig.backlog.min() > mondrv.BACKLOG_CAP:
        trig.poll()
        return False
    trig.process_wide(feed.next()[0])
    return True


def _hook(rec: refmon.Record, fault, published: set, swap: tuple,
          faulty: dict):
    """The hook the trigger calls: notes the centres with a track event in
    `published` (for the warm-up), then applies the fault once the window
    has set faulty["armed"], counting in faulty["fired"] the outputs it
    changed."""

    def on_output(host, pos_before):
        published.update(np.nonzero(host.track_event.any(axis=(0, 2)))[0]
                         .tolist())
        if faulty["armed"] and fault == "centres_swapped":
            order = list(range(host.psr.shape[1]))
            order[swap[0]], order[swap[1]] = swap[1], swap[0]
            host = type(host)(*(a[:, order] for a in host))
            faulty["fired"] += 1
        elif faulty["armed"] and fault == "answer_altered" \
                and (host.track_event.any() or host.drop_event.any()):
            cid, did = host.cell_id.copy(), host.drop_cell_id.copy()
            cid[host.track_event] = (cid[host.track_event] + 1) % 504
            did[host.drop_event] = (did[host.drop_event] + 1) % 504
            host = host._replace(cell_id=cid, drop_cell_id=did)
            faulty["fired"] += 1
        rec(host, pos_before)

    return on_output


def setup(ctx: dict) -> dict:
    # the program's entry points first: a program without them fails here,
    # before any input is made
    api, WidebandTrigger = _program()
    cfg, mix, dev = ctx["config"], ctx["traffic"], ctx["device"]
    rate = float(cfg["sample_rate"])
    ratio = int(round(rate / SENSING_RATE))
    g0 = time.perf_counter()
    carriers = widegen.draw(mix, cfg, ctx["seed"])
    index = banddrv._centres(cfg, carriers)
    offsets = [float(f) for f in bandgen.raster(cfg)[index]]
    cells = bandgen.centre_cells(carriers, len(index), index)
    loop = widegen.loop(carriers, cfg, mix, ctx["seed"], dev)
    gen_s = time.perf_counter() - g0
    steady = {i for i, c in enumerate(cells)
              if c.get("role") == "steady"}
    # the fault swaps the steady carrier's centre with the next one
    s0 = min(steady)
    swap = (s0, s0 + 1 if s0 + 1 < len(index) else s0 - 1)
    rec = refmon.Record()
    published, faulty = set(), dict(armed=False, fired=0)
    trig = WidebandTrigger(
        rate, offsets, transport=cfg["transport"],
        psr_threshold=float(cfg["psr_threshold"]),
        track_after=int(cfg["track_after"]),
        track_every=int(cfg["track_every"]), pipeline=int(cfg["pipeline"]),
        cfo_search_range=int(cfg["cfo_search_range"]), device=dev,
        on_output=_hook(rec, ctx.get("fault"), published, swap, faulty))
    # the control: the program is fed the wide stream rounded to bf16
    fed = loop if ctx.get("fault") != "bf16_stream" else \
        np.ascontiguousarray(torch.from_numpy(loop.view(np.float32).copy())
                             .bfloat16().float().numpy().view(np.complex64))
    feed = mondrv._Feed(fed[None], int(cfg["chunk_samples"]))
    length = loop.size
    w0 = time.perf_counter()
    chunk_hf = int(cfg["chunk_samples"]) // ratio // HALF_FRAME
    asked, early, settled = set(), None, 0
    while feed.fed < mondrv.WARM_LOOPS * length:
        depths = {rows for _, _, rows in rec.harvests}
        if early is None and settled >= SETTLE:
            first, re, im = trig.resident_lanes()
            early = (first, re.cpu(), im.cpu())
            del re, im
        if early is not None and feed.fed >= length and steady <= published:
            break
        ask = [d for d in mondrv.DEPTHS if d not in depths | asked]
        if ask:
            asked.add(ask[0])
            trig.process_wide(feed.next(-(-ask[0] // chunk_hf) + 1)[0])
            continue
        settled += _step(trig, feed) and set(mondrv.DEPTHS) <= depths
    if early is None:
        raise RuntimeError("the warm-up ended before the mirror was read")
    slices.sync_fn(dev)()
    return dict(api=api, trig=trig, feed=feed, rec=rec, cells=cells,
                carriers=carriers, index=index, offsets=offsets, loop=loop,
                ratio=ratio, faulty=faulty, early=early,
                info=dict(gen_s=gen_s, warm_s=time.perf_counter() - w0,
                          warm_loops=feed.fed / length,
                          warm_depths=sorted({r for _, _, r in
                                              rec.harvests}),
                          warm_unpublished=sorted(steady - published),
                          centres=len(index),
                          carriers=[dict(earfcn=int(cfg["earfcn"][0])
                                         + c["earfcn_index"],
                                         role=c["role"], prb=c["prb"],
                                         snr_db=c["snr_db"],
                                         cfo_hz=c["cfo_hz"])
                                    for c in carriers]))


def window(ctx: dict, st: dict) -> dict:
    dev, seconds = ctx["device"], ctx["seconds"]
    trig, feed, rec, api = st["trig"], st["feed"], st["rec"], st["api"]
    sl = wide_trace.Slice(ctx["trace"], 0.4 * seconds,
                          min(2.0, 0.25 * seconds), slices.sync_fn(dev),
                          api.stream_counts)
    fault, faulty = ctx.get("fault"), st["faulty"]
    min_feeds = int(ctx["config"].get("min_feeds", 0))
    counts0 = collections.Counter(api.stream_counts)
    h0 = len(rec.harvests)
    feeds = polls = 0
    skip = fault == "chunk_skipped"
    faulty["armed"] = True
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    cpu0 = time.thread_time()
    while True:
        now = time.perf_counter() - t0
        if feeds >= min_feeds and not sl.open_until(now, seconds):
            break
        sl.step(now)
        if skip and feeds == 3:
            feed.skip(0)
            skip = False
            faulty["fired"] += 1
        if _step(trig, feed):
            feeds += 1
            sl.count()
        else:
            polls += 1
    t1 = time.perf_counter()
    cpu = time.thread_time() - cpu0
    counts = collections.Counter(api.stream_counts)
    counts.subtract(counts0)
    sl.close()
    if sl.result is not None:
        sl.result.update(t0_ns=int(sl.t0 * 1e9), t1_ns=int(sl.t1 * 1e9))
    inside = [h for h in rec.harvests[h0:] if h[0] <= t1]
    steps = sum(n for _, n, _ in inside)
    trig.flush()
    wide_rate = float(ctx["config"]["sample_rate"]) / 1e6
    scan_msps = steps * HALF_FRAME * st["ratio"] / (t1 - t0) / 1e6
    info = dict(st["info"], feeds=feeds, polls=polls,
                harvested=len(inside), steps_harvested=steps,
                dispatches=counts["dispatches"],
                steps_dispatched=counts["steps"],
                forced_drains=counts["forced_drains"],
                upload_bytes=counts["upload_bytes"],
                wide_samples=counts["wide_samples"],
                depths=dict(sorted(collections.Counter(
                    r for _, _, r in inside).items())),
                real_time_factor=scan_msps / wide_rate,
                thread_cpu_share=cpu / (t1 - t0),
                fired={fault: faulty["fired"]} if faulty["fired"] else {})
    st.update(counts=counts, slice_result=sl.result, info=info)
    return dict(scan_msps=scan_msps, setup_s=setup_s, attempted=feeds,
                failed=0, window_s=t1 - t0, info=info)


def free(ctx: dict, st: dict) -> None:
    """Once the peak memory has been read: the lanes the mirror holds are
    read (`resident_lanes`) and folded onto the loop, and the feeding rule
    goes on, an eighth of a loop between reads, until the reads hold every
    sample of the loop (`READS` reads at most; the mirror holds up to ~1.3
    s of stream, less after it slides); then a flush, and the program's
    last peak is read.  Then the program's state goes; the loop and the
    outputs stay."""
    trig, feed = st.pop("trig"), st.pop("feed")
    period = st["loop"].size // st["ratio"]
    turns = max(st["loop"].size // 8 // int(ctx["config"]["chunk_samples"]),
                1)
    have, reads, differ = None, 0, 0
    while reads < READS:
        have, d = refwide.fold(have, trig.resident_lanes(), period)
        reads, differ = reads + 1, differ + d
        if refwide.covered(have, period):
            break
        for _ in range(turns):
            _step(trig, feed)
    trig.flush()
    st["peak"] = trig.peak
    st["program_lanes"] = have
    st["info"].update(mirror_reads=reads, reads_differ=differ,
                      loop_covered=refwide.covered(have, period))
    del trig, feed
    if ctx["device"].type == "cuda":
        torch.cuda.empty_cache()


def check(ctx: dict, st: dict, limits: dict) -> dict:
    t0 = time.perf_counter()
    checks, info = refwide.check(
        st["rec"], st["loop"], st["cells"], st["offsets"], ctx["config"],
        limits, ctx["device"], peak=st["peak"],
        program_lanes=st.pop("program_lanes"), early=st.pop("early"),
        centres_at_once=CENTRES_AT_ONCE if ctx["device"].type == "cuda"
        else len(st["cells"]))
    st["ties"], st["undue"] = info.pop("ties"), info.pop("undue")
    st["info"].update(info, check_s=time.perf_counter() - t0)
    return checks
