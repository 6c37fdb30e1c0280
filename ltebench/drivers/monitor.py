"""Driver of the live monitor cells: `models.multi.MultiTrigger` fed
chunks of N carrier loops held in host memory, closed loop on the main
thread, through the pipeline's own calls `process_all` and `poll`.

Configuration: streams, sample_rate (the pipeline's 1.92 Msps),
chunk_samples, loop_seconds, transport, pipeline, cfo_search_range,
psr_threshold, track_after, track_every.  The mix gives each stream its
cell and its role (`gen/monitor.py`).

Set-up makes the loops from the seed and builds the trigger with an
`on_output` hook that keeps every drained dispatch
(`reference.monitor.Record`).  It warms up by the window's own feeding
rule for at least one whole loop and until every steady stream's cell is
published; then each scan depth (4, 8, 16 and 32 steps) that has not run
yet is asked for once, by one `process_all` of that many half-frames and
one chunk more a stream, and the feeding rule goes on until each has been
harvested; all within WARM_LOOPS loops.  The window feeds the next chunk
of every loop (`process_all`) while min(backlog) is at most BACKLOG_CAP
samples and calls `poll()` otherwise, as a source that blocks on a full
buffer; `thread_cpu_share` under `info` is the main thread's CPU time over
the window's wall time.
`scan_msps` counts, over all streams, the stream samples of the half-frame
steps whose outputs were harvested inside the window, over the window's
wall time: samples fed but not yet scanned do not count.  After the window
a flush drains what is in flight, and every harvested step from stream
position 0 is held to the plain reference (`reference.monitor`), with the
last peak after the flush.

A program without the hook or `api.stream_counts` cannot run the cell:
set-up raises before any input is made.  Faults (tests of the check):
"chunk_skipped" (one chunk of stream 0 is never fed, inside the window),
"streams_swapped" (streams 0 and 1's outputs swapped), "answer_altered"
(every published id off by one).
"""

from __future__ import annotations

import collections
import inspect
import time

import numpy as np
import torch

from ltebench import slices
from ltebench.gen import monitor as mongen
from ltebench.reference import monitor as refmon

HALF_FRAME = 9600
BACKLOG_CAP = 64 * HALF_FRAME       # min(backlog) past which the feed waits
DEPTHS = (4, 8, 16, 32)             # the pipeline's scan depths, in steps
WARM_LOOPS = 4                      # the warm-up's cap, in loops fed
REAL_TIME_MSPS = 1.92               # one carrier's rate


def _program():
    """(api, MultiTrigger) of a program that has the hook and counters."""
    from ltetrigger_tpu_torch.models import api
    from ltetrigger_tpu_torch.models.multi import MultiTrigger
    if not hasattr(api, "stream_counts") or "on_output" not in \
            inspect.signature(MultiTrigger.__init__).parameters:
        raise RuntimeError("this program's MultiTrigger has no on_output "
                           "hook or api.stream_counts: it cannot run the "
                           "monitor cells")
    return api, MultiTrigger


class _Feed:
    """The next chunk of every stream's loop, cycling; `skip(i)` drops one
    chunk of stream i."""

    def __init__(self, loops: np.ndarray, chunk: int):
        self.loops, self.chunk = loops, chunk
        self.off = np.zeros(loops.shape[0], dtype=np.int64)
        self.fed = 0                # samples fed a stream

    def next(self, chunks: int = 1) -> list:
        """The next `chunks` chunks of every stream, one array each."""
        length = self.loops.shape[1]
        out = []
        for i, o in enumerate(self.off):
            parts = [self.loops[i, (o + k * self.chunk) % length:][
                :self.chunk] for k in range(chunks)]
            out.append(parts[0] if chunks == 1 else np.concatenate(parts))
        self.off = (self.off + chunks * self.chunk) % length
        self.fed += chunks * self.chunk
        return out

    def skip(self, i: int) -> None:
        self.off[i] = (self.off[i] + self.chunk) % self.loops.shape[1]


def _step(trig, feed: _Feed) -> bool:
    """One turn of the feeding rule: True if it fed, False if it polled."""
    if trig.backlog.min() > BACKLOG_CAP:
        trig.poll()
        return False
    trig.process_all(feed.next())
    return True


def _hook(rec: refmon.Record, fault, published: set):
    """The hook the trigger calls: notes the streams with a track event
    in `published` (for the warm-up), then applies the fault."""

    def on_output(host, pos_before):
        published.update(np.nonzero(host.track_event.any(axis=(0, 2)))[0]
                         .tolist())
        if fault == "streams_swapped":
            order = [1, 0] + list(range(2, host.psr.shape[1]))
            host = type(host)(*(a[:, order] for a in host))
        elif fault == "answer_altered":
            cid = host.cell_id.copy()
            cid[host.track_event] = (cid[host.track_event] + 1) % 504
            host = host._replace(cell_id=cid)
        rec(host, pos_before)

    return on_output


def setup(ctx: dict) -> dict:
    # the program's entry points first: a program without them fails here,
    # before any input is made
    api, MultiTrigger = _program()
    cfg, mix, dev = ctx["config"], ctx["traffic"], ctx["device"]
    if float(cfg["sample_rate"]) != REAL_TIME_MSPS * 1e6:
        raise ValueError("the monitor cells feed 1.92-Msps streams")
    g0 = time.perf_counter()
    cells = mongen.draw(mix, cfg, ctx["seed"])
    loops = mongen.loops(cells, cfg, mix, ctx["seed"], dev)
    gen_s = time.perf_counter() - g0
    rec = refmon.Record()
    published = set()
    trig = MultiTrigger(
        int(cfg["streams"]), psr_threshold=float(cfg["psr_threshold"]),
        track_after=int(cfg["track_after"]),
        track_every=int(cfg["track_every"]), pipeline=int(cfg["pipeline"]),
        transport=cfg["transport"],
        cfo_search_range=int(cfg["cfo_search_range"]), device=dev,
        on_output=_hook(rec, ctx.get("fault"), published))
    feed = _Feed(loops, int(cfg["chunk_samples"]))
    steady = {i for i, c in enumerate(cells) if c["role"] == "steady"}
    length = loops.shape[1]
    w0 = time.perf_counter()
    asked = set()
    while feed.fed < WARM_LOOPS * length:
        depths = {rows for _, _, rows in rec.harvests}
        if feed.fed >= length and steady <= published:
            if set(DEPTHS) <= depths:
                break
            ask = [d for d in DEPTHS if d not in depths | asked]
            if ask:
                asked.add(ask[0])
                trig.process_all(feed.next(ask[0] // 2 + 1))
                continue
        _step(trig, feed)
    slices.sync_fn(dev)()
    return dict(api=api, trig=trig, feed=feed, rec=rec, cells=cells,
                loops=loops, n=int(cfg["streams"]),
                info=dict(gen_s=gen_s, warm_s=time.perf_counter() - w0,
                          warm_loops=feed.fed / length,
                          warm_depths=sorted({r for _, _, r in
                                              rec.harvests}),
                          warm_unpublished=sorted(steady - published)))


def window(ctx: dict, st: dict) -> dict:
    dev, seconds = ctx["device"], ctx["seconds"]
    trig, feed, rec, api = st["trig"], st["feed"], st["rec"], st["api"]
    sl = slices.Slice(ctx["trace"], 0.4 * seconds, min(2.0, 0.25 * seconds),
                      slices.sync_fn(dev))
    fault = ctx.get("fault")
    counts0 = collections.Counter(api.stream_counts)
    h0 = len(rec.harvests)
    feeds = polls = 0
    skip = fault == "chunk_skipped"
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    cpu0 = time.thread_time()
    while True:
        now = time.perf_counter() - t0
        if not sl.open_until(now, seconds):
            break
        sl.step(now)
        if skip and feeds == 3:
            feed.skip(0)
            skip = False
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
    peak = trig.peak
    scan_msps = st["n"] * steps * HALF_FRAME / (t1 - t0) / 1e6
    info = dict(st["info"], feeds=feeds, polls=polls,
                harvested=len(inside), steps_harvested=steps,
                dispatches=counts["dispatches"],
                steps_dispatched=counts["steps"],
                forced_drains=counts["forced_drains"],
                upload_bytes=counts["upload_bytes"],
                depths=dict(sorted(collections.Counter(
                    r for _, _, r in inside).items())),
                real_time_factor=scan_msps / (st["n"] * REAL_TIME_MSPS),
                thread_cpu_share=cpu / (t1 - t0))
    st.update(counts=counts, slice_result=sl.result, peak=peak, info=info)
    return dict(scan_msps=scan_msps, setup_s=setup_s, attempted=feeds,
                failed=0, window_s=t1 - t0, info=info)


def free(ctx: dict, st: dict) -> None:
    """The program's state goes; the loops and the outputs stay."""
    st.pop("trig", None)
    st.pop("feed", None)
    if ctx["device"].type == "cuda":
        torch.cuda.empty_cache()


def check(ctx: dict, st: dict, limits: dict) -> dict:
    t0 = time.perf_counter()
    checks, info = refmon.check(st["rec"], st["loops"], st["cells"],
                                ctx["config"], limits, ctx["device"],
                                peak=st["peak"])
    st["ties"], st["undue"] = info.pop("ties"), info.pop("undue")
    st["info"].update(info, check_s=time.perf_counter() - t0)
    return checks
