"""The live monitor cell (`monitor8_replay`) on the CPU at a small size:
`MultiTrigger` over looped carrier streams (steady, keyed, vacant) held
step for step to the benchmark's plain streaming reference
(`ltebench/reference/monitor.py`: `passab`'s passes A and B over each
whole fed stream from a fresh state), fed in uneven chunks so that the
dispatch depths vary; one chunk against many small ones; the cell run with
overrides, sound and with each of its three faults; the pipeline's
counters, its spans `stream.upload` and `stream.harvest`, once a dispatch;
the cell's readers; a program without the `on_output` hook refused at
set-up.  The test marked `cuda` runs the cell's driver on a card at a
reduced window and holds it to the reference.

Tolerances: integers and flags exact; PSR within the cell's limit
(`limits/monitor8_replay.json`, 1e-3 relative), which the program meets
by three orders of magnitude.  No JAX here: the reference is the
benchmark's own.
"""

import collections
import json

import numpy as np
import pytest
import torch

from ltebench import run
from ltebench.gen import monitor as mongen
from ltebench.reference import monitor as refmon, passab
from ltetrigger_tpu_torch.models import api, multi
from ltetrigger_tpu_torch.utils import profiling

CELL = "monitor8_replay"
BENCH = run.load_benchmark()
_, CFG, MIX = run.resolve(BENCH, CELL)
LIMITS = run.load_json("limits", CELL)
SEED = 3_900_026_017
# the cell's runs: three streams (one of each role), 0.8-s loops
SMALL = {"config": {"streams": 3, "loop_seconds": 0.8}}
# the pipeline against the reference: 1.6-s loops, the keyed cell on for
# 160 half-frames and off for 160, long enough for its loss (PSR's EMA is
# updated every 8th step while a root tracks)
LONG = dict(SMALL["config"], loop_seconds=1.6)
CPU = [torch.profiler.ProfilerActivity.CPU]
METRICS = [m["name"] for m in BENCH["per_layer"]
           if m["name"].endswith(".monitor")]
CHUNKS = (19200, 4801, 320000, 1000, 123456, 9600, 160000, 30000)


def small_cfg():
    return dict(CFG, **LONG)


@pytest.fixture(scope="module")
def streams():
    """(cells, loops [3, 1.6 s]) from the seed: one stream of each role."""
    cfg = small_cfg()
    cells = mongen.draw(MIX, cfg, SEED)
    assert sorted(c["role"] for c in cells) == ["keyed", "steady", "vacant"]
    return cells, mongen.loops(cells, cfg, MIX, SEED, "cpu")


def tiled(loops, n):
    reps = -(-n // loops.shape[1])
    return np.tile(loops, (1, reps))[:, :n]


def feed(loops, n, sizes, **kw):
    """MultiTrigger(3) fed `n` samples of each looped stream in chunks of
    the cycled `sizes`, then flushed: (record, trigger)."""
    rec = refmon.Record()
    m = multi.MultiTrigger(loops.shape[0], transport="f32", device="cpu",
                           on_output=rec, **kw)
    x = tiled(loops, n)
    i = k = 0
    while i < n:
        c = sizes[k % len(sizes)]
        m.process_all(list(x[:, i:i + c]))
        i, k = i + c, k + 1
    m.flush()
    return rec, m


# ------------------------------------------------------- the reference --
def test_uneven_chunks_equal_the_plain_streaming_reference(streams):
    cells, loops = streams
    rec, m = feed(loops, 2 * loops.shape[1], CHUNKS)
    depths = {rows for _, _, rows in rec.harvests}
    assert {4, 8, 16, 32} <= depths            # the dispatches vary
    got = rec.arrays()
    assert len(got["steps"]) >= 300
    checks, info = refmon.check(rec, loops, cells, small_cfg(), LIMITS,
                                "cpu", peak=m.peak)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert checks["psr_rel_gap"]["value"] < 1e-5
    assert info["grid_faults"] == 0 and info["undue"] == 0
    # the steady cell published once, the keyed one retracted and
    # published again, nothing on the vacant stream
    role = {i: c["role"] for i, c in enumerate(cells)}
    kinds = collections.Counter((role[e["stream"]], e["kind"])
                                for e in rec.events)
    assert kinds[("steady", "track")] == 1
    assert kinds[("keyed", "drop")] >= 1
    assert kinds[("keyed", "track")] - kinds[("keyed", "drop")] in (0, 1)
    assert not any(role[e["stream"]] == "vacant" for e in rec.events)
    # the reference's own tracking ends where each retraction falls
    ref = refmon.reference(torch.from_numpy(loops), len(got["steps"]),
                           small_cfg())
    trk = ref["tracking"].numpy()
    np.testing.assert_array_equal(got["tracking"], trk)
    np.testing.assert_array_equal(got["score"], ref["score"].numpy())
    for e in rec.events:
        if e["kind"] == "drop":
            assert trk[e["step"] - 1, e["stream"], e["root"]]
            assert not trk[e["step"], e["stream"], e["root"]]


def test_one_chunk_or_many_small_give_the_same_outputs(streams):
    _, loops = streams
    n = loops.shape[1] // 2
    one, _ = feed(loops, n, (n,))
    many, _ = feed(loops, n, (3000, 7000))
    a, b = one.arrays(), many.arrays()
    for k in ("steps", "score", "tracking"):
        np.testing.assert_array_equal(a[k], b[k], k)
    np.testing.assert_allclose(a["psr"], b["psr"], rtol=1e-6, atol=0)
    assert one.events == many.events


def test_loop_power_is_pass_a_of_the_tiled_stream(streams):
    _, loops = streams
    x = torch.from_numpy(loops[:, :2 * 9600 * 5 + 9600])
    period = x.shape[1] // 9600
    got = refmon.loop_power(x, "bfloat16", steps_at_once=3)
    ext = torch.from_numpy(tiled(x.numpy(), 2 * x.shape[1] + 128))
    want = passab.correlation_power(ext.real.contiguous(),
                                    ext.imag.contiguous(), 0, 2 * period,
                                    "bfloat16")
    for t in range(2 * period):
        torch.testing.assert_close(got[:, t % period], want[:, t],
                                   rtol=1e-9, atol=1e-9)


def test_the_loops_repeat_without_a_seam_and_key_the_cell(streams):
    cells, loops = streams
    cfg = small_cfg()
    n = mongen.loop_samples(cfg)
    assert loops.shape == (3, n) and loops.dtype == np.complex64
    for c in cells:
        assert (c["cfo_hz"] * cfg["loop_seconds"]) % 1 == 0
    bare = mongen.loops([dict(c, cell_id=-1) for c in cells], cfg, MIX,
                        SEED, "cpu")
    steady = mongen.loops([dict(c, role="steady") for c in cells], cfg, MIX,
                          SEED, "cpu")
    for i, c in enumerate(cells):
        if c["role"] == "vacant":
            np.testing.assert_array_equal(loops[i], bare[i])
        elif c["role"] == "keyed":
            np.testing.assert_array_equal(loops[i, :n // 2],
                                          steady[i, :n // 2])
            np.testing.assert_array_equal(loops[i, n // 2:], bare[i, n // 2:])
        else:
            np.testing.assert_array_equal(loops[i], steady[i])
            assert (loops[i] != bare[i]).any()


# ------------------------------------------------------------ the cell --
def cpu_run(fault=None, trace=False, seconds=0.6):
    return run.run_cell(BENCH, CELL, SEED, seconds, trace, device="cpu",
                        overrides=json.loads(json.dumps(SMALL)), fault=fault)


def test_a_sound_small_run_is_correct():
    r = cpu_run()
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == set(LIMITS)
    assert set(r["metrics"]) == {"scan_msps", "setup_s"}
    assert r["metrics"]["scan_msps"]["value"] > 0
    info = r["info"]
    assert info["warm_depths"] == [4, 8, 16, 32]
    assert info["warm_unpublished"] == [] and info["undue"] == 0
    assert info["steps_harvested"] > 0 and info["grid_faults"] == 0


@pytest.mark.parametrize("fault", ["chunk_skipped", "streams_swapped",
                                   "answer_altered"])
def test_a_fault_in_the_timed_path_is_not_correct(fault):
    # the skipped chunk is the window's fourth feed: a window long enough
    # for a loaded host to reach it, and the feeds to show that it did
    skip = fault == "chunk_skipped"
    r = cpu_run(fault=fault, seconds=2.0 if skip else 0.3)
    if skip:
        assert r["info"]["feeds"] >= 4, r["info"]
    assert r["correct"] is False, r["checks"]


def test_the_i8_control_is_not_correct():
    from ltebench import control_monitor

    r = control_monitor.control_numbers(CELL, SEED, 0.5, "cpu",
                                        overrides=SMALL)
    assert r["correct"] is False
    assert r["psr_rel_gap"] > 10 * LIMITS["psr_rel_gap"]


def test_a_program_without_the_hook_cannot_run_the_cell(monkeypatch):
    monkeypatch.delattr(api, "stream_counts")
    made = []
    monkeypatch.setattr(mongen, "loops", lambda *a: made.append(a))
    with pytest.raises(RuntimeError, match="on_output"):
        cpu_run()
    assert made == []


# ------------------------------------------------- spans and counters --
def test_counters_and_both_spans_once_a_dispatch(streams):
    _, loops = streams
    profiling.reset()
    before = collections.Counter(api.stream_counts)
    with torch.profiler.profile(activities=CPU):
        rec, _ = feed(loops, loops.shape[1] // 4, (19200, 61440))
    got = collections.Counter(api.stream_counts)
    got.subtract(before)
    spans = profiling.spans()
    preps = [s for s in spans if s.name == "prep"]
    by_seq = {s.seq: s for s in spans}
    assert got["dispatches"] == len(preps) == len(rec.harvests) > 0
    assert got["steps"] == sum(rows for _, _, rows in rec.harvests)
    assert got["forced_drains"] == 0           # nothing waits on the CPU
    uploads = [s for s in spans if s.name == "stream.upload"]
    harvests = [s for s in spans if s.name == "stream.harvest"]
    assert len(uploads) == len(harvests) == len(preps)
    assert {by_seq[s.parent].name for s in uploads} == {"prep"}
    assert len({s.call for s in preps}) == len(preps)
    assert {s.call for s in uploads} == {s.call for s in preps}
    assert all(s.device_ms is None for s in uploads + harvests)
    for h in harvests:
        inside = [s.name for s in spans if s.parent == h.seq]
        assert inside.count("drain") == 1
    # 8 bytes a sample and stream (f32), every sample uploaded once
    assert got["upload_bytes"] % (8 * 3) == 0
    assert loops.shape[1] // 4 * 8 * 3 <= got["upload_bytes"] \
        <= (loops.shape[1] // 4 + api.LOOKBACK) * 8 * 3


def test_the_hook_of_a_single_stream_trigger():
    rows = []
    t = api.Trigger(transport="f32", device="cpu",
                    on_output=lambda host, pos: rows.append(
                        (host.consumed.shape, pos.copy())))
    t.process(np.zeros(9 * 9600, np.complex64))
    t.flush()
    assert rows and all(len(s) == 2 and s[1] == 3 and p.shape == (3,)
                        for s, p in rows)
    assert rows[0][1].tolist() == [0, 0, 0]


def test_the_monitor_readers_read_a_traced_run_and_none_untraced():
    r = cpu_run(trace=True)
    assert r["correct"] is True, r["checks"]
    m = r["metrics"]
    assert set(METRICS) == {"steps_per_dispatch.monitor",
                            "upload_host_ms_per_dispatch.monitor",
                            "upload_stream_ms_per_dispatch.monitor",
                            "harvest_host_ms_per_dispatch.monitor"}
    assert m["steps_per_dispatch.monitor"]["value"] >= 4
    for name in ("upload_host_ms_per_dispatch.monitor",
                 "harvest_host_ms_per_dispatch.monitor"):
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms/dispatch"
    # on the CPU: no CUDA events
    assert "upload_stream_ms_per_dispatch.monitor" not in m
    rd = dict(ctx=None, state={}, e2e={}, slice=None)
    for name in METRICS:
        assert run.load_file_module("metrics", name).read(rd) is None


# ------------------------------------------------ on a card (marker cuda) --
@pytest.mark.cuda
def test_the_cell_on_a_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    r = run.run_cell(BENCH, CELL, SEED, 2.0, False, device="cuda")
    assert r["correct"] is True, r["checks"]
    assert r["info"]["steps_harvested"] > 0
    assert r["checks"]["psr_rel_gap"]["value"] < 1e-5
    assert r["device"]["kind"] == torch.cuda.get_device_name(0)
