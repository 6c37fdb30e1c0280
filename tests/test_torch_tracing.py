"""The port's tracer (`utils/profiling.span`) on the engine's path: off, a
shared no-op and the same outputs; on, the spans of every layer boundary of
`channel_scan` and the readback, with parents, call ids, the host waits
that `trigger.host_syncs` counts, and the same regions in the profiler's
Chrome trace; the benchmark's span metrics from a traced CPU run.  The last
test (marker cuda) holds each hand kernel's launch to its span on a card.
"""

import collections
import json

import numpy as np
import pytest
import torch

from ltebench import run
from ltebench.gen import traffic as gen
from ltetrigger_tpu_torch.models import trigger as trig
from ltetrigger_tpu_torch.parallel.sharded import channel_scan
from ltetrigger_tpu_torch.utils import profiling

SEED = 3_900_000_017
CHANNELS, STEPS = 4, 100          # the harness's size on the CPU
CELL = "scan512_cfo1k5"
CFG = run.load_json("configs", "capture_scan512")
KW = dict(track_after=CFG["track_after"], track_every=CFG["track_every"])
CPU = [torch.profiler.ProfilerActivity.CPU]

# span -> the span it opens in (None: at the top of a call)
PARENT = {
    "channel_scan": None, "scan_pass": "channel_scan",
    "pass_a": "scan_pass", "pass_b": "scan_pass", "wait.grid": "scan_pass",
    "pass_c": "channel_scan", "wait.emit": "pass_c",
    "pass_c.sync": "pass_c", "pass_c.capture": "pass_c",
    "wait.capture": "pass_c", "pass_c.decode": "pass_c",
    "wait.cp": "pass_c.decode", "pass_c.events": "pass_c",
    "readback.pack": None, "readback.copy": None, "readback.unpack": None,
}


def buffers(device, channels=CHANNELS):
    mix = run.load_json("traffic", "cells_cfo1k5")
    cells = gen.draw_cells(mix, gen.rng_for(SEED), channels)
    return gen.capture_batch(cells, STEPS * trig.HALF_FRAME_LENGTH, SEED,
                             torch.device(device))


@pytest.fixture(scope="module")
def bufs():
    return buffers("cpu")


def scan_call(bufs, states=None):
    """One call as the benchmark makes it: the scan, then the readback."""
    st, out = channel_scan(bufs, STEPS, CFG["psr_threshold"], states=states,
                           device=bufs[0].device, **KW)
    return st, trig.unpack_output(trig.pack_output(out))


def same_call(a, b):
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)


def test_off_a_span_is_one_shared_no_op(monkeypatch):
    """Without a profiler no region is opened and nothing kept."""
    def refuse(*a, **k):
        raise AssertionError("a profiler region opened with tracing off")

    monkeypatch.setattr(profiling, "_region_enter", refuse)
    profiling.reset()
    assert profiling.span("a") is profiling.span("b", device="cpu")
    with profiling.span("a"):
        with profiling.span("b"):
            pass
    assert profiling.spans() == []


def test_off_records_nothing_and_outputs_equal_a_traced_run(bufs):
    profiling.reset()
    off = scan_call(bufs)
    assert profiling.spans() == []
    with torch.profiler.profile(activities=CPU):
        on = scan_call(bufs)
    assert profiling.spans()
    same_call(off, on)


def traced_calls(bufs, tmp_path, n=2):
    """n calls under a CPU profiler: (spans, Chrome trace events)."""
    profiling.reset()
    with torch.profiler.profile(activities=CPU) as prof:
        for _ in range(n):
            scan_call(bufs)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return profiling.spans(), events


def test_spans_have_the_engine_names_parents_and_one_call_id_a_call(
        bufs, tmp_path):
    spans, _ = traced_calls(bufs, tmp_path)
    by_seq = {s.seq: s for s in spans}
    assert {s.name for s in spans} == set(PARENT) - {"wait.grid"}
    for s in spans:
        parent = by_seq[s.parent].name if s.parent >= 0 else None
        assert parent == PARENT[s.name], s
        assert s.start_ns <= s.end_ns and s.device_ms is None
        if s.parent >= 0:
            p = by_seq[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            assert p.call == s.call
    scans = [s for s in spans if s.name == "channel_scan"]
    assert len(scans) == 2 and scans[0].call < scans[1].call
    for sc in scans:
        names = collections.Counter(s.name for s in spans
                                    if s.call == sc.call)
        assert names["readback.copy"] == names["readback.unpack"] == 1
        assert names["pass_a"] == names["pass_b"] == STEPS // 25
        assert names["wait.cp"] == 2


def test_every_span_is_a_user_annotation_of_the_chrome_trace(bufs,
                                                            tmp_path):
    """Same names in the same order and nesting, durations within
    max(5 %, 50 us): the spans lie on the profiler's own clock."""
    spans, events = traced_calls(bufs, tmp_path)
    ann = sorted(((float(e["ts"]), float(e["dur"]), e["name"])
                  for e in events if e.get("cat") == "user_annotation"
                  and e.get("ph") == "X" and e["name"] in PARENT),
                 key=lambda a: (a[0], -a[1]))
    mine = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    assert [a[2] for a in ann] == [s.name for s in mine]
    by_seq = {s.seq: s for s in spans}
    for i, (ts, dur, name) in enumerate(ann):
        inner = [a for a in ann[:i] if a[0] <= ts and ts + dur <= a[0] + a[1]]
        got = min(inner, key=lambda a: a[1])[2] if inner else None
        s = mine[i]
        assert got == (by_seq[s.parent].name if s.parent >= 0 else None)
        us = s.host_ms * 1e3
        assert abs(dur - us) <= max(0.05 * dur, 50.0), (name, dur, us)


def test_wait_spans_match_the_host_syncs_name_for_name(bufs):
    st, _ = scan_call(bufs)
    before = collections.Counter(trig.host_syncs)
    profiling.reset()
    with torch.profiler.profile(activities=CPU):
        scan_call(bufs)
        scan_call(bufs, states=st)        # a carried state reads the grid
    syncs = collections.Counter(trig.host_syncs)
    syncs.subtract(before)
    waits = collections.Counter(s.name[len("wait."):]
                                for s in profiling.spans()
                                if s.name.startswith("wait."))
    assert +syncs == waits and waits["grid"] == 1


def test_stage_timer_stages_and_annotate_are_spans():
    timer = profiling.StageTimer()

    @profiling.annotate("region")
    def f():
        with timer.stage("scan"):
            return 1

    profiling.reset()
    with torch.profiler.profile(activities=CPU):
        profiling.next_call()
        assert f() == 1
    names = [(s.name, s.parent) for s in profiling.spans()]
    assert names[0] == ("region", -1) and names[1][0] == "scan"
    assert timer.summary()["scan"]["count"] == 1


def test_a_traced_cpu_run_reports_the_host_span_metrics():
    r = run.run_cell(run.load_benchmark(), CELL, SEED, 1.0, True,
                     device="cpu",
                     overrides={"config": {"channels": CHANNELS,
                                           "steps": STEPS}})
    assert r["correct"] is True
    m = r["metrics"]
    for name in ("host_wait_ms_per_call.scan",
                 "pass_c_host_ms_per_call.scan",
                 "readback_host_ms_per_call.scan"):
        assert m[name]["value"] >= 0 and m[name]["unit"] == "ms/call"
    assert "pass_c_stream_ms_per_call.scan" not in m
    assert m["host_syncs_per_call.scan"]["value"] == 4.0


# ------------------------------------------------ on a card (marker cuda) --
def _under(trace_events):
    """Each device kernel's name -> the names of the user annotations that
    were open on the launching thread when it was launched."""
    ann, launch, kernels = [], {}, []
    for e in trace_events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        if cat == "user_annotation":
            ann.append((e["ts"], e["ts"] + e["dur"], e["tid"], e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") \
                and "correlation" in args:
            launch[args["correlation"]] = (e["ts"], e["tid"])
        elif cat == "kernel":
            kernels.append((e["name"], args.get("correlation")))
    out = []
    for name, corr in kernels:
        ts, tid = launch[corr]
        out.append((name, {a[3] for a in ann
                           if a[2] == tid and a[0] <= ts <= a[1]}))
    return out


@pytest.mark.cuda
def test_each_hand_kernel_launches_under_its_span_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bufs = buffers("cuda", channels=16)
    ref = scan_call(bufs)                     # builds and warms the kernels
    profiling.reset()
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = scan_call(bufs)
    same_call(ref, got)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    seen = collections.Counter()
    under = _under(json.loads(path.read_text())["traceEvents"])
    # between the "emit" and "capture" reads pass C's front end queues its
    # three hand kernels and no other
    front = [name for name, spans in under
             if spans & {"pass_c.sync", "pass_c.capture"}]
    assert len(front) == 3, front
    for name, spans in under:
        for kernel, span in (("mf_stage_kernel", "scan_pass"),
                             ("mf_wgmma_kernel", "scan_pass"),
                             ("pb_scan_kernel", "scan_pass"),
                             ("ring_scan_kernel", "pass_c.sync"),
                             ("front_estimate_kernel", "pass_c.sync"),
                             ("front_decide_kernel", "pass_c.capture"),
                             ("tti_chain_kernel", "pass_c.decode"),
                             ("vit_wa_kernel", "pass_c.decode")):
            if kernel in name:
                assert span in spans, (name, spans)
                seen[kernel] += 1
    assert seen["pb_scan_kernel"] and seen["ring_scan_kernel"] \
        and seen["tti_chain_kernel"] and seen["vit_wa_kernel"], seen
    assert seen["front_estimate_kernel"] == seen["front_decide_kernel"] \
        == seen["ring_scan_kernel"], seen
    assert seen["mf_stage_kernel"] or seen["mf_wgmma_kernel"], seen
    names = collections.Counter(s.name for s in profiling.spans())
    assert names["wait.drain"] == names["readback.copy"] \
        == names["readback.unpack"] == 1, names
    spans = {s.name: s for s in profiling.spans()}
    assert 0 < spans["pass_c"].device_ms <= spans["channel_scan"].device_ms
    assert 0 < spans["scan_pass"].device_ms


def _owner(a):
    """The object that owns a numpy array's memory."""
    while isinstance(a, np.ndarray) and a.base is not None:
        a = a.base
    return a


def _edges(packed):
    """`packed` with NaN / +-inf / -0.0 in psr and cfo_mean, and the ints'
    and bools' edge values, on its first step."""
    fields = trig.StepOutput._fields
    p = packed.clone()
    for f in trig._F32_FIELDS:
        p[0, ..., fields.index(f)] = torch.tensor(
            [float("nan"), float("inf"), -float("inf"), -0.0])[
                torch.arange(p[0, ..., 0].numel()) % 4].reshape(
                    p.shape[1:-1]).to(p.device)
    for f, v in (("cell_id", -1), ("sfn_offset", 1020), ("nof_prb", 0)):
        p[0, ..., fields.index(f)] = v
    return p


def _same_output(a, b):
    for f, x, y in zip(trig.StepOutput._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.cuda
def test_a_cuda_readback_is_the_host_split_in_a_pinned_buffer_of_its_own():
    """A CUDA packed output reads back equal to the host split of the same
    tensor, field for field and dtype for dtype, as views of one pinned
    buffer that the result owns: a later call changes no earlier result,
    also once a result between them was dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, out = channel_scan(buffers("cuda", channels=16), STEPS,
                          CFG["psr_threshold"], device=torch.device("cuda"),
                          **KW)
    p1 = _edges(trig.pack_output(out))
    p2 = p1 + 1.0                       # every int and float moved
    p2[..., [trig.StepOutput._fields.index(f)
             for f in trig._BOOL_FIELDS]] = 1.0 - p1[..., [
                 trig.StepOutput._fields.index(f)
                 for f in trig._BOOL_FIELDS]]
    paths = collections.Counter(trig.readback_paths)
    first = trig.unpack_output(p1)
    want1 = trig.unpack_output(p1.cpu())
    _same_output(first, want1)
    owner = _owner(first.psr)
    assert isinstance(owner, torch.Tensor) and owner.is_pinned()
    assert all(_owner(a) is owner for a in first)
    second = trig.unpack_output(p2)
    _same_output(second, trig.unpack_output(p2.cpu()))
    _same_output(first, want1)
    del second
    torch.cuda.synchronize()
    third = trig.unpack_output(p2)
    _same_output(first, want1)
    _same_output(third, trig.unpack_output(p2.cpu()))
    counted = collections.Counter(trig.readback_paths)
    counted.subtract(paths)
    assert +counted == {"device": 3, "host": 3}
