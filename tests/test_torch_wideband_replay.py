"""The live band monitor cell (`band12_live_cfo1k5`) on the CPU at a small
size: `WidebandTrigger` over a looped wide stream of Band 12 (a steady and
a keyed carrier, each with its neighbouring raster points, 0.32-s loops)
held step for step to the benchmark's plain reference
(`ltebench/reference/wideband.py`: `reference.band`'s float64 channelizer
of the stream as fed, then `passab`'s passes A and B over every whole lane
from a fresh state); the cell run sound (traced) and with each of its
three faults and its bf16 control; the reference's lanes against the
channelizer of the tiled stream; the loop's seam and keying; the front
end's spans `wide.upload` and `wide.mix` once a dispatch inside
`stream.upload`, and its counters; the `.wide` readers; a program without
the `on_output` hook refused at set-up.  The tests marked `cuda` run the
cell at all 170 centres on a card and hold the lanes there to repeating
with the loop.

The runs set the driver's `min_feeds` so that a loaded host still reaches
the faults and a keyed carrier's events, and the carriers' SNR to -8 dB,
where the keyed carrier's tracking ends inside its 0.16 s off air, so
that every loop has a retraction and a re-acquisition.  Tolerances:
integers and flags exact; PSR and the lanes within the cell's limits
(`limits/band12_live_cfo1k5.json`).  No JAX here: the reference is the
benchmark's own.
"""

import collections
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from ltebench import run
from ltebench.drivers import band as banddrv
from ltebench.gen import band as bandgen, wideband as widegen
from ltebench.reference import band as refband, wideband as refwide
from ltetrigger_tpu_torch.models import api
from ltetrigger_tpu_torch.ops import channelize as chan
from ltetrigger_tpu_torch.models.wideband import BLOCK, WidebandTrigger
from ltetrigger_tpu_torch.utils import profiling

CELL = "band12_live_cfo1k5"
BENCH = run.load_benchmark()
_, CFG, MIX = run.resolve(BENCH, CELL)
LIMITS = run.load_json("limits", CELL)
SEED = 3_900_026_017
LOOP_S = 0.32
SMALL = {"config": {"neighbours": 1, "loop_seconds": LOOP_S,
                    "min_feeds": 34},
         "traffic": {"snr_db": [-8.0, -8.0], "keyed_snr_db": [-8.0, -8.0]}}
CPU = [torch.profiler.ProfilerActivity.CPU]
METRICS = [m["name"] for m in BENCH["per_layer"]
           if m["name"].endswith(".wide")]


def small():
    """(cfg, mix, carriers, centre offsets, loop) of the small cell."""
    cfg = dict(CFG, **SMALL["config"])
    mix = dict(MIX, **SMALL["traffic"])
    carriers = widegen.draw(mix, cfg, SEED)
    index = banddrv._centres(cfg, carriers)
    offsets = [float(f) for f in bandgen.raster(cfg)[index]]
    return cfg, mix, carriers, offsets, widegen.loop(carriers, cfg, mix,
                                                     SEED, "cpu")


@pytest.fixture(scope="module")
def band():
    return small()


def cpu_run(fault=None, trace=False, seconds=0.3):
    return run.run_cell(BENCH, CELL, SEED, seconds, trace, device="cpu",
                        overrides=json.loads(json.dumps(SMALL)), fault=fault)


@pytest.fixture(scope="module")
def traced():
    return cpu_run(trace=True)


# ------------------------------------------------------------ the cell --
def test_a_sound_traced_run_is_correct(traced):
    r = traced
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == set(LIMITS)
    info = r["info"]
    assert info["warm_depths"] == [4, 8, 16, 32]
    assert info["warm_unpublished"] == [] and info["undue"] == 0
    assert info["centres"] == 6 and info["grid_faults"] == 0
    assert info["feeds"] >= 34 and info["steps_harvested"] > 0
    # the keyed carrier came and went: a retraction and a re-acquisition
    assert info["retractions"] >= 1 and info["published"] >= 3
    assert r["checks"]["psr_rel_gap"]["value"] < 1e-5
    assert r["checks"]["chan_rel_err"]["value"] < 1e-5
    assert info["loop_covered"] and info["program_samples"] > 0
    assert info["fired"] == {}


def test_the_wide_readers_read_a_traced_run_and_none_untraced(traced):
    m = traced["metrics"]
    assert set(METRICS) == {"steps_per_dispatch.wide",
                            "wide_upload_host_ms_per_dispatch.wide",
                            "wide_mix_stream_ms_per_dispatch.wide",
                            "harvest_host_ms_per_dispatch.wide",
                            "chan_roofline.wide"}
    assert m["steps_per_dispatch.wide"]["value"] >= 4
    for name in ("wide_upload_host_ms_per_dispatch.wide",
                 "harvest_host_ms_per_dispatch.wide"):
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms/dispatch"
    # on the CPU: no CUDA events, no channelizer kernel
    assert "wide_mix_stream_ms_per_dispatch.wide" not in m
    assert "chan_roofline.wide" not in m
    rd = dict(ctx=None, state={}, e2e={}, slice=None)
    for name in METRICS:
        assert run.load_file_module("metrics", name).read(rd) is None


@pytest.mark.parametrize("fault", ["chunk_skipped", "centres_swapped",
                                   "answer_altered"])
def test_a_fault_in_the_timed_path_is_not_correct(fault):
    r = cpu_run(fault=fault)
    assert r["info"]["fired"].get(fault, 0) >= 1, r["info"]
    assert r["correct"] is False, r["checks"]


def test_the_bf16_control_is_not_correct():
    from ltebench import control_wideband

    r = control_wideband.control_numbers(CELL, SEED, 0.3, "cpu",
                                         overrides=SMALL)
    assert r["correct"] is False
    assert r["chan_rel_err"] > 10 * LIMITS["chan_rel_err"]


@pytest.mark.parametrize("lacks", ["stream_counts", "resident_lanes"])
def test_a_program_without_the_hook_cannot_run_the_cell(monkeypatch, lacks):
    if lacks == "stream_counts":
        monkeypatch.delattr(api, "stream_counts")
    else:
        monkeypatch.delattr(WidebandTrigger, "resident_lanes")
    made = []
    monkeypatch.setattr(widegen, "loop", lambda *a: made.append(a))
    with pytest.raises(RuntimeError, match="on_output|resident_lanes"):
        cpu_run()
    assert made == []


def test_the_reference_and_the_generator_import_nothing_of_the_program():
    code = ("import sys; import ltebench.reference.wideband, "
            "ltebench.gen.wideband; print(sorted({m.split('.')[0] for m "
            "in sys.modules} & {'jax', 'jaxlib', 'flax', 'ltetrigger_tpu', "
            "'ltetrigger_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=run.ROOT, check=True).stdout
    assert out.strip() == "[]"


# ------------------------------------------- the reference, the loop --
def test_stream_lanes_are_the_tiled_streams_lanes(band):
    cfg, _, _, offsets, loop = band
    rate = float(cfg["sample_rate"])
    ratio = int(round(rate / 1.92e6))
    period = loop.size // ratio
    offs = offsets[:2]
    got = refwide.stream_lanes(torch.from_numpy(loop), rate, offs)
    assert got.shape == (2, period + 9600 + 128)
    # the stream as fed: zeros before wide sample 0, then the loop twice
    tiled = torch.from_numpy(np.concatenate([loop, loop]))
    want = refband.lanes(tiled, rate, offs, 2 * period - 16)
    torch.testing.assert_close(got, want[:, :got.shape[1]], rtol=0,
                               atol=1e-9)
    # periodic past the filter's half span, not before it
    half = refwide.TAPS_HALF
    torch.testing.assert_close(want[:, period + half:2 * period - 16],
                               want[:, half:period - 16], rtol=0, atol=1e-7)
    assert (want[:, :half] - want[:, period:period + half]).abs().max() > 1e-3
    pos = torch.tensor([0, 7, 8, period + 7, period + 8, 5 * period + 9])
    assert refwide.loop_index(pos, period).tolist() == [
        0, 7, 8, period + 7, 8, 9]


def test_the_loop_repeats_without_a_seam_and_keys_a_carrier(band):
    cfg, mix, carriers, _, loop = band
    n = widegen.loop_samples(cfg)
    assert loop.shape == (n,) and loop.dtype == np.complex64
    assert sorted(c["role"] for c in carriers) == ["keyed", "steady"]
    for c in carriers:
        for f in (c["cfo_hz"], c["offset_hz"]):
            assert abs(f * LOOP_S - round(f * LOOP_S)) < 1e-6
    steady = widegen.loop([dict(c, role="steady") for c in carriers], cfg,
                          mix, SEED, "cpu")
    np.testing.assert_array_equal(loop[:n // 2], steady[:n // 2])
    assert (loop[n // 2:] != steady[n // 2:]).mean() > 0.99
    # a raster offset off the loop's frequency grid would leave a seam
    with pytest.raises(ValueError, match="seam"):
        widegen.draw(mix, dict(cfg, center_hz=cfg["center_hz"] + 1.0),
                     SEED)


# ------------------------------------------ spans, counters, accessor --
def test_both_wide_spans_and_the_counters_once_a_dispatch(band):
    cfg, _, _, offsets, loop = band
    profiling.reset()
    before = collections.Counter(api.stream_counts)
    t = WidebandTrigger(cfg["sample_rate"], offsets[:3], transport="f32",
                        device="cpu")
    first, re, _ = t.resident_lanes()
    assert re.shape == (3, 0)
    with torch.profiler.profile(activities=CPU):
        for i in range(0, loop.size // 4, 307200):
            t.process_wide(loop[i:i + 307200])
        t.flush()
    got = collections.Counter(api.stream_counts)
    got.subtract(before)
    spans = profiling.spans()
    by_seq = {s.seq: s for s in spans}
    preps = [s for s in spans if s.name == "prep"]
    uploads = [s for s in spans if s.name == "stream.upload"]
    assert got["dispatches"] == len(preps) == len(uploads) > 0
    for name in ("wide.upload", "wide.mix"):
        inner = [s for s in spans if s.name == name]
        assert len(inner) == len(uploads), name
        assert {by_seq[s.parent].name for s in inner} == {"stream.upload"}
        assert len({s.parent for s in inner}) == len(inner)
        assert all(s.device_ms is None for s in inner)
    # every wide payload sample once, from the LOOKBACK's zeros on; f32:
    # 8 bytes a sample and two context blocks an upload
    first, re, im = t.resident_lanes()
    assert got["wide_samples"] == 16 * (first + re.shape[-1] + api.LOOKBACK)
    assert got["upload_bytes"] - 8 * got["wide_samples"] \
        == 8 * 2 * BLOCK * len(uploads)
    # a copy: writing it leaves the mirror as it was
    re.zero_()
    assert t.resident_lanes()[1].abs().max() > 0


def looped_lanes(loop, offsets, device, loops=3):
    """The lanes the mirror holds after `loops` turns of `loop` fed in the
    cell's 10-ms chunks and a flush: (first, re, im)."""
    t = WidebandTrigger(CFG["sample_rate"], offsets, transport="f32",
                        device=device)
    for i in range(0, loops * loop.size, 307200):
        t.process_wide(loop[i % loop.size:][:307200])
    t.flush()
    return t.resident_lanes()


def assert_lanes_repeat(lanes, period):
    """Loop 2's lanes are loop 3's, bit for bit; loop 1's first upload
    started off the block grid (the LOOKBACK), so its first samples may
    differ in the last bit."""
    first, re, im = lanes
    assert first <= 0 and first + re.shape[-1] > 3 * period - 1000
    for x in (re, im):
        a = x[:, period - first:2 * period - 1000 - first]
        b = x[:, 2 * period - first:3 * period - 1000 - first]
        assert a.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_the_lanes_repeat_with_the_loop(band):
    """Fed in whole chunks that each dispatch takes up, every upload starts
    on the absolute block grid, and the whole-Hz centres' exact origins
    repeat with the loop: the check folds the mirror's reads onto the loop
    on that ground."""
    _, _, _, offsets, loop = band
    assert_lanes_repeat(looped_lanes(loop, offsets[:2], "cpu"),
                        loop.size // 16)


def test_whole_hz_phase_origins_are_float64s_and_repeat():
    offs = np.array([-8_500_000, 120_000, 8_400_000], dtype=np.float64)
    rate = 30_720_000.0
    for start in (-BLOCK, 123_456_000):
        got = chan._phase_tables(offs, rate, start, 40)
        n = start + BLOCK * np.arange(40, dtype=np.float64)
        f64 = np.mod(-(offs / rate)[:, None] * n[None], 1.0)
        d = np.abs(got.astype(np.float64) - f64)
        assert np.minimum(d, 1 - d).max() < 1e-6
    # whole-Hz centres: the origins repeat every second of samples, exactly
    np.testing.assert_array_equal(
        chan._phase_tables(offs, rate, 5 * BLOCK, 40),
        chan._phase_tables(offs, rate, 5 * BLOCK + 1000 * int(rate), 40))


@pytest.mark.parametrize("centre", [-2.4e6, -2.4e6 + 0.25])
def test_the_lanes_are_the_one_shot_channelizers(band, centre):
    """Whole-Hz centres take integer origins, others float64's, in the
    streaming and the one-shot channelizer alike: either way the mirror
    holds the one-shot channelizer's lanes."""
    cfg, _, _, _, loop = band
    x = loop[:4 * 307200]
    t = WidebandTrigger(cfg["sample_rate"], [centre], transport="f32",
                        device="cpu")
    for i in range(0, x.size, 307200):
        t.process_wide(x[i:i + 307200])
    t.flush()
    first, re, im = t.resident_lanes()
    want = chan.channelize(x, cfg["sample_rate"], [centre], device="cpu")
    lo = -first
    n = min(re.shape[-1] - lo, want[0].shape[-1])
    assert n > 60000
    for got, ref in zip((re, im), want):
        torch.testing.assert_close(got[:, lo:lo + n], ref[:, :n], rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


# ------------------------------------------------ on a card (marker cuda) --
@pytest.mark.cuda
def test_the_lanes_on_a_card_repeat_with_the_loop(band):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, _, _, offsets, loop = band
    assert_lanes_repeat(looped_lanes(loop, offsets, "cuda"),
                        loop.size // 16)


@pytest.mark.cuda
def test_the_cell_at_170_centres_on_a_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    r = run.run_cell(BENCH, CELL, SEED, 2.0, False, device="cuda")
    assert r["correct"] is True, r["checks"]
    assert r["info"]["centres"] == 170
    assert r["info"]["steps_harvested"] > 0
    assert r["device"]["kind"] == torch.cuda.get_device_name(0)
