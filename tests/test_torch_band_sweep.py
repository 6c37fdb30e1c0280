"""The Band 12 sweep (`band12_sweep_cfo1k5`) on the CPU at a small size: the
port's channelizer against the benchmark's float64 reference
(`ltebench/reference/band.py`) within the cell's `chan_rel_err` limit, and
the bf16 control over it; the generator's carriers (their centre 72
subcarriers are `gen/cells.tti`'s grid, fully loaded inside their bandwidth,
placed inside the band and apart); the cell run with overrides, sound and
with three faults; the channelizer's spans and counters, one call id a
`scan_band` call, and the band metrics' readers; `wideband_scan`'s CLI
output unchanged by its split into `scan_band` and `scan_records`.  The
tests marked `cuda` hold the matched filter and pass B at the cell's
170 channels (g = 20, the scan's group over 400 steps, and 24, 4096 // 170)
to their plain versions on a card.

No JAX here: the reference is the benchmark's own.
"""

import collections
import json

import numpy as np
import pytest
import torch

from ltebench import band_trace, run
from ltebench.gen import band as bandgen, cells as cellmod, traffic as gen
from ltebench.gen.ltecore import refrx
from ltebench.gen.ltecore.constants import SLOT_LENGTH, symbol_data_offsets
from ltebench.reference import band as refband
from ltetrigger_tpu_torch.apps import wideband_scan as scan
from ltetrigger_tpu_torch.models import trigger as trig
from ltetrigger_tpu_torch.ops import channelize as chan
from ltetrigger_tpu_torch.parallel.sharded import channel_scan
from ltetrigger_tpu_torch.utils import profiling

CELL = "band12_sweep_cfo1k5"
BENCH = run.load_benchmark()
_, CFG, MIX = run.resolve(BENCH, CELL)
LIMITS = run.load_json("limits", CELL)
RATE = float(CFG["sample_rate"])
SEED = 3_900_021_017
# 0.15 s (30 steps), one capture, each carrier's raster point and one
# neighbour a side: 6 centres
SMALL = {"config": {"seconds": 0.15, "pool": 1, "neighbours": 1}}
CPU = [torch.profiler.ProfilerActivity.CPU]
METRICS = [m["name"] for m in BENCH["per_layer"]
           if m["name"].endswith(".band")]


def draw(seed=SEED, pool=1):
    return bandgen.draw_carriers(MIX, CFG, gen.rng_for(seed), pool)


def small_band(seed=SEED, seconds=0.03):
    """(capture, the six centres' offsets, carriers): a short capture."""
    cs = draw(seed)[0]
    ks = sorted({c["earfcn_index"] + d for c in cs for d in (-1, 0, 1)})
    offs = bandgen.raster(CFG)
    return (bandgen.capture(cs, int(seconds * RATE), RATE, seed, "cpu"),
            [float(offs[k]) for k in ks], cs)


# ----------------------------------------------------------- channelizer --
@pytest.mark.parametrize("seed", [SEED, 2 ** 40 + 5])
def test_channelize_is_within_the_limit_of_the_reference_and_bf16_is_not(
        seed):
    x, offs, _ = small_band(seed)
    ref = refband.lanes(torch.from_numpy(x), RATE, offs, x.size // 16)
    got = chan.channelize(x, RATE, offs, device="cpu")
    assert got[0].shape == ref.shape
    err = refband.rel_err(got, ref)
    assert err.max() <= LIMITS["chan_rel_err"], err
    xb = torch.from_numpy(x)
    xb = torch.complex(xb.real.bfloat16().float(),
                       xb.imag.bfloat16().float()).numpy()
    ctl = refband.rel_err(chan.channelize(xb, RATE, offs, device="cpu"), ref)
    assert ctl.min() > LIMITS["chan_rel_err"], ctl


@pytest.mark.parametrize("off", [-8.5e6, 0.0, 2.3e6])
def test_the_reference_is_mix_then_refrx_decimate_in_float64(off):
    rng = np.random.default_rng(3)
    n = 16 * 3000 + 7
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    ref = refband.lanes(torch.from_numpy(x), RATE, [off], n // 16,
                        outs_at_once=700)[0].numpy()
    w = np.arange(n)
    z = x * np.exp(-2j * np.pi * np.mod(off / RATE * w, 1.0))
    want = refrx.decimate(z, 16)[:n // 16]
    np.testing.assert_allclose(ref, want, rtol=0, atol=1e-12)


# ------------------------------------------------------------- generator --
def _symbols(x, step, fft, normal_cp=True):
    """[slots, nsym, fft] the FFT / fft of each CP-stripped symbol."""
    offs = symbol_data_offsets(normal_cp)
    slots = x.reshape(-1, step * SLOT_LENGTH)
    sym = np.stack([slots[:, step * o:step * o + fft] for o in offs], 1)
    return np.fft.fft(sym, axis=-1) / fft


@pytest.mark.parametrize("cell_id,prb,ports", [(7, 50, 1), (500, 25, 4),
                                               (258, 50, 2)])
def test_a_carriers_centre_72_subcarriers_are_the_tti_grid(cell_id, prb,
                                                           ports):
    cell = dict(cell_id=cell_id, prb=prb, ports=ports, normal_cp=True,
                sfn0=8, start=0)
    g = torch.Generator().manual_seed(1)
    wide = bandgen.carrier(cell, bandgen.TTI_WIDE, g, "cpu").numpy()
    got = _symbols(wide.astype(np.complex128), 16, 2048)
    tti = _symbols(cellmod.tti(cell_id, prb, ports, 8)
                   .astype(np.complex128), 1, 128)
    centre = np.r_[2048 - 36:2048, 1:37]
    np.testing.assert_allclose(got[..., centre],
                               tti[..., np.r_[128 - 36:128, 1:37]],
                               rtol=0, atol=2e-6)
    # fully loaded inside the bandwidth, at the PSS elements' power
    half = 6 * prb
    outer = np.r_[37:half + 1, 2048 - half:2048 - 36]
    _, amp = bandgen.centre_grid(cell)
    np.testing.assert_allclose(np.abs(got[..., outer]),
                               np.broadcast_to(amp[:, None, None],
                                               got[..., outer].shape),
                               rtol=1e-4)
    empty = np.r_[0, half + 1:2048 - half]
    assert np.abs(got[..., empty]).max() < 1e-5


def test_carriers_lie_on_the_raster_inside_the_band_apart():
    a, b = draw(2 ** 40 + 3, pool=2), draw(2 ** 40 + 3, pool=2)
    assert a == b and a != draw(2 ** 40 + 4, pool=2)
    f = bandgen.raster(CFG) + CFG["center_hz"]
    assert f.size == 170 and f[0] == 729e6 and abs(f[-1] - 745.9e6) < 1
    snr = []
    for cs in a:
        assert [c["prb"] for c in cs] == [50, 25]
        for c in cs:
            lo = f[c["earfcn_index"]] - c["bandwidth_hz"] / 2
            assert lo >= 729e6 and lo + c["bandwidth_hz"] <= 746e6
            assert 0 <= c["cell_id"] <= 503 and c["ports"] in (1, 2, 4)
            assert abs(c["cfo_hz"]) <= 1500 and abs(c["snr_db"]) <= 10
            snr.append(c["snr_db"])
        assert abs(cs[0]["offset_hz"] - cs[1]["offset_hz"]) >= 7.5e6
    assert sorted(snr) == [-7.5, -2.5, 2.5, 7.5]


# ------------------------------------------------------------------ cell --
def cpu_run(fault=None, trace=False, seconds=0.3):
    return run.run_cell(BENCH, CELL, SEED, seconds, trace, device="cpu",
                        overrides=json.loads(json.dumps(SMALL)), fault=fault)


def test_a_sound_small_run_is_correct_and_publishes_both_carriers():
    r = cpu_run()
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == set(LIMITS)
    assert r["info"]["undue"] == 0          # both carriers are due
    assert set(r["metrics"]) == {"scan_msps", "setup_s"}


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged",
                                   "answer_altered", "bf16_capture"])
def test_a_fault_or_the_bf16_control_is_not_correct(fault):
    r = cpu_run(fault=fault, seconds=0.05)
    assert r["correct"] is False, r["checks"]
    if fault == "bf16_capture":
        c = r["checks"]["chan_rel_err"]
        assert c["value"] > c["limit"]


# -------------------------------------------------- spans and counters --
def test_the_channelizer_spans_carry_each_scan_band_calls_id():
    x, offs, _ = small_band(seconds=0.06)
    profiling.reset()
    before = collections.Counter(chan.counts)
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            lanes, states, host = scan.scan_band(x, RATE, offs, seconds=0.05,
                                                 device="cpu")
    got = collections.Counter(chan.counts)
    got.subtract(before)
    # 0.06 s at 1.92 Msps is 115200 lanes' samples, 19200 a chunk
    assert got == {"chunks": 2 * 6, "upload_bytes": 2 * x.nbytes}
    spans = profiling.spans()
    by_seq = {s.seq: s for s in spans}
    scans = [s for s in spans if s.name == "channel_scan"]
    assert len(scans) == 2 and scans[0].call != scans[1].call
    for sc in scans:
        mine = [s for s in spans if s.call == sc.call]
        names = collections.Counter(s.name for s in mine)
        assert names["channelize"] == names["channelize.upload"] \
            == names["channelize.mix"] == names["readback.copy"] == 1
        for s in mine:
            if s.name in ("channelize.upload", "channelize.mix"):
                assert by_seq[s.parent].name == "channelize"
            if s.name == "channelize":
                assert s.parent == -1 and s.device_ms is None
    assert lanes[0].shape == (6, x.size // 16)
    assert host.track_event.shape == (10, 6, 3)


def test_channel_scan_opens_a_call_of_its_own_outside_scan_band():
    bufs = tuple(torch.zeros((1, trig.LOOKBACK + 5 * 9600 + trig.WINDOW))
                 for _ in range(2))
    profiling.reset()
    with torch.profiler.profile(activities=CPU):
        with profiling.call():
            channel_scan(bufs, 5, 4.0, device="cpu")
            channel_scan(bufs, 5, 4.0, device="cpu")
        channel_scan(bufs, 5, 4.0, device="cpu")
    calls = [s.call for s in profiling.spans() if s.name == "channel_scan"]
    assert calls[0] == calls[1] != calls[2]


def test_the_band_readers_read_a_traced_run_and_none_untraced():
    r = cpu_run(trace=True)
    assert r["correct"] is True, r["checks"]
    m = r["metrics"]
    assert set(METRICS) == {"chan_stream_ms_per_call.band",
                            "chan_host_ms_per_call.band",
                            "upload_host_ms_per_call.band",
                            "chan_roofline.band"}
    # on the CPU: host spans; no CUDA events, no device operation
    for name in ("chan_host_ms_per_call.band",
                 "upload_host_ms_per_call.band"):
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms/call"
    assert m["upload_host_ms_per_call.band"]["value"] \
        < m["chan_host_ms_per_call.band"]["value"]
    assert "chan_stream_ms_per_call.band" not in m
    assert "chan_roofline.band" not in m
    rd = dict(ctx=None, state={}, e2e={}, slice=None)
    for name in METRICS:
        assert run.load_file_module("metrics", name).read(rd) is None


def test_the_channelizer_bound_and_the_trace_reader():
    t, what = band_trace.channelizer(61_440_000, 170, 16)
    assert what == "bytes"
    assert abs(t - (8 * 61.44e6 + 8 * 170 * 3.84e6) / 3.35e12) < 1e-12
    ev = [dict(ph="X", cat="user_annotation", name="channelize", ts=0,
               dur=100, tid=1),
          dict(ph="X", cat="cuda_runtime", name="launch", ts=10, dur=1,
               tid=1, args=dict(correlation=1)),
          dict(ph="X", cat="cuda_runtime", name="launch", ts=200, dur=1,
               tid=1, args=dict(correlation=2)),
          dict(ph="X", cat="kernel", name="k", ts=50, dur=30,
               args=dict(correlation=1)),
          dict(ph="X", cat="kernel", name="k", ts=60, dur=40,
               args=dict(correlation=1)),
          dict(ph="X", cat="kernel", name="k", ts=300, dur=40,
               args=dict(correlation=2))]
    assert abs(band_trace.device_s_inside(ev, "channelize") - 50e-6) < 1e-12
    assert band_trace.device_s_inside(ev, "other") == 0


# ---------------------------------------------------------- CLI unchanged --
def _wideband_scan_as_before(iq, sample_rate, centers, seconds):
    """`wideband_scan` as one function, the body it had before its split
    into `scan_band` and `scan_records`."""
    from ltetrigger_tpu_torch.models import api
    from ltetrigger_tpu_torch.runtime.cellstore import PHICH_RES_STR

    total = int(seconds * 1_920_000)
    need_wide = int(seconds * sample_rate)
    if iq.size < need_wide:
        iq = np.tile(iq, -(-need_wide // iq.size))[:need_wide]
    chans = chan.channelize(iq, sample_rate, centers, device="cpu")
    buffers = tuple(torch.nn.functional.pad(
        comp[:, :total], (trig.LOOKBACK, trig.WINDOW)) for comp in chans)
    _, out = channel_scan(buffers, total // trig.HALF_FRAME_LENGTH,
                          api.ensure_safe_threshold(4.0))
    host = trig.unpack_output(trig.pack_output(out))
    results = []
    for ci, off in enumerate(centers):
        ev = host.track_event[:, ci, :]
        rec = {"center_offset_hz": float(off), "detected": bool(ev.any())}
        if rec["detected"]:
            s, r = np.argwhere(ev)[0]
            rec.update({
                "cell_id": int(host.cell_id[s, ci, r]),
                "nof_prb": int(host.nof_prb[s, ci, r]),
                "nof_tx_ports": int(host.nof_ports[s, ci, r]),
                "cp_len": "Normal" if host.normal_cp[s, ci, r]
                          else "Extended",
                "phich_len": "Extended" if host.phich_ext[s, ci, r]
                             else "Normal",
                "nof_phich_resources":
                    PHICH_RES_STR[int(host.phich_res[s, ci, r])],
                "psr": float(host.psr[s, ci, r]),
            })
        results.append(rec)
    return results


def test_the_cli_json_is_byte_for_byte_the_unsplit_scans(tmp_path, capsys):
    x, offs, cs = small_band(seconds=0.12)
    path = tmp_path / "band.c64"
    x.tofile(path)
    spec = ",".join(repr(o) for o in offs)
    assert scan.main([str(path), "-s", "30.72M", f"--centers={spec}",
                      "--seconds", "0.12", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    want = _wideband_scan_as_before(np.fromfile(path, np.complex64), RATE,
                                    offs, 0.12)
    assert out == json.dumps(want, indent=2) + "\n"
    got = {r["center_offset_hz"]: r for r in json.loads(out)}
    for c in cs:
        rec = got[c["offset_hz"]]
        assert rec["detected"] and rec["cell_id"] == c["cell_id"] \
            and rec["nof_prb"] == c["prb"], (rec, c)


# ------------------------------------------------ on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


C = 170


@pytest.mark.cuda
@pytest.mark.parametrize("g", [20, 24])
def test_matched_filter_at_170_channels_matches_plain_on_card(cuda_device,
                                                              g):
    from ltetrigger_tpu_torch.ops.kernels import matched_filter as mf

    gen_ = torch.Generator(device=cuda_device).manual_seed(g)
    n = trig.LOOKBACK + g * 9600 + 9600
    re, im = torch.randn((2, C, n), generator=gen_, device=cuda_device)
    lo = trig.LOOKBACK + 9600
    got = mf.group_power(re, im, lo, g, torch.bfloat16)
    ref = mf.group_power_plain(re, im, lo, g, torch.bfloat16)
    torch.cuda.synchronize()
    assert got.shape == (C, g, 75, 3, 128)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def _planted(g: int, strong, seed: int, device) -> torch.Tensor:
    """[C, g, 75, 3, 128] float32 pass-A power: unit exponential noise, and
    on the steps where strong[t] a peak with a short lobe on root (lane %
    3) at a bin of its own."""
    gen_ = torch.Generator(device=device).manual_seed(seed)
    p = -torch.log(torch.rand((C, g, 3, 9600), generator=gen_,
                              device=device))
    lanes = torch.arange(C, device=device)
    bins = (37 * lanes * 97) % 9600
    for t in range(g):
        if strong[t]:
            for d in range(4):
                for b in (bins - d, bins + d):
                    p[lanes, t, lanes % 3, b.clamp(0, 9599)] = 60 * 0.6 ** d
    return p.reshape(C, g, 3, 75, 128).permute(0, 1, 3, 2, 4).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("g", [20, 24])
def test_pass_b_at_170_channels_matches_plain_on_card(cuda_device, g):
    """Three groups (acquisition, loss, reacquisition), the last partly
    active: rows and state exact, as the kernel's contract has it."""
    from ltetrigger_tpu_torch.ops.kernels import pass_b

    strong = [t < g // 2 + 12 or t >= 2 * g + 2 for t in range(3 * g)]
    st_k = st_p = trig.init_state(batch=(C,), device=cuda_device)
    for gi in range(3):
        power = _planted(g, strong[gi * g:(gi + 1) * g], gi, cuda_device)
        n_act = g - 3 if gi == 2 else g
        grid = trig.LOOKBACK + gi * g * 9600
        st_k, rk = pass_b.scan_group_kernel(st_k, power, grid, n_act, 4.0,
                                            4, 3)
        st_p, rp = pass_b.scan_group_plain(st_p, power, grid, n_act, 4.0,
                                           4, 3)
        torch.cuda.synchronize()
        for i, (x, y) in enumerate(zip(rk, rp)):
            assert x.dtype == y.dtype and torch.equal(x, y), i
        for f in trig.TriggerState._fields:
            assert torch.equal(getattr(st_k, f), getattr(st_p, f)), f
    assert bool(st_k.tracking.any())


def test_pass_a_inputs_take_the_programs_rounding_only_at_ties():
    """A program value within tie_rel x the lane's rms of the exact value
    that rounds to another bf16 value is taken; one farther off is not."""
    mid = 1.0 + 2 ** -8          # half way between 1 and the next bf16
    exact = torch.tensor([[mid - 1e-6, mid - 1e-6, 0.5, -0.25]],
                         dtype=torch.float64)
    ref = torch.complex(exact, torch.zeros_like(exact))
    rms = float(exact.square().mean().sqrt())
    prog = (torch.tensor([[mid + 1e-6, mid + 1e-2, 0.5, -0.25]]),
            torch.zeros((1, 4)))
    (re, im), ties = refband.pass_a_inputs(ref, prog, 4, 1e-4)
    assert 2e-6 < 1e-4 * rms and ties == 1
    assert re.tolist() == [[1.0 + 2 ** -7, 1.0, 0.5, -0.25]]
    (re0, _), ties0 = refband.pass_a_inputs(ref, None, 4, 1e-4)
    assert ties0 == 0 and re0.tolist() == [[1.0, 1.0, 0.5, -0.25]]
