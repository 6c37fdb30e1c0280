"""The PyTorch port's wideband path (`ops/channelize`, `WidebandTrigger`,
`live_monitor --wideband`) against the JAX package on the CPU: the same
seeded band goes to both.

The band is the fixture of tests/test_wideband.py rebuilt from the port's
synthesizer: 7.68 Msps, centres at -2.4 / 0 / +2.4 MHz, cell 99 (25 PRB) at
the first and cell 250 (50 PRB) at the last, 12 frames.

Tolerances: phase tables (the JAX package's, or the exact fraction for
whole-Hz centres at large indices) and `shift_host` are equal arrays;
`channelize` rtol 1e-4 / atol 1e-5 on a unit-rms band (cos/sin and the
FIR's float32 sums differ in the last bits between XLA and PyTorch); f32
events, their order and `tracking_score` are exact; `mean_psr` rtol 1e-3
(the port channelizes other segments than the JAX class, which moves block
boundaries by at most 2^-24 cycles of phase); the quantised transports must
publish the same cell id, PRB, ports and CP.
"""

import io
import json

import numpy as np
import pytest
import torch

from ltetrigger_tpu.apps import live_monitor as jmon
from ltetrigger_tpu.models import wideband as jwide
from ltetrigger_tpu.ops import channelize as jchan
from ltetrigger_tpu_torch.apps import live_monitor as mon
from ltetrigger_tpu_torch.ltecore import refrx
from ltetrigger_tpu_torch.models import multi, wideband
from ltetrigger_tpu_torch.ops import channelize as chan
from test_torch_common import (DECISIVE, fields, frames, noise, offset,
                               upsample)

RATE = 7.68e6
CENTERS = [-2.4e6, 0.0, 2.4e6]
WCHUNK = 4 * 19200                      # wide samples per feed
CHAN_TOL = dict(rtol=1e-4, atol=1e-5)


def upconvert(x: np.ndarray, rate: float, offset_hz: float) -> np.ndarray:
    """A 1.92 Msps signal interpolated to `rate` and mixed to offset_hz."""
    wide = upsample(x, int(rate / 1.92e6)).astype(np.complex128)
    t = np.arange(wide.size, dtype=np.float64)
    return wide * np.exp(2j * np.pi * (offset_hz / rate) * t)


def unit(x: np.ndarray) -> np.ndarray:
    return (x / np.sqrt(np.mean(np.abs(x) ** 2))).astype(np.complex64)


def two_cell_band(n_frames: int = 12) -> np.ndarray:
    return unit(upconvert(frames(99, n_frames, nof_prb_field=25), RATE,
                          -2.4e6)
                + upconvert(frames(250, n_frames, nof_prb_field=50), RATE,
                            2.4e6))


@pytest.fixture(scope="module")
def band():
    return two_cell_band()


def run_wide(cls, wide, chunk=WCHUNK, transport="f32", centers=CENTERS,
             **kw):
    """process_wide in chunks, then flush: (trigger, events in callback
    order, published (stream, fields) pairs)."""
    log = []
    w = cls(RATE, centers, psr_threshold=4, transport=transport,
            on_track=lambda n, c: log.append(("track", n, fields(c))),
            on_drop=lambda n, cid: log.append(("drop", n, cid)), **kw)
    pub = []
    for i in range(0, len(wide), chunk):
        pub += w.process_wide(wide[i:i + chunk])
    pub += w.flush()
    return w, log, [(n, fields(c)) for n, c in pub]


@pytest.fixture(scope="module")
def jax_f32(band):
    return run_wide(jwide.WidebandTrigger, band)


@pytest.fixture(scope="module")
def port_f32(band):
    return run_wide(wideband.WidebandTrigger, band, device="cpu")


# --------------------------------------------------------- channelizer ----
def test_phase_tables_and_host_shift_are_the_jax_packages():
    """Centres off whole Hz take the JAX package's float64 tables, to the
    bit.  Whole-Hz centres take integer arithmetic: the JAX package's
    tables where float64 holds the phase exactly (small indices), and the
    exact fraction rounded once to float32 where float64 no longer does."""
    rate = 30.72e6
    whole = np.array([-2.4e6, 0.0, 1.23456e6, 7.1e6])
    off_grid = whole + np.array([0.5, 0.25, -0.125, 0.75])
    starts = (-9600, 0, 2 ** 31 + 12345, 10 ** 12 + 7)
    for start in starts:
        np.testing.assert_array_equal(
            chan._phase_tables(off_grid, rate, start, 34),
            jchan._phase_tables(off_grid / rate, start, 34))
    for start in starts[:2]:
        np.testing.assert_array_equal(
            chan._phase_tables(whole, rate, start, 34),
            jchan._phase_tables(whole / rate, start, 34))
    r = int(rate)
    for start in starts:
        exact = np.array([[np.float32(((-int(f) * (start + 9600 * b)) % r)
                                      / r) for b in range(34)]
                          for f in whole], dtype=np.float32)
        np.testing.assert_array_equal(
            chan._phase_tables(whole, rate, start, 34), exact)
    # the ramp is the table the JAX package builds inline
    offs = whole / rate
    ramp = np.mod(-offs[:, None] * np.arange(9600, dtype=np.float64)[None],
                  1.0).astype(np.float32)
    np.testing.assert_array_equal(chan._ramp_table(offs), ramp)
    assert (chan.BLOCK, chan.CHUNK_BLOCKS) == (jchan.BLOCK,
                                               jchan.CHUNK_BLOCKS)
    x = noise(np.random.default_rng(1), 5000)
    np.testing.assert_array_equal(
        chan.shift_host(x, 7.68e6, 1.5e6, start_index=10 ** 9),
        jchan.shift_host(x, 7.68e6, 1.5e6, start_index=10 ** 9))


@pytest.mark.parametrize("source", ["numpy", "pair"])
@pytest.mark.parametrize("rate,centers", [
    (7.68e6, [-2.4e6, 0.0, 2.4e6]), (15.36e6, [-5.1e6, 1.0e6])])
def test_channelize_matches_jax(rate, centers, source):
    """A length that is no multiple of the chunk (nor of the ratio), and
    more than one chunk, so both the full and the short chunk run."""
    n = 40 * 9600 + 1235
    x = unit(noise(np.random.default_rng(2), n))
    ref = jchan.channelize(x, rate, centers)
    if source == "numpy":
        got = chan.channelize(x, rate, centers, device="cpu")
    else:
        pair = (torch.from_numpy(np.ascontiguousarray(x.real)),
                torch.from_numpy(np.ascontiguousarray(x.imag)))
        got = chan.channelize(pair, rate, centers)     # device: the pair's
    for g, r in zip(got, ref):
        assert g.shape == np.asarray(r).shape \
            == (len(centers), n // int(rate / 1.92e6))
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **CHAN_TOL)


def test_channelize_is_shift_then_decimate_in_float64():
    """One channel against `shift_host` and a numpy float64 decimation with
    the reference receiver's filter."""
    n, ratio, off = 35 * 9600 + 77, 4, 2.4e6
    x = unit(noise(np.random.default_rng(3), n))
    got = chan.channelize(x, RATE, [0.0, off], device="cpu")
    h = refrx.design_lowpass(ratio, 16).astype(np.float64)
    lead = (h.size - 1) // 2
    y = np.convolve(chan.shift_host(x, RATE, off).astype(np.complex128), h)
    want = y[lead:lead + n:ratio][:n // ratio]
    mine = got[0][1].numpy() + 1j * got[1][1].numpy()
    np.testing.assert_allclose(mine, want, rtol=1e-4, atol=2e-5)


def test_channelize_checks_rate_and_device(monkeypatch):
    x = noise(np.random.default_rng(4), 9600)
    with pytest.raises(ValueError, match="1.92"):
        chan.channelize(x, 8.0e6, [0.0], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chan.channelize(x, RATE, [0.0])


def test_constant_tables_are_uploaded_once_per_device():
    """The decimator's taps and the codeword search's tables are cached per
    device: a streaming caller must not re-upload them on every call (from
    pageable memory that makes the card's stream wait)."""
    from ltetrigger_tpu_torch.ops import pbch, resample
    assert resample._taps_on(4, "cpu") is resample._taps_on(4, "cpu")
    assert resample._rational_taps_on(5, 8, "cpu") \
        is resample._rational_taps_on(5, 8, "cpu")
    np.testing.assert_array_equal(resample._taps_on(8, "cpu").numpy(),
                                  resample._taps(8))
    tabs = pbch._decode_tables("cpu")
    assert tabs is pbch._decode_tables("cpu")
    np.testing.assert_array_equal(tabs["crc"].numpy(), pbch._crc_matrix())
    np.testing.assert_array_equal(tabs["masks"].numpy(),
                                  np.repeat(pbch._crc_masks(), 4, axis=0))
    assert tabs["prb"].tolist() == [6, 15, 25, 50, 75, 100, 0, 0]
    assert tabs["ports"].tolist() == [1] * 4 + [2] * 4 + [4] * 4
    assert tabs["prb"].dtype == tabs["ports"].dtype == torch.int32


# ----------------------------------------------------- WidebandTrigger ----
def test_wideband_f32_matches_jax(jax_f32, port_f32):
    ref, ref_log, ref_pub = jax_f32
    w, log, pub = port_f32
    assert log == ref_log and pub == ref_pub
    assert [(k, n, v["cell_id"]) for k, n, v in log] \
        == [("track", 0, 99), ("track", 2, 250)]
    np.testing.assert_array_equal(w.tracking_score,
                                  np.asarray(ref.tracking_score))
    np.testing.assert_array_equal(w.tracking, np.asarray(ref.tracking))
    np.testing.assert_allclose(w.mean_psr, np.asarray(ref.mean_psr),
                               rtol=1e-3)
    np.testing.assert_array_equal(w.backlog, ref.backlog)
    assert w.stores[1].cells() == []
    # how far the host buffer is trimmed depends on the dispatch schedule;
    # the wide front always sits one context block before the narrow one
    assert w._wabs == ref._wabs == 0
    assert w._wbase == w._base * w.ratio - chan.BLOCK
    assert len(w._wbuf) < 8 * WCHUNK and w._bufs == []


def test_wideband_chunking_invariant(band, port_f32):
    """Upload-segment boundaries are invisible: another wide chunking
    publishes the same, with the same scores."""
    w, log, _ = port_f32
    w2, log2, _ = run_wide(wideband.WidebandTrigger, band, chunk=30720 * 7,
                           device="cpu")
    assert log2 == log
    np.testing.assert_array_equal(w2.tracking_score, w.tracking_score)
    np.testing.assert_allclose(w2.mean_psr, w.mean_psr, rtol=1e-4)


def test_wideband_equals_multi_fed_the_channelizer(band, port_f32):
    """The streaming front end is the one-shot channelizer fed in
    context-overlapped segments."""
    w, log, _ = port_f32
    chans = chan.channelize(band, RATE, CENTERS, device="cpu")
    narrow = [(chans[0][i] + 1j * chans[1][i]).numpy().astype(np.complex64)
              for i in range(len(CENTERS))]
    mlog = []
    m = multi.MultiTrigger(
        len(CENTERS), psr_threshold=4, transport="f32", device="cpu",
        on_track=lambda n, c: mlog.append(("track", n, fields(c))),
        on_drop=lambda n, cid: mlog.append(("drop", n, cid)))
    for i in range(0, len(narrow[0]), 19200):
        m.process_all([s[i:i + 19200] for s in narrow])
    m.flush()
    assert mlog == log
    np.testing.assert_array_equal(w.tracking_score, m.tracking_score)
    np.testing.assert_allclose(w.mean_psr, m.mean_psr, rtol=1e-3)


@pytest.mark.parametrize("transport", ["i16", "i8", "i4"])
def test_wideband_quantised_transports(band, port_f32, transport):
    _, log, _ = port_f32
    w, qlog, _ = run_wide(wideband.WidebandTrigger, band,
                          transport=transport, device="cpu")
    assert [(k, n, {f: v[f] for f in DECISIVE}) for k, n, v in qlog] \
        == [(k, n, {f: v[f] for f in DECISIVE}) for k, n, v in log]
    assert w.stores[1].cells() == []


def test_wideband_defaults_and_refusals(monkeypatch):
    w = wideband.WidebandTrigger(RATE, CENTERS, device="cpu")
    assert w.transport == "i8" and w.ratio == 4 and w.n == 3
    x = np.zeros(100, np.complex64)
    for call in (lambda: w.process(0, x), lambda: w.process_all([x] * 3),
                 lambda: w.fill_gap(0, 100)):
        with pytest.raises(TypeError, match="process_wide"):
            call()
    with pytest.raises(ValueError, match="exceeds"):
        wideband.WidebandTrigger(RATE, [3.0e6], device="cpu")
    with pytest.raises(ValueError, match="1.92"):
        wideband.WidebandTrigger(8.0e6, [0.0], device="cpu")
    # mesh=None is the unmeshed trigger: it owns every carrier
    w = wideband.WidebandTrigger(RATE, CENTERS, mesh=None, device="cpu")
    assert w.local_streams == range(3) and w.n_streams == w.n == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        wideband.WidebandTrigger(RATE, CENTERS)


def test_fill_gap_wide_is_silence(band, port_f32):
    """Dropped wide samples enter as zeros: the backlog stays bounded and
    the cells found before the gap stay published."""
    w = wideband.WidebandTrigger(RATE, CENTERS, psr_threshold=4,
                                 transport="f32", device="cpu")
    ev = w.process_wide(band[:6 * WCHUNK])
    ev += w.fill_gap_wide(2 * WCHUNK) + w.flush()
    assert sorted((n, c.cell_id) for n, c in ev) == [(0, 99), (2, 250)]
    assert int(w.backlog.max()) <= 9600
    assert w._fed_min() == 8 * 19200 - chan.BLOCK // 4


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wideband_checkpoint_crosses_between_the_packages(tmp_path, band,
                                                          writer):
    """A third cell comes up at the middle centre half way through.  A
    checkpoint taken before that, with the two outer cells tracked, resumes
    in the other package and publishes what an uninterrupted run does."""
    late = np.concatenate([np.zeros(6 * 19200, np.complex64),
                           frames(301, 6, nof_prb_field=15)])
    band = unit(band.astype(np.complex128) * 1.4
                + upconvert(late, RATE, 0.0))
    cut = 5 * WCHUNK + 4321
    path = str(tmp_path / "wide.npz")
    make = {"jax": lambda **kw: jwide.WidebandTrigger(
                RATE, CENTERS, psr_threshold=4, transport="f32", **kw),
            "port": lambda **kw: wideband.WidebandTrigger(
                RATE, CENTERS, psr_threshold=4, transport="f32",
                device="cpu", **kw)}
    reader = "port" if writer == "jax" else "jax"
    first = make[writer]()
    before = first.process_wide(band[:cut]) + first.flush()
    assert sorted((n, c.cell_id) for n, c in before) == [(0, 99), (2, 250)]
    first.save_state(path)
    log = []
    second = make[reader](
        on_track=lambda n, c: log.append(("track", n, fields(c))),
        on_drop=lambda n, cid: log.append(("drop", n, cid)))
    second.load_state(path)
    second.process_wide(band[cut:])
    second.flush()
    whole, whole_log, _ = run_wide(wideband.WidebandTrigger, band,
                                   device="cpu")
    assert log == whole_log[2:] and len(log) == 1
    assert log[0][:2] == ("track", 1) and log[0][2]["cell_id"] == 301
    np.testing.assert_array_equal(np.asarray(second.tracking_score),
                                  whole.tracking_score)
    np.testing.assert_allclose(np.asarray(second.mean_psr), whole.mean_psr,
                               rtol=1e-3)
    with np.load(path) as data:
        assert {"n", "base", "psr_threshold", "cfo_bins", "wide", "wbase",
                "wabs", "sample_rate", "centers", "state_pos",
                "state_chest"} <= set(data.files)
    other = wideband.WidebandTrigger(RATE, [0.0, 2.4e6, -2.4e6],
                                     device="cpu")
    with pytest.raises(ValueError, match="centre plan"):
        other.load_state(path)


def test_wideband_rebase_keeps_the_mixer_phase(monkeypatch):
    """The coordinate rebase must not jump the mixer phase (origins are
    evaluated at absolute wide indices via _wabs): the events equal those of
    a run without a rebase."""
    wide = two_cell_band(16)
    plain, log, _ = run_wide(wideband.WidebandTrigger, wide, pipeline=0,
                             device="cpu")
    assert plain._wabs == 0
    monkeypatch.setattr(wideband.WidebandTrigger, "REBASE_AT", 4 * 19200)
    w, rlog, _ = run_wide(wideband.WidebandTrigger, wide, pipeline=0,
                          device="cpu")
    assert w._wabs > 0 and w._wabs % (4 * 19200 * 4) == 0, \
        "rebase must have fired"
    assert w._wbase + w._wabs == plain._wbase
    assert rlog == log and len(log) == 2
    np.testing.assert_array_equal(w.tracking_score, plain.tracking_score)
    np.testing.assert_allclose(w.mean_psr, plain.mean_psr, rtol=1e-4)
    assert w.tracking[0].any() and w.tracking[2].any()


def test_wideband_integer_cfo_acquisition():
    """A carrier inside the band 1.3 subcarriers off (invisible to the plain
    matched filter) acquires through the inherited per-stream integer-CFO
    probe, which rotates only that carrier's channelized mirror rows."""
    wide = unit(
        upconvert(offset(frames(200, 12, nof_prb_field=50), 1.3), RATE,
                  -2.4e6)
        + upconvert(frames(250, 12, nof_prb_field=50), RATE, 2.4e6))
    plain, _, _ = run_wide(wideband.WidebandTrigger, wide, device="cpu")
    assert plain.stores[0].cells() == [], \
        "uncorrected filter must NOT see the offset carrier"
    assert plain.stores[2].latest_cell().cell_id == 250
    w, _, _ = run_wide(wideband.WidebandTrigger, wide, cfo_search_range=2,
                       device="cpu")
    assert w.stores[0].latest_cell() is not None \
        and w.stores[0].latest_cell().cell_id == 200
    assert w.stores[2].latest_cell().cell_id == 250
    assert w._cfo_bins[0] != 0 and w._cfo_bins[2] == 0


# --------------------------------------------------------- live_monitor ----
def test_live_monitor_wideband_prints_the_jax_events(tmp_path, capsys, band):
    path = str(tmp_path / "band.c64")
    band[:10 * WCHUNK].tofile(path)
    ref_out = io.StringIO()
    with open(path, "rb") as f:
        jmon.run_wideband(f, RATE, CENTERS, refresh_every=3, out=ref_out,
                          transport="f32")
    assert mon.main([path, "--wideband", "-s", "7.68M", "--centers=-2.4M,0,2.4M",
                     "--refresh", "3", "--transport", "f32",
                     "--device", "cpu"]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    ref = [json.loads(x) for x in ref_out.getvalue().splitlines()]

    def events(lines):
        return [{k: v for k, v in e.items() if k != "tracking_start_time"}
                for e in lines if e["event"] != "status"]

    assert events(got) == events(ref)
    assert [(e["event"], e["stream"], e["center_offset_hz"], e["cell_id"])
            for e in events(got)] \
        == [("track", 0, -2.4e6, 99), ("track", 2, 2.4e6, 250)]
    mine = [e for e in got if e["event"] == "status"]
    theirs = [e for e in ref if e["event"] == "status"]
    assert len(mine) == len(theirs) == 3
    # what a status line shows depends on how far the pipeline has drained
    # when it is printed, so only its layout is compared
    for g, r in zip(mine, theirs):
        assert list(g) == list(r)
        assert g["centers_hz"] == CENTERS and len(g["psd_db"]) == 32
        assert np.shape(g["mean_psr"]) == np.shape(r["mean_psr"]) == (3, 3)


def test_live_monitor_wideband_takes_one_source(tmp_path, capsys):
    paths = [str(tmp_path / f"s{i}.c64") for i in range(2)]
    for p in paths:
        np.zeros(10, np.complex64).tofile(p)
    with pytest.raises(SystemExit):
        mon.main(paths + ["--wideband", "--device", "cpu"])
    assert "exactly one source" in capsys.readouterr().err


# ------------------------------------------------- on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["f32", "i4"])
def test_wideband_on_card_equals_cpu(cuda_device, band, port_f32, transport):
    _, want, _ = port_f32
    _, log, _ = run_wide(wideband.WidebandTrigger, band, transport=transport,
                         device=cuda_device)
    keys = None if transport == "f32" else DECISIVE
    strip = [(k, n, {f: v[f] for f in keys} if keys else v)
             for k, n, v in log]
    assert strip == [(k, n, {f: v[f] for f in keys} if keys else v)
                     for k, n, v in want]
    assert log


@pytest.mark.cuda
def test_channelize_on_card_equals_cpu(cuda_device, band):
    want = chan.channelize(band, RATE, CENTERS, device="cpu")
    got = chan.channelize(band, RATE, CENTERS, device=cuda_device)
    for g, r in zip(got, want):
        torch.testing.assert_close(g.cpu(), r, **CHAN_TOL)
