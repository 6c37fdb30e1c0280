"""The long-running monitor's paths against the JAX package on the CPU: the
int32-guard coordinate rebase with dispatches in flight, across an integer
CFO, in `MultiTrigger` and `WidebandTrigger`; a checkpoint written after a
rebase and continued in the other package; a producer pacing itself on
`backlog` with `poll()`; and the streaming integer-CFO probe when the cell
comes up after noise.

`REBASE_AT` is lowered in both packages to 3 x 19200 = 57600 samples (a
multiple of 256, which the rebase requires), so that 3 or more rebases fire
within 30 half-frames.  The port runs with two dispatches in flight
(`pipeline=2`).  The JAX classes plan from an estimate of the grid and trim
their host buffers later, so at `pipeline=2` they do not rebase within a
stream this short; the JAX reference runs at `pipeline=0` (its events do not
depend on the depth: tests/test_torch_stream.py), except with an integer
CFO: the JAX probe runs only where the 4 half-frames after its drained
position are in its mirror, which at `pipeline=0` they never are, so there
the reference runs at `pipeline=2` and the rebases are the port's alone.
`_base` is held equal to the JAX class's at equal depth in
test_torch_stream.py / test_torch_multi.py.  Positions are compared in
absolute stream coordinates: drained position plus rebases x REBASE_AT.

Tolerances: events and their order, integer telemetry and positions exact;
the port against its own run without a rebase bit for bit; float telemetry
against JAX rtol 1e-4 / atol 1e-5, the wideband's mean PSR rtol 1e-3 (ROADMAP
section 3, "No upload quantum"); with an integer CFO the streaming probe's
kept difference (ROADMAP section 3) leaves the JAX telemetry
uncompared and the i8 events are held by their decisive fields, as
tests/test_torch_stream.py does.
"""

import time

import numpy as np
import pytest

from ltetrigger_tpu.models import api as japi
from ltetrigger_tpu.models import multi as jmulti
from ltetrigger_tpu.models import wideband as jwide
from ltetrigger_tpu_torch.models import api, multi, wideband
from test_torch_common import (DECISIVE, acq_loss_reacq, fields, frames,
                               noise, offset, upsample)

CHUNK = 19200
RATE = 7.68e6
REBASE = 3 * CHUNK
FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)
TELEMETRY = ("tracking_score", "tracking", "cap_overflow", "max_psr",
             "mean_psr", "mean_cfo", "channel_estimate")
CENTERS4 = [-2.4e6, -0.8e6, 0.8e6, 2.4e6]
RATIO = int(RATE / 1.92e6)


def upconvert(x: np.ndarray, offset_hz: float) -> np.ndarray:
    """A 1.92 Msps signal interpolated to RATE and mixed to offset_hz."""
    wide = upsample(x, RATIO).astype(np.complex128)
    t = np.arange(wide.size, dtype=np.float64)
    return wide * np.exp(2j * np.pi * (offset_hz / RATE) * t)


def lower_rebase(monkeypatch, *classes):
    for cls in classes:
        monkeypatch.setattr(cls, "REBASE_AT", REBASE)


def fed_end(t) -> int:
    """Where the host's samples end, in the trigger's own coordinates."""
    if hasattr(t, "_wbuf"):
        return (t._wbase + len(t._wbuf) - wideband.BLOCK) // t.ratio
    bufs = t._bufs if hasattr(t, "_bufs") else [t._buf]
    return min(t._base + len(b) for b in bufs)


def rebases(t, n_fed: int) -> int:
    """How many rebases a trigger fed `n_fed` samples a stream made."""
    k, rest = divmod(n_fed - fed_end(t), REBASE)
    assert rest == 0, (n_fed, fed_end(t))
    return k


def run_trigger(cls, sig, chunk=CHUNK, **kw):
    """process() in chunks, then flush: (trigger, events in callback
    order)."""
    log = []
    t = cls(psr_threshold=4,
            on_track=lambda c: log.append(("track", fields(c))),
            on_drop=lambda cid: log.append(("drop", cid)), **kw)
    for i in range(0, len(sig), chunk):
        t.process(sig[i:i + chunk])
    t.flush()
    return t, log


def tagged_log(log):
    return dict(on_track=lambda n, c: log.append(("track", n, fields(c))),
                on_drop=lambda n, cid: log.append(("drop", n, cid)))


def run_multi(cls, sigs, chunk=CHUNK, **kw):
    log = []
    m = cls(len(sigs), psr_threshold=4, **tagged_log(log), **kw)
    for i in range(0, len(sigs[0]), chunk):
        m.process_all([s[i:i + chunk] for s in sigs])
    m.flush()
    return m, log


def run_wide(cls, wide, chunk=4 * CHUNK, **kw):
    log = []
    w = cls(RATE, CENTERS4, psr_threshold=4, transport="f32",
            **tagged_log(log), **kw)
    for i in range(0, len(wide), chunk):
        w.process_wide(wide[i:i + chunk])
    w.flush()
    return w, log


def decisive(events):
    return [(k, {f: v[f] for f in DECISIVE} if k == "track" else v)
            for k, v in events]


def assert_bit_equal(got, want):
    for name in TELEMETRY:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)


def assert_close_to_jax(port, ref, psr_rtol=1e-4):
    for name in ("tracking_score", "tracking", "cap_overflow"):
        np.testing.assert_array_equal(getattr(port, name),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("max_psr", "mean_psr", "mean_cfo", "channel_estimate"):
        tol = dict(FLOAT_TOL, rtol=psr_rtol) if name == "mean_psr" \
            else FLOAT_TOL
        np.testing.assert_allclose(getattr(port, name),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **tol)


@pytest.fixture(scope="module")
def streams4():
    """Four dissimilar streams of 30 half-frames: a cell acquired, lost
    and reacquired; noise; a steady cell in weak noise; another cell
    acquired, lost and reacquired."""
    rng = np.random.default_rng(11)
    a = acq_loss_reacq(125)
    c = frames(207, 15, nof_prb_field=25) + noise(rng, a.size, 0.05)
    return [a, noise(rng, a.size, 0.5), c.astype(np.complex64),
            acq_loss_reacq(301, seed=3)]


def band4(late_from: int = 0, n_frames: int = 16) -> np.ndarray:
    """7.68 Msps, cells 99 (25 PRB) at -2.4 MHz and 250 (50 PRB) at +2.4
    MHz throughout, cell 40 (15 PRB) at +0.8 MHz from frame `late_from`;
    nothing at -0.8 MHz."""
    late = frames(40, n_frames, nof_prb_field=15)
    late[:late_from * 19200] = 0
    x = upconvert(frames(99, n_frames, nof_prb_field=25), -2.4e6) \
        + upconvert(frames(250, n_frames, nof_prb_field=50), 2.4e6) \
        + upconvert(late, 0.8e6)
    return (x / np.sqrt(np.mean(np.abs(x) ** 2))).astype(np.complex64)


# ------------------------------------------------------------- Trigger ----
@pytest.mark.parametrize("transport,subcarriers", [
    ("f32", 0.0), ("f32", 1.0), ("i8", 1.0)])
def test_trigger_rebases_with_dispatches_in_flight(monkeypatch, transport,
                                                   subcarriers):
    """Three or more rebases while two dispatches are in flight, with and
    without an integer CFO (+2 half-subcarriers, cfo_search_range=2): the
    port's events and telemetry equal its own run without a rebase bit for
    bit, its events equal the JAX package's, and both stand at the same
    absolute positions."""
    sig = acq_loss_reacq(125)
    if subcarriers:
        sig = offset(sig, subcarriers)
    kw = dict(transport=transport,
              cfo_search_range=2 if subcarriers else 0)
    plain, plain_log = run_trigger(api.Trigger, sig, device="cpu", **kw)
    lower_rebase(monkeypatch, api.Trigger, japi.Trigger)
    t, log = run_trigger(api.Trigger, sig, device="cpu", **kw)
    ref, ref_log = run_trigger(japi.Trigger, sig,
                               pipeline=2 if subcarriers else 0, **kw)
    k, k_ref = rebases(t, sig.size), rebases(ref, sig.size)
    assert k >= 3 and (k_ref >= 3 or subcarriers), (k, k_ref)
    assert t.max_in_flight == 1 and t.pipeline == 2

    assert log == plain_log and [e for e, _ in log] == ["track", "drop",
                                                        "track"]
    for name in ("_base", "_grid", "_dev_base"):
        assert getattr(t, name) + k * REBASE == getattr(plain, name), name
    np.testing.assert_array_equal(t._pos_lb + k * REBASE, plain._pos_lb)
    np.testing.assert_array_equal(t._cfo_bins, plain._cfo_bins)
    assert_bit_equal(t, plain)

    np.testing.assert_array_equal(t._pos_lb + k * REBASE,
                                  ref._pos_lb + k_ref * REBASE)
    assert t.backlog == ref.backlog
    if transport == "f32":
        assert log == ref_log
    else:
        assert decisive(log) == decisive(ref_log)
    if subcarriers:
        assert int(t._cfo_bins[0]) == ref._cfo_bin == 2
    else:
        assert_close_to_jax(t, ref)


# -------------------------------------------- MultiTrigger / Wideband ----
@pytest.mark.parametrize("kind", ["multi", "wideband"])
def test_multi_and_wideband_rebase_like_jax(monkeypatch, streams4, kind):
    """MultiTrigger(4) and WidebandTrigger(4 carriers), 3 or more rebases
    with dispatches in flight: the events equal the port's run without a
    rebase and the JAX package's, telemetry and positions too; the wide
    stream's `_wabs` is the rebases' deltas and keeps the mixer phase."""
    if kind == "multi":
        cls, jcls, n_fed = multi.MultiTrigger, jmulti.MultiTrigger, \
            streams4[0].size

        def run(c, **kw):
            return run_multi(c, streams4, transport="f32", **kw)
    else:
        wide = band4()
        # a narrow sample is made once the wide stream holds one context
        # block past it
        cls, jcls, n_fed = wideband.WidebandTrigger, jwide.WidebandTrigger, \
            (wide.size - wideband.BLOCK) // RATIO

        def run(c, **kw):
            return run_wide(c, wide, **kw)
    plain, plain_log = run(cls, device="cpu")
    lower_rebase(monkeypatch, cls, jcls)
    m, log = run(cls, device="cpu")
    ref, ref_log = run(jcls, pipeline=0)
    k, k_ref = rebases(m, n_fed), rebases(ref, n_fed)
    assert k >= 3 and k_ref >= 3, (k, k_ref)

    assert log == plain_log == ref_log
    assert {n for e, n, _ in log if e == "track"} \
        == ({0, 2, 3} if kind == "multi" else {0, 2, 3})
    np.testing.assert_array_equal(m._pos_lb + k * REBASE, plain._pos_lb)
    np.testing.assert_array_equal(m._pos_lb + k * REBASE,
                                  ref._pos_lb + k_ref * REBASE)
    assert_bit_equal(m, plain)
    assert_close_to_jax(m, ref, 1e-4 if kind == "multi" else 1e-3)
    if kind == "wideband":
        assert m._wabs == k * REBASE * RATIO and plain._wabs == 0
        assert ref._wabs == k_ref * REBASE * RATIO
        assert m._wbase + m._wabs == plain._wbase
        assert m._wbase + len(m._wbuf) + m._wabs \
            == ref._wbase + len(ref._wbuf) + ref._wabs


# ---------------------------------------------------------- checkpoint ----
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["trigger", "wideband"])
def test_checkpoint_after_a_rebase_crosses_between_the_packages(
        tmp_path, monkeypatch, kind, writer):
    """A checkpoint written after two rebases by one package continues in
    the other and publishes what the uninterrupted JAX run publishes after
    the cut (the wideband's late cell, the Trigger's reacquisition)."""
    lower_rebase(monkeypatch, api.Trigger, japi.Trigger,
                 wideband.WidebandTrigger, jwide.WidebandTrigger)
    path = str(tmp_path / "ckpt.npz")
    if kind == "trigger":
        sig, cut = acq_loss_reacq(125), 9 * CHUNK + 1234
        make = {"jax": lambda **kw: japi.Trigger(psr_threshold=4,
                                                 transport="f32", **kw),
                "port": lambda **kw: api.Trigger(psr_threshold=4,
                                                 transport="f32",
                                                 device="cpu", **kw)}
        whole, whole_log = run_trigger(japi.Trigger, sig, transport="f32")
        after = whole_log[2:]

        def feed(t, x):
            for i in range(0, len(x), CHUNK):
                t.process(x[i:i + CHUNK])

        def logged(log):
            return dict(on_track=lambda c: log.append(("track", fields(c))),
                        on_drop=lambda cid: log.append(("drop", cid)))
    else:
        sig, cut = band4(late_from=10), 8 * 19200 * RATIO + 4321
        make = {"jax": lambda **kw: jwide.WidebandTrigger(
                    RATE, CENTERS4, psr_threshold=4, transport="f32", **kw),
                "port": lambda **kw: wideband.WidebandTrigger(
                    RATE, CENTERS4, psr_threshold=4, transport="f32",
                    device="cpu", **kw)}
        whole, whole_log = run_wide(jwide.WidebandTrigger, sig)
        after = [e for e in whole_log if e[1] == 2]

        def feed(t, x):
            for i in range(0, len(x), 4 * CHUNK):
                t.process_wide(x[i:i + 4 * CHUNK])

        logged = tagged_log
    reader = "port" if writer == "jax" else "jax"
    first = make[writer](pipeline=0) if writer == "jax" else make[writer]()
    feed(first, sig[:cut])
    first.save_state(path)
    with np.load(path) as data:
        # the checkpoint holds rebased coordinates
        assert int(data["state_pos"].min()) + 2 * REBASE \
            <= cut // (RATIO if kind == "wideband" else 1)
        if kind == "wideband":
            assert int(data["wabs"]) >= 2 * REBASE * RATIO
    log = []
    second = make[reader](**logged(log))
    second.load_state(path)
    feed(second, sig[cut:])
    second.flush()
    assert log == after and log
    port, ref = (second, whole) if reader == "port" else (whole, second)
    assert_close_to_jax(port, ref, 1e-4 if kind == "trigger" else 1e-3)


# ------------------------------------------------------------- pacing ----
def paced(t, sigs, bound: float, chunk: int = 7777) -> int:
    """Feed in `chunk`-sample pieces; after each, poll() until every
    stream's backlog is at most `bound` (for at most 60 s: the JAX class's
    outputs arrive asynchronously).  Returns the most backlog seen after
    the polls."""
    worst = 0
    multi_ = len(sigs) > 1
    for i in range(0, len(sigs[0]), chunk):
        if multi_:
            t.process_all([s[i:i + chunk] for s in sigs])
        else:
            t.process(sigs[0][i:i + chunk])
        deadline = time.monotonic() + 60.0
        while np.max(t.backlog) > bound and time.monotonic() < deadline:
            t.poll()
            time.sleep(0.001)
        worst = max(worst, int(np.max(t.backlog)))
    t.flush()
    return worst


@pytest.mark.parametrize("kind", ["trigger", "multi"])
def test_paced_feeder_publishes_the_unpaced_events(monkeypatch, streams4,
                                                   kind):
    """A feeder that holds `backlog` under 3 half-frames by calling poll()
    between feeds, across rebases: the same events as the same stream fed
    unpaced, in both packages."""
    lower_rebase(monkeypatch, api.Trigger, japi.Trigger, multi.MultiTrigger,
                 jmulti.MultiTrigger)
    bound = 3 * 9600
    logs, worst = {}, {}
    for pkg in ("jax", "port"):
        dev = {} if pkg == "jax" else {"device": "cpu"}
        for pace in (False, True):
            log = []
            if kind == "trigger":
                sigs = streams4[:1]
                t = (japi.Trigger if pkg == "jax" else api.Trigger)(
                    psr_threshold=4, transport="f32",
                    on_track=lambda c, log=log: log.append(("track",
                                                            fields(c))),
                    on_drop=lambda cid, log=log: log.append(("drop", cid)),
                    **dev)
            else:
                sigs = streams4
                t = (jmulti.MultiTrigger if pkg == "jax"
                     else multi.MultiTrigger)(
                    len(sigs), psr_threshold=4, transport="f32",
                    **tagged_log(log), **dev)
            if pace:
                worst[pkg] = paced(t, sigs, bound)
            else:
                paced(t, sigs, np.inf, chunk=CHUNK)
            logs[pkg, pace] = log
    assert worst["port"] <= bound and worst["jax"] <= bound, worst
    assert logs["port", True] == logs["port", False] == logs["jax", True] \
        == logs["jax", False] and logs["port", True]


# ------------------------------------------ the probe after a lead-in ----
@pytest.mark.parametrize("kind", ["trigger", "multi"])
def test_cfo_probe_reaches_an_offset_cell_after_noise(kind):
    """A cell one subcarrier off (+2 half-subcarriers) that comes up after
    0.2 s of noise 20 dB over it, cfo_search_range=4 (bins -8 .. 8).  The
    port's probe searches absolute bins and moves a rotation only on a hit
    (its best bin's PSR over PROBE_MIN_PSR): the rotation stays put through
    the noise, and the first probe of the cell finds bin 2, so the port
    publishes the cell with the decisive fields the JAX package publishes
    on the same stream.  (Moving by every probe's best bin relative to the
    rotation, as the JAX package does, walked the port's rotation to -8 ..
    -28 in the noise, and the cell was never published; the JAX package
    probes less often at its default depth and finds this one: ROADMAP
    section 3.)"""
    rng = np.random.default_rng(5)
    cell = frames(200, 20, nof_prb_field=50)
    lead = noise(rng, 4 * 96000, 10.0)
    rx = offset(np.concatenate([lead, cell]).astype(np.complex64), 1.0)
    rx = (rx + noise(rng, rx.size, 0.05)).astype(np.complex64)
    kw = dict(transport="f32", cfo_search_range=4)
    if kind == "trigger":
        ref, want = run_trigger(japi.Trigger, rx, **kw)
        t, log = run_trigger(api.Trigger, rx, device="cpu", **kw)
        assert [(e, v["cell_id"]) for e, v in log] == [("track", 200)]
        assert decisive(log) == decisive(want)
        assert t._cfo_bins.tolist() == [ref._cfo_bin] == [2]
    else:
        quiet = noise(rng, rx.size, 0.5)
        ref, want = run_multi(jmulti.MultiTrigger, [rx, quiet], **kw)
        m, log = run_multi(multi.MultiTrigger, [rx, quiet], device="cpu",
                           **kw)
        assert [(e, n, v["cell_id"]) for e, n, v in log] \
            == [("track", 0, 200)]
        assert decisive([(e, v) for e, _, v in log]) \
            == decisive([(e, v) for e, _, v in want])
        assert m._cfo_bins[0] == ref._cfo_bins[0] == 2
        # the noise stream's rotation never moves
        assert m._cfo_bins.tolist() == [2, 0]
