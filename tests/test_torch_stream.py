"""The PyTorch port's streaming `Trigger`, its mirror functions, the
integer-CFO probe and the single-source `live_monitor` against the JAX
package on the CPU: the same seeded chunks go to both.

Tolerances: integer and boolean fields, events and their order are exact;
PSR, CFO and the other float telemetry rtol 1e-4 / atol 1e-5; the mirror is
exact for f32 samples without rotation and rtol 1e-6 otherwise (another
library's cos/sin); the probe's PSR per bin rtol 5e-3 with the same best
bin (bf16 banks).  Card-only cases carry the `cuda` marker.
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltetrigger_tpu.apps import live_monitor as jmon
from ltetrigger_tpu.models import api as japi
from ltetrigger_tpu.ops import correlate as jcorr
from ltetrigger_tpu_torch.apps import live_monitor as mon
from ltetrigger_tpu_torch.models import api, trigger as trig
from ltetrigger_tpu_torch.ops import correlate
from test_torch_common import (DECISIVE, acq_loss_reacq, fields, frames,
                               noise, offset, to_pair_torch)

CHUNK = 19200
FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)


def run_stream(cls, sig, chunk=CHUNK, **kw):
    """Feed `sig` in chunks, then flush: (trigger, events in the order the
    callbacks saw them, published cells)."""
    log = []
    t = cls(psr_threshold=4,
            on_track=lambda c: log.append(("track", fields(c))),
            on_drop=lambda cid: log.append(("drop", cid)), **kw)
    pub = []
    for i in range(0, len(sig), chunk):
        pub += t.process(sig[i:i + chunk])
    pub += t.flush()
    return t, log, [fields(c) for c in pub]


def assert_same_telemetry(port, ref):
    for name in ("tracking_score", "tracking", "cap_overflow"):
        np.testing.assert_array_equal(getattr(port, name),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("max_psr", "mean_psr", "mean_cfo", "channel_estimate"):
        np.testing.assert_allclose(getattr(port, name),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **FLOAT_TOL)
    assert port.backlog == ref.backlog


@pytest.fixture(scope="module")
def lossy():
    """Acquire cell 125, lose it under loud noise, reacquire: track and
    drop events, 30 half-frames."""
    return acq_loss_reacq(125)


@pytest.fixture(scope="module")
def lossy_jax(lossy):
    return run_stream(japi.Trigger, lossy, transport="f32")


# ------------------------------------------------------------- Trigger ----
def test_trigger_f32_events_and_telemetry_match_jax(lossy, lossy_jax):
    ref, ref_log, ref_pub = lossy_jax
    t, log, pub = run_stream(api.Trigger, lossy, transport="f32",
                             device="cpu")
    assert log == ref_log and pub == ref_pub
    assert [k for k, _ in log] == ["track", "drop", "track"]
    assert_same_telemetry(t, ref)
    assert fields(t.cellstore.latest_cell()) \
        == fields(ref.cellstore.latest_cell())


@pytest.mark.parametrize("chunk", [7777, 30 * 9600])
def test_chunking_does_not_change_events(lossy, lossy_jax, chunk):
    ref, ref_log, _ = lossy_jax
    t, log, _ = run_stream(api.Trigger, lossy, chunk=chunk, transport="f32",
                           device="cpu")
    assert log == ref_log
    np.testing.assert_allclose(t.mean_psr, ref.mean_psr, rtol=1e-5)


@pytest.mark.parametrize("pipeline", [0, 5])
def test_pipeline_depth_does_not_change_events(lossy, lossy_jax, pipeline):
    t, log, _ = run_stream(api.Trigger, lossy, transport="f32",
                           pipeline=pipeline, device="cpu")
    assert log == lossy_jax[1]
    assert t.max_in_flight == 1          # on the CPU nothing stays in flight


def test_host_buffer_is_trimmed_like_the_jax_class(lossy):
    """The pipeline trims its host buffer through the `_trim_front` hook:
    after a long synchronous feed the buffer starts and ends where the JAX
    class's does, LOOKBACK before the position drained at the last
    dispatch, and nothing is lost at the back."""
    ref, _, _ = run_stream(japi.Trigger, lossy, transport="f32", pipeline=0)
    t, _, _ = run_stream(api.Trigger, lossy, transport="f32", pipeline=0,
                         device="cpu")
    assert t._base == ref._base > 20 * 9600
    assert len(t._bufs[0]) == len(ref._buf) < 4 * 9600
    assert t._base + len(t._bufs[0]) == len(lossy)


@pytest.mark.parametrize("transport", ["i16", "i8"])
def test_quantised_transports_find_the_jax_cells(lossy, transport):
    _, ref_log, _ = run_stream(japi.Trigger, lossy, transport=transport)
    _, log, _ = run_stream(api.Trigger, lossy, transport=transport,
                           device="cpu")

    def decisive(events):
        return [(k, {f: v[f] for f in DECISIVE} if k == "track" else v)
                for k, v in events]

    assert decisive(log) == decisive(ref_log) and len(log) == 3


def test_exit_on_success_stops_like_jax():
    sig = frames(123, 10, nof_prb_field=6)
    ref = japi.Trigger(psr_threshold=4, exit_on_success=True,
                       transport="f32")
    t = api.Trigger(psr_threshold=4, exit_on_success=True, transport="f32",
                    device="cpu")
    got, want = t.process(sig), ref.process(sig)
    assert [fields(c) for c in got] == [fields(c) for c in want]
    assert len(got) == 1 and t.done and ref.done
    assert t.process(sig[:CHUNK]) == [] and t.poll() == []


def test_poll_advances_pipeline_without_feeding():
    sig = frames(123, 10, nof_prb_field=6)
    t = api.Trigger(psr_threshold=4, transport="f32", device="cpu")
    cells = t.process(sig)
    b0 = t.backlog
    for _ in range(2000):
        cells += t.poll()
        if t.backlog <= 9600:
            break
    assert t.backlog < b0 or b0 <= 9600
    # the final half-frame needs WINDOW read-ahead and stays unscannable
    assert t.backlog <= 9600
    ref = japi.Trigger(psr_threshold=4, transport="f32")
    want = ref.process(sig) + ref.flush()
    assert [fields(c) for c in cells] == [fields(c) for c in want]
    assert t.backlog == ref.backlog


def test_rebase_is_transparent(monkeypatch, lossy):
    """The int32 stream-coordinate rebase, with the threshold patched small
    in both packages: same events, same shifted coordinates."""
    monkeypatch.setattr(japi.Trigger, "REBASE_AT", 4 * CHUNK)
    monkeypatch.setattr(api.Trigger, "REBASE_AT", 4 * CHUNK)
    ref, ref_log, _ = run_stream(japi.Trigger, lossy, chunk=9600,
                                 transport="f32", pipeline=0)
    t, log, _ = run_stream(api.Trigger, lossy, chunk=9600, transport="f32",
                           pipeline=0, device="cpu")
    assert log == ref_log and len(log) == 3
    assert t._base + len(t._bufs[0]) < len(lossy), "rebase must have fired"
    assert t._base == ref._base
    np.testing.assert_array_equal(t._pos_lb, ref._pos_lb)
    assert_same_telemetry(t, ref)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_between_the_packages(tmp_path, lossy, lossy_jax,
                                                 writer):
    """A checkpoint written mid-stream by one package continues in the
    other and publishes what the uninterrupted JAX run publishes."""
    cut = 9 * CHUNK + 1234              # in the noise, after the drop
    path = str(tmp_path / "ckpt.npz")
    make = {"jax": lambda **kw: japi.Trigger(psr_threshold=4,
                                             transport="f32", **kw),
            "port": lambda **kw: api.Trigger(psr_threshold=4,
                                             transport="f32", device="cpu",
                                             **kw)}
    reader = "port" if writer == "jax" else "jax"
    first = make[writer]()
    first.process(lossy[:cut])
    first.save_state(path)
    log = []
    second = make[reader](on_track=lambda c: log.append(("track",
                                                         fields(c))),
                          on_drop=lambda cid: log.append(("drop", cid)))
    second.load_state(path)
    second.process(lossy[cut:])
    second.flush()
    ref, ref_log, _ = lossy_jax
    assert log == ref_log[2:] and log
    assert_same_telemetry(*((second, ref) if reader == "port"
                            else (ref, second)))
    with np.load(path) as data:
        assert set(data.files) == {"buf", "base", "psr_threshold", "done",
                                   "cfo_bin"} | {
            f"state_{f}" for f in trig.TriggerState._fields}


def test_checkpoint_without_chest_loads(tmp_path):
    """Files older than the channel-estimate telemetry lack `state_chest`."""
    t = api.Trigger(psr_threshold=4, transport="f32", device="cpu")
    t.process(frames(123, 3, nof_prb_field=6))
    path = str(tmp_path / "old.npz")
    t.save_state(path)
    with np.load(path) as data:
        old = {k: data[k] for k in data.files if k != "state_chest"}
    np.savez(path, **old)
    t2 = api.Trigger(psr_threshold=4, device="cpu")
    t2.load_state(path)
    assert not t2.channel_estimate.any()
    np.testing.assert_array_equal(t2.tracking_score, t.tracking_score)


def test_trigger_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.Trigger()
    with pytest.raises(ValueError, match="transport"):
        api.Trigger(transport="i4", device="cpu")


# ------------------------------------------------------ integer-CFO probe --
@pytest.mark.parametrize("cfo_bin", [0.5, -1.5, 2.0])
def test_cfo_bank_tables_byte_identical(cfo_bin):
    for got, ref in zip(correlate._toeplitz_weights(cfo_bin),
                        jcorr._toeplitz_weights(cfo_bin)):
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_cfo_bins_power_matches_jax(dtype):
    """The plain version (two matmuls over all banks) against the JAX
    function: rtol 1e-4 / atol 1e-5."""
    rng = np.random.default_rng(5)
    win = np.stack([noise(rng, correlate.V2_WINDOW + 40) for _ in range(3)])
    win[1, 300:9300] += offset(frames(200, 1, nof_prb_field=25),
                               1.5)[:9000]
    bins = api._probe_bins(2)
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                "f32": (torch.float32, jnp.float32)}[dtype]
    ref = jcorr.pss_correlate_power_cfo_bins(
        (jnp.asarray(win.real), jnp.asarray(win.imag)), bins, jdt)
    got = correlate.pss_correlate_power_cfo_bins(to_pair_torch(win), bins,
                                                 tdt)
    assert got.shape == (3, 9, 3, 9600)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5 * float(np.asarray(ref).max()))


def test_cfo_bin_probe_matches_jax():
    rx = offset(frames(200, 2, nof_prb_field=50), 1.3)
    jbuf = japi._prepare_buffer(rx, 1.92e6)
    ref_bin, ref_psr = japi._cfo_bin_probe(jbuf, 2)
    buf = api._prepare_buffer(rx, 1.92e6, device="cpu")
    got_bin, got_psr = api._cfo_bin_probe(buf, 2)
    assert int(got_bin) == int(ref_bin) == 3
    np.testing.assert_allclose(got_psr.numpy(), np.asarray(ref_psr),
                               rtol=5e-3)
    rot = api._rotate_half_bins(buf, 3)
    jrot = japi._rotate_half_bins(jbuf, 3)
    for g, r in zip(rot, jrot):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(rx).max()))


def test_search_with_cfo_range_matches_jax():
    rx = offset(frames(200, 1, nof_prb_field=50), 1.3)
    assert api.search(rx, 1.92e6, max_seconds=0.3, device="cpu") == []
    ref = japi.search(rx, 1.92e6, max_seconds=0.3, cfo_search_range=2)
    got = api.search(rx, 1.92e6, max_seconds=0.3, cfo_search_range=2,
                     device="cpu")
    assert [fields(c) for c in got] == [fields(c) for c in ref]
    assert got and got[0].cell_id == 200 and got[0].nof_prb == 50


def test_streaming_probe_acquires_an_offset_cell(tmp_path):
    rx = offset(frames(200, 12, nof_prb_field=50), 1.3)
    _, plain_log, _ = run_stream(api.Trigger, rx, device="cpu")
    assert plain_log == [], "1.3 subcarriers off must be invisible"
    ref, ref_log, _ = run_stream(japi.Trigger, rx, cfo_search_range=2)
    t, log, _ = run_stream(api.Trigger, rx, cfo_search_range=2,
                           device="cpu")
    assert [(k, v["cell_id"]) for k, v in log] == [("track", 200)]
    assert [k for k, _ in log] == [k for k, _ in ref_log]
    assert {f: log[0][1][f] for f in DECISIVE} \
        == {f: ref_log[0][1][f] for f in DECISIVE}
    assert int(t._cfo_bins[0]) == ref._cfo_bin == 3
    # the probed bin survives a checkpoint, in either package
    path = str(tmp_path / "cfo.npz")
    t.save_state(path)
    t2 = api.Trigger(cfo_search_range=2, device="cpu")
    t2.load_state(path)
    ref2 = japi.Trigger(cfo_search_range=2)
    ref2.load_state(path)
    assert int(t2._cfo_bins[0]) == ref2._cfo_bin == 3


def test_stream_cfo_probe_function_matches_jax():
    rng = np.random.default_rng(6)
    rx = offset(frames(200, 3, nof_prb_field=50), -0.9) \
        + noise(rng, 3 * CHUNK, 0.1)
    start = 1500
    ref = japi._stream_cfo_probe((jnp.asarray(rx.real), jnp.asarray(rx.imag)),
                                 jnp.int32(start), 2)
    one = api._stream_cfo_probe(to_pair_torch(rx), start, 2)
    rows = np.stack([rx, noise(rng, rx.size)])
    two = api._stream_cfo_probe(to_pair_torch(rows), start, 2)
    assert int(one) == int(ref) == -2
    assert int(two[0]) == int(ref) and two.shape == (2,)


# --------------------------------------------------------------- mirror ----
def _segment(rng, transport, length):
    if transport == "f32":
        return (rng.normal(size=(2, length)).astype(np.float32),
                np.float32(1.0))
    dt, lim = {"i16": (np.int16, 32767), "i8": (np.int8, 127)}[transport]
    return (rng.integers(-lim, lim + 1, size=(2, length)).astype(dt),
            np.float32(0.37 / lim))


@pytest.mark.parametrize("half_bins", [0, 3, -4])
@pytest.mark.parametrize("transport", ["f32", "i16", "i8"])
@pytest.mark.parametrize("shift", [0, 5000])
def test_mirror_advance_matches_jax(transport, half_bins, shift):
    rng = np.random.default_rng(7)
    cap, length, write_off, seg_start = 40000, 9000, 21000, 2 ** 29 - 3000
    dev = rng.normal(size=(2, cap)).astype(np.float32)
    dev[:, write_off + shift:] = 0      # the mirror past its valid end
    up, scale = _segment(rng, transport, length)
    ref = japi._mirror_advance(
        jnp.asarray(dev[0]), jnp.asarray(dev[1]), jnp.asarray(up[0]),
        jnp.asarray(up[1]), jnp.float32(scale), jnp.int32(shift),
        jnp.int32(write_off), jnp.int32(half_bins), jnp.int32(seg_start))
    got = api._mirror_advance(
        torch.from_numpy(dev[0].copy()), torch.from_numpy(dev[1].copy()),
        torch.from_numpy(up[0]), torch.from_numpy(up[1]),
        torch.tensor(scale), shift, write_off, half_bins, seg_start)
    for g, r in zip(got, ref):
        if transport == "f32" and half_bins == 0:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-6)
        assert not g[write_off + length:].any()


@pytest.mark.parametrize("half_bins", [0, 1, -5])
def test_mirror_rotate_matches_jax(half_bins):
    rng = np.random.default_rng(8)
    dev = rng.normal(size=(2, 30000)).astype(np.float32)
    base = 2 ** 29 - 777
    ref = japi._mirror_rotate(jnp.asarray(dev[0]), jnp.asarray(dev[1]),
                              jnp.int32(half_bins), jnp.int32(base))
    got = api._mirror_rotate(torch.from_numpy(dev[0]),
                             torch.from_numpy(dev[1]), half_bins, base)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


def test_scan_with_host_grid_equals_scan_without():
    """`grid0` only spares the read of `state.pos`: same state and output,
    and the read is counted when it happens."""
    sig = frames(125, 3, nof_prb_field=50)
    buf = tuple(torch.nn.functional.pad(c, (trig.LOOKBACK, trig.WINDOW))
                for c in to_pair_torch(sig))
    trig.host_syncs.clear()
    st_a, out_a = trig.scan_engine(buf, trig.init_state(device="cpu"), 6, 4.0)
    assert trig.host_syncs["grid"] == 1
    st_b, out_b = trig.scan_engine(buf, trig.init_state(device="cpu"), 6, 4.0,
                                   grid0=trig.LOOKBACK)
    assert trig.host_syncs["grid"] == 1 and trig.host_syncs["emit"] == 2
    for a, b in zip(tuple(st_a) + tuple(out_a), tuple(st_b) + tuple(out_b)):
        assert torch.equal(a, b)


# --------------------------------------------------------- live_monitor ----
def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()]


def test_live_monitor_prints_the_jax_events(tmp_path, capsys):
    path = tmp_path / "stream.c64"
    frames(124, 8, nof_prb_field=25).tofile(path)
    ref_out = io.StringIO()
    with open(path, "rb") as f:
        jmon.run(f, refresh_every=3, out=ref_out)
    assert mon.main([str(path), "--refresh", "3", "--device", "cpu"]) == 0
    got, ref = _json_lines(capsys.readouterr().out), \
        _json_lines(ref_out.getvalue())
    # with pipeline > 0 an event surfaces when its dispatch has drained, so
    # its place among the status lines, and what those show of the state,
    # depends on timing: events are compared in full, status lines by
    # layout and by the PSD line (a function of the samples alone)
    def events(lines):
        return [{k: v for k, v in e.items() if k != "tracking_start_time"}
                for e in lines if e["event"] != "status"]

    assert events(got) == events(ref) and events(got)[0]["cell_id"] == 124
    mine = [e for e in got if e["event"] == "status"]
    theirs = [e for e in ref if e["event"] == "status"]
    assert len(mine) == len(theirs) == 2
    for g, r in zip(mine, theirs):
        assert list(g) == list(r)               # same keys, same order
        assert g["psd_db"] == r["psd_db"]
        assert np.shape(g["mean_psr"]) == np.shape(r["mean_psr"]) == (3,)
        assert {"prep", "scan"} <= g["stages"].keys() \
            <= {"prep", "scan", "drain"}
    assert len(got) == len(ref)


def test_live_monitor_wideband_names_the_roadmap(capsys, monkeypatch):
    """`--wideband` used to exit with a pointer to the roadmap; it is ported
    now: one (empty) source runs to its end, two sources are refused."""
    monkeypatch.setattr("sys.stdin", io.TextIOWrapper(io.BytesIO(b"")))
    assert mon.main(["-", "--wideband", "-s", "7.68M", "--device",
                     "cpu"]) == 0
    with pytest.raises(SystemExit) as e:
        mon.main(["-", "-", "--wideband", "--device", "cpu"])
    assert e.value.code == 2
    assert "ROADMAP" not in capsys.readouterr().err


def test_psd_line_equals_jax():
    rng = np.random.default_rng(9)
    x = noise(rng, 5000)
    assert mon._psd_db(x) == jmon._psd_db(x)
    assert mon._psd_db(x[:7]) == jmon._psd_db(x[:7]) == [0.0] * 32


# ------------------------------------------------- on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [0, 2])
def test_trigger_on_card_equals_cpu(cuda_device, lossy, pipeline):
    _, want, _ = run_stream(api.Trigger, lossy, transport="f32",
                            device="cpu")
    t, log, _ = run_stream(api.Trigger, lossy, transport="f32",
                           pipeline=pipeline, device=cuda_device)
    assert log == want and len(log) == 3


@pytest.mark.cuda
def test_probe_banks_on_card_equal_plain(cuda_device):
    from ltetrigger_tpu_torch.ops.kernels import matched_filter
    rng = np.random.default_rng(10)
    win = tuple(torch.from_numpy(rng.normal(size=(4, correlate.V2_WINDOW))
                                 .astype(np.float32)).to(cuda_device)
                for _ in range(2))
    bins = api._probe_bins(2)
    before = matched_filter.launches
    got = matched_filter.pss_correlate_power_cfo_bins(win, bins)
    assert matched_filter.launches == before + 9
    ref = correlate.pss_correlate_power_cfo_bins(win, bins)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
