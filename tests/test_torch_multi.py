"""The PyTorch port's `MultiTrigger`, its batched mirror functions and the
multi-source `live_monitor` against the JAX package on the CPU, and against
N single-stream `Trigger`s of the port: the same seeded chunks go to each.

Tolerances: events, their order and every integer or boolean field are
exact for the f32 transport; float telemetry rtol 1e-4 / atol 1e-5; the
quantised transports (i16 / i8 / i4) must publish the same cell id, PRB,
ports and CP; the mirror rtol 1e-6 (exact for f32 without rotation).
Card-only cases carry the `cuda` marker.  Every case uses 3 streams, so the
JAX package compiles one family of shapes.
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltetrigger_tpu.apps import live_monitor as jmon
from ltetrigger_tpu.models import multi as jmulti
from ltetrigger_tpu_torch.apps import live_monitor as mon
from ltetrigger_tpu_torch.models import api, multi
from test_torch_common import (DECISIVE, acq_loss_reacq, fields, frames,
                               noise, offset)

CHUNK = 19200
N = 3
FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def streams():
    """Three dissimilar streams of 30 half-frames: a cell acquired, lost
    and reacquired; noise; another cell with a weak noise floor."""
    rng = np.random.default_rng(11)
    a = acq_loss_reacq(125)
    c = frames(207, 15, nof_prb_field=25) + noise(rng, a.size, 0.05)
    return [a, noise(rng, a.size, 0.5), c.astype(np.complex64)]


def run_multi(cls, sigs, chunk=CHUNK, **kw):
    """process_all in chunks, then flush: (trigger, events in callback
    order, published (stream, fields) pairs)."""
    log = []
    m = cls(len(sigs), psr_threshold=4,
            on_track=lambda n, c: log.append(("track", n, fields(c))),
            on_drop=lambda n, cid: log.append(("drop", n, cid)), **kw)
    pub = []
    for i in range(0, len(sigs[0]), chunk):
        pub += m.process_all([s[i:i + chunk] for s in sigs])
    pub += m.flush()
    return m, log, [(n, fields(c)) for n, c in pub]


def assert_same_telemetry(port, ref):
    for name in ("tracking_score", "tracking", "cap_overflow"):
        np.testing.assert_array_equal(getattr(port, name),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("max_psr", "mean_psr", "mean_cfo", "channel_estimate"):
        np.testing.assert_allclose(getattr(port, name),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **FLOAT_TOL)
    np.testing.assert_array_equal(port.backlog, ref.backlog)


@pytest.fixture(scope="module")
def jax_f32(streams):
    return run_multi(jmulti.MultiTrigger, streams, transport="f32")


# -------------------------------------------------------- MultiTrigger ----
def test_multi_f32_matches_jax_multi(streams, jax_f32):
    ref, ref_log, ref_pub = jax_f32
    m, log, pub = run_multi(multi.MultiTrigger, streams, transport="f32",
                            device="cpu")
    assert log == ref_log and pub == ref_pub
    assert [(k, n) for k, n, _ in log if n == 0] \
        == [("track", 0), ("drop", 0), ("track", 0)]
    assert {n for _, n, _ in log} == {0, 2}
    assert_same_telemetry(m, ref)
    assert m.stores[1].cells() == []


def test_multi_equals_single_triggers(streams):
    m, log, _ = run_multi(multi.MultiTrigger, streams, transport="f32",
                          device="cpu")
    for n, sig in enumerate(streams):
        one_log = []
        t = api.Trigger(
            psr_threshold=4, transport="f32", device="cpu",
            on_track=lambda c: one_log.append(("track", n, fields(c))),
            on_drop=lambda cid: one_log.append(("drop", n, cid)))
        for i in range(0, len(sig), CHUNK):
            t.process(sig[i:i + CHUNK])
        t.flush()
        assert [e for e in log if e[1] == n] == one_log
        np.testing.assert_array_equal(m.tracking_score[n], t.tracking_score)
        np.testing.assert_allclose(m.mean_psr[n], t.mean_psr, **FLOAT_TOL)
        np.testing.assert_allclose(m.mean_cfo[n], t.mean_cfo, **FLOAT_TOL)
        assert [fields(c) for c in m.stores[n].cells()] \
            == [fields(c) for c in t.cellstore.cells()]


def test_host_buffers_are_trimmed_like_the_jax_class(streams):
    """The pipeline trims its host buffers through the `_trim_front` hook:
    after a long synchronous feed every stream's buffer starts and ends
    where the JAX class's does, and nothing is lost at the back."""
    ref, _, _ = run_multi(jmulti.MultiTrigger, streams, transport="f32",
                          pipeline=0)
    m, _, _ = run_multi(multi.MultiTrigger, streams, transport="f32",
                        pipeline=0, device="cpu")
    assert m._base == ref._base > 20 * 9600
    assert [len(b) for b in m._bufs] == [len(b) for b in ref._bufs]
    assert all(m._base + len(b) == len(streams[0]) < m._base + 4 * 9600
               for b in m._bufs)


@pytest.mark.parametrize("transport", ["i16", "i8", "i4"])
def test_quantised_transports_find_the_jax_cells(streams, transport):
    _, ref_log, _ = run_multi(jmulti.MultiTrigger, streams,
                              transport=transport)
    m, log, _ = run_multi(multi.MultiTrigger, streams, transport=transport,
                          device="cpu")

    def decisive(events):
        return [(k, n, {f: v[f] for f in DECISIVE} if k == "track" else v)
                for k, n, v in events]

    assert decisive(log) == decisive(ref_log)
    assert m.stores[0].latest_cell().cell_id == 125
    assert m.stores[2].latest_cell().cell_id == 207
    assert m.stores[1].cells() == []


def test_shared_consumption_and_fill_gap(streams):
    """The group advances at the slowest stream's pace; fill_gap unblocks
    it, in the port as in the JAX package."""
    sig = streams[2][:6 * CHUNK]
    got = {}
    for name, cls, kw in (("jax", jmulti.MultiTrigger, {}),
                          ("port", multi.MultiTrigger, {"device": "cpu"})):
        m = cls(N, psr_threshold=4, transport="f32", **kw)
        m.process(0, sig)
        m.flush()
        assert m.stores[0].cells() == []        # streams 1, 2 have no data
        stalled = np.asarray(m.backlog).copy()
        assert stalled[0] > stalled[1] == stalled[2]
        ev = m.fill_gap(1, len(sig)) + m.fill_gap(2, len(sig)) + m.flush()
        assert m.stores[0].latest_cell().cell_id == 207
        assert m.stores[1].cells() == [] and m.stores[2].cells() == []
        got[name] = (stalled, [(n, fields(c)) for n, c in ev],
                     np.asarray(m.backlog), m.tracking_score)
    for a, b in zip(got["port"], got["jax"]):
        if isinstance(a, list):
            assert a == b and a
        else:
            np.testing.assert_array_equal(a, b)


def test_poll_drains_without_feeding(streams, jax_f32):
    m = multi.MultiTrigger(N, psr_threshold=4, transport="f32",
                           device="cpu")
    ev = m.process_all(streams)
    for _ in range(2000):
        ev += m.poll()
        if m.backlog.max() <= 9600:
            break
    assert m.backlog.max() <= 9600
    assert [(n, fields(c)) for n, c in ev] == jax_f32[2]


def test_rebase_is_transparent(monkeypatch, streams):
    monkeypatch.setattr(jmulti.MultiTrigger, "REBASE_AT", 4 * CHUNK)
    monkeypatch.setattr(multi.MultiTrigger, "REBASE_AT", 4 * CHUNK)
    ref, ref_log, _ = run_multi(jmulti.MultiTrigger, streams,
                                transport="f32", pipeline=0)
    m, log, _ = run_multi(multi.MultiTrigger, streams, transport="f32",
                          pipeline=0, device="cpu")
    assert log == ref_log and log
    assert m._base + len(m._bufs[0]) < len(streams[0]), "rebase must fire"
    assert m._base == ref._base
    np.testing.assert_array_equal(m._pos_lb, ref._pos_lb)
    assert_same_telemetry(m, ref)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_between_the_packages(tmp_path, streams, jax_f32,
                                                 writer):
    cut = 9 * CHUNK + 1234              # stream 0 has dropped its cell
    path = str(tmp_path / "multi.npz")
    make = {"jax": lambda **kw: jmulti.MultiTrigger(
                N, psr_threshold=4, transport="f32", **kw),
            "port": lambda **kw: multi.MultiTrigger(
                N, psr_threshold=4, transport="f32", device="cpu", **kw)}
    reader = "port" if writer == "jax" else "jax"
    first = make[writer]()
    first.process_all([s[:cut] for s in streams])
    first.save_state(path)
    log = []
    second = make[reader](
        on_track=lambda n, c: log.append(("track", n, fields(c))),
        on_drop=lambda n, cid: log.append(("drop", n, cid)))
    second.load_state(path)
    second.process_all([s[cut:] for s in streams])
    second.flush()
    ref, ref_log, _ = jax_f32
    assert log == ref_log[-1:] and log[0][:2] == ("track", 0)
    assert_same_telemetry(*((second, ref) if reader == "port"
                            else (ref, second)))
    with np.load(path) as data:
        assert {"n", "base", "psr_threshold", "cfo_bins", "buf_0", "buf_2",
                "state_pos", "state_chest"} <= set(data.files)
    other = multi.MultiTrigger(2, device="cpu")
    with pytest.raises(ValueError, match="streams"):
        other.load_state(path)


def test_per_stream_cfo_probe_matches_jax(tmp_path):
    """Stream 0 sits 1.3 subcarriers off, stream 2 on frequency: the probe
    rotates only stream 0's mirror row, to the bin the JAX package finds."""
    rng = np.random.default_rng(12)
    on = frames(207, 12, nof_prb_field=25)
    sigs = [offset(frames(200, 12, nof_prb_field=50), 1.3),
            noise(rng, on.size, 0.5), on]
    ref, ref_log, _ = run_multi(jmulti.MultiTrigger, sigs,
                                cfo_search_range=2)
    m, log, _ = run_multi(multi.MultiTrigger, sigs, cfo_search_range=2,
                          device="cpu")
    assert sorted((k, n, v["cell_id"]) for k, n, v in log) \
        == sorted((k, n, v["cell_id"]) for k, n, v in ref_log) \
        == [("track", 0, 200), ("track", 2, 207)]
    # the noise stream's "best" bin is whichever noise peak its probe
    # windows held: not compared
    assert m._cfo_bins[[0, 2]].tolist() == ref._cfo_bins[[0, 2]].tolist() \
        == [3, 0]
    path = str(tmp_path / "cfo.npz")
    m.save_state(path)
    ref2 = jmulti.MultiTrigger(N, cfo_search_range=2)
    ref2.load_state(path)
    np.testing.assert_array_equal(ref2._cfo_bins, m._cfo_bins)


def test_multi_defaults_to_cuda_and_takes_no_mesh(monkeypatch):
    # mesh=None is the unmeshed trigger: it owns every stream
    m = multi.MultiTrigger(2, mesh=None, device="cpu")
    assert m.local_streams == range(2) and m.n_streams == m.n == 2
    with pytest.raises(IndexError, match="stream 2"):
        m.process(2, np.zeros(10, np.complex64))
    with pytest.raises(ValueError, match="cellstores"):
        multi.MultiTrigger(2, cellstores=[], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        multi.MultiTrigger(2)


# --------------------------------------------------------------- mirror ----
def _segments(rng, transport, length):
    scale = rng.uniform(0.1, 2.0, size=N).astype(np.float32)
    if transport == "f32":
        return rng.normal(size=(2, N, length)).astype(np.float32), \
            np.ones(N, np.float32)
    if transport == "i4":
        return rng.integers(0, 256, size=(N, length)).astype(np.uint8), \
            scale / 7
    dt, lim = {"i16": (np.int16, 32767), "i8": (np.int8, 127)}[transport]
    return rng.integers(-lim, lim + 1, size=(2, N, length)).astype(dt), \
        scale / lim


@pytest.mark.parametrize("half_bins", [(0, 0, 0), (3, 0, -4)])
@pytest.mark.parametrize("transport", ["f32", "i16", "i8", "i4"])
@pytest.mark.parametrize("shift", [0, 5000])
def test_mmirror_advance_matches_jax(transport, half_bins, shift):
    rng = np.random.default_rng(13)
    cap, length, write_off, seg_start = 40000, 9000, 21000, 2 ** 29 - 3000
    dev = rng.normal(size=(2, N, cap)).astype(np.float32)
    dev[..., write_off + shift:] = 0    # the mirror past its valid end
    up, scale = _segments(rng, transport, length)
    tail = (jnp.asarray(scale), jnp.int32(shift), jnp.int32(write_off),
            jnp.asarray(half_bins, jnp.int32), jnp.int32(seg_start))
    mine = (torch.from_numpy(scale), shift, write_off, np.array(half_bins),
            seg_start)
    d = [torch.from_numpy(x.copy()) for x in dev]
    if transport == "i4":
        ref = jmulti._mmirror_advance_i4(jnp.asarray(dev[0]),
                                         jnp.asarray(dev[1]),
                                         jnp.asarray(up), *tail)
        got = multi._mmirror_advance_i4(*d, torch.from_numpy(up), *mine)
    else:
        ref = jmulti._mmirror_advance(jnp.asarray(dev[0]),
                                      jnp.asarray(dev[1]), jnp.asarray(up[0]),
                                      jnp.asarray(up[1]), *tail)
        got = multi._mmirror_advance(*d, torch.from_numpy(up[0]),
                                     torch.from_numpy(up[1]), *mine)
    for g, r in zip(got, ref):
        if transport == "f32" and not any(half_bins):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-6)
        assert not g[..., write_off + length:].any()


def test_mmirror_rotate_matches_jax():
    rng = np.random.default_rng(14)
    dev = rng.normal(size=(2, N, 30000)).astype(np.float32)
    bins, base = (2, 0, -7), 2 ** 29 - 777
    ref = jmulti._mmirror_rotate(jnp.asarray(dev[0]), jnp.asarray(dev[1]),
                                 jnp.asarray(bins, jnp.int32),
                                 jnp.int32(base))
    got = multi._mmirror_rotate(torch.from_numpy(dev[0]),
                                torch.from_numpy(dev[1]), np.array(bins),
                                base)
    for g, r, x in zip(got, ref, dev):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(g[1].numpy(), x[1])    # bin 0: as is


# --------------------------------------------------------- live_monitor ----
def test_live_monitor_multi_prints_the_jax_events(tmp_path, capsys, streams):
    """Three sources, one of them shorter (it is continued with silence):
    the same track / drop events per stream as the JAX monitor prints."""
    paths = []
    for i, (sig, n) in enumerate(zip(streams, (8, 8, 5))):
        paths.append(str(tmp_path / f"s{i}.c64"))
        sig[:n * CHUNK].tofile(paths[-1])
    ref_out = io.StringIO()
    files = [open(p, "rb") for p in paths]
    try:
        jmon.run_multi(files, refresh_every=3, out=ref_out, transport="f32")
    finally:
        for f in files:
            f.close()
    assert mon.main(paths + ["--refresh", "3", "--transport", "f32",
                             "--device", "cpu"]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    ref = [json.loads(x) for x in ref_out.getvalue().splitlines()]

    def events(lines):
        return [{k: v for k, v in e.items() if k != "tracking_start_time"}
                for e in lines if e["event"] != "status"]

    assert events(got) == events(ref)
    assert {(e["event"], e["stream"]) for e in events(got)} \
        >= {("track", 0), ("drop", 0), ("track", 2)}
    mine = [e for e in got if e["event"] == "status"]
    theirs = [e for e in ref if e["event"] == "status"]
    assert len(mine) == len(theirs) == 2
    # what a status line shows depends on how far the pipeline has drained
    # when it is printed, so only its layout is compared
    for g, r in zip(mine, theirs):
        assert list(g) == list(r)
        assert np.shape(g["mean_psr"]) == np.shape(r["mean_psr"]) == (N, 3)
        assert len(g["cells"]) == len(g["backlog"]) == N


# ------------------------------------------------- on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["f32", "i4"])
def test_multi_on_card_equals_cpu(cuda_device, streams, transport):
    _, want, _ = run_multi(multi.MultiTrigger, streams, transport=transport,
                           device="cpu")
    _, log, _ = run_multi(multi.MultiTrigger, streams, transport=transport,
                          device=cuda_device)
    keys = None if transport == "f32" else DECISIVE
    strip = [(k, n, {f: v[f] for f in keys} if keys and k == "track" else v)
             for k, n, v in log]
    assert strip == [(k, n, {f: v[f] for f in keys}
                      if keys and k == "track" else v) for k, n, v in want]
    assert log
