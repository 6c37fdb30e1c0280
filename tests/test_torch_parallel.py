"""The PyTorch port's `parallel` layer on four gloo ranks on the CPU: the
process mesh, `channel_scan(mesh=)`, `time_sharded_scan` with the halo
exchange, `MultiTrigger(mesh=)` / `WidebandTrigger(mesh=)`, their one-file
checkpoints and `gather_events`, against the unsharded port and against the
JAX package on its 8-virtual-device mesh.

This file is also the ranks' program: `python tests/test_torch_parallel.py
--worker RANK WORLD PORT OUTDIR MODE` runs one rank, which imports the port
only (never jax), runs every scenario and writes what it got into OUTDIR.
One spawn of 4 ranks serves all the cases below (a module-scoped fixture);
a second spawn of 2 ranks is the `init_distributed` bring-up.  Every spawn
and every process group has a timeout.

Inputs are built by the functions at the top from numpy seeds and the
port's `ltecore.synth` (byte-equal to the JAX package's,
tests/test_torch_shared.py), so the ranks, the unsharded port and the JAX
package all see the same arrays.

Tolerances: events, integers and booleans exact; floats as
test_torch_common.FLOAT_TOL (rtol 1e-4 / atol 1e-5 and kin: float32 sums in
another order); telemetry rtol 1e-4 / atol 1e-5.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHUNK = 19200                       # one radio frame at 1.92 Msps
RATE = 7.68e6                       # the wide band of the wideband cases
CENTERS = [-2.4e6, 0.0, 2.4e6, 1.2e6]
WCHUNK = 4 * CHUNK
N_STREAMS = 8
MULTI_CUT = 2 * CHUNK + 5000        # checkpoint cuts (samples fed before)
WIDE_CUT = 3 * WCHUNK + 7777
SHARD_STREAMS = ("every_block", "straddle", "halo_only")


# ------------------------------------------------------------- the inputs --
def _synth():
    from ltetrigger_tpu_torch.ltecore import synth
    return synth


def _noise(rng, n, sigma):
    return (sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))
            / np.sqrt(2.0)).astype(np.complex64)


def _frames(cell_id, n, prb=25):
    return np.tile(_synth().synthesize_frame(cell_id, nof_prb_field=prb), n) \
        .astype(np.complex64)


def scan_buffers():
    """[8, LOOKBACK + 10 half-frames + WINDOW] complex64: even channels carry
    a cell each (four ids) over a weak noise floor, odd channels noise."""
    from ltetrigger_tpu_torch.models import trigger as trig
    rng = np.random.default_rng(31)
    rows = []
    for c in range(8):
        x = _noise(rng, 5 * CHUNK, 0.1)
        if c % 2 == 0:
            x = x + _frames(77 + 40 * c, 5)
        rows.append(np.concatenate([np.zeros(trig.LOOKBACK, np.complex64), x,
                                    np.zeros(trig.WINDOW, np.complex64)]))
    return np.stack(rows)


def shard_stream(kind):
    """One 8-frame stream at 1.92 Msps for 4 time shards of 2 frames each:
    the cell in every block; every block's last PSS peak 200 samples before
    its seam; one frame whose only subframe-0 peak sits 100 samples before
    the first seam (decodable through the halo alone)."""
    iq = _frames(123, 1, prb=6)
    if kind == "every_block":
        return np.tile(iq, 8)
    if kind == "straddle":
        shift = 9400 - 832
        return np.tile(iq, 9)[19200 - shift: 19200 - shift + 8 * 19200].copy()
    stream = np.zeros(8 * 19200, np.complex64)
    g = 38400 - 100 - 832
    stream[g:g + 19200] = iq
    return stream


def multi_streams():
    """8 streams of 6 frames: streams 0 and 4 carry a cell from the start,
    2 and 6 from frame 3 on (after the checkpoint's cut), odd ones noise."""
    rng = np.random.default_rng(32)
    sigs = []
    for i in range(N_STREAMS):
        x = _noise(rng, 6 * CHUNK, 0.4 if i % 2 else 0.05)
        if i % 2 == 0:
            cell = _frames(60 + 37 * i, 6, prb=(25, 50)[i // 2 % 2])
            if i % 4 == 2:
                cell[:3 * CHUNK] = 0
            x = x + cell
        sigs.append(x.astype(np.complex64))
    return sigs


def wide_band():
    """8 frames of a 7.68 Msps band: cell 99 at -2.4 MHz from the start,
    cell 250 at +2.4 MHz from frame 4 on; nothing at 0 and +1.2 MHz."""
    def up(x, offset_hz):
        F = np.fft.fft(x.astype(np.complex128))
        n = x.size
        Fw = np.zeros(4 * n, dtype=np.complex128)
        Fw[:n // 2] = F[:n // 2]
        Fw[-n // 2:] = F[-n // 2:]
        t = np.arange(4 * n, dtype=np.float64)
        return np.fft.ifft(Fw) * 4 * np.exp(2j * np.pi * (offset_hz / RATE)
                                            * t)
    a = _frames(99, 8, prb=25)
    b = _frames(250, 8, prb=50)
    b[:4 * CHUNK] = 0
    x = up(a, -2.4e6) + up(b, 2.4e6)
    x = x / np.sqrt(np.mean(np.abs(x) ** 2))
    return (x + _noise(np.random.default_rng(33), x.size, 0.02)) \
        .astype(np.complex64)


def pair_np(x):
    return (np.ascontiguousarray(x.real, np.float32),
            np.ascontiguousarray(x.imag, np.float32))


def cell_fields(cell):
    d = cell.to_dict()
    d.pop("tracking_start_time")
    return d


def tagged(events):
    """(stream, Cell) pairs as JSON-ready [stream, fields] pairs."""
    return [[int(n), cell_fields(c)] for n, c in events]


def feed_multi(m, sigs, start=0):
    ev = []
    for i in range(start, len(sigs[0]), CHUNK):
        ev += m.process_all([s[i:i + CHUNK] for s in sigs])
    return ev + m.flush()


def feed_wide(w, wide, start=0):
    ev = []
    for i in range(start, len(wide), WCHUNK):
        ev += w.process_wide(wide[i:i + WCHUNK])
    return ev + w.flush()


TELEMETRY = ("tracking_score", "tracking", "cap_overflow", "max_psr",
             "mean_psr", "mean_cfo", "channel_estimate")


def telemetry(trigger):
    return {k: np.asarray(getattr(trigger, k)) for k in TELEMETRY}


# ------------------------------------------------------- one rank's work ---
def _scenarios(rank, out):
    """Every scenario, in the same order on every rank (they are
    collectives).  Global results are written by rank 0, a rank's own by
    that rank."""
    import torch
    from ltetrigger_tpu_torch.apps import snr_sweep, wideband_scan
    from ltetrigger_tpu_torch.models.multi import MultiTrigger
    from ltetrigger_tpu_torch.models.wideband import WidebandTrigger
    from ltetrigger_tpu_torch.parallel import (channel_scan, gather_events,
                                               halo_exchange_right,
                                               make_mesh, time_sharded_scan)

    def save(name, tup, every_rank=False):
        if rank == 0 or every_rank:
            arrays = tup if isinstance(tup, dict) else \
                {f: getattr(tup, f).numpy() for f in tup._fields}
            np.savez(out / (name + (f"_r{rank}" if every_rank else "")),
                     **arrays)

    def dump(name, obj):
        if rank == 0:
            (out / f"{name}.json").write_text(json.dumps(obj))

    meshes = {"ch4": make_mesh(4, 1, device="cpu"),
              "ch2t2": make_mesh(2, 2, device="cpu"),
              "t4": make_mesh(1, 4, device="cpu")}
    (out / f"mesh_r{rank}.json").write_text(json.dumps({
        k: {"shape": m.shape, "coords": m.coords, "peers": m.peers,
            "slice8": list(m.local_slice(8)), "device": str(m.device)}
        for k, m in meshes.items()}))

    # halo exchange: 64 samples over 4 shards, and over the 2 of ch2t2
    x = torch.arange(64, dtype=torch.float32)
    for name, n_t in (("t4", 4), ("ch2t2", 2)):
        m = meshes[name]
        b = 64 // n_t
        mine = x[m.coords["t"] * b:(m.coords["t"] + 1) * b]
        save(f"halo_{name}", {"y": halo_exchange_right(mine, 4, m).numpy()},
             every_rank=True)

    # channel_scan: fresh, then 5 more steps from the carried state
    bufs = pair_np(scan_buffers())
    for name in ("ch4", "ch2t2"):
        st, out1 = channel_scan(bufs, 5, 4.0, mesh=meshes[name])
        st2, out2 = channel_scan(bufs, 5, 4.0, mesh=meshes[name], states=st)
        save(f"scan_{name}_out1", out1)
        save(f"scan_{name}_out2", out2)
        save(f"scan_{name}_state", st2)

    # the apps pass the mesh on
    dump("wideband_scan", wideband_scan.wideband_scan(
        wide_band()[:3 * WCHUNK], RATE, CENTERS, seconds=0.03,
        mesh=meshes["ch4"]))
    dump("snr_sweep", snr_sweep.snr_sweep(
        _frames(77, 1), 1.92e6, [5.0, -30.0], seconds=0.05, n_trials=2,
        seed=3, mesh=meshes["ch4"]))

    # time-sharded scans
    for kind in SHARD_STREAMS:
        save(f"shard_{kind}", time_sharded_scan(
            pair_np(shard_stream(kind)), meshes["t4"], 4.0))

    # MultiTrigger over the mesh: the whole run, with a checkpoint at the cut
    sigs = multi_streams()
    kw = dict(psr_threshold=4, transport="f32")
    m = MultiTrigger(N_STREAMS, mesh=meshes["ch4"], **kw)
    head = [s[:MULTI_CUT] for s in sigs]
    tail = [s[MULTI_CUT:] for s in sigs]
    before = m.process_all(head) + m.flush()
    m.save_state(str(out / "multi_sharded.npz"))
    after = feed_multi(m, tail)
    dump("multi_events", {"before": tagged(gather_events(before, m.mesh)),
                          "after": tagged(gather_events(after, m.mesh))})
    own = {"local_streams": list(m.local_streams), "n": m.n,
           "own_events": tagged(before + after),
           "stores": [len(s.cells()) for s in m.stores],
           "backlog": m.backlog.tolist()}
    (out / f"multi_own_r{rank}.json").write_text(json.dumps(own))
    save("multi_telemetry", telemetry(m), every_rank=True)
    # checkpoints of the unsharded port, of the JAX class and of the ch=4
    # mesh, each resumed on a mesh (the last on another mesh shape)
    for src, name in (("multi_unsharded", "ch4"), ("multi_jax", "ch4"),
                      ("multi_sharded", "ch2t2")):
        r = MultiTrigger(N_STREAMS, mesh=meshes[name], **kw)
        r.load_state(str(out / f"{src}.npz"))
        dump(f"resumed_{src}", tagged(gather_events(feed_multi(r, tail),
                                                    r.mesh)))
        save(f"resumed_{src}_telemetry", telemetry(r), every_rank=True)

    # WidebandTrigger over the mesh, likewise
    wide = wide_band()
    w = WidebandTrigger(RATE, CENTERS, mesh=meshes["ch4"], **kw)
    before = w.process_wide(wide[:WIDE_CUT]) + w.flush()
    w.save_state(str(out / "wide_sharded.npz"))
    after = feed_wide(w, wide[WIDE_CUT:])
    dump("wide_events", {"before": tagged(gather_events(before, w.mesh)),
                         "after": tagged(gather_events(after, w.mesh))})
    save("wide_telemetry", telemetry(w), every_rank=True)
    for src, name in (("wide_unsharded", "ch4"), ("wide_jax", "ch2t2")):
        r = WidebandTrigger(RATE, CENTERS, mesh=meshes[name], **kw)
        r.load_state(str(out / f"{src}.npz"))
        dump(f"resumed_{src}", tagged(gather_events(
            feed_wide(r, wide[WIDE_CUT:]), r.mesh)))


def _bringup(rank, out):
    """The counterpart of the JAX package's two-process test: a 2-rank `ch`
    mesh scans 4 channels of synthetic frames."""
    from ltetrigger_tpu_torch.parallel import channel_scan, make_mesh
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"ch": 2, "t": 1} and mesh.coords["ch"] == rank
    bufs = scan_buffers()[:4, :3 * 9600 + 12000]
    _, res = channel_scan(pair_np(bufs), 3, 4.0, mesh=mesh)
    ev = res.track_event.numpy()
    assert ev.any(axis=(0, 2)).tolist() == [True, False] * 2, ev.any(
        axis=(0, 2))
    assert set(res.cell_id.numpy()[ev].tolist()) == {77, 157}
    print("DISTRIBUTED_OK", flush=True)


def _worker(rank, world, port, out, mode):
    import torch
    import torch.distributed as dist
    from ltetrigger_tpu_torch.parallel import init_distributed
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                     timeout=240)
    try:
        (_bringup if mode == "bringup" else _scenarios)(rank,
                                                        pathlib.Path(out))
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    assert sys.argv[1] == "--worker", sys.argv
    _worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
            sys.argv[5], sys.argv[6])
    sys.exit(0)


# ======================================================================
# the tests
# ======================================================================
import pytest  # noqa: E402
import torch  # noqa: E402

from test_torch_common import FLOAT_TOL, assert_fields  # noqa: E402

TEL_TOL = dict(rtol=1e-4, atol=1e-5)


def spawn(world, out, mode, timeout=420):
    """Run `world` ranks of this file; all must exit 0 inside `timeout`
    seconds.  A rank that fails ends the others at once."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = [open(out / f"{mode}_rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--worker",
         str(r), str(world), str(port), str(out), mode],
        cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT),
             "OMP_NUM_THREADS": "1"})
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline \
                    or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    assert [p.returncode for p in procs] == [0] * world, \
        "\n".join(f"--- rank {r} ---\n{t[-3000:]}"
                  for r, t in enumerate(texts))
    return texts


def load(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


class Fields:
    """A saved tuple's arrays as attributes (for assert_fields)."""
    def __init__(self, arrays):
        self.__dict__.update(arrays)


def key_sorted(events):
    """An unsharded run's events in `gather_events`' order."""
    return sorted(events, key=lambda e: e[0])


# --------------------------------------------------- references, unsharded --
@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """Unsharded runs of the port and meshed runs of the JAX classes, and
    the checkpoints the ranks resume from."""
    import jax.numpy as jnp
    from ltetrigger_tpu.models.multi import MultiTrigger as JMulti
    from ltetrigger_tpu.models.wideband import WidebandTrigger as JWide
    from ltetrigger_tpu.parallel import make_mesh as jmake_mesh
    from ltetrigger_tpu_torch.models.multi import MultiTrigger
    from ltetrigger_tpu_torch.models.wideband import WidebandTrigger

    out = tmp_path_factory.mktemp("ranks")
    ref = {"out": out, "jnp": jnp}
    kw = dict(psr_threshold=4, transport="f32")
    sigs, wide = multi_streams(), wide_band()
    head = [s[:MULTI_CUT] for s in sigs]
    tail = [s[MULTI_CUT:] for s in sigs]
    for name, make in (
            ("port", lambda: MultiTrigger(N_STREAMS, device="cpu", **kw)),
            ("jax", lambda: JMulti(N_STREAMS, mesh=jmake_mesh(8, 1), **kw))):
        m = make()
        before = m.process_all(head) + m.flush()
        m.save_state(str(out / ("multi_unsharded.npz" if name == "port"
                                else "multi_jax.npz")))
        after = feed_multi(m, tail)
        ref[f"multi_{name}"] = (m, tagged(before), tagged(after))
        ref[f"make_multi_{name}"] = make
    for name, make in (
            ("port", lambda: WidebandTrigger(RATE, CENTERS, device="cpu",
                                             **kw)),
            ("jax", lambda: JWide(RATE, CENTERS, mesh=jmake_mesh(4, 2),
                                  **kw))):
        w = make()
        before = w.process_wide(wide[:WIDE_CUT]) + w.flush()
        w.save_state(str(out / ("wide_unsharded.npz" if name == "port"
                                else "wide_jax.npz")))
        after = feed_wide(w, wide[WIDE_CUT:])
        ref[f"wide_{name}"] = (w, tagged(before), tagged(after))
        ref[f"make_wide_{name}"] = make
    return ref


@pytest.fixture(scope="module")
def ranks(references):
    """The one spawn of 4 ranks; returns the directory of what they wrote."""
    spawn(4, references["out"], "scenarios")
    return references["out"]


# ------------------------------------------------------------------ mesh ---
@pytest.mark.parametrize("name,n_ch,n_t", [("ch4", 4, 1), ("ch2t2", 2, 2),
                                           ("t4", 1, 4)])
def test_mesh_shapes_and_local_slice(ranks, name, n_ch, n_t):
    for r in range(4):
        m = json.loads((ranks / f"mesh_r{r}.json").read_text())[name]
        assert m["shape"] == {"ch": n_ch, "t": n_t}
        assert m["coords"] == {"ch": r // n_t, "t": r % n_t}
        per = 8 // n_ch
        assert m["slice8"] == [r // n_t * per, (r // n_t + 1) * per]
        assert m["peers"]["ch"] == [i * n_t + r % n_t for i in range(n_ch)]
        assert m["peers"]["t"] == [r // n_t * n_t + j for j in range(n_t)]
        assert m["device"] == "cpu"


def test_mesh_without_a_process_group():
    """One process, no process group: the {ch: 1, t: 1} mesh, on which every
    sharded call runs with no collective; the JAX function's assertion."""
    from ltetrigger_tpu_torch import parallel
    from ltetrigger_tpu_torch.parallel import mesh as meshmod
    assert not torch.distributed.is_initialized()
    m = parallel.make_mesh(device="cpu")
    assert m.shape == {"ch": 1, "t": 1} and m.coords == {"ch": 0, "t": 0}
    assert m.groups == {"ch": None, "t": None} and m.local_slice(6) == (0, 6)
    with pytest.raises(AssertionError, match="2 x 1 != 1 devices"):
        parallel.make_mesh(2, device="cpu")
    x = torch.arange(12.0).reshape(3, 4)
    assert meshmod.all_gather(x, m, "ch", dim=1) is x
    assert meshmod.all_gather_object({"a": 1}, m, None) == [{"a": 1}]
    y = parallel.halo_exchange_right(torch.arange(8.0), 3, m)
    assert y.tolist() == list(range(8)) + [0, 0, 0]
    with pytest.raises(ValueError, match="no neighbour"):
        meshmod.ring_recv_right(x, m, "t")
    assert parallel.gather_events([(1, "b"), (0, "a")], m) \
        == [(0, "a"), (1, "b")]
    bufs = pair_np(scan_buffers()[:2])
    _, got = parallel.channel_scan(bufs, 3, 4.0, mesh=m)
    _, want = parallel.channel_scan(bufs, 3, 4.0, device="cpu")
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.cell_id.dtype == torch.int32 \
        and got.track_event.dtype == torch.bool
    with pytest.raises(AssertionError, match="half-frame multiple"):
        parallel.time_sharded_scan(pair_np(np.zeros(10000, np.complex64)),
                                   m, 4.0)
    assert set(parallel.__all__) >= {
        "make_mesh", "init_distributed", "channel_scan", "time_sharded_scan",
        "halo_exchange_right", "gather_events"}


@pytest.mark.parametrize("name,n_t", [("t4", 4), ("ch2t2", 2)])
def test_halo_exchange_against_numpy(ranks, name, n_t):
    b = 64 // n_t
    for r in range(4):
        t = r % n_t
        y = load(ranks / f"halo_{name}_r{r}.npz")["y"]
        halo = [0, 0, 0, 0] if t == n_t - 1 \
            else list(range((t + 1) * b, (t + 1) * b + 4))
        np.testing.assert_array_equal(y, list(range(t * b, (t + 1) * b))
                                      + halo)


# ---------------------------------------------------------- channel_scan ---
@pytest.fixture(scope="module")
def scan_refs(references):
    from ltetrigger_tpu.ops import cplx as jcplx
    from ltetrigger_tpu.parallel import channel_scan as jchannel_scan
    from ltetrigger_tpu_torch.parallel import channel_scan
    bufs = scan_buffers()
    st, out1 = channel_scan(pair_np(bufs), 5, 4.0, device="cpu")
    st, out2 = channel_scan(pair_np(bufs), 5, 4.0, states=st, device="cpu")
    jst, jout1 = jchannel_scan(jcplx.from_numpy(bufs), 5, 4.0)
    jst, jout2 = jchannel_scan(jcplx.from_numpy(bufs), 5, 4.0, states=jst)
    return {"port": {"out1": out1, "out2": out2, "state": st},
            "jax": {"out1": jout1, "out2": jout2, "state": jst}}


@pytest.mark.parametrize("what", ["out1", "out2", "state"])
@pytest.mark.parametrize("name", ["ch4", "ch2t2"])
def test_channel_scan_over_the_mesh(ranks, scan_refs, name, what):
    """Fresh and with a carried state: field for field the unsharded port
    (floats within FLOAT_TOL) and the JAX package."""
    from ltetrigger_tpu_torch.models import trigger as trig
    got = Fields(load(ranks / f"scan_{name}_{what}.npz"))
    names = (trig.TriggerState if what == "state"
             else trig.StepOutput)._fields
    assert_fields(got, scan_refs["port"][what], names, f"port {what}")
    assert_fields(got, scan_refs["jax"][what], names, f"jax {what}")
    if what == "out2":
        ev = got.track_event | Fields(load(
            ranks / f"scan_{name}_out1.npz")).track_event
        assert ev.any(axis=(0, 2)).tolist() == [True, False] * 4
    if what == "state":
        assert (got.pos == trig.LOOKBACK + 10 * 9600).all()


def test_apps_pass_the_mesh(ranks):
    from ltetrigger_tpu_torch.apps import snr_sweep, wideband_scan
    got = json.loads((ranks / "wideband_scan.json").read_text())
    want = wideband_scan.wideband_scan(wide_band()[:3 * WCHUNK], RATE,
                                       CENTERS, seconds=0.03, device="cpu")
    assert [r["detected"] for r in got] == [True, False, False, False]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "psr"} \
            == {k: v for k, v in w.items() if k != "psr"}
        if "psr" in g:
            np.testing.assert_allclose(g["psr"], w["psr"], rtol=1e-4)
    got = json.loads((ranks / "snr_sweep.json").read_text())
    want = snr_sweep.snr_sweep(_frames(77, 1), 1.92e6, [5.0, -30.0],
                               seconds=0.05, n_trials=2, seed=3, device="cpu")
    assert [r["prob"] for r in got] == [r["prob"] for r in want] == [1.0, 0.0]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_allclose(g["max_psr"], w["max_psr"], rtol=1e-4)


# ------------------------------------------------------ time_sharded_scan --
@pytest.fixture(scope="module")
def shard_refs(references):
    from ltetrigger_tpu.parallel import make_mesh, time_sharded_scan
    jnp = references["jnp"]
    mesh = make_mesh(n_channels=2, n_time=4)
    return {kind: time_sharded_scan(
        tuple(jnp.asarray(c) for c in pair_np(shard_stream(kind))), mesh, 4.0)
        for kind in SHARD_STREAMS}


@pytest.mark.parametrize("kind", SHARD_STREAMS)
def test_time_sharded_scan_equals_jax(ranks, shard_refs, kind):
    from ltetrigger_tpu_torch.models import trigger as trig
    got = Fields(load(ranks / f"shard_{kind}.npz"))
    assert got.track_event.shape == (4, 4, 3)
    names = trig.StepOutput._fields
    if kind == "halo_only":
        # The JAX engine reports PHICH resource index 0 for this one event,
        # which falls on the LAST step of a 4-step scan; scanning the same
        # stream in 8 steps it reports 2, which is what the synthesized MIB
        # carries ("1") and what the port reports here.  Every other field
        # of the event agrees.
        names = tuple(f for f in names if f != "phich_res")
        assert got.phich_res[got.track_event].tolist() == [2]
    assert_fields(got, shard_refs[kind], names, kind)
    ev = got.track_event
    assert set(got.cell_id[ev].tolist()) == {123}
    if kind == "halo_only":
        # shard 0 owns the peak and decodes it through the halo; shard 1
        # sees only the subframe-5 half: nobody else fires
        assert ev.sum(axis=(1, 2)).tolist() == [1, 0, 0, 0]
    else:
        assert ev.any(axis=(1, 2)).all()
    if kind == "straddle":
        # the step whose window crosses the seam (local peak 38200): full
        # PSR on the owning lane in every shard with a right neighbour
        for shard in range(3):
            assert got.psr[shard, 3, 123 % 3] > 4.0
            assert got.cell_id[shard, 3, 123 % 3] == 123


# ----------------------------------------------------------- MultiTrigger --
def assert_telemetry(parts, ref, what):
    """The ranks' local telemetry rows, joined, against a whole trigger's."""
    for k in TELEMETRY:
        got = np.concatenate([p[k] for p in parts])
        want = np.asarray(getattr(ref, k))
        if got.dtype.kind in "fc":
            np.testing.assert_allclose(got, want, err_msg=f"{what} {k}",
                                       **TEL_TOL)
        else:
            np.testing.assert_array_equal(got, want, f"{what} {k}")


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_multi_over_the_mesh(ranks, references, ref):
    """Gathered events and joined telemetry of MultiTrigger(8, mesh=ch4)
    equal the unsharded port's and the JAX class's with its mesh."""
    m, before, after = references[f"multi_{ref}"]
    got = json.loads((ranks / "multi_events.json").read_text())
    assert got["before"] == key_sorted(before)
    assert got["after"] == key_sorted(after)
    assert [n for n, _ in got["before"]] == [0, 4]
    assert [n for n, _ in got["after"]] == [2, 6]
    assert_telemetry([load(ranks / f"multi_telemetry_r{r}.npz")
                      for r in range(4)], m, ref)


def test_multi_ranks_keep_their_own_streams(ranks):
    """No collective on the streaming path: a rank publishes its own
    streams only, with global indices, and the others' stores stay empty."""
    for r in range(4):
        own = json.loads((ranks / f"multi_own_r{r}.json").read_text())
        assert own["local_streams"] == [2 * r, 2 * r + 1] and own["n"] == 2
        assert [n for n, _ in own["own_events"]] == [2 * r]
        assert own["stores"] == [int(i == 2 * r) for i in range(N_STREAMS)]
        assert len(own["backlog"]) == 2 and max(own["backlog"]) <= 9600
        tel = load(ranks / f"multi_telemetry_r{r}.npz")
        assert tel["mean_psr"].shape == (2, 3)


@pytest.mark.parametrize("src", ["multi_unsharded", "multi_jax",
                                 "multi_sharded"])
def test_multi_checkpoint_resumed_on_a_mesh(ranks, references, src):
    """A checkpoint of the unsharded port, of the JAX class, and of the
    ch=4 mesh (resumed on the 2 x 2 mesh) continues as the whole run did."""
    m, _, after = references["multi_port"]
    got = json.loads((ranks / f"resumed_{src}.json").read_text())
    assert got == key_sorted(after) and got
    n_ch = 2 if src == "multi_sharded" else 4
    # ranks along t hold the same rows: take the t = 0 column
    cols = range(0, 4, 2) if n_ch == 2 else range(4)
    assert_telemetry([load(ranks / f"resumed_{src}_telemetry_r{r}.npz")
                      for r in cols], m, src)


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_multi_sharded_checkpoint_loads_unsharded(ranks, references, reader):
    """The ch=4 mesh's one file has the JAX package's keys and global
    shapes: the unsharded port and the JAX class resume from it."""
    m, _, after = references[f"multi_{reader}"]
    with np.load(ranks / "multi_sharded.npz") as data:
        assert {"n", "base", "psr_threshold", "cfo_bins", "buf_0", "buf_7",
                "state_pos", "state_chest"} <= set(data.files)
        assert int(data["n"]) == N_STREAMS
        assert data["state_ema"].shape == (N_STREAMS, 75, 3, 128)
        assert data["cfo_bins"].shape == (N_STREAMS,)
    r = references[f"make_multi_{reader}"]()
    r.load_state(str(ranks / "multi_sharded.npz"))
    tail = [s[MULTI_CUT:] for s in multi_streams()]
    assert tagged(feed_multi(r, tail)) == after and after
    for k in ("tracking_score", "tracking"):
        np.testing.assert_array_equal(np.asarray(getattr(r, k)),
                                      np.asarray(getattr(m, k)))
    np.testing.assert_allclose(np.asarray(r.mean_psr), np.asarray(m.mean_psr),
                               **TEL_TOL)


# -------------------------------------------------------- WidebandTrigger --
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_wideband_over_the_mesh(ranks, references, ref):
    w, before, after = references[f"wide_{ref}"]
    got = json.loads((ranks / "wide_events.json").read_text())
    assert got["before"] == key_sorted(before)
    assert got["after"] == key_sorted(after)
    assert [(n, f["cell_id"]) for n, f in got["before"] + got["after"]] \
        == [(0, 99), (2, 250)]
    parts = [load(ranks / f"wide_telemetry_r{r}.npz") for r in range(4)]
    for k in ("tracking_score", "tracking", "cap_overflow"):
        np.testing.assert_array_equal(
            np.concatenate([p[k] for p in parts]), np.asarray(getattr(w, k)),
            k)
    # the JAX class channelizes in other segments (its upload quantum):
    # rtol 1e-3, as tests/test_torch_wideband.py holds the two classes
    np.testing.assert_allclose(
        np.concatenate([p["mean_psr"] for p in parts]),
        np.asarray(w.mean_psr), rtol=1e-4 if ref == "port" else 1e-3)


@pytest.mark.parametrize("src", ["wide_unsharded", "wide_jax"])
def test_wideband_checkpoint_resumed_on_a_mesh(ranks, references, src):
    _, _, after = references["wide_port"]
    got = json.loads((ranks / f"resumed_{src}.json").read_text())
    assert got == key_sorted(after) and [n for n, _ in got] == [2]


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_wideband_sharded_checkpoint_loads_unsharded(ranks, references,
                                                     reader):
    w, _, after = references[f"wide_{reader}"]
    with np.load(ranks / "wide_sharded.npz") as data:
        assert {"n", "base", "wide", "wbase", "wabs", "sample_rate",
                "centers", "cfo_bins", "state_pos"} <= set(data.files)
        assert data["state_score"].shape == (4, 3)
        assert data["centers"].tolist() == CENTERS
    r = references[f"make_wide_{reader}"]()
    r.load_state(str(ranks / "wide_sharded.npz"))
    assert tagged(feed_wide(r, wide_band()[WIDE_CUT:])) == after and after
    np.testing.assert_array_equal(np.asarray(r.tracking_score),
                                  np.asarray(w.tracking_score))


# -------------------------------------------------------------- bring-up ---
def test_two_process_init_distributed(tmp_path):
    """`init_distributed("127.0.0.1:port", 2, pid)` and a 2-rank channel
    scan of synthetic frames, in two fresh processes."""
    texts = spawn(2, tmp_path, "bringup", timeout=180)
    assert all("DISTRIBUTED_OK" in t for t in texts), texts


def test_a_failing_rank_fails_the_spawn(tmp_path):
    """A rank that raises ends its process group and the spawn reports it
    (mode "bringup" on a world of 3 trips the worker's own assertion)."""
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="rank 0"):
        spawn(3, tmp_path, "bringup", timeout=120)
    assert time.monotonic() - t0 < 100


# ------------------------------------------------- on a card (marker cuda) --
@pytest.mark.cuda
def test_nccl_world_of_one():
    """NCCL at world size 1 in this process: the mesh is {ch: 1, t: 1}, its
    all_gather runs through NCCL, and `channel_scan(mesh=)` equals
    `channel_scan()`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL has no CPU mode")
    import torch.distributed as dist
    from ltetrigger_tpu_torch import parallel
    from ltetrigger_tpu_torch.parallel import mesh as meshmod
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dev = parallel.init_distributed(f"127.0.0.1:{port}", 1, 0, timeout=120)
    try:
        assert dist.get_backend() == "nccl" and dev.type == "cuda"
        m = parallel.make_mesh()
        assert m.shape == {"ch": 1, "t": 1} and m.device == dev
        x = torch.arange(6.0, device=dev).reshape(2, 3)
        assert torch.equal(meshmod.all_gather(x, m, "ch", dim=1), x)
        bufs = pair_np(scan_buffers())
        st, got = parallel.channel_scan(bufs, 5, 4.0, mesh=m)
        st0, want = parallel.channel_scan(bufs, 5, 4.0)
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        for f in st._fields:
            assert torch.equal(getattr(st, f), getattr(st0, f)), f
        out = parallel.time_sharded_scan(
            pair_np(shard_stream("every_block")), m, 4.0)
        assert out.track_event.shape == (1, 16, 3) and out.track_event.any()
    finally:
        dist.destroy_process_group()
