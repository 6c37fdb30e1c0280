"""The long-running monitor on a process mesh: `MultiTrigger(mesh=)` and
`WidebandTrigger(mesh=)` on four gloo ranks on the CPU through several
coordinate rebases, their one-file checkpoints written between the ranks'
rebases, and checkpoints crossing between the mesh, the unsharded port and
the JAX package after rebases.

`REBASE_AT` is lowered to 4 x 19200 = 76800 samples (a multiple of 256, as
the rebase requires) in every rank and in the references, so that a 16-frame
stream rebases three times.  Each rank rebases on its own, when its own
host buffer passes `REBASE_AT`: ranks whose `process()` calls differ rebase
on different calls.  The "split" scenario makes them differ through the
public API alone (ranks 0 and 2 feed 19200-sample chunks, ranks 1 and 3
38400-sample chunks) and checkpoints at every point where their feeds meet
(every 38400 samples), so that a `save_state` falls between one rank's
rebase and another's; each of those checkpoints continues in an unsharded
trigger.

This file is also the ranks' program: `python tests/test_torch_mesh_monitor.py
--worker RANK WORLD PORT OUTDIR` runs one rank, which imports the port only
(never jax), runs every scenario and writes what it got into OUTDIR.  One
spawn of 4 ranks serves all the cases below (a module-scoped fixture); the
spawn and the process group have a timeout.

Tolerances: events and their order, integers and positions exact; telemetry
floats as test_torch_common.FLOAT_TOL (against the JAX wideband class the
peak and mean PSR within rtol 1e-3: it channelizes in other segments,
ROADMAP section 3, "No upload quantum").
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
REBASE = 4 * CHUNK                  # REBASE_AT everywhere in this file
N_FRAMES = 16                       # 307200 samples a stream: 3 rebases
N_STREAMS = 8
RATE = 7.68e6
RATIO = 4
CENTERS = [-2.4e6, -0.8e6, 0.8e6, 2.4e6]
WCHUNK = RATIO * CHUNK
CUT = 10 * CHUNK + 1234             # the checkpoints' cut: after 2 rebases
WIDE_CUT = 10 * WCHUNK + 4321
MEET = 2 * CHUNK                    # where the split feeders meet
SPLIT_CHUNKS = (CHUNK, MEET)        # rank r feeds SPLIT_CHUNKS[r % 2]


# ------------------------------------------------------------- the inputs --
def _frames(cell_id, n, prb):
    from ltetrigger_tpu_torch.ltecore import synth
    return np.tile(synth.synthesize_frame(cell_id, nof_prb_field=prb), n) \
        .astype(np.complex64)


def _noise(rng, n, sigma):
    return (sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))
            / np.sqrt(2.0)).astype(np.complex64)


def multi_streams():
    """8 streams of N_FRAMES frames: streams 0 and 4 carry a cell lost to
    noise 20 dB over it in frames 5-9 and reacquired, streams 2 and 6 a
    cell from frame 7 on, odd streams noise alone."""
    rng = np.random.default_rng(41)
    n = N_FRAMES * CHUNK
    sigs = []
    for i in range(N_STREAMS):
        x = _noise(rng, n, 0.4 if i % 2 else 0.05)
        if i % 2 == 0:
            cell = _frames(60 + 37 * i, N_FRAMES, (25, 50)[i // 2 % 2])
            if i % 4 == 0:
                cell[5 * CHUNK:10 * CHUNK] = 0
                x[5 * CHUNK:10 * CHUNK] += _noise(rng, 5 * CHUNK, 10.0)
            else:
                cell[:7 * CHUNK] = 0
            x = x + cell
        sigs.append(x.astype(np.complex64))
    return sigs


def wide_band():
    """N_FRAMES frames of a 7.68 Msps band: cell 99 at -2.4 MHz throughout,
    cell 250 at +2.4 MHz from frame 6 on and cell 40 at +0.8 MHz from frame
    11 on (after the first and the second rebase); nothing at -0.8 MHz."""
    def up(x, offset_hz):
        F = np.fft.fft(x.astype(np.complex128))
        n = x.size
        Fw = np.zeros(RATIO * n, dtype=np.complex128)
        Fw[:n // 2] = F[:n // 2]
        Fw[-n // 2:] = F[-n // 2:]
        t = np.arange(RATIO * n, dtype=np.float64)
        return np.fft.ifft(Fw) * RATIO * np.exp(
            2j * np.pi * (offset_hz / RATE) * t)
    x = up(_frames(99, N_FRAMES, 25), -2.4e6)
    for cid, prb, first, center in ((250, 50, 6, 2.4e6), (40, 15, 11, 0.8e6)):
        late = _frames(cid, N_FRAMES, prb)
        late[:first * CHUNK] = 0
        x = x + up(late, center)
    x = x / np.sqrt(np.mean(np.abs(x) ** 2))
    return (x + _noise(np.random.default_rng(43), x.size, 0.02)) \
        .astype(np.complex64)


def cell_fields(cell):
    d = cell.to_dict()
    d.pop("tracking_start_time")
    return d


def tagged(events):
    """(stream, Cell) pairs as JSON-ready [stream, fields] pairs."""
    return [[int(n), cell_fields(c)] for n, c in events]


def feeder(trigger, data):
    """call(i, j): samples [i, j) of every stream (of the wide stream for a
    WidebandTrigger) into `trigger`; returns its events."""
    if hasattr(trigger, "process_wide"):
        return lambda i, j: trigger.process_wide(data[i:j])
    return lambda i, j: trigger.process_all([s[i:j] for s in data])


def feed(trigger, data, start, stop, chunk, rebases):
    """Feed [start, stop) in `chunk` pieces; append to `rebases` the fed
    length at the end of every call that rebased (`_base` went down)."""
    call, ev = feeder(trigger, data), []
    for i in range(start, stop, chunk):
        j = min(i + chunk, stop)
        base = trigger._base
        ev += call(i, j)
        if trigger._base < base:
            rebases.append(j)
    return ev


TELEMETRY = ("tracking_score", "tracking", "cap_overflow", "max_psr",
             "mean_psr", "mean_cfo", "channel_estimate")


def save(t, path, rebases, at):
    """`t.save_state(path)` at fed length `at`; a rebase it settles is
    noted in `rebases` as at that length."""
    base = t._base
    t.save_state(str(path))
    if t._base < base:
        rebases.append(at)


def positions(t, n_rebases):
    """A trigger's drained stream coordinates made absolute (its own plus
    the rebases' shift), where its host buffer starts, and the wide
    stream's offset where it has one."""
    shift = n_rebases * REBASE
    out = {"grid": t._grid + shift, "pos_lb": (t._pos_lb + shift).tolist(),
           "base": t._base + shift}
    if hasattr(t, "_wabs"):
        out.update(wabs=t._wabs, wbase_abs=t._wbase + t._wabs)
    return out


# ------------------------------------------------------- one rank's work ---
def _scenarios(rank, out):
    """Every scenario, in the same order on every rank (checkpoints and
    gathers are collectives).  Global results are written by rank 0, a
    rank's own by that rank."""
    from ltetrigger_tpu_torch.models.multi import MultiTrigger
    from ltetrigger_tpu_torch.models.wideband import WidebandTrigger
    from ltetrigger_tpu_torch.parallel import gather_events, make_mesh

    MultiTrigger.REBASE_AT = REBASE         # WidebandTrigger's too
    mesh = make_mesh(4, 1, device="cpu")
    kw = dict(psr_threshold=4, transport="f32")
    own = {}

    def dump(name, obj):
        if rank == 0:
            (out / f"{name}.json").write_text(json.dumps(obj))

    # the whole stream through each class, a sharded checkpoint at the cut,
    # then the JAX package's checkpoint at the same cut continued here
    for name, make, data, cut in (
            ("multi", lambda: MultiTrigger(N_STREAMS, mesh=mesh, **kw),
             multi_streams(), CUT),
            ("wide", lambda: WidebandTrigger(RATE, CENTERS, mesh=mesh, **kw),
             wide_band(), WIDE_CUT)):
        chunk = WCHUNK if name == "wide" else CHUNK
        stop = len(data) if name == "wide" else len(data[0])
        t, rebases = make(), []
        before = feed(t, data, 0, cut, chunk, rebases) + t.flush()
        save(t, out / f"{name}_sharded.npz", rebases, cut)
        after = feed(t, data, cut, stop, chunk, rebases) + t.flush()
        dump(f"{name}_events", {"before": tagged(gather_events(before, mesh)),
                                "after": tagged(gather_events(after, mesh))})
        own[name] = dict(rebases=rebases, **positions(t, len(rebases)),
                         telemetry={k: np.asarray(getattr(t, k)).tolist()
                                    for k in TELEMETRY[:-1]})
        np.save(out / f"{name}_chest_r{rank}.npy", t.channel_estimate)
        r = make()
        r.load_state(str(out / f"{name}_jax.npz"))
        resumed = feed(r, data, cut, stop, chunk, [])
        dump(f"{name}_resumed_jax",
             tagged(gather_events(resumed + r.flush(), mesh)))

    # ranks that rebase on different calls, checkpointed where they meet
    # from the first rank's rebase to the last's (a first run without
    # checkpoints finds them)
    from ltetrigger_tpu_torch.parallel import mesh as meshmod
    sigs = multi_streams()
    n, chunk = len(sigs[0]), SPLIT_CHUNKS[rank % 2]
    dry = []
    feed(MultiTrigger(N_STREAMS, mesh=mesh, **kw), sigs, 0, n, chunk, dry)
    spans = meshmod.all_gather_object(dry, mesh, "ch")
    window = [m for m in range(MEET, n, MEET)
              if min(r[0] for r in spans) <= m <= max(r[-1] for r in spans)]
    t, rebases, saves, events = MultiTrigger(N_STREAMS, mesh=mesh, **kw), \
        [], [], []
    try:
        last = 0
        for meet in window:
            ev = feed(t, sigs, last, meet, chunk, rebases) + t.flush()
            events += [(s, (meet, c)) for s, c in ev]
            before = len(rebases)
            save(t, out / f"split_{meet}.npz", rebases, meet)
            saves.append({"meet": meet, "rebases_before": before,
                          "base": t._base})
            last = meet
        ev = feed(t, sigs, last, n, chunk, rebases) + t.flush()
        events += [(s, (n, c)) for s, c in ev]
        error = None
    except ValueError as e:     # raised on every rank alike (see multi.py)
        error = str(e)
    own["split"] = dict(dry=dry, window=window, rebases=rebases, saves=saves,
                        error=error)
    if error is None:
        dump("split_events", [[int(s), meet, cell_fields(c)] for s, (meet, c)
                              in gather_events(events, mesh)])
    (out / f"own_r{rank}.json").write_text(json.dumps(own))


def _worker(rank, world, port, out):
    import torch
    import torch.distributed as dist
    from ltetrigger_tpu_torch.parallel import init_distributed
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                     timeout=240)
    try:
        _scenarios(rank, pathlib.Path(out))
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    assert sys.argv[1] == "--worker", sys.argv
    _worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
            sys.argv[5])
    sys.exit(0)


# ======================================================================
# the tests
# ======================================================================
import pytest  # noqa: E402

from ltetrigger_tpu.models import multi as jmulti  # noqa: E402
from ltetrigger_tpu.models import wideband as jwide  # noqa: E402
from ltetrigger_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from ltetrigger_tpu_torch.models import multi, wideband  # noqa: E402
from test_torch_common import FLOAT_TOL  # noqa: E402

# each telemetry property's engine field in FLOAT_TOL
TEL_TOL = {"max_psr": FLOAT_TOL["psr_max"], "mean_psr": FLOAT_TOL["psr_ring"],
           "mean_cfo": FLOAT_TOL["cfo_ring"],
           "channel_estimate": FLOAT_TOL["chest"]}


def spawn(world, out, timeout=420):
    """Run `world` ranks of this file; all must exit 0 inside `timeout`
    seconds.  A rank that fails ends the others at once."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = [open(out / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--worker",
         str(r), str(world), str(port), str(out)],
        cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
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


def key_sorted(events):
    """Events in `gather_events`' order: stably by stream."""
    return sorted(events, key=lambda e: e[0])


def run(t, data, cut=None, path=None):
    """Feed the whole stream (with a checkpoint at `cut` into `path`):
    (events before the cut, events after it, tagged; the rebases)."""
    chunk = WCHUNK if hasattr(t, "process_wide") else CHUNK
    stop = len(data) if hasattr(t, "process_wide") else len(data[0])
    cut = stop if cut is None else cut
    rebases = []
    before = feed(t, data, 0, cut, chunk, rebases) + t.flush()
    if path is not None:
        save(t, path, rebases, cut)
    after = feed(t, data, cut, stop, chunk, rebases) + t.flush()
    return tagged(before), tagged(after), rebases


def makers(kind):
    """The port's unsharded class and the JAX class (on its 8-device mesh,
    pipeline=0), and the kind's inputs and cut."""
    kw = dict(psr_threshold=4, transport="f32")
    if kind == "multi":
        return (lambda: multi.MultiTrigger(N_STREAMS, device="cpu", **kw),
                lambda: jmulti.MultiTrigger(N_STREAMS, mesh=jmake_mesh(8, 1),
                                            pipeline=0, **kw),
                multi_streams(), CUT)
    return (lambda: wideband.WidebandTrigger(RATE, CENTERS, device="cpu",
                                             **kw),
            lambda: jwide.WidebandTrigger(RATE, CENTERS, pipeline=0,
                                          mesh=jmake_mesh(4, 2), **kw),
            wide_band(), WIDE_CUT)


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """REBASE_AT lowered in both packages for the module; the unsharded
    port and the JAX class through the whole stream, the JAX class with its
    checkpoint at the cut (which the ranks continue)."""
    mp = pytest.MonkeyPatch()
    try:
        for cls in (multi.MultiTrigger, wideband.WidebandTrigger,
                    jmulti.MultiTrigger, jwide.WidebandTrigger):
            mp.setattr(cls, "REBASE_AT", REBASE)
        out = tmp_path_factory.mktemp("mesh_monitor")
        ref = {"out": out}
        for kind in ("multi", "wide"):
            make_port, make_jax, data, cut = makers(kind)
            t = make_port()
            before, after, rebases = run(t, data)
            ref[kind, "port"] = (t, before + after)
            ref[kind, "port_rebases"] = rebases
            j = make_jax()
            before, after, _ = run(j, data, cut, out / f"{kind}_jax.npz")
            ref[kind, "jax"] = (j, before + after)
            ref[kind, "jax_after"] = after
        yield ref
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def ranks(references):
    """The one spawn of 4 ranks; returns the directory of what they wrote
    and each rank's own record."""
    out = references["out"]
    spawn(4, out)
    return out, [json.loads((out / f"own_r{r}.json").read_text())
                 for r in range(4)]


def assert_telemetry(parts, chests, ref, what, psr_rtol=None):
    """The ranks' telemetry rows, joined, against a whole trigger's."""
    for k in TELEMETRY:
        if k == "channel_estimate":
            got = np.concatenate(chests)
        else:
            got = np.concatenate([np.asarray(p[k]) for p in parts])
        want = np.asarray(getattr(ref, k))
        if k in TEL_TOL:
            tol = dict(TEL_TOL[k])
            if k in ("max_psr", "mean_psr") and psr_rtol:
                tol["rtol"] = psr_rtol
            np.testing.assert_allclose(got, want, err_msg=f"{what} {k}",
                                       **tol)
        else:
            np.testing.assert_array_equal(got, want, f"{what} {k}")


# ------------------------------------------ the mesh through the rebases ---
@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("kind", ["multi", "wide"])
def test_mesh_through_rebases_equals_one_process(ranks, references, kind,
                                                 ref):
    """Three rebases on every rank, a sharded checkpoint between the second
    and the third: the gathered events equal the unsharded port's and the
    JAX class's (on its mesh, pipeline=0) on the same streams, the joined
    telemetry too."""
    out, own = ranks
    got = json.loads((out / f"{kind}_events.json").read_text())
    t, want = references[kind, ref]
    assert key_sorted(got["before"] + got["after"]) == key_sorted(want)
    streams = {n for n, _ in want}
    assert streams == ({0, 2, 4, 6} if kind == "multi" else {0, 2, 3})
    assert all(len(o[kind]["rebases"]) == 3 for o in own), \
        [o[kind]["rebases"] for o in own]
    assert_telemetry([o[kind]["telemetry"] for o in own],
                     [np.load(out / f"{kind}_chest_r{r}.npy")
                      for r in range(4)], t, f"{kind} {ref}",
                     1e-3 if (kind, ref) == ("wide", "jax") else None)


@pytest.mark.parametrize("kind", ["multi", "wide"])
def test_ranks_stand_at_one_absolute_position(ranks, references, kind):
    """Every rank's drained position plus its rebases' shift is the
    unsharded port's; the ranks' host buffers start at one absolute sample;
    the wide stream's `_wabs` is the rebases' deltas on every rank."""
    _, own = ranks
    t, _ = references[kind, "port"]
    want = positions(t, len(references[kind, "port_rebases"]))
    got = [o[kind] for o in own]
    for g in got:
        assert g["grid"] == want["grid"]
        assert np.unique(g["pos_lb"]).tolist() \
            == np.unique(want["pos_lb"]).tolist()
    assert len({g["base"] for g in got}) == 1, [g["base"] for g in got]
    if kind == "wide":
        assert [g["wabs"] for g in got] \
            == [len(g["rebases"]) * REBASE * RATIO for g in got]
        assert len({g["wbase_abs"] for g in got}) == 1


# ------------------------------- a checkpoint between the ranks' rebases ---
def test_ranks_that_rebase_on_different_calls_checkpoint(ranks, references):
    """Ranks 0 and 2 feed 19200-sample chunks, ranks 1 and 3 38400: they
    rebase on different calls (without checkpoints, three times and twice
    in the stream), and a checkpoint falls between one rank's rebase and
    another's.  Every save from the first rank's rebase to the last's
    succeeds, every rank stands at the file's base after it, and each of
    those checkpoints continues in an unsharded trigger to the events of
    the uninterrupted run."""
    out, own = ranks
    errors = {o["split"]["error"] for o in own}
    assert errors == {None}, errors
    window = own[0]["split"]["window"]
    assert all(o["split"]["window"] == window for o in own) and window
    dry = [o["split"]["dry"] for o in own]
    assert [len(r) for r in dry] == [3, 2, 3, 2], dry
    saves = [o["split"]["saves"] for o in own]
    # a save at which the ranks had rebased different numbers of times
    split = [s[0]["meet"] for s in zip(*saves)
             if len({x["rebases_before"] for x in s}) > 1]
    assert split, saves
    for at in zip(*saves):
        with np.load(out / f"split_{at[0]['meet']}.npz") as data:
            assert {x["base"] for x in at} == {int(data["base"])}

    t, want = references["multi", "port"]
    want = key_sorted(want)
    got = json.loads((out / "split_events.json").read_text())
    assert [[s, f] for s, _, f in got] == want
    make_port, _, sigs, _ = makers("multi")
    for meet in window:
        r = make_port()
        r.load_state(str(out / f"split_{meet}.npz"))
        resumed = tagged(feed(r, sigs, meet, len(sigs[0]), CHUNK, [])
                         + r.flush())
        before = [[s, f] for s, m, f in got if m <= meet]
        assert key_sorted(before + resumed) == want, meet
        np.testing.assert_array_equal(r.tracking_score, t.tracking_score)


# ------------------------------- checkpoints across the packages ----------
@pytest.mark.parametrize("reader", ["port", "jax"])
@pytest.mark.parametrize("kind", ["multi", "wide"])
def test_sharded_checkpoint_after_rebases_loads_unsharded(
        ranks, references, kind, reader):
    """The 4 ranks' one file, written after two rebases with the JAX keys
    and global shapes, continues in the unsharded port and in the JAX class
    to what the JAX run publishes after the cut."""
    out, _ = ranks
    make_port, make_jax, data, cut = makers(kind)
    path = out / f"{kind}_sharded.npz"
    with np.load(path) as d:
        assert int(d["state_pos"].min()) + 2 * REBASE \
            <= cut // (RATIO if kind == "wide" else 1)
        if kind == "wide":
            assert int(d["wabs"]) >= 2 * REBASE * RATIO
            assert d["state_score"].shape == (len(CENTERS), 3)
        else:
            assert d["state_ema"].shape == (N_STREAMS, 75, 3, 128)
    r = (make_port if reader == "port" else make_jax)()
    r.load_state(str(path))
    chunk = WCHUNK if kind == "wide" else CHUNK
    stop = len(data) if kind == "wide" else len(data[0])
    got = tagged(feed(r, data, cut, stop, chunk, []) + r.flush())
    want = references[kind, "jax_after"]
    assert key_sorted(got) == key_sorted(want) and want


@pytest.mark.parametrize("kind", ["multi", "wide"])
def test_jax_checkpoint_after_rebases_continues_on_the_mesh(ranks,
                                                            references,
                                                            kind):
    """The JAX class's checkpoint at the same cut, after its rebases,
    continues on the 4 ranks to what the JAX run publishes after it."""
    out, _ = ranks
    got = json.loads((out / f"{kind}_resumed_jax.json").read_text())
    want = references[kind, "jax_after"]
    assert got == key_sorted(want) and want
