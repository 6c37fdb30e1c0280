"""The port's own copies of the numpy-only layers (`ltecore`, `runtime`,
`utils`) against the JAX package's originals.

Both are deterministic numpy code, so every comparison is exact: arrays must
agree in dtype, shape and bytes, scalars and records by `==`.  The second
half checks that the port really stands alone: no module of it resolves to a
file of the JAX package, and importing its entry points loads neither `jax`
nor `ltetrigger_tpu`.
"""

import dataclasses
import importlib
import os
import pathlib
import pkgutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import ltetrigger_tpu
import ltetrigger_tpu_torch
from ltetrigger_tpu import ltecore as jcore
from ltetrigger_tpu.runtime import cellstore as jstore, chunkbuf as jbuf
from ltetrigger_tpu.runtime import native as jnative
from ltetrigger_tpu.utils import eng_notation as jeng, profiling as jprof
from ltetrigger_tpu_torch.runtime import cellstore as tstore, chunkbuf as tbuf
from ltetrigger_tpu_torch.runtime import native as tnative
from ltetrigger_tpu_torch.utils import eng_notation as teng, profiling as tprof

PORT = pathlib.Path(ltetrigger_tpu_torch.__file__).resolve().parent
JAX_PKG = pathlib.Path(ltetrigger_tpu.__file__).resolve().parent
CORE_MODULES = ("constants", "pss", "sss", "scrambling", "coding", "mib",
                "crs", "refrx", "synth")


def pair(name):
    return (importlib.import_module(f"ltetrigger_tpu.ltecore.{name}"),
            importlib.import_module(f"ltetrigger_tpu_torch.ltecore.{name}"))


def same(a, b, where=""):
    """Exact equality through tuples, lists, dicts, dataclasses, arrays."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (where, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif dataclasses.is_dataclass(a):
        same(dataclasses.asdict(a), dataclasses.asdict(b), where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


# ------------------------------------------------------------- ltecore -----
@pytest.mark.parametrize("name", CORE_MODULES)
def test_module_surface_equal(name):
    """Same public names; every public constant (not a function, class or
    module) has the same value."""
    jm, tm = pair(name)

    def public(m):
        return {k for k, v in vars(m).items() if not k.startswith("_")
                and not isinstance(v, types.ModuleType)}

    assert public(jm) == public(tm)
    for k in sorted(public(jm)):
        v = getattr(jm, k)
        if not callable(v):
            same(v, getattr(tm, k), f"{name}.{k}")


def test_constants_functions():
    jm, tm = pair("constants")
    for normal in (True, False):
        same(jm.symbol_data_offsets(normal), tm.symbol_data_offsets(normal))
        for i in range(7 if normal else 6):
            same(jm.cp_len(i, normal), tm.cp_len(i, normal))


@pytest.mark.parametrize("fft_size", [128, 512, 2048])
def test_pss_tables(fft_size):
    jm, tm = pair("pss")
    same(jm.pss_freq(fft_size), tm.pss_freq(fft_size))
    same(jm.pss_time(fft_size), tm.pss_time(fft_size))
    same(jm.subcarrier_bins(fft_size), tm.subcarrier_bins(fft_size))
    same(jm.pss_freq_occupied(), tm.pss_freq_occupied())
    for root in jm.PSS_ZC_ROOTS:
        same(jm.zadoff_chu(root), tm.zadoff_chu(root))


def test_sss_tables():
    jm, tm = pair("sss")
    for fn in ("base_sequences", "nid1_table", "shift_bank", "c_scramble",
               "z_bank"):
        same(getattr(jm, fn)(), getattr(tm, fn)(), fn)
    for n in range(168):
        same(jm.m0m1_from_nid1(n), tm.m0m1_from_nid1(n))


@pytest.mark.parametrize("cell_id", [0, 1, 2, 123, 167, 251, 369, 503])
def test_sss_sequences(cell_id):
    jm, tm = pair("sss")
    for sub5 in (False, True):
        same(jm.sss_sequence(cell_id // 3, cell_id % 3, sub5),
             tm.sss_sequence(cell_id // 3, cell_id % 3, sub5))


@pytest.mark.parametrize("length", [31, 440, 1920])
def test_gold_sequences(length):
    jm, tm = pair("scrambling")
    same(jm.gold_matrix(length), tm.gold_matrix(length))
    rng = np.random.default_rng(length)
    for c_init in (0, 1, 503, *rng.integers(0, 2 ** 31, 5).tolist()):
        same(jm.gold_sequence(c_init, length),
             tm.gold_sequence(c_init, length))
    for cid in (0, 77, 503):
        same(jm.pbch_c_init(cid), tm.pbch_c_init(cid))
        for slot, sym, ncp in ((0, 0, True), (1, 4, True), (19, 3, False)):
            same(jm.crs_c_init(cid, slot, sym, ncp),
                 tm.crs_c_init(cid, slot, sym, ncp))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coding(seed):
    jm, tm = pair("coding")
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, 24).astype(np.uint8)
    same(jm.crc16(payload), tm.crc16(payload))
    for ports in jm.PORT_HYPOTHESES:
        a, b = jm.crc16_attach(payload, ports), tm.crc16_attach(payload,
                                                                ports)
        same(a, b)
        ca, cb = jm.conv_encode(a), tm.conv_encode(b)
        same(ca, cb)
        for e_bits in (480, 432, 1920):
            same(jm.rate_match(ca, e_bits), tm.rate_match(cb, e_bits))
    for e_bits in (480, 432, 1920, 1728):
        same(jm.ratematch_map(120, e_bits), tm.ratematch_map(120, e_bits))
        same(jm.dematch_scatter(120, e_bits), tm.dematch_scatter(120, e_bits))
    same(jm.trellis_tables(), tm.trellis_tables())


@pytest.mark.parametrize("prb", [6, 15, 25, 50, 75, 100])
def test_mib_pack_unpack(prb):
    jm, tm = pair("mib")
    for ext in (False, True):
        for res in range(4):
            for sfn in (0, 5, 1020):
                a = jm.mib_pack(prb, ext, res, sfn)
                same(a, tm.mib_pack(prb, ext, res, sfn))
                same(jm.mib_unpack(a), tm.mib_unpack(a))


@pytest.mark.parametrize("cell_id", [0, 123, 369, 503])
def test_crs(cell_id):
    jm, tm = pair("crs")
    for normal in (True, False):
        for port in range(4):
            same(jm.crs_symbol_indices(port, normal),
                 tm.crs_symbol_indices(port, normal))
        for slot, sym in ((0, 0), (1, 4), (7, 0), (19, 3 if not normal
                                                   else 4)):
            same(jm.crs_values(cell_id, slot, sym, normal),
                 tm.crs_values(cell_id, slot, sym, normal))
            for port in range(4):
                same(jm.crs_v(port, sym, slot), tm.crs_v(port, sym, slot))
                same(jm.crs_subcarriers(cell_id, port, sym, slot),
                     tm.crs_subcarriers(cell_id, port, sym, slot))


@pytest.mark.parametrize("cell_id,prb,ports,normal,quarter", [
    (0, 6, 1, True, 0), (123, 15, 2, True, 1), (251, 25, 4, True, 2),
    (369, 50, 1, False, 3), (503, 100, 2, False, 0), (77, 75, 4, False, 1)])
def test_synthesize_frame(cell_id, prb, ports, normal, quarter):
    jm, tm = pair("synth")
    kw = dict(nof_prb_field=prb, sfn=8 * quarter, quarter=quarter,
              nof_ports=ports, normal_cp=normal)
    same(jm.synthesize_frame(cell_id, **kw), tm.synthesize_frame(cell_id,
                                                                 **kw))
    same(jm.synthesize_frame_ports(cell_id, **kw),
         tm.synthesize_frame_ports(cell_id, **kw))
    same(jm.synthesize_pbch_subframe(cell_id, **kw),
         tm.synthesize_pbch_subframe(cell_id, **kw))


@pytest.mark.parametrize("seed", [0, 3])
def test_synth_channels(seed):
    jm, tm = pair("synth")
    for ports in (1, 2, 4):
        same(jm.default_port_channels(ports, seed),
             tm.default_port_channels(ports, seed))
    x = jm.synthesize_frame(5)
    taps = [(0, 1.0), (3, 0.5j), (9, -0.2)]
    same(jm.multipath_channel(x, taps, doppler_hz=30.0, phase0=0.4),
         tm.multipath_channel(x, taps, doppler_hz=30.0, phase0=0.4))
    same(jm.synthesize_faded_frames(42, n_frames=2, seed=seed),
         tm.synthesize_faded_frames(42, n_frames=2, seed=seed))


@pytest.mark.parametrize("ratio", [1, 4, 8, 16])
def test_refrx_lowpass_and_decimate(ratio):
    jm, tm = pair("refrx")
    same(jm.design_lowpass(ratio), tm.design_lowpass(ratio))
    same(jm.design_lowpass(ratio, 8), tm.design_lowpass(ratio, 8))
    rng = np.random.default_rng(ratio)
    x = (rng.normal(size=4000) + 1j * rng.normal(size=4000)) \
        .astype(np.complex64)
    same(jm.decimate(x, ratio), tm.decimate(x, ratio))


@pytest.mark.parametrize("cell_id,normal", [(123, True), (370, False)])
def test_refrx_chain(cell_id, normal):
    """The host reference receiver, stage by stage and end to end."""
    jm, tm = pair("refrx")
    frame = jcore.synth.synthesize_frame(cell_id, nof_prb_field=25,
                                         normal_cp=normal)
    rng = np.random.default_rng(cell_id)
    frame = (frame + 0.05 * (rng.normal(size=frame.size)
                             + 1j * rng.normal(size=frame.size))) \
        .astype(np.complex64)
    window = np.concatenate([frame, frame])[:9600 + 128]
    pw = jm.pss_correlate(window, cell_id % 3)
    same(pw, tm.pss_correlate(window, cell_id % 3))
    same(jm.peak_and_psr(pw), tm.peak_and_psr(pw))
    aligned = frame[:9600]
    same(jm.detect_cp(aligned), tm.detect_cp(aligned))
    same(jm.sss_decode(aligned, cell_id % 3, normal),
         tm.sss_decode(aligned, cell_id % 3, normal))
    same(jm.ofdm_demod_slot(frame[:960], normal),
         tm.ofdm_demod_slot(frame[:960], normal))
    same(jm.pbch_re_indices(cell_id % 3, normal),
         tm.pbch_re_indices(cell_id % 3, normal))
    sub = frame[:1920]
    for ports in (1, 2):
        same(jm.pbch_llrs(sub, cell_id, normal, ports),
             tm.pbch_llrs(sub, cell_id, normal, ports))
    llr = rng.normal(size=120)
    same(jm.viterbi_tailbiting(llr), tm.viterbi_tailbiting(llr))
    same(jm.mib_decode_subframe(sub, cell_id, normal),
         tm.mib_decode_subframe(sub, cell_id, normal))
    same(jm.search_frame(frame, 1.92e6), tm.search_frame(frame, 1.92e6))


# ------------------------------------------------------ runtime and utils --
@pytest.mark.parametrize("fields", [
    (123, 50, 1, 0, 2, 0, True), (503, 100, 4, 1, 3, 7, False),
    (0, 6, 2, 0, 0, 3, True)])
def test_cell_from_step_and_store(fields):
    a = jstore.cell_from_step(*fields, timestamp=1700000000)
    b = tstore.cell_from_step(*fields, timestamp=1700000000)
    same(a, b)
    same(a.to_dict(), b.to_dict())
    assert [f.name for f in dataclasses.fields(jstore.Cell)] == \
        [f.name for f in dataclasses.fields(tstore.Cell)]
    sa, sb = jstore.CellStore(), tstore.CellStore()
    assert sa.tracking() == sb.tracking() is False
    assert sa.latest_cell() is sb.latest_cell() is None
    other_a = jstore.cell_from_step(7, 25, 1, 0, 1, 1, True, timestamp=5)
    other_b = tstore.cell_from_step(7, 25, 1, 0, 1, 1, True, timestamp=5)
    for s, c, o in ((sa, a, other_a), (sb, b, other_b)):
        s.track_cell(c)
        s.track_cell(o)
        s.track_cell(c)
        s.drop_cell(c)                  # removes the first equal record
        s.drop_cell_id(99)              # no such cell: no-op
    same(sa.cells(), sb.cells())
    same(sa.latest_cell(), sb.latest_cell())
    sa.drop_cell_id(fields[0])
    sb.drop_cell_id(fields[0])
    same(sa.cells(), sb.cells())
    with pytest.raises(TypeError):
        sb.track_cell({"cell_id": 1})


def test_chunkbuffer_equal():
    rng = np.random.default_rng(4)
    ja, tb = jbuf.ChunkBuffer(), tbuf.ChunkBuffer()
    for n in (100, 1, 4096, 33, 700):
        chunk = (rng.normal(size=n) + 1j * rng.normal(size=n)) \
            .astype(np.complex64)
        ja.append(chunk)
        tb.append(chunk)
    assert len(ja) == len(tb)
    same(ja.view(50, 4300), tb.view(50, 4300))
    for drop in (60, 41, 4000):
        ja.drop_front(drop)
        tb.drop_front(drop)
        assert len(ja) == len(tb)
        same(ja.to_array(), tb.to_array())
    same(ja.view(0, len(ja)), tb.view(0, len(tb)))


# ------------------------------------------------------ runtime.native ----
def _iq(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def test_native_points_at_the_same_sources():
    """The port's copy binds the same cpp/ library as the JAX package's."""
    assert tnative._CPP_DIR == jnative._CPP_DIR
    assert tnative._SO_PATH == jnative._SO_PATH
    assert tnative.available() == jnative.available()
    same(jnative.deinterleave(_iq(1, 1000)), tnative.deinterleave(_iq(1, 1000)))


@pytest.mark.parametrize("ratio", [1, 4, 16])
def test_native_decimator_equal(ratio):
    x = _iq(2, 16 * 700 + 5)
    same(jnative.Decimator(ratio)(x), tnative.Decimator(ratio)(x))


def test_native_ring_buffer_equal():
    ja, tb = jnative.RingBuffer(1000), tnative.RingBuffer(1000)
    for seed, n in ((3, 600), (4, 700), (5, 10)):
        x = _iq(seed, n)
        assert ja.write(x) == tb.write(x)
        assert ja.available() == tb.available()
        same(ja.read(450), tb.read(450))


@pytest.mark.parametrize("repeat", [False, True])
def test_native_file_source_equal(tmp_path, repeat):
    path = str(tmp_path / "capture.c64")
    _iq(6, 3000).tofile(path)
    ja, tb = jnative.FileSource(path, repeat), tnative.FileSource(path, repeat)
    assert ja.n_samples == tb.n_samples == 3000
    for n in (1000, 2500, 700):
        same(ja.read(n), tb.read(n))
    with pytest.raises(FileNotFoundError):
        tnative.FileSource(str(tmp_path / "absent.c64"))


@pytest.mark.parametrize("text", ["15.36M", "1.92M", "800k", "2.4G", "10",
                                  "3m", "1e6", "7u"])
def test_eng_notation(text):
    same(jeng.str_to_num(text), teng.str_to_num(text))
    same(jeng.num_to_str(jeng.str_to_num(text)),
         teng.num_to_str(teng.str_to_num(text)))


def test_stage_timer_equal_shape():
    """StageTimer is copied as it is: same stages, counts and keys."""
    ja, tb = jprof.StageTimer(), tprof.StageTimer()
    for t in (ja, tb):
        for name in ("gather", "step", "step"):
            with t.stage(name):
                pass
    sa, sb = ja.summary(), tb.summary()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].keys() == sb[k].keys()
        assert sa[k]["count"] == sb[k]["count"]
    tb.reset()
    assert tb.summary() == {}


def test_trace_and_annotate_use_torch_profiler(tmp_path):
    """`trace` writes a Chrome trace into log_dir; `annotate` names a region
    in it (same signatures as the JAX package's, torch.profiler behind)."""
    @tprof.annotate("matmul_region")
    def f(x):
        return x @ x

    with tprof.trace(str(tmp_path / "tr")):
        y = f(torch.ones(4, 4))
    assert f.__name__ == "f" and float(y[0, 0]) == 4.0
    files = list((tmp_path / "tr").glob("*.json"))
    assert len(files) == 1
    assert "matmul_region" in files[0].read_text()


# ------------------------------------------------ the port stands alone ----
def port_modules():
    names = [ltetrigger_tpu_torch.__name__]
    for m in pkgutil.walk_packages([str(PORT)],
                                   prefix="ltetrigger_tpu_torch."):
        names.append(m.name)
    return names


def test_no_module_resolves_into_the_jax_package():
    names = port_modules()
    for want in ("ltecore.synth", "runtime.cellstore", "runtime.chunkbuf",
                 "runtime.native", "utils.profiling", "utils.eng_notation",
                 "models.api", "models.multi", "apps.live_monitor",
                 "models.wideband", "ops.channelize", "ops.device",
                 "parallel.sharded", "apps.wideband_scan", "apps.snr_sweep",
                 "apps.run_flowgraph"):
        assert f"ltetrigger_tpu_torch.{want}" in names
    for name in names:
        mod = importlib.import_module(name)
        f = pathlib.Path(mod.__file__).resolve()
        assert PORT in f.parents, (name, f)
        assert JAX_PKG not in f.parents, (name, f)
        for p in getattr(mod, "__path__", []):
            assert pathlib.Path(p).resolve() == f.parent, (name, p)


def test_no_path_tricks_in_the_port_sources():
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        for word in ("__path__", "importlib", "sys.path"):
            assert word not in text, (path, word)


def test_cli_import_loads_no_jax():
    """A fresh interpreter that imports the port's CLI, its API and the
    shared layers ends with neither jax nor ltetrigger_tpu loaded, and with
    every port module's file under the port's directory."""
    code = (
        "import sys, pathlib\n"
        "import ltetrigger_tpu_torch.apps.cell_search_file as c\n"
        "import ltetrigger_tpu_torch.apps.live_monitor as l\n"
        "import ltetrigger_tpu_torch.models.api as a\n"
        "import ltetrigger_tpu_torch.models.multi as m\n"
        "import ltetrigger_tpu_torch.models.wideband as w\n"
        "import ltetrigger_tpu_torch.parallel as p\n"
        "from ltetrigger_tpu_torch.apps import (run_flowgraph, snr_sweep, "
        "wideband_scan)\n"
        "from ltetrigger_tpu_torch.ltecore import synth, refrx\n"
        "from ltetrigger_tpu_torch.runtime import cellstore, chunkbuf\n"
        "from ltetrigger_tpu_torch.runtime import native\n"
        "from ltetrigger_tpu_torch.utils import profiling, eng_notation\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ltetrigger_tpu')]\n"
        "assert not bad, bad\n"
        "root = pathlib.Path(sys.modules['ltetrigger_tpu_torch'].__file__)"
        ".resolve().parent\n"
        "for n, m in list(sys.modules.items()):\n"
        "    if n.split('.')[0] == 'ltetrigger_tpu_torch':\n"
        "        f = pathlib.Path(m.__file__).resolve()\n"
        "        assert root in f.parents, (n, f)\n"
        "print('alone')\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], check=True, env=env,
                         cwd=PORT.parent, timeout=120, capture_output=True,
                         text=True)
    assert out.stdout.strip().endswith("alone")
