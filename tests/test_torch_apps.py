"""The PyTorch port's one-device `channel_scan` and the apps built on it
(`wideband_scan`, `snr_sweep`, `pbch_sweep`) and `run_flowgraph`, against the
JAX package on the CPU.

Tolerances: `channel_scan` field for field as tests/test_torch_engine.py
holds `scan_engine` (integers and booleans equal, floats within
test_torch_common.FLOAT_TOL); `wideband_scan` records equal apart from the
PSR, which is held to rtol 5e-3 (pass A runs in bf16 in both packages; the
channelizers agree to rtol 1e-4 / atol 1e-5).  The sweeps' noise comes from
each package's own generator, so their curves are compared only through the
record keys and, on the port alone, through where P(detect) is 0 and 1; the
engines under them are compared on one set of numpy-made noisy buffers.
"""

import inspect
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from ltetrigger_tpu.apps import snr_sweep as jsweep
from ltetrigger_tpu.apps import wideband_scan as jscan
from ltetrigger_tpu.ops import cplx as jcplx
from ltetrigger_tpu.parallel import channel_scan as jchannel_scan
from ltetrigger_tpu_torch.apps import snr_sweep as sweep
from ltetrigger_tpu_torch.apps import wideband_scan as scan
from ltetrigger_tpu_torch.models import api, trigger as trig
from ltetrigger_tpu_torch.parallel import channel_scan
from ltetrigger_tpu_torch.runtime.cellstore import CellStore
from test_torch_common import (assert_fields, engine_buffer, frames, noise,
                               to_pair_torch, upsample)

ROOT = pathlib.Path(__file__).resolve().parent.parent
RATE = 7.68e6
CENTERS = [-2.4e6, 0.0, 2.4e6]


# -------------------------------------------------------- channel_scan ----
@pytest.fixture(scope="module")
def noisy():
    """One clean cell at four SNRs (+5, 0, -8, -25 dB), built in numpy the
    way `snr_sweep` builds its channels: [4, LOOKBACK + 10 half-frames +
    WINDOW] complex64."""
    rng = np.random.default_rng(21)
    sig = frames(77, 5, nof_prb_field=25)
    sig = sig / np.sqrt(np.mean(np.abs(sig) ** 2))
    lanes = [sig + noise(rng, sig.size, np.sqrt(10.0 ** (-snr / 10.0)))
             for snr in (5.0, 0.0, -8.0, -25.0)]
    return np.stack([engine_buffer(x.astype(np.complex64), trig.LOOKBACK,
                                   trig.WINDOW) for x in lanes])


@pytest.mark.parametrize("combine", [True, False])
def test_channel_scan_fresh_matches_jax(noisy, combine):
    """Lane by lane: both packages' engines on the same noisy buffers."""
    jst, jout = jchannel_scan(jcplx.from_numpy(noisy), 10, 4.0,
                              combine=combine)
    st, out = channel_scan(to_pair_torch(noisy), 10, 4.0, combine=combine)
    assert_fields(out, jout, trig.StepOutput._fields, "out")
    assert_fields(st, jst, trig.TriggerState._fields, "state")
    ev = out.track_event.numpy()
    assert ev[:, 0].any() and ev[:, 1].any() and not ev[:, 3].any()
    assert set(out.cell_id.numpy()[ev]) == {77}


def test_channel_scan_carried_states_match_jax(noisy):
    """Two calls of 5 steps with the carry passed between them; the second
    reads its grid start from the carry in both packages."""
    jb, tb = jcplx.from_numpy(noisy), to_pair_torch(noisy)
    jst, jout1 = jchannel_scan(jb, 5, 4.0)
    st, out1 = channel_scan(tb, 5, 4.0)
    assert_fields(out1, jout1, trig.StepOutput._fields, "out1")
    trig.host_syncs.clear()
    jst, jout2 = jchannel_scan(jb, 5, 4.0, states=jst)
    st, out2 = channel_scan(tb, 5, 4.0, states=st)
    assert trig.host_syncs["grid"] == 1
    assert_fields(out2, jout2, trig.StepOutput._fields, "out2")
    assert_fields(st, jst, trig.TriggerState._fields, "state")
    assert int(st.pos[0, 0]) == trig.LOOKBACK + 10 * 9600


def test_channel_scan_takes_numpy_and_defaults_to_cuda(noisy, monkeypatch):
    pair = (np.ascontiguousarray(noisy.real), np.ascontiguousarray(noisy.imag))
    _, out = channel_scan(pair, 2, 4.0, device="cpu")
    _, ref = channel_scan(to_pair_torch(noisy), 2, 4.0)
    for f in trig.StepOutput._fields:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        channel_scan(pair, 2, 4.0)


# ------------------------------------------------------- wideband_scan ----
@pytest.fixture(scope="module")
def band():
    """7.68 Msps, cell 99 (25 PRB) at -2.4 MHz and cell 250 (50 PRB) at
    +2.4 MHz, 5 frames (0.05 s)."""
    def up(x, off):
        wide = upsample(x, 4).astype(np.complex128)
        return wide * np.exp(2j * np.pi * (off / RATE)
                             * np.arange(wide.size, dtype=np.float64))
    wide = up(frames(99, 5, nof_prb_field=25), -2.4e6) \
        + up(frames(250, 5, nof_prb_field=50), 2.4e6)
    return (wide / np.sqrt(np.mean(np.abs(wide) ** 2))).astype(np.complex64)


def _same_records(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        assert {k: v for k, v in g.items() if k != "psr"} \
            == {k: v for k, v in r.items() if k != "psr"}
        if "psr" in r:
            np.testing.assert_allclose(g["psr"], r["psr"], rtol=5e-3)


def test_wideband_scan_matches_jax(band):
    """The capture is shorter than `seconds`, so it is looped."""
    ref = jscan.wideband_scan(band, RATE, CENTERS, seconds=0.1)
    got = scan.wideband_scan(band, RATE, CENTERS, seconds=0.1, device="cpu")
    _same_records(got, ref)
    by_off = {r["center_offset_hz"]: r for r in got}
    assert (by_off[-2.4e6]["cell_id"], by_off[-2.4e6]["nof_prb"]) == (99, 25)
    assert (by_off[2.4e6]["cell_id"], by_off[2.4e6]["nof_prb"]) == (250, 50)
    assert by_off[0.0] == {"center_offset_hz": 0.0, "detected": False}


def test_wideband_scan_cli_prints_the_jax_json(tmp_path, capsys, band):
    path = str(tmp_path / "band.c64")
    band.tofile(path)
    argv = [path, "-s", "7.68M", "--centers=-2.4M,0,2.4M", "--seconds",
            "0.1"]
    assert jscan.main(argv) == 0
    ref = json.loads(capsys.readouterr().out)
    assert scan.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    _same_records(got, ref)
    assert [r["detected"] for r in got] == [True, False, True]


def test_wideband_scan_defaults_to_cuda(band, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        scan.wideband_scan(band, RATE, CENTERS, seconds=0.1)


# ----------------------------------------------------------- the sweeps ----
@pytest.fixture(scope="module")
def cell_iq():
    return frames(77, 1, nof_prb_field=25)


def test_snr_sweep_records_and_curve(cell_iq):
    ref = jsweep.snr_sweep(cell_iq, 1.92e6, [-25, 5], seconds=0.08)
    kw = dict(seconds=0.08, n_trials=3, seed=5, device="cpu")
    got = sweep.snr_sweep(cell_iq, 1.92e6, [-25, 5], **kw)
    assert [list(g) for g in got] == [list(r) for r in ref]
    low, high = got
    assert (low["snr_db"], low["prob"], low["detected"]) == (-25.0, 0.0,
                                                             False)
    assert (high["prob"], high["detected"], high["cell_id"],
            high["n_trials"]) == (1.0, True, 77, 3)
    assert high["max_psr"] > low["max_psr"] and high["steps_to_detect"] <= 2
    # the same seed on the same device gives the same curve, another seed
    # other noise
    assert sweep.snr_sweep(cell_iq, 1.92e6, [-25, 5], **kw) == got
    other = sweep.snr_sweep(cell_iq, 1.92e6, [-25, 5], **dict(kw, seed=6))
    assert other[0]["mean_psr"] != low["mean_psr"]


def test_snr_sweep_decimates_fades_and_drops_combining(cell_iq):
    """A 7.68 Msps capture, the multipath profile of `--fading`, and the
    stateless decoder: at +10 dB the cell is found all the same."""
    from ltetrigger_tpu_torch.ltecore.synth import default_port_channels
    got = sweep.snr_sweep(upsample(cell_iq, 4), 7.68e6, [10], seconds=0.08,
                          combine=False, device="cpu",
                          channel_taps=default_port_channels(1)[0])
    assert got[0]["detected"] and got[0]["cell_id"] == 77


def test_noisy_buffers_take_the_generator():
    """The noise comes from the generator handed in: the same state twice
    gives the same buffers, scaled per channel, padded for the engine."""
    sig = to_pair_torch(frames(77, 1, nof_prb_field=25))
    sigmas = torch.tensor([0.0, 0.5, 2.0])

    def build(seed):
        return sweep._noisy_buffers(
            [sig], [None], sigmas, torch.Generator().manual_seed(seed))

    a, b, c = build(1), build(1), build(2)
    n = sig[0].shape[0]
    body = slice(trig.LOOKBACK, trig.LOOKBACK + n)
    for comp in (0, 1):
        assert a[comp].shape == (3, trig.LOOKBACK + n + trig.WINDOW)
        assert torch.equal(a[comp], b[comp])
        assert not torch.equal(a[comp], c[comp])
        assert torch.equal(a[comp][0, body], sig[comp])
        assert not a[comp][:, :trig.LOOKBACK].any()
        assert not a[comp][:, trig.LOOKBACK + n:].any()
        noise2 = (a[comp][2, body] - sig[comp]).std()
        assert 1.9 < float(noise2) < 2.1
    assert not torch.equal(a[0][1], a[1][1])     # re and im drawn apart


def test_pbch_sweep_records_and_curve():
    ref = jsweep.pbch_sweep([-40, 0], n_ttis=1, n_trials=1)
    kw = dict(n_ttis=1, n_trials=2, seed=3, device="cpu")
    got = sweep.pbch_sweep([-40, 0], **kw)
    assert [list(g) for g in got] == [list(r) for r in ref]
    assert (got[0]["pbch_rel_db"], got[0]["prob"]) == (-40.0, 0.0)
    assert (got[1]["prob"], got[1]["n_trials"], got[1]["snr_sync_db"]) \
        == (1.0, 2, 0.0)
    assert got[1]["median_steps_to_publish"] <= 2
    assert sweep.pbch_sweep([-40, 0], **kw) == got


def test_snr_sweep_cli(tmp_path, capsys, cell_iq, monkeypatch):
    path = str(tmp_path / "cell.c64")
    cell_iq.tofile(path)
    argv = [path, "-s", "1.92M", "--snr-min", "5", "--snr-max", "5",
            "--seconds", "0.08", "--trials", "2", "--no-combine", "--fading"]
    assert sweep.main(argv + ["--device", "cpu"]) == 0
    (rec,) = json.loads(capsys.readouterr().out)
    assert rec["snr_db"] == 5.0 and rec["n_trials"] == 2 and rec["detected"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.pbch_sweep([0], n_ttis=1, n_trials=1)


# --------------------------------------------------------- run_flowgraph ----
@pytest.fixture
def flow():
    pytest.importorskip("yaml")
    from ltetrigger_tpu_torch.apps import run_flowgraph
    return run_flowgraph


def _template_params(text):
    return set(re.findall(r"\$\{(\w+)\}", text))


def test_port_descriptors_match_the_api(flow):
    descs = flow.load_descriptors()
    assert set(descs) == {"ltetrigger_tpu_torch_downlink_trigger",
                          "ltetrigger_tpu_torch_cellstore"}
    d = descs["ltetrigger_tpu_torch_downlink_trigger"]
    sig = inspect.signature(api.Trigger.__init__)
    declared = {p["id"]: p for p in d["parameters"]}
    assert set(declared) <= set(sig.parameters)
    assert _template_params(d["templates"]["make"]) == set(declared) \
        == {"psr_threshold", "exit_on_success", "device"}
    assert declared["device"]["default"] == "cuda" \
        == sig.parameters["device"].default
    assert d["templates"]["imports"] \
        == "from ltetrigger_tpu_torch.models import api"
    for cb in d["templates"]["callbacks"]:
        assert callable(getattr(api.Trigger, cb.split("(")[0]))
    assert {o["label"] for o in d["outputs"]} == {"track", "drop"}
    assert any("psr_threshold" in a for a in d["asserts"])
    store = descs["ltetrigger_tpu_torch_cellstore"]
    assert "ltetrigger_tpu_torch.runtime.cellstore" \
        in store["templates"]["imports"]
    assert {i["label"] for i in store["inputs"]} == {"track", "drop"}
    made = flow._make_from_descriptor(store, {})
    assert isinstance(made, CellStore)
    t = flow._make_from_descriptor(d, {"device": "cpu",
                                       "exit_on_success": "True"})
    assert isinstance(t, api.Trigger) and t.exit_on_success \
        and t.device.type == "cpu" and t.psr_threshold == 4.0
    with pytest.raises(ValueError, match="assert"):
        flow._make_from_descriptor(d, {"device": "cpu",
                                       "psr_threshold": "-1"})


def _demo_on_cpu(tmp_path, name: str, capture: np.ndarray) -> str:
    """A copy of a shipped demo whose file source reads `capture` and whose
    trigger runs on the CPU."""
    import yaml
    cap = tmp_path / "capture.c64"
    capture.astype(np.complex64).tofile(cap)
    with open(ROOT / "examples" / name) as f:
        fg = yaml.safe_load(f)
    for b in fg["blocks"]:
        if b["id"] == "blocks_file_source":
            b["parameters"]["file"] = str(cap)
        if b["id"] == "ltetrigger_tpu_torch_downlink_trigger":
            assert b["parameters"]["device"] == "cuda"
            b["parameters"]["device"] = "cpu"
    path = tmp_path / name
    with open(path, "w") as f:
        yaml.safe_dump(fg, f)
    return str(path)


def test_demo_flowgraph_runs_headless(flow, tmp_path, capsys):
    path = _demo_on_cpu(tmp_path, "ltetrigger_demo_torch.grc",
                        frames(123, 1, nof_prb_field=6))
    out = flow.FlowgraphRunner(path).run(time_out=1.0)
    cells = out["cellstore_0"]
    assert cells and cells[0]["cell_id"] == 123 and cells[0]["nof_prb"] == 6
    assert flow.main([path, "--time-out", "1"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed["cellstore_0"][0]["cell_id"] == 123


def test_snr_flowgraph_runs_headless(flow, tmp_path):
    """At the shipped low noise the cell publishes; with the noise variable
    raised far above the detection knee it must not."""
    path = _demo_on_cpu(tmp_path, "snr_ltetrigger_demo_torch.grc",
                        frames(123, 1, nof_prb_field=6))
    out = flow.FlowgraphRunner(path).run(time_out=1.0)
    assert out["cellstore_0"] and out["cellstore_0"][0]["cell_id"] == 123
    loud = flow.FlowgraphRunner(path)
    loud.vars["noise_amp"] = 30.0          # ~-30 dB SNR: far below the knee
    assert loud.run(time_out=0.6)["cellstore_0"] == []


def test_flowgraph_trigger_defaults_to_cuda(flow, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flow.FlowgraphRunner(ROOT / "examples" / "ltetrigger_demo_torch.grc")
    with pytest.raises(ValueError, match="not a GRC flowgraph"):
        flow.load_flowgraph(ROOT / "ltetrigger_tpu_torch" / "grc"
                            / "ltetrigger_tpu_torch_cellstore.block.yml")


# ------------------------------------------------------------- package ----
def test_package_exports_resolve_lazily():
    import ltetrigger_tpu_torch as pkg
    from ltetrigger_tpu_torch.models import multi, wideband
    assert pkg.search is api.search and pkg.Trigger is api.Trigger
    assert pkg.MultiTrigger is multi.MultiTrigger
    assert pkg.WidebandTrigger is wideband.WidebandTrigger
    assert pkg.CellStore is CellStore
    with pytest.raises(AttributeError):
        pkg.no_such_name
    assert "one-shot LTE cell search" not in pkg.__doc__


# ------------------------------------------------- on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_wideband_scan_on_card_equals_cpu(cuda_device, band):
    want = scan.wideband_scan(band, RATE, CENTERS, seconds=0.1, device="cpu")
    got = scan.wideband_scan(band, RATE, CENTERS, seconds=0.1,
                             device=cuda_device)
    _same_records(got, want)
