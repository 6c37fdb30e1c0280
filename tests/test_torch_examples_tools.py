"""The PyTorch port's example tools (examples/*_torch.py) on the CPU,
against the JAX package and the JAX tools' keys:

- `LTETRIGGER_GROUP_BUDGET`: the port's `_pick_group` equals the JAX one
  under the same value (a fresh interpreter each);
- `bench_sweep_torch.run_point` and the `passes` ladder at C=2: the full
  rung equals `scan_engine`, its output equals JAX `channel_scan` on the
  same buffer (integers exact, floats within test_torch_common's
  FLOAT_TOL); `decode` / `micro` at C=1 print the JAX tool's keys
  (read from examples/bench_attrib.py's `emit` calls);
- `make_snr_curve_torch`'s `knee` and renderer;
- each example imported in a fresh interpreter with jax blocked loads
  nothing of JAX, and `--device cuda` raises without a card.
"""

import ast
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltetrigger_tpu_torch.models import trigger as trig
from test_torch_common import assert_fields

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
sys.path.insert(0, str(EXAMPLES))

import bench_attrib_torch  # noqa: E402
import bench_stream_torch  # noqa: E402
import bench_sweep_torch  # noqa: E402
import in_flight_torch  # noqa: E402
import make_snr_curve_torch  # noqa: E402
import pass_b_stamps_torch  # noqa: E402
import seam_sweep_torch  # noqa: E402

# imported in a fresh interpreter: any module of these packages is a fault
BLOCK_JAX = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ltetrigger_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
"""


# ----------------------------------------------------------- group budget --
@pytest.mark.parametrize("budget", ["2048", "16384"])
def test_group_budget_from_the_environment(budget):
    code = """
import json
from ltetrigger_tpu.models import trigger as j
from ltetrigger_tpu_torch.models import trigger as t
cases = [(s, b) for s in (8, 25, 55, 100, 200) for b in (1, 32, 128, 512,
                                                          1024)]
print(json.dumps([t.GROUP_BUDGET, j.GROUP_BUDGET,
                  [t._pick_group(*c) for c in cases],
                  [j._pick_group(*c) for c in cases]]))
"""
    env = dict(os.environ, LTETRIGGER_GROUP_BUDGET=budget,
               PYTHONPATH=str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    tb, jb, tg, jg = json.loads(done.stdout.splitlines()[-1])
    assert tb == jb == int(budget)
    assert tg == jg
    assert trig.GROUP_BUDGET == 4096        # the default, in this process


# ------------------------------------------ the sweep and the pass ladder --
def _lines(out: str) -> list:
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def _jax_emits(cmd: str) -> list:
    """The keyword names and the name value of each `emit(...)` call in the
    JAX tool's `cmd_<cmd>` (examples/bench_attrib.py)."""
    tree = ast.parse((EXAMPLES / "bench_attrib.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == f"cmd_{cmd}")
    got = []
    for call in ast.walk(fn):
        if isinstance(call, ast.Call) and getattr(call.func, "id", "") \
                == "emit":
            keys = [k.arg for k in call.keywords]
            name = next((k.value.value for k in call.keywords
                         if isinstance(k.value, ast.Constant)
                         and isinstance(k.value.value, str)), None)
            got.append((keys, name))
    return got


def _jax_dicts(tool: str, fn: str) -> list:
    """The key sets of the dict literals with string keys in function `fn`
    of examples/<tool>.py (a JAX tool, or its port), in source order."""
    tree = ast.parse((EXAMPLES / f"{tool}.py").read_text())
    func = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == fn)
    found = [d for d in ast.walk(func) if isinstance(d, ast.Dict) and d.keys
             and all(isinstance(k, ast.Constant) for k in d.keys)]
    return [{k.value for k in d.keys}
            for d in sorted(found, key=lambda d: (d.lineno, d.col_offset))]


def test_run_point_on_the_cpu():
    rec = bench_sweep_torch.run_point(2, 10, 0.055, 1, "cpu")
    assert rec["detections_ok"] is True
    assert [set(rec)] == _jax_dicts("bench_sweep", "run_point")
    assert bench_sweep_torch.capped(1024, 0.55, 100) == (0.275, 55)
    assert bench_sweep_torch.capped(128, 0.55, 100) == (0.55, 100)


def test_capture_file_replaces_the_synthetic_frame(tmp_path):
    from ltetrigger_tpu_torch.ltecore import synth
    path = tmp_path / "cell123.c64"
    (3.0 * synth.synthesize_frame(123, nof_prb_field=6)).astype(
        "complex64").tofile(path)
    got, want = bench_sweep_torch.frame_iq(str(path)), \
        bench_sweep_torch.frame_iq()
    assert got.dtype == want.dtype and got.shape == want.shape == (19200,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("multi", [False, True])
def test_stream_tool_on_the_cpu(multi):
    """Per-pass records and the summary, with the JAX tool's keys."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if multi:
            got = bench_stream_torch.multi_main(2, 0.1, 4, ["i4"], 2, "cpu")
        else:
            got = bench_stream_torch.single_main(0.1, 4, ["f32", "i8"], 1,
                                                 "cpu")
    lines = _lines(out.getvalue())
    keys = _jax_dicts("bench_stream", "multi_main" if multi else "main")
    per_pass = [x for x in lines if "pass" in x]
    assert [set(x) for x in per_pass] == [keys[0]] * len(per_pass)
    assert [x for x in lines if "pass" not in x] == got
    assert all(set(r) == keys[1] and r["detections_ok"] for r in got)
    assert len(per_pass) == 2 and len(got) == (1 if multi else 2)


def test_passes_ladder_equals_scan_engine_and_jax():
    from ltetrigger_tpu.parallel import channel_scan as jchannel_scan
    args = bench_attrib_torch.parse(["passes", "--channels", "2", "--steps",
                                     "10", "--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows, got = bench_attrib_torch.cmd_passes(args)
    lines = _lines(out.getvalue())
    assert lines[0]["config"] == {"channels": 2, "steps": 10, "group": 10,
                                  "group_budget": 4096}
    assert [r["variant"] for r in lines[1:]] == [
        "pass_A_only", "passes_AB", "ABC_nodecode", "ABC_decode"]
    jax_keys = [set(k) for k, _ in _jax_emits("passes")]
    assert jax_keys[0] == {"config"}
    for r in rows:
        assert set(r) == jax_keys[1] | {"device_ms", "launches_by_kernel"}
        assert r["device_ms"] is None
        # every hand kernel's count, 0 where the plain versions run
        assert r["launches_by_kernel"] == dict.fromkeys(
            ("mf", "pb", "tti", "vit", "ring"), 0)
    buf = bench_sweep_torch.make_buffer(2, 0.55, "cpu")
    _, want = trig.scan_engine(buf, trig.init_state(batch=(2,), device="cpu"),
                               10, 4.0, grid0=trig.LOOKBACK)
    for f in trig.StepOutput._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.track_event[:, :, 123 % 3].any()
    _, ref = jchannel_scan(tuple(jnp.asarray(c.numpy()) for c in buf), 10,
                           4.0)
    assert_fields(got, ref, trig.StepOutput._fields, "ABC_decode")


@pytest.mark.parametrize("cmd,argv", [
    ("decode", ["--channels", "1"]),
    ("micro", ["--channels", "1", "--steps", "10"])])
def test_decode_and_micro_print_the_jax_keys(cmd, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = bench_attrib_torch.main([cmd, *argv, "--device", "cpu"])
    lines = _lines(out.getvalue())
    assert lines == rows
    want = [(k, name) for k, name in _jax_emits(cmd)
            if name not in ("extract_taa", "extract_dense")]
    assert [(sorted(set(r) - {"device_ms"}), r.get("stage", r.get("op")))
            for r in rows] == [(sorted(k), name) for k, name in want]
    assert all(r["ms"] > 0 for r in rows)
    if cmd == "decode":
        assert [r["batch"] for r in rows] == [48, 48, 576]


# ------------------------------------------------------------ SNR curve ----
def test_knee():
    knee = make_snr_curve_torch.knee
    curve = [{"snr_db": s, "prob": p} for s, p in
             ((-20, 0.0), (-19, 0.6), (-18, 0.4), (-17, 1.0), (-16, 1.0))]
    assert knee(curve) == -17                   # monotone above only
    assert knee(curve[:2]) == -19
    assert knee([{"snr_db": 0, "prob": 0.25}]) is None
    assert seam_sweep_torch.knee(
        [{"snr_db": -3, "p": 1.0}, {"snr_db": -4, "p": 0.5}], "p") == -4


def test_snr_curve_payload_has_the_jax_keys():
    port = _jax_dicts("make_snr_curve_torch", "main")
    for keys in _jax_dicts("make_snr_curve", "main"):
        assert any(keys <= k for k in port), keys


@pytest.mark.parametrize("combine_wins", [False, True])
def test_snr_curve_markdown(combine_wins):
    def curve(knee_at):
        return [{"snr_db": float(s), "prob": float(s >= knee_at)}
                for s in (-22, -20, -18)]
    names = [n for n, _, _ in make_snr_curve_torch.CONFIGS]
    curves, knees = {}, {}
    for n in names:
        for mode in ("combine", "single"):
            k = -20 if (mode == "combine" and combine_wins) else -18
            curves[f"{n}_{mode}"] = curve(k)
            knees[f"{n}_{mode}"] = make_snr_curve_torch.knee(curve(k))
    pc = [{"pbch_rel_db": x, "prob": float(x >= -28.5)} for x in (-30, -27)]
    ps = [{"pbch_rel_db": x, "prob": float(x >= -27)} for x in (-30, -27)]
    payload = {"device": "cpu", "capture": "a frame", "n_trials": 2,
               "seconds_per_trial": 0.5, "knee_db": knees, "curves": curves,
               "first_sync_s": 0.0,
               "pbch_limited": {"knee_db": {"pbch_combine": -27.0,
                                            "pbch_single": -27.0},
                                "curves": {"pbch_combine": pc,
                                           "pbch_single": ps},
                                "n_ttis": 6, "snr_sync_db": 0.0}}
    text = make_snr_curve_torch.render(payload)
    heads = [x for x in text.splitlines() if x.startswith("#")]
    assert heads == [
        "# Detection probability vs SNR — combine vs single, AWGN vs fading",
        "## awgn_t4  (threshold 4, AWGN)", "## awgn_t1.5  (threshold 1.5, "
        "AWGN)", "## fading_t4  (threshold 4, fading)",
        "## fading_t1.5  (threshold 1.5, fading)",
        "## pbch_limited  (sync at 0 dB, ONLY PBCH REs attenuated, 6 TTIs)",
        "## Interpretation"]
    assert "| -20 | " + ("1.00 | 0.00 |" if combine_wins
                          else "0.00 | 0.00 |") in text
    assert ("Combining wins end-to-end at `fading_t1.5`" in text) \
        == combine_wins
    assert "Device: cpu." in text and "Knee: combine **-27.0 dB**" in text


# ------------------------------------------------------- pass-B stamps --
def test_stamp_phases():
    """examples/pass_b_stamps_torch.py: the stamps of a searched step split
    into its five phases and the gap to the next step; an unsearched step
    (phases 1-4 unset) into one span and the gap; the seeded power carries
    its peak in root 0 at bin 4000 while strong."""
    stamps = pass_b_stamps_torch
    st = np.zeros((3, 6), np.uint64)
    st[0] = [100, 400, 450, 900, 1400, 1600]
    st[1] = [1800, 0, 0, 0, 0, 1900]
    st[2] = [2100, 2500, 2600, 3000, 3500, 3700]
    rows = stamps.phases(st, 3)
    assert rows[0] == (0, True, [300, 50, 450, 500, 200, 200])
    assert rows[1] == (1, False, [100, 200])
    assert rows[2] == (2, True, [400, 100, 400, 500, 200, -1])
    p = stamps.seeded_power(2, 3, 1, "cpu")
    assert tuple(p.shape) == (2, 3, 75, 3, 128)
    flat = p.permute(0, 1, 3, 2, 4).reshape(2, 3, 3, 9600)
    assert (flat[:, 0, 0].argmax(-1) == 4000).all()
    assert (flat[:, 1:, 0].amax(-1) < 60).all()


def test_stamp_block_spans():
    """examples/pass_b_stamps_torch.py: each block's entry, prologue, loop
    and carry-out stamps become its three spans; the entries' spread and
    the kernel's span run from the first entry to the last carry-out."""
    blocks = np.array([[1000, 1300, 5300, 5400],
                       [1200, 1450, 5900, 6100],
                       [1100, 1400, 5000, 5050]], np.uint64)
    got = pass_b_stamps_torch.block_spans(blocks)
    assert got["spans"].tolist() == [[300, 4000, 100], [250, 4450, 200],
                                     [300, 3600, 50]]
    assert got["entry_spread"] == 200
    assert got["span"] == 5100


# ------------------------------------------- imports and the device rule --
MODULES = ("bench_sweep_torch", "bench_attrib_torch", "bench_stream_torch",
           "seam_sweep_torch", "make_snr_curve_torch", "pass_b_stamps_torch",
           "in_flight_torch")


@pytest.mark.parametrize("module", MODULES)
def test_example_imports_nothing_of_jax(module):
    code = BLOCK_JAX + f"""
sys.path.insert(0, {str(EXAMPLES)!r})
import {module}
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "ltetrigger_tpu")]
assert not bad, bad
assert "torch" in sys.modules and "ltetrigger_tpu_torch" in sys.modules
print("ok")
"""
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0 and done.stdout.strip() == "ok", \
        done.stderr[-2000:]


@pytest.mark.parametrize("module,argv", [
    ("bench_sweep_torch", ["32"]),
    ("bench_attrib_torch", ["passes"]),
    ("bench_attrib_torch", ["decode"]),
    ("bench_stream_torch", ["0.1"]),
    ("seam_sweep_torch", ["--trials", "1"]),
    ("make_snr_curve_torch", ["--trials", "1"]),
    ("pass_b_stamps_torch", ["--steps", "4"]),
    ("in_flight_torch", ["--procs", "0"])])
def test_device_cuda_raises_without_a_card(module, argv, tmp_path):
    assert not torch.cuda.is_available()
    main = sys.modules[module].main
    extra = ["--out-dir", str(tmp_path)] if module.startswith("make") else []
    with pytest.raises(RuntimeError, match="CUDA"):
        main([*argv, *extra])                   # cuda is the default
    with pytest.raises(RuntimeError, match="CUDA"):
        main([*argv, *extra, "--device", "cuda"])
    assert not list(tmp_path.iterdir())         # nothing was written


def test_in_flight_counts_calls_on_the_cpu(capsys):
    """examples/in_flight_torch.py on the CPU: every call counted, none
    returns with an output in flight (an output on the CPU is there when
    its dispatch returns), one half-frame of read-ahead stands after each
    38400-sample call."""
    in_flight_torch.main(["--device", "cpu", "--procs", "0", "--seconds",
                          "0.2"])
    got = json.loads(capsys.readouterr().out)
    assert got["process"] == "alone" and got["device"] == "cpu"
    assert got["Trigger 38400"]["calls"] == 10
    assert got["MultiTrigger(8) 38400"]["calls"] == 10
    for key in ("Trigger 38400", "Trigger 307200", "MultiTrigger(8) 38400"):
        assert got[key]["in_flight"] == 0, key
        assert got[key]["backlog_max"] == 9600, key
