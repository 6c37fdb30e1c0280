"""The PyTorch port's example tools that start processes, on the CPU:

- `seam_sweep_torch --ranks 4 --backend gloo`: four gloo ranks of the
  script; P(detect) of the continuous and the time-sharded scan equal the
  JAX `channel_scan` / `time_sharded_scan` (on a 1 x 4 mesh of virtual CPU
  devices) over the same signal and the same seeded noise, exactly;
- `bench_attrib_torch groups`: a `passes` subprocess per budget, whose
  group follows LTETRIGGER_GROUP_BUDGET;
- `examples/test_torch.sh`: the port's CLI over four captures (synthetic
  frames of the four cells at their rates) with DEVICE=cpu.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from ltetrigger_tpu.ltecore import synth
from ltetrigger_tpu.models import trigger as jtrig
from ltetrigger_tpu.parallel import channel_scan, make_mesh, time_sharded_scan
from test_torch_common import upsample

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
SNRS, TRIALS, STEPS = (-20.0, -17.0, -14.0), 4, 4


def _run(args, env=None, timeout=300):
    done = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-3000:]
    return [json.loads(x) for x in done.stdout.splitlines()
            if x.startswith("{")]


def _jax_seam(snrs, n_trials, steps_per_shard, seed=0):
    """examples/seam_sweep.py's loop on the JAX package, over the port's
    frame (the synthetic cell 123, unit power) on 4 time shards."""
    mesh = make_mesh(1, 4, devices=jax.devices()[:4])
    iq = synth.synthesize_frame(123, nof_prb_field=6)
    iq = (iq / np.sqrt(np.mean(np.abs(iq) ** 2))).astype(np.complex64)
    total = 4 * steps_per_shard * jtrig.HALF_FRAME_LENGTH
    sig = np.tile(iq, -(-total // iq.size))[:total]
    sig = sig / np.sqrt(np.mean(np.abs(sig) ** 2))
    rng = np.random.default_rng(seed)
    out = []
    for snr_db in snrs:
        sigma = float(np.sqrt(10.0 ** (-snr_db / 10.0) / 2.0))
        det_c = det_s = 0
        for _ in range(n_trials):
            noisy = (sig + sigma * (rng.normal(size=total)
                                    + 1j * rng.normal(size=total))) \
                .astype(np.complex64)
            pair = (jnp.asarray(noisy.real.astype(np.float32)),
                    jnp.asarray(noisy.imag.astype(np.float32)))
            zh = jnp.zeros((1, jtrig.LOOKBACK), jnp.float32)
            zt = jnp.zeros((1, jtrig.WINDOW), jnp.float32)
            buf = tuple(jnp.concatenate([zh, c[None], zt], axis=1)
                        for c in pair)
            _, oc = channel_scan(buf, total // jtrig.HALF_FRAME_LENGTH, 4.0)
            det_c += bool((np.asarray(oc.track_event)
                           & (np.asarray(oc.cell_id) == 123)).any())
            os_ = time_sharded_scan(pair, mesh, 4.0)
            det_s += bool((np.asarray(os_.track_event)
                           & (np.asarray(os_.cell_id) == 123)).any())
        out.append({"snr_db": float(snr_db),
                    "p_continuous": det_c / n_trials,
                    "p_sharded": det_s / n_trials, "n_trials": n_trials})
    return out


def test_seam_sweep_on_four_ranks_equals_jax():
    lines = _run([str(EXAMPLES / "seam_sweep_torch.py"), "--ranks", "4",
                  "--backend", "gloo", "--device", "cpu", "--snr-min",
                  str(SNRS[0]), "--snr-max", str(SNRS[-1]), "--step", "3",
                  "--trials", str(TRIALS), "--steps-per-shard", str(STEPS)])
    *curve, summary = lines
    assert summary["n_shards"] == 4 and summary["curve"] == curve
    # every hand kernel's count, 0 where the plain versions run
    assert summary["launches_by_kernel"] == dict.fromkeys(
        ("mf", "pb", "tti", "vit", "ring", "chan", "front"), 0)
    want = _jax_seam(SNRS, TRIALS, STEPS)
    assert curve == want
    assert {r["p_sharded"] for r in want} > {0.0, 1.0}   # one in between
    assert summary["knee_sharded_db"] == summary["knee_continuous_db"] \
        == -17.0


def test_groups_follow_the_budget():
    lines = _run([str(EXAMPLES / "bench_attrib_torch.py"), "groups",
                  "--channels", "2", "--steps", "8", "--budgets", "2,8",
                  "--device", "cpu"])
    budgets = [x["group_budget"] for x in lines if "group_budget" in x]
    configs = [x["config"] for x in lines if "config" in x]
    assert budgets == [2, 8]
    assert [(c["group_budget"], c["group"]) for c in configs] == [(2, 1),
                                                                  (8, 4)]
    # each subprocess's rungs report every hand kernel's launches: 0 here
    rungs = [x for x in lines if "variant" in x]
    assert len(rungs) == 8 and all(
        x["launches_by_kernel"] == dict.fromkeys(
            ("mf", "pb", "tti", "vit", "ring", "chan", "front"), 0) for x in rungs)
    assert [x["variant"] for x in lines if "variant" in x] == [
        "pass_A_only", "passes_AB", "ABC_nodecode", "ABC_decode"] * 2


def test_cli_script_over_four_captures(tmp_path):
    for name, cid, prb, factor in (
            ("lte_frame_6prb_cellid_123", 123, 6, 1),
            ("lte_frame_25prb_cellid_124", 124, 25, 4),
            ("lte_frame_50prb_cellid_125", 125, 50, 8),
            ("lte_frame_100prb_cellid_369", 369, 100, 16)):
        frame = synth.synthesize_frame(cid, nof_prb_field=prb)
        (upsample(frame, factor) if factor > 1 else
         frame.astype(np.complex64)).tofile(tmp_path / name)
    done = subprocess.run(
        ["bash", str(EXAMPLES / "test_torch.sh")], cwd=tmp_path,
        env=dict(os.environ, FRAMES=str(tmp_path), DEVICE="cpu",
                 PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    decode = json.JSONDecoder().raw_decode
    found = [decode(part.lstrip())[0]["cell_id"]
             for part in done.stdout.split("done.")[1:]]
    assert found == [123, 124, 125, 369], done.stdout[-2000:]
