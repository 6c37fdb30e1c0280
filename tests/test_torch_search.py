"""The PyTorch port's main path as a whole: `search` and the CLI give the
JAX package's cells and JSON on the CPU; the package imports no JAX; the
matched-filter wrapper never falls back; and, on a card only (marker
`cuda`), the CUDA kernel agrees with its plain version.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ltetrigger_tpu.apps import cell_search_file as jcli
from ltetrigger_tpu.models import api as japi
from ltetrigger_tpu_torch.apps import cell_search_file as cli
from ltetrigger_tpu_torch.models import api
from ltetrigger_tpu_torch.ops import correlate
from ltetrigger_tpu_torch.ops.kernels import matched_filter
from test_torch_common import frames, noise, upsample

PORT = pathlib.Path(__file__).resolve().parents[1] / "ltetrigger_tpu_torch"
SECONDS = 0.3     # one buffer shape for every case: one JAX compile


def _fields(cells):
    return [{k: v for k, v in c.to_dict().items()
             if k != "tracking_start_time"} for c in cells]


def _capture(case: str) -> tuple[np.ndarray, float]:
    if case == "6prb_1.92M":
        return frames(123, 1, nof_prb_field=6), 1.92e6
    if case == "25prb_7.68M":
        return upsample(frames(124, 1, nof_prb_field=25), 4), 7.68e6
    if case == "ext_cp_2port":
        return frames(301, 1, nof_prb_field=25, normal_cp=False,
                      nof_ports=2), 1.92e6
    return noise(np.random.default_rng(0), 19200), 1.92e6


@pytest.mark.parametrize("case", ["6prb_1.92M", "25prb_7.68M",
                                  "ext_cp_2port", "noise"])
def test_search_matches_jax(case):
    iq, rate = _capture(case)
    ref = japi.search(iq, rate, psr_threshold=4, max_seconds=SECONDS)
    got = api.search(iq, rate, psr_threshold=4, max_seconds=SECONDS,
                     device="cpu")
    assert _fields(got) == _fields(ref)
    assert bool(got) == (case != "noise")


def test_cli_prints_jax_json(tmp_path, capsys):
    iq, _ = _capture("25prb_7.68M")
    path = tmp_path / "capture.c64"
    iq.tofile(path)
    argv = [str(path), "-s", "7.68M", "--repeat", "--time-out",
            str(SECONDS), "--json-only"]
    assert jcli.main(argv) == 0
    ref = json.loads(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.pop("tracking_start_time") >= ref.pop("tracking_start_time")
    assert got == ref and got["status"] == "FOUND"


def test_search_refuses_missing_cuda_and_cfo_probe(monkeypatch):
    """Without a card `search` raises, with and without the integer-CFO
    probe (the probe itself is ported: on the CPU it finds an on-frequency
    cell at bin 0 and changes nothing)."""
    iq, rate = _capture("6prb_1.92M")
    got = api.search(iq, rate, max_seconds=SECONDS, cfo_search_range=2,
                     device="cpu")
    assert _fields(got) == _fields(api.search(iq, rate, max_seconds=SECONDS,
                                              device="cpu")) and got
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.search(iq, rate, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.search(iq, rate, cfo_search_range=2)


def test_kernel_wrapper_never_falls_back():
    """A tensor that is neither on the CPU nor on a card is refused; it is
    never handed to the plain version."""
    x = torch.empty((2, 20000), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        matched_filter.group_power(x, x, 832, 2, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        matched_filter.pss_correlate_power((x, x), torch.float32)


def test_port_imports_no_jax():
    """An AST scan of every file of the port: no jax import and no import
    of the JAX package (the port has its own copies of the numpy-only
    layers, see tests/test_torch_shared.py); then importing the whole port
    in a fresh interpreter leaves jax and ltetrigger_tpu out of
    sys.modules."""
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 18
    assert {"multi.py", "live_monitor.py", "native.py", "wideband.py",
            "channelize.py", "sharded.py", "wideband_scan.py",
            "snr_sweep.py", "run_flowgraph.py"} <= {f.name for f in files}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                assert root not in ("jax", "jaxlib", "ltetrigger_tpu"), \
                    (path, m)
    code = ("import sys\n"
            "import ltetrigger_tpu_torch.apps.cell_search_file as c\n"
            "import ltetrigger_tpu_torch.apps.live_monitor as l\n"
            "import ltetrigger_tpu_torch.models.api as a\n"
            "import ltetrigger_tpu_torch.models.multi as m\n"
            "import ltetrigger_tpu_torch.models.wideband as w\n"
            "import ltetrigger_tpu_torch.parallel as p\n"
            "from ltetrigger_tpu_torch.apps import (run_flowgraph, "
            "snr_sweep, wideband_scan)\n"
            "from ltetrigger_tpu_torch.ltecore import synth, refrx\n"
            "from ltetrigger_tpu_torch.runtime import native\n"
            "a.Trigger(device='cpu').process(synth.synthesize_frame(1))\n"
            "m.MultiTrigger(2, device='cpu').flush()\n"
            "w.WidebandTrigger(7.68e6, [0.0], device='cpu').process_wide("
            "synth.synthesize_frame(1))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ltetrigger_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=PORT.parent, timeout=120)


# ------------------------------------------------- on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    """Both entry points against the plain version on the same card inputs:
    rtol 1e-4 / atol 1e-5 (float32 sums in another order)."""
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, 3, 40000))
         + 1j * rng.normal(size=(2, 3, 40000))).astype(np.complex64)
    re = torch.from_numpy(x.real.copy()).to(cuda_device)
    im = torch.from_numpy(x.imag.copy()).to(cuda_device)
    before = matched_filter.launches
    got = matched_filter.group_power(re, im, 30000, 2, dtype)
    ref = matched_filter.group_power_plain(re, im, 30000, 2, dtype)
    torch.cuda.synchronize()
    assert matched_filter.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    win = (re[0].contiguous(), im[0].contiguous())
    got = matched_filter.pss_correlate_power(win, dtype)
    ref = correlate.pss_correlate_power_v2(win, dtype)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
