"""The PyTorch port's one-shot `search` through frequency-selective
multipath per transmit port (tests/test_fading.py for the JAX package): 1,
2 and 4 ports, noise with 100 Hz Doppler, extended CP.  The same faded
input (from the JAX package's `synthesize_faded_frames`, byte-equal to the
port's copy) goes through both packages' `search`; every Cell field but the
wall-clock stamp must be equal, and the cell must be the transmitted one.
"""

import pytest

from ltetrigger_tpu.ltecore import synth
from ltetrigger_tpu.models import api as japi
from ltetrigger_tpu_torch.ltecore import synth as tsynth
from ltetrigger_tpu_torch.models import api
from test_torch_common import fields

CASES = {
    "1 port": (dict(cell_id=78, n_frames=8, nof_prb_field=50, nof_ports=1,
                    seed=2), 0.5),
    "2 ports": (dict(cell_id=79, n_frames=8, nof_prb_field=50, nof_ports=2,
                     seed=2), 0.5),
    "4 ports": (dict(cell_id=81, n_frames=8, nof_prb_field=50, nof_ports=4,
                     seed=2), 0.5),
    "noise and 100 Hz Doppler": (dict(cell_id=200, n_frames=10,
                                      nof_prb_field=25, nof_ports=2,
                                      snr_db=10.0, doppler_hz=100.0, seed=5),
                                 0.6),
    "extended CP": (dict(cell_id=301, n_frames=8, nof_prb_field=15,
                         nof_ports=1, normal_cp=False, seed=3), 0.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_search_through_fading_equals_jax(case):
    kw, seconds = CASES[case]
    rx = synth.synthesize_faded_frames(**kw)
    assert (tsynth.synthesize_faded_frames(**kw) == rx).all()
    got = api.search(rx, 1.92e6, psr_threshold=4, max_seconds=seconds,
                     device="cpu")
    want = japi.search(rx, 1.92e6, psr_threshold=4, max_seconds=seconds)
    assert got and [fields(c) for c in got] == [fields(c) for c in want]
    cell = got[0]
    assert cell.cell_id == kw["cell_id"]
    assert cell.nof_prb == kw["nof_prb_field"]
    assert cell.nof_tx_ports == kw["nof_ports"]
    assert cell.cp_len == ("Normal" if kw.get("normal_cp", True)
                           else "Extended")
