"""The generator: planted TTIs equal to the frozen synthesiser's frames, draws
that repeat from a seed and differ across seeds, and the roofline counts."""

import numpy as np
import pytest
import torch

from ltebench import roofline
from ltebench.gen import cells, traffic
from ltebench.gen.ltecore import synth

MIX = traffic.load("traffic", "cells_cfo1k5")


@pytest.mark.parametrize("cell_id,prb,ports,sfn0", [
    (0, 6, 1, 0), (257, 25, 2, 240), (503, 100, 4, 12), (131, 50, 4, 252)])
def test_tti_is_the_synthesisers_four_frames(cell_id, prb, ports, sfn0):
    got = cells.tti(cell_id, prb, ports, sfn0)
    want = np.concatenate([synth.synthesize_frame(
        cell_id, prb, sfn=sfn0 + q, quarter=q, nof_ports=ports)
        for q in range(4)])
    assert got.dtype == np.complex64 and got.shape == (cells.TTI_LENGTH,)
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_draws_repeat_from_a_seed_and_differ_across_seeds():
    a = traffic.draw_cells(MIX, traffic.rng_for(2 ** 40 + 3), 16)
    b = traffic.draw_cells(MIX, traffic.rng_for(2 ** 40 + 3), 16)
    c = traffic.draw_cells(MIX, traffic.rng_for(2 ** 40 + 4), 16)
    assert a == b and a != c
    for cell in a:
        assert 0 <= cell["cell_id"] <= 503 and cell["prb"] in MIX["prb"]
        assert cell["ports"] in MIX["ports"] and cell["sfn0"] % 4 == 0
        assert MIX["snr_db"][0] <= cell["snr_db"] <= MIX["snr_db"][1]
        assert MIX["cfo_hz"][0] <= cell["cfo_hz"] <= MIX["cfo_hz"][1]
        assert 0 <= cell["start"] < cells.TTI_LENGTH


def test_captures_repeat_from_a_seed_and_differ_across_seeds():
    dev = torch.device("cpu")
    draw = traffic.draw_cells(MIX, traffic.rng_for(9), 2)
    n = 2 * 9600
    a = traffic.capture_batch(draw, n, 2 ** 35 + 1, dev)
    b = traffic.capture_batch(draw, n, 2 ** 35 + 1, dev)
    c = traffic.capture_batch(draw, n, 2 ** 35 + 2, dev)
    assert a[0].shape == (2, cells.LOOKBACK + n + cells.WINDOW)
    for x, y in zip(a, b):          # on a mismatch: where, and how far
        off = (x != y).nonzero()
        assert off.shape[0] == 0, (off.shape[0], off[:4].tolist(),
                                   (x - y).abs().max().item())
    assert not torch.equal(a[0], c[0])
    assert not a[0][:, :cells.LOOKBACK].any()
    assert not a[1][:, -cells.WINDOW:].any()


def test_noise_power_follows_the_drawn_snr():
    dev = torch.device("cpu")
    cell = dict(traffic.draw_cells(MIX, traffic.rng_for(1), 1)[0],
                cell_id=-1, snr_db=-3.0)
    x = traffic.signals([cell], 200000, 5, dev)
    assert abs(x.abs().square().mean().item() - 10 ** 0.3) < 0.05


def test_pass_a_roofline_counts_the_shapes():
    t, what = roofline.pass_a(128, 100)
    starts = 128 * 100 * 9600 * 3
    nbytes = 128 * (100 * 9600 + 128) * 8 + starts * 4
    ops = starts * (8 * 128 + 3)
    assert what == "bytes"
    assert t == pytest.approx(max(nbytes / roofline.PEAK_BYTES,
                                  ops / roofline.PEAK_BF16))
    t2, _ = roofline.pass_a(256, 100)
    assert t2 == pytest.approx(2 * t, rel=1e-3)
    _, what32 = roofline.pass_a(1, 1, bf16=False)
    assert what32 == "operations"


def test_copied_bounds_keep_their_arithmetic():
    t, what = roofline.pass_b_bound(384, 25, 8576)
    nbytes = 4 * 8576 * 9600 + 2 * 4 * 384 * 3 * 9800 + 19 * 25 * 384 * 3
    assert what == "bytes"
    assert t == pytest.approx(nbytes / roofline.PEAK_BYTES)
    t, what = roofline.viterbi_bound(73728, 44)
    assert what == "operations"
    assert t == pytest.approx(73728 * (60 * (44 + 256 + 192) + 64)
                              / roofline.PEAK_F32_OP)


def test_a_pss_on_the_grid_edge_is_seen_by_neither_side():
    """A cell whose PSS peak falls on the last candidate of a half-frame step
    (start 833: peak at 9599) reads a ratio of ~2.45 in the reference and is
    never published by the program; the check does not count it as due.
    The same cell 16 samples later is tracked and published."""
    from ltebench.gen.cells import LOOKBACK
    from ltebench.reference import check, passab
    from ltetrigger_tpu_torch.models import trigger as trig
    from ltetrigger_tpu_torch.parallel.sharded import channel_scan
    cell = dict(cell_id=35, prb=100, ports=1, normal_cp=True, sfn0=0,
                snr_db=20.0, cfo_hz=0.0, start=833)
    cells_ = [cell, dict(cell, start=833 - 16)]
    re, im = traffic.capture_batch(cells_, 24 * 9600, 3,
                                   torch.device("cpu"))
    pw = passab.correlation_power(re, im, LOOKBACK, 24, "bfloat16")
    ref = passab.pass_b(lambda t: pw[:, t], 24, (2,), pw.device, 4.0, 16, 8)
    assert check.due_cells(cells_, ref["tracking"]) == [False, True]
    assert ref["psr"][:, 0, 2].max() < 3.0 < ref["psr"][:, 1, 2].min()
    _, out = channel_scan((re, im), 24, 4.0, device="cpu")
    host = trig.unpack_output(trig.pack_output(out))
    assert not host.track_event[:, 0].any() and host.track_event[:, 1].any()
