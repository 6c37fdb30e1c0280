"""Parity of the PyTorch port's ops (ltetrigger_tpu_torch.ops) with the JAX
package's, on the CPU: the same seeded numpy inputs go to both.

Integer and boolean outputs must match exactly.  Float tolerances are
stated per test: the two frameworks sum in different orders (and use
different sin/cos/atan2), so float32 results agree to a few ulps of the
operands' scale, not bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltetrigger_tpu.ltecore import coding, synth
from ltetrigger_tpu.models import trigger as jtrig
from ltetrigger_tpu.ops import cfo as jcfo
from ltetrigger_tpu.ops import correlate as jcorr
from ltetrigger_tpu.ops import cplx as jcplx
from ltetrigger_tpu.ops import dft as jdft
from ltetrigger_tpu.ops import pbch as jpbch
from ltetrigger_tpu.ops import resample as jres
from ltetrigger_tpu.ops import sync as jsync
from ltetrigger_tpu.ops import viterbi as jvit
from ltetrigger_tpu_torch.ops import cfo, correlate, cplx, dft, pbch
from ltetrigger_tpu_torch.ops import resample, sync, viterbi
from ltetrigger_tpu_torch.ops.kernels import matched_filter
from test_torch_common import frames, noise, to_pair_torch


def _np(p):
    return tuple(np.asarray(a) for a in p)


def _t(p):
    return tuple(torch.from_numpy(np.asarray(a)) for a in p)


# ------------------------------------------------------------------ tables --
TABLES = {
    "toeplitz_WL": (lambda: jcorr._toeplitz_weights()[0],
                    lambda: correlate._toeplitz_weights()[0]),
    "toeplitz_WU": (lambda: jcorr._toeplitz_weights()[1],
                    lambda: correlate._toeplitz_weights()[1]),
    "toeplitz_fat": (jcorr._toeplitz_weights_fat,
                     correlate._toeplitz_weights_fat),
    "radix4_OB2": (lambda: jvit._radix4_tables()[0],
                   lambda: viterbi._radix4_tables()[0]),
    "radix4_BITS2": (lambda: jvit._radix4_tables()[1],
                     lambda: viterbi._radix4_tables()[1]),
    "pbch_sel_P_normal": (lambda: jpbch._pbch_sel_mats(True)[0],
                          lambda: pbch._pbch_sel_mats(True)[0]),
    "pbch_sel_K72_ext": (lambda: jpbch._pbch_sel_mats(False)[1],
                         lambda: pbch._pbch_sel_mats(False)[1]),
    "crs_interp_W": (lambda: jpbch._crs_sel_mats()[1],
                     pbch._crs_interp_mats),
    "crc_matrix": (jpbch._crc_matrix, pbch._crc_matrix),
    "crc_masks": (jpbch._crc_masks, pbch._crc_masks),
    "dematch_normal": (lambda: jpbch._dematch_onehot(True),
                       lambda: pbch._dematch_onehot(True)),
    "dematch_ext": (lambda: jpbch._dematch_onehot(False),
                    lambda: pbch._dematch_onehot(False)),
    "gold_1920": (lambda: jpbch._gold_mats(1920)[0],
                  lambda: pbch._gold_mats(1920)[0]),
    "sss_section_banks": (lambda: jsync._section_banks(3),
                          lambda: sync._section_banks(3)),
    "decimate_taps_16": (lambda: jres._taps(16), lambda: resample._taps(16)),
    "rational_taps_24_125": (lambda: jres._rational_taps(24, 125),
                             lambda: resample._rational_taps(24, 125)),
    "dft_sync62": (lambda: jdft.dft_sync62()[1], lambda: dft.dft_sync62()[1]),
    "dft_pbch72": (lambda: jdft.dft_pbch72()[0], lambda: dft.dft_pbch72()[0]),
    "chest_replicas": (lambda: jcfo.chest_replicas()[1],
                       lambda: cfo.chest_replicas()[1]),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_rebuilt_table_byte_identical(name):
    ref, port = (np.asarray(f()) for f in TABLES[name])
    assert ref.dtype == port.dtype and ref.shape == port.shape
    assert ref.tobytes() == port.tobytes()


# -------------------------------------------------------------------- cplx --
def test_cplx_algebra_matches():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 4, 64)).astype(np.float32)
    b = rng.normal(size=(2, 4, 64)).astype(np.float32)
    ja, jb = (jnp.asarray(a[0]), jnp.asarray(a[1])), \
        (jnp.asarray(b[0]), jnp.asarray(b[1]))
    ta, tb = _t(a), _t(b)
    th = rng.uniform(-10, 10, size=(4, 64)).astype(np.float32)
    pairs = [
        (jcplx.mul(ja, jb), cplx.mul(ta, tb)),
        (jcplx.mul_conj(ja, jb), cplx.mul_conj(ta, tb)),
        (jcplx.dot_conj_sum(ja, jb), cplx.dot_conj_sum(ta, tb)),
        (jcplx.expi(jnp.asarray(th)), cplx.expi(torch.from_numpy(th))),
    ]
    for ref, got in pairs:
        for r, g in zip(ref, got):
            # float32 ulps; dot sums 64 products
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cplx.abs2(ta).numpy(),
                               np.asarray(jcplx.abs2(ja)), rtol=1e-6)
    np.testing.assert_allclose(cplx.angle(ta).numpy(),
                               np.asarray(jcplx.angle(ja)), atol=1e-6)


# -------------------------------------------------------------- correlator --
def _stream(n: int, seed: int = 3) -> np.ndarray:
    """[2, n]: two channels of synthetic frames + noise."""
    rng = np.random.default_rng(seed)
    x = np.stack([frames(123, 2, nof_prb_field=6),
                  frames(302, 2, nof_prb_field=50, normal_cp=False)])
    x = x[:, :n]
    return (x + noise(rng, x.size, 0.3).reshape(x.shape)).astype(np.complex64)


@pytest.mark.parametrize("impl", ["v2", "fast"])
def test_group_power_plain_matches_jax(monkeypatch, impl):
    """Pass A's plain version against JAX trig._group_power, f32 ("v2")
    and bf16 inputs ("fast"): rtol 1e-4 / atol 1e-5, the tolerance the
    JAX package holds its own correlator variants to (test_ops.py)."""
    monkeypatch.setenv("LTETRIGGER_CORRELATOR", impl)
    x = _stream(19000)
    lo, g = 700, 2
    # the port reads zeros past the buffer's end; JAX is given the zeros
    need = lo + g * 9600 + 128
    assert need > x.shape[-1]
    xp = np.concatenate([x, np.zeros((2, need - x.shape[-1]),
                                     np.complex64)], -1)
    ref = np.asarray(jtrig._group_power(jcplx.from_numpy(xp), lo, g))
    dt = torch.float32 if impl == "v2" else torch.bfloat16
    got = matched_filter.group_power(*to_pair_torch(x), lo, g, dt)
    assert got.shape == (2, g, 75, 3, 128)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_window_power_matches_v2_and_pallas():
    """Window entry (plain version on the CPU) against the JAX f32 and bf16
    blocked-Toeplitz correlator and against the Pallas kernel in interpret
    mode (as test_ops.py runs it): rtol 1e-4 / atol 1e-5."""
    from jax.experimental.pallas import tpu as pltpu

    from ltetrigger_tpu.ops.pallas import matched_filter as jmf
    x = _stream(jcorr.V2_WINDOW + 50)
    jw = jcplx.from_numpy(x)
    tw = to_pair_torch(x)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jcorr.pss_correlate_power_v2(jw, jdt))
        got = matched_filter.pss_correlate_power(tw, tdt)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jmf.pss_correlate_power_pallas(jw))
    got = matched_filter.pss_correlate_power(tw, torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_peak_and_psr_exact():
    """Peaks exact and PSR bit-equal on identical power, including ties,
    block-boundary peaks, peaks at and near the stream's ends (the
    duplicate-self rise) and plateaus, for the flat and block layouts."""
    rng = np.random.default_rng(17)
    for trial in range(7):
        p = rng.random((2, 3, 9600)).astype(np.float32)
        if trial == 1:
            p[(p > 0.99)] = 1.5
            p[0, 0, 0] = 1.5
            p[0, 0, 9599] = 1.5
        if trial == 2:
            p[0, :, 128 * 40 - 1] = 3.0
            p[1, :, 128 * 40] = 3.0
        if trial == 3:
            p[0, :, 0] = 3.0
            p[1, :, 9599] = 3.0
        if trial == 4:
            p[0, :, 5] = 3.0
            p[1, :, 9597] = 3.0
        if trial == 5:
            p[0, 0, 4000:4200] = 2.0
        if trial == 6:
            p[0, 0, 4000] = 3.0
            p[0, 0, 4063] = 2.9
            p[0, 0, 4064] = 2.95
        blocked = np.ascontiguousarray(
            p.reshape(2, 3, 75, 128).transpose(0, 2, 1, 3))
        rpk, rpsr = jcorr.peak_and_psr_blocked(jnp.asarray(blocked))
        fpk, fpsr = jcorr.peak_and_psr(jnp.asarray(p))
        for got, ref in ((correlate.peak_and_psr_blocked(
                torch.from_numpy(blocked)), (rpk, rpsr)),
                (correlate.peak_and_psr(torch.from_numpy(p)), (fpk, fpsr))):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


# ---------------------------------------------------------------- resample --
@pytest.mark.parametrize("ratio", [4, 16])
def test_decimate_matches(ratio):
    """Strided conv1d against JAX's conv_general_dilated: atol 2e-5 on
    unit-variance input (sums of 16*ratio taps in another order)."""
    rng = np.random.default_rng(ratio)
    x = noise(rng, 64 * ratio * 7 + 3).reshape(1, -1)
    ref = _np(jres.decimate(jcplx.from_numpy(x), ratio))
    got = resample.decimate(to_pair_torch(x), ratio)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, atol=2e-5)


def test_rational_resample_matches():
    """Polyphase 24/125 (10 MHz -> 1.92 MHz): atol 2e-5."""
    rng = np.random.default_rng(5)
    x = noise(rng, 5000)
    ref = _np(jres.rational_resample(jcplx.from_numpy(x), 24, 125))
    got = resample.rational_resample(to_pair_torch(x), 24, 125)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, atol=2e-5)


# ------------------------------------------------------------- dft and cfo --
def test_dft_and_cfo_match():
    """DFT rows (128-term sums: atol 1e-4 on unit-variance input), CFO
    estimate (atol 1e-5 subcarriers) and rotation (atol 1e-5)."""
    rng = np.random.default_rng(9)
    x = noise(rng, 6 * 128).reshape(6, 128)
    jx, tx = jcplx.from_numpy(x), to_pair_torch(x)
    for jf, tf in ((jdft.dft_sync, dft.dft_sync),
                   (jdft.dft_grid, dft.dft_grid)):
        for r, g in zip(_np(jf(jx)), tf(tx)):
            np.testing.assert_allclose(g.numpy(), r, atol=1e-4)

    from ltetrigger_tpu.ltecore import pss as pssmod
    n = np.arange(128)
    rx = np.stack([pssmod.pss_time()[k % 3] * np.exp(
        2j * np.pi * c / 128 * n) for k, c in
        enumerate((-0.9, -0.25, 0.0, 0.4, 0.9, 0.1))]).astype(np.complex64)
    rx = rx + noise(rng, rx.size, 0.05).reshape(rx.shape)
    jr = tuple(jnp.asarray(a)[jnp.arange(6) % 3]
               for a in jcfo.replica_pairs())
    tr = tuple(torch.from_numpy(a)[torch.arange(6) % 3]
               for a in cfo.replica_pairs())
    ref = np.asarray(jcfo.cfo_estimate(jcplx.from_numpy(rx), jr))
    got = cfo.cfo_estimate(to_pair_torch(rx), tr)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    freq = rng.uniform(-0.01, 0.01, size=6).astype(np.float32)
    ref = _np(jcfo.cfo_rotate(jcplx.from_numpy(rx), jnp.asarray(freq), 448))
    got = cfo.cfo_rotate(to_pair_torch(rx), torch.from_numpy(freq), 448)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5)


# -------------------------------------------------------------------- sync --
def test_detect_cp_and_sss_decode_exact():
    """CP and SSS decisions are exact on slot-0 tails of subframe 0 and 5,
    both CPs, several cells, and noise."""
    rng = np.random.default_rng(2)
    segs, nid2 = [], []
    for cell, ncp in ((123, True), (302, False), (451, True), (7, False)):
        f = synth.synthesize_frame(cell, nof_prb_field=25, normal_cp=ncp)
        f = f + noise(rng, f.size, 0.2)
        for start in (0, 9600):                     # subframes 0 and 5
            segs.append(f[start + 448:start + 960])
            nid2.append(cell % 3)
    segs.append(noise(rng, 512))
    nid2.append(1)
    x = np.stack(segs).astype(np.complex64)
    nid2 = np.array(nid2, np.int32)
    jx, tx = jcplx.from_numpy(x), to_pair_torch(x)
    ref_cp = np.asarray(jsync.detect_cp(jx, end=512))
    got_cp = sync.detect_cp(tx, end=512)
    np.testing.assert_array_equal(got_cp.numpy(), ref_cp)
    r1, r5 = jsync.sss_decode(jx, jnp.asarray(nid2), jnp.asarray(ref_cp),
                              end=512)
    g1, g5 = sync.sss_decode(tx, torch.from_numpy(nid2), got_cp, end=512)
    np.testing.assert_array_equal(g1.numpy(), np.asarray(r1))
    np.testing.assert_array_equal(g5.numpy(), np.asarray(r5))
    assert (np.asarray(r1)[:8:2] >= 0).all()


# ----------------------------------------------------------------- viterbi --
def test_viterbi_wa_bits_match_jax_wa_and_tb():
    """Decoded bits equal the JAX wrap-around and exact tail-biting
    decoders' on clean and noisy codewords; metric rtol 1e-5 vs JAX wa."""
    rng = np.random.default_rng(11)
    for sigma in (0.0, 0.6, 1.0):
        bits_in = rng.integers(0, 2, size=(24, 40)).astype(np.uint8)
        llr = np.stack([
            (1.0 - 2.0 * coding.conv_encode(b).astype(np.float64)
             + sigma * rng.normal(size=(3, 40))).T
            for b in bits_in]).astype(np.float32)
        bw, mw = jvit.viterbi_decode_wa(jnp.asarray(llr))
        bt, _ = jvit.viterbi_decode_tb(jnp.asarray(llr))
        bits, metric = viterbi.viterbi_decode_wa(torch.from_numpy(llr))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(bw))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(bt))
        np.testing.assert_allclose(metric.numpy(), np.asarray(mw),
                                   rtol=1e-5)


# -------------------------------------------------------------------- pbch --
@pytest.mark.parametrize("nof_ports,normal_cp,quarter", [
    (1, True, 0), (2, True, 1), (4, True, 3),
    (1, False, 2), (2, False, 0), (4, False, 1),
])
def test_pbch_llrs_and_search_match(nof_ports, normal_cp, quarter):
    """Quarter LLRs (rtol 1e-4, atol 1e-6 of the largest LLR: MRC LLRs are
    sums of terms near that scale, taken in another order, so cancelling
    sums keep an absolute error of a few float32 ulps of it), then the
    codeword search: the decoded MIB fields exact, on both packages' LLRs."""
    cell_id = 451
    sf = synth.synthesize_pbch_subframe(
        cell_id, nof_prb_field=75, quarter=quarter, nof_ports=nof_ports,
        normal_cp=normal_cp).astype(np.complex64)
    slot1 = sf[960:1920]
    ref = np.asarray(jpbch.pbch_quarter_llrs_slot1(
        jcplx.from_numpy(slot1), jnp.int32(cell_id), normal_cp))
    got = pbch.pbch_quarter_llrs_slot1(to_pair_torch(slot1),
                                       torch.tensor(cell_id), normal_cp)
    assert got.shape == (3, 4, 120)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-6 * np.abs(ref).max())

    both = pbch.quarter_llrs_both_cp(to_pair_torch(slot1),
                                     torch.tensor(cell_id))
    np.testing.assert_allclose(both[int(normal_cp)].numpy(), got.numpy())

    q_of = np.arange(12, dtype=np.int32) % 4
    jres_ = jpbch.search_and_unpack(jnp.asarray(ref.reshape(12, 120)),
                                    jnp.asarray(q_of))
    assert bool(jres_["found"]) and int(jres_["quarter"]) == quarter
    batch = torch.from_numpy(np.stack([ref.reshape(12, 120),
                                       got.numpy().reshape(12, 120)]))
    res = pbch.search_and_unpack(batch, torch.from_numpy(np.stack([q_of] *
                                                                  2)))
    for key in ("found", "nof_prb", "nof_ports", "phich_ext", "phich_res",
                "sfn_offset", "quarter"):
        np.testing.assert_array_equal(res[key].numpy(),
                                      [np.asarray(jres_[key])] * 2, key)
    assert int(res["nof_ports"][1]) == nof_ports
