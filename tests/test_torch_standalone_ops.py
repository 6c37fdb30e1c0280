"""The PyTorch port's standalone op entry points (the ones the engine does
not call but the package offers) against their JAX counterparts, on seeded
numpy inputs on the CPU.

Tolerances: MIB fields, Viterbi bits and peak positions exact; LLRs and the
TTI accumulator rtol 1e-4 with atol 1e-4 of the largest value (float32 sums
in another order); correlation power rtol 1e-4 / atol 1e-5 of the peak;
`cfo_correct` rtol 1e-5 / atol 1e-5 (elementwise products), `pss_chest` rtol
1e-5 / atol 1e-4 (128-term DFT sums, as tests/test_torch_ops.py holds the
DFT); bf16 against f32 PSR rtol 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltetrigger_tpu.ops import cfo as jcfo
from ltetrigger_tpu.ops import correlate as jcorrelate
from ltetrigger_tpu.ops import pbch as jpbch
from ltetrigger_tpu.ops import viterbi as jviterbi
from ltetrigger_tpu_torch.ltecore import coding, synth
from ltetrigger_tpu_torch.ops import cfo, correlate, pbch, viterbi
from ltetrigger_tpu_torch.ops.kernels import matched_filter
from test_torch_common import noise, to_pair_torch

MIB_KEYS = ("found", "nof_prb", "nof_ports", "phich_ext", "phich_res",
            "sfn_offset", "quarter")


def to_pair_jax(x):
    return (jnp.asarray(np.ascontiguousarray(x.real, np.float32)),
            jnp.asarray(np.ascontiguousarray(x.imag, np.float32)))


def subframe(cell_id, prb, ports=1, normal_cp=True, quarter=0, seed=0):
    """Subframe 0 of one synthetic frame plus a little seeded noise."""
    f = synth.synthesize_frame(cell_id, nof_prb_field=prb, nof_ports=ports,
                               normal_cp=normal_cp, sfn=8 * quarter,
                               quarter=quarter)[:1920]
    return (f + noise(np.random.default_rng(seed), 1920, 0.02)) \
        .astype(np.complex64)


def close_to_scale(got, want, rtol=1e-4, rel_atol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rel_atol * np.abs(want).max())


# -------------------------------------------------------------------- pbch --
jmib_decode = jax.jit(jpbch.mib_decode)
jmib_combine = jax.jit(jpbch.mib_combine_decode)

MIB_CASES = [(123, 6, 1, True), (124, 25, 2, True), (125, 50, 4, True),
             (369, 100, 1, True), (77, 25, 2, False)]


@pytest.mark.parametrize("cell_id,prb,ports,normal_cp", MIB_CASES)
def test_mib_decode_fields_equal_jax(cell_id, prb, ports, normal_cp):
    x = subframe(cell_id, prb, ports, normal_cp, seed=cell_id)
    ref = jmib_decode(to_pair_jax(x), jnp.int32(cell_id),
                      jnp.asarray(normal_cp))
    got = pbch.mib_decode(to_pair_torch(x), cell_id, normal_cp)
    assert got.keys() == ref.keys()
    for k in MIB_KEYS:
        assert got[k].item() == np.asarray(ref[k]).item(), k
    assert (got["found"].item(), got["nof_prb"].item(),
            got["nof_ports"].item()) == (True, prb, ports)
    np.testing.assert_allclose(got["metric"].item(), float(ref["metric"]),
                               rtol=1e-4)
    # the wrong CP hypothesis must not decode
    assert not pbch.mib_decode(to_pair_torch(x), cell_id,
                               not normal_cp)["found"].item()


@pytest.mark.parametrize("normal_cp", [True, False])
def test_pbch_quarter_llrs_equal_jax(normal_cp):
    x = subframe(200, 50, 2, normal_cp, seed=5)
    ref = jpbch.pbch_quarter_llrs(to_pair_jax(x), jnp.int32(200), normal_cp)
    got = pbch.pbch_quarter_llrs(to_pair_torch(x), 200, normal_cp)
    assert tuple(got.shape) == (3, 4, 120)
    close_to_scale(got.numpy(), ref)
    # batched over leading dims, with a cell id per row
    two = np.stack([x, subframe(201, 50, 2, normal_cp, seed=6)])
    got2 = pbch.pbch_quarter_llrs(to_pair_torch(two), torch.tensor([200, 201]),
                                  normal_cp)
    assert tuple(got2.shape) == (2, 3, 4, 120)
    close_to_scale(got2[0].numpy(), ref)


def test_mib_combine_first_attempt_is_mib_decode():
    """From an empty accumulator, attempt 0 is the stateless decode; the
    accumulator and the second attempt (the next frame, quarter 1) equal
    the JAX function's."""
    x0 = subframe(300, 25, quarter=0, seed=7)
    x1 = subframe(300, 25, quarter=1, seed=8)
    acc, res = pbch.mib_combine_decode(to_pair_torch(x0), 300, True,
                                       torch.zeros(12, 120), 0)
    plain = pbch.mib_decode(to_pair_torch(x0), 300, True)
    for k in MIB_KEYS:
        assert res[k].item() == plain[k].item(), k
    jacc, jres = jmib_combine(to_pair_jax(x0), jnp.int32(300),
                              jnp.asarray(True), jnp.zeros((12, 120)),
                              jnp.int32(0))
    assert tuple(acc.shape) == (12, 120)
    close_to_scale(acc.numpy(), jacc)
    acc2, res2 = pbch.mib_combine_decode(to_pair_torch(x1), 300, True, acc,
                                         torch.tensor(1))
    jacc2, jres2 = jmib_combine(to_pair_jax(x1), jnp.int32(300),
                                jnp.asarray(True), jacc, jnp.int32(1))
    close_to_scale(acc2.numpy(), jacc2)
    for k in MIB_KEYS:
        assert res2[k].item() == np.asarray(jres2[k]).item(), k
        assert res[k].item() == np.asarray(jres[k]).item(), k
    assert res2["found"].item() and res2["sfn_offset"].item() == 0


def test_mib_combine_adds_sensitivity():
    """PBCH 12 dB under a noise floor that one subframe cannot decode
    through: four attempts of one TTI combined can (and the JAX function
    agrees attempt by attempt)."""
    rng = np.random.default_rng(9)
    acc, jacc = torch.zeros(12, 120), jnp.zeros((12, 120))
    found = []
    for q in range(4):
        x = synth.synthesize_frame(410, nof_prb_field=50, sfn=0,
                                   quarter=q)[:1920]
        x = (x + noise(rng, 1920, 1.1)).astype(np.complex64)
        single = pbch.mib_decode(to_pair_torch(x), 410, True)
        acc, res = pbch.mib_combine_decode(to_pair_torch(x), 410, True, acc, q)
        jacc, jres = jmib_combine(to_pair_jax(x), jnp.int32(410),
                                  jnp.asarray(True), jacc, jnp.int32(q))
        assert res["found"].item() == bool(jres["found"])
        found.append((single["found"].item(), res["found"].item()))
    close_to_scale(acc.numpy(), jacc)
    assert found[-1][1], found
    assert all(c or not s for s, c in found), found   # never loses a decode


# ----------------------------------------------------------------- viterbi --
def codewords(seed, batch, sigma):
    """LLRs [batch, 40, 3] of random 40-bit tail-biting codewords (+1
    favours bit 0) plus noise, and the bits."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(batch, 40)).astype(np.uint8)
    coded = np.stack([coding.conv_encode(b) for b in bits])     # [B, 120]
    llr = (1.0 - 2.0 * coded.reshape(batch, 3, 40).transpose(0, 2, 1)) \
        + sigma * rng.normal(size=(batch, 40, 3))
    return llr.astype(np.float32), bits


@pytest.mark.parametrize("seed,sigma", [(0, 0.3), (1, 0.8), (2, 1.5)])
def test_viterbi_tb_bits_equal_jax(seed, sigma):
    """Bit for bit the JAX package's exact decoder, noisy blocks included
    (where it no longer returns what was sent)."""
    llr, bits = codewords(seed, 6, sigma)
    ref_bits, ref_metric = jviterbi.viterbi_decode_tb(jnp.asarray(llr))
    got_bits, got_metric = viterbi.viterbi_decode_tb(torch.from_numpy(llr))
    assert got_bits.dtype == torch.int32 and tuple(got_bits.shape) == (6, 40)
    np.testing.assert_array_equal(got_bits.numpy(), np.asarray(ref_bits))
    np.testing.assert_allclose(got_metric.numpy(), np.asarray(ref_metric),
                               rtol=1e-5)
    if sigma < 1.0:
        np.testing.assert_array_equal(got_bits.numpy(), bits)


@pytest.mark.parametrize("seed", [3, 4])
def test_viterbi_wa_against_the_ports_own_golden(seed):
    """`viterbi_decode_wa` (what the engine runs) against the exact
    decoder: the same bits wherever the block is decodable, and a metric
    that never beats the maximum-likelihood one by more than rounding."""
    llr, bits = codewords(seed, 16, 0.7)
    tb_bits, tb_metric = viterbi.viterbi_decode_tb(torch.from_numpy(llr))
    wa_bits, wa_metric = viterbi.viterbi_decode_wa(torch.from_numpy(llr))
    np.testing.assert_array_equal(tb_bits.numpy(), bits)
    np.testing.assert_array_equal(wa_bits.numpy(), tb_bits.numpy())
    # the wrap-around metric is the 120-step path metric / 3
    np.testing.assert_allclose(wa_metric.numpy(), tb_metric.numpy(),
                               rtol=0.05)


# --------------------------------------------------------------- correlate --
@pytest.fixture(scope="module")
def windows():
    """[4, 9728] complex64: three cells (one per root) at three offsets and
    SNRs, and a noise row."""
    rng = np.random.default_rng(10)
    rows = []
    for cell, shift, sigma in ((123, 0, 0.05), (124, 3000, 0.3),
                               (125, 7777, 1.0), (None, 0, 1.0)):
        x = noise(rng, 9728, sigma)
        if cell is not None:
            f = synth.synthesize_frame(cell, nof_prb_field=25)
            x = x + np.roll(np.concatenate([f, f]), shift)[:9728]
        rows.append(x.astype(np.complex64))
    return np.stack(rows)


def test_conv_form_cross_checks_the_kernels_plain_version(windows):
    """The conv form shares nothing with the blocked-Toeplitz weights: it
    equals the JAX conv form, the kernel's plain version (window entry) and
    the grid entry's plain version at the same positions."""
    pair = to_pair_torch(windows)
    got = correlate.pss_correlate_power(pair)
    assert tuple(got.shape) == (4, 3, 9600)
    scale = float(got.max())
    ref = jcorrelate.pss_correlate_power(to_pair_jax(windows))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5 * scale)
    plain = correlate.pss_correlate_power_v2(pair, torch.float32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-5 * scale)
    grid = matched_filter.group_power_plain(*pair, 0, 1, torch.float32)
    np.testing.assert_allclose(
        got.numpy(), grid[:, 0].permute(0, 2, 1, 3).reshape(4, 3, 9600)
        .numpy(), rtol=1e-4, atol=1e-5 * scale)
    # leading dims ride along
    one = correlate.pss_correlate_power((pair[0][1], pair[1][1]))
    np.testing.assert_allclose(one.numpy(), got[1].numpy(), rtol=1e-4,
                               atol=1e-5 * scale)


def test_fast_keeps_every_f32_peak(windows):
    pair = to_pair_torch(windows)
    f32 = correlate.pss_correlate_power(pair)
    fast = correlate.pss_correlate_power_fast(pair)
    ref = jcorrelate.pss_correlate_power_fast(to_pair_jax(windows))
    np.testing.assert_allclose(fast.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5 * float(f32.max()))
    pk32, psr32 = correlate.peak_and_psr(f32)
    pk16, psr16 = correlate.peak_and_psr(fast)
    hit = psr32 > 4.0
    assert hit.sum().item() == 3 and hit[3].sum().item() == 0
    assert torch.equal(pk32[hit], pk16[hit])
    np.testing.assert_allclose(psr16[hit].numpy(), psr32[hit].numpy(),
                               rtol=5e-3)
    # any leading shape, through the same wrapper
    deep = correlate.pss_correlate_power_fast(
        tuple(c.reshape(2, 2, -1) for c in pair))
    np.testing.assert_array_equal(deep.reshape(4, 3, 9600).numpy(),
                                  fast.numpy())


def test_default_power_reads_the_switch_as_jax_does(windows):
    assert correlate._IMPLS.keys() == jcorrelate._IMPLS.keys()
    assert correlate.default_power is correlate._IMPLS["fast"]
    assert correlate.WINDOW_LEN == jcorrelate.WINDOW_LEN == 9727
    np.testing.assert_array_equal(correlate._kernel(), jcorrelate._kernel())
    pair = to_pair_torch(windows[:1])
    v2 = correlate._IMPLS["v2"](pair)
    np.testing.assert_allclose(
        v2.numpy(), correlate._IMPLS["v1"](pair).numpy(), rtol=1e-4,
        atol=1e-5 * float(v2.max()))


# --------------------------------------------------------------------- cfo --
@pytest.mark.parametrize("freq", [0.0013, np.array([-0.002, 0.0005])])
def test_cfo_correct_equals_jax(freq):
    rng = np.random.default_rng(11)
    lead = np.shape(freq)
    x = noise(rng, int(np.prod(lead + (1920,))), 1.0).reshape(lead + (1920,))
    ref = jcfo.cfo_correct(to_pair_jax(x), jnp.asarray(freq, jnp.float32))
    got = cfo.cfo_correct(to_pair_torch(x),
                          freq if not lead else torch.from_numpy(
                              freq.astype(np.float32)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("n_id_2", [0, 1, 2])
def test_pss_chest_equals_jax(n_id_2):
    frame = synth.synthesize_frame(3 * 40 + n_id_2, nof_prb_field=25)
    sym = (frame[832:960] + noise(np.random.default_rng(12), 128, 0.05)) \
        .astype(np.complex64)
    ref = jcfo.pss_chest(to_pair_jax(sym), n_id_2)
    got = cfo.pss_chest(to_pair_torch(sym), n_id_2)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (62,)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4)
    # a clean PSS of the right root over a flat channel: a flat estimate
    flat = got[0].numpy() + 1j * got[1].numpy()
    assert np.abs(flat).std() < 0.1 * np.abs(flat).mean()
    # a root per row
    rows = cfo.pss_chest(tuple(c.expand(3, 128) for c in to_pair_torch(sym)),
                         torch.arange(3))
    np.testing.assert_allclose(rows[0][n_id_2].numpy(), got[0].numpy(),
                               rtol=1e-6, atol=1e-6)
