"""The wrap-around Viterbi kernel's module (ops/kernels/viterbi.py): on the
CPU its entry is the plain version; (marked `cuda`) the kernel against the
plain version on a card.  Also the first-use build's library name.

Tolerances: bits exact; the kernel sums each branch metric in symbol order
and the plain version leaves the order to a library matrix product, so on
the card bits may differ only where the plain version's two best final
metrics lie within 1e-4 relative (a near-tie), and the metric within rtol
1e-5.
"""

import pathlib

import numpy as np
import pytest
import torch

from ltetrigger_tpu_torch.ops import pbch, viterbi
from ltetrigger_tpu_torch.ops.kernels import build
from ltetrigger_tpu_torch.ops.kernels import viterbi as vk
from test_torch_common import near_tie
from test_torch_standalone_ops import codewords

SEEDS_SIGMAS = [(0, 0.3), (1, 0.8), (2, 1.5)]


@pytest.mark.parametrize("seed,sigma", SEEDS_SIGMAS)
def test_cpu_entry_is_the_plain_version(seed, sigma):
    """Bit for bit ops/viterbi.viterbi_decode_wa; below sigma 1, where every
    block decodes, the exact decoder's bits (at 1.5 the wrap-around
    decoder, which is not maximum-likelihood, may keep another path on a
    block the exact one decodes)."""
    llr, sent = codewords(seed, 48, sigma)
    x = torch.from_numpy(llr)
    bits, metric = vk.viterbi_decode_wa(x)
    ref_bits, ref_metric = viterbi.viterbi_decode_wa(x)
    assert bits.dtype == torch.int32 and tuple(bits.shape) == (48, 40)
    assert torch.equal(bits, ref_bits) and torch.equal(metric, ref_metric)
    tb_bits, _ = viterbi.viterbi_decode_tb(x)
    decoded = (tb_bits.numpy() == sent).all(axis=1)
    assert decoded.any()
    if sigma < 1.0:
        assert decoded.all()
        np.testing.assert_array_equal(bits.numpy(), tb_bits.numpy())


def test_codeword_search_takes_the_kernels_entry():
    assert pbch.viterbi_decode_wa is vk.viterbi_decode_wa


def test_table_words_pack_the_radix4_tables():
    """Each state's word unpacks to OB2's signs and BITS2's symbols."""
    OB2, BITS2 = viterbi._radix4_tables()
    words = vk.table_words()
    assert len(words) == 64 and all(0 <= w < 2 ** 32 for w in words)
    for ns, w in enumerate(words):
        for j in range(4):
            for c in range(6):
                sign = -1.0 if (w >> (6 * j + c)) & 1 else 1.0
                assert OB2[ns, j, c] == sign
            assert (w >> (24 + 2 * j)) & 3 == BITS2[ns, j]


def test_final_metrics_and_near_tie():
    """final_metrics is the decoder's own trellis: its best state's metric
    / 3 is the returned metric; noisy codewords are no near-tie, an
    all-zero block ties every path."""
    llr, _ = codewords(5, 6, 0.5)
    x = torch.from_numpy(llr)
    m, _ = viterbi.final_metrics(x)
    _, metric = viterbi.viterbi_decode_wa(x)
    assert torch.equal(m.amax(dim=-1) / 3.0, metric)
    assert not near_tie(x).any()
    assert near_tie(torch.zeros((2, 40, 3))).all()


def test_routing_rule():
    with pytest.raises(ValueError, match="CUDA"):
        vk.viterbi_decode_wa_kernel(torch.zeros((2, 40, 3)))


def test_library_name_follows_the_sources(tmp_path):
    """The first-use build names its library by a hash of every source: an
    edited or an added .cu names a new library, so a stale one is never
    loaded."""
    src = pathlib.Path(build.CSRC)
    for f in src.glob("*.cu"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    first = build.library_path(tmp_path)
    assert build.library_path(tmp_path) == first
    assert first.parent == build.BUILD_DIR
    assert build.library_path(src) == first
    (tmp_path / "zz_new.cu").write_text("// a new kernel\n")
    added = build.library_path(tmp_path)
    assert added != first
    (tmp_path / "zz_new.cu").write_text("// a new kernel, edited\n")
    assert build.library_path(tmp_path) not in (first, added)
    assert {p.name for p in src.glob("*.cu")} >= {
        "matched_filter.cu", "pass_b.cu", "viterbi.cu"}


# ------------------------------------------------- on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,sigma", SEEDS_SIGMAS)
@pytest.mark.parametrize("batch", [48, 4096])
def test_kernel_matches_plain_on_card(cuda_device, seed, sigma, batch):
    llr, _ = codewords(seed, batch, sigma)
    x = torch.from_numpy(llr).to(cuda_device)
    bits, metric = vk.viterbi_decode_wa_kernel(x)
    ref_bits, ref_metric = viterbi.viterbi_decode_wa(x)
    torch.cuda.synchronize()
    differ = (bits != ref_bits).any(dim=1)
    assert not (differ & ~near_tie(x)).any(), int(differ.sum())
    torch.testing.assert_close(metric, ref_metric, rtol=1e-5, atol=0)
