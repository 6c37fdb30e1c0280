"""The wrap-around Viterbi kernel's module (ops/kernels/viterbi.py): on the
CPU its entry is the plain version; the kernel's tables and its schedule in
PyTorch against the radix-4 tables, the plain version and the JAX package;
(marked `cuda`) the kernel against the plain version and its schedule on a
card.  Also the first-use build's library name and the launch plan.

Tolerances: bits exact; the kernel sums each branch metric in symbol order
and the plain version leaves the order to a library matrix product, so on
the card bits may differ only where the plain version's two best final
metrics lie within 1e-4 relative (a near-tie), and the metric within rtol
1e-5.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltetrigger_tpu.ops import viterbi as jviterbi
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


def test_lane_words_pack_the_radix4_tables():
    """Each lane's word unpacks, as the kernel unpacks it, to OB2's sign row
    of every (state, j) of its butterfly (one key of the 32 distinct sums
    and one sign), and BITS2 is what the traceback reads off the state
    (bit 4 then bit 5: the two input bits of the step)."""
    OB2, BITS2 = viterbi._radix4_tables()
    words = vk.lane_words()
    assert len(words) == 16 and all(0 <= w < 2 ** 21 for w in words)
    key, sign = vk.branch_keys()
    for ns in range(64):
        for j in range(4):
            k = int(key[ns, j])
            t3 = -1 if k & 1 else 1
            row = sign[ns, j] * np.array(
                [1, -1 if k & 16 else 1, -1 if k & 8 else 1, t3,
                 -t3 if k & 4 else t3, -t3 if k & 2 else t3])
            np.testing.assert_array_equal(row, OB2[ns, j])
            assert BITS2[ns, j] == (((ns >> 4) & 1) << 1) | (ns >> 5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distinct_sums_reassemble_branch_metrics(seed):
    """sign * sums[key] is OB2 @ r: exactly on integer-valued LLRs (any
    order), and on real LLRs exactly the symbol-order sum."""
    OB2, _ = viterbi._radix4_tables()
    key, sign = vk.branch_keys()
    rng = np.random.default_rng(seed)
    for llr in (rng.integers(-9, 10, size=(7, 40, 3)).astype(np.float32),
                rng.normal(size=(7, 40, 3)).astype(np.float32)):
        got = (vk.distinct_sums(torch.from_numpy(llr))[:, :, key]
               * torch.from_numpy(sign)).numpy()                # [7, 20, 64, 4]
        r6 = llr.reshape(7, 20, 6)
        seq = np.zeros_like(got)
        for c in range(6):
            seq = (seq + OB2[None, None, :, :, c]
                   * r6[:, :, None, None, c]).astype(np.float32)
        np.testing.assert_array_equal(got, seq)
        if llr.dtype == np.float32 and (llr == np.round(llr)).all():
            np.testing.assert_array_equal(
                got, np.einsum("njc,btc->btnj", OB2, r6))


@pytest.mark.parametrize("seed,sigma", SEEDS_SIGMAS)
@pytest.mark.parametrize("batch", [48, 512])
def test_schedule_model_matches_jax(seed, sigma, batch):
    """The kernel's schedule in PyTorch (distinct sums, decisions,
    traceback) decodes what the JAX package's viterbi_decode_wa decodes,
    near-ties excepted; metric within rtol 1e-5."""
    llr, _ = codewords(seed + 10, batch, sigma)
    ref_bits, ref_metric = jviterbi.viterbi_decode_wa(jnp.asarray(llr))
    bits, metric = vk.schedule_model(torch.from_numpy(llr))
    differ = (bits.numpy() != np.asarray(ref_bits)).any(axis=1)
    tie = near_tie(torch.from_numpy(llr)).numpy()
    assert not (differ & ~tie).any(), int(differ.sum())
    np.testing.assert_allclose(metric.numpy(), np.asarray(ref_metric),
                               rtol=1e-5)


def test_schedule_model_on_ties():
    """LLRs of -1, 0 and +1 tie paths everywhere: the schedule's
    first-occurrence decisions and traceback still give the plain
    version's bits wherever the final metrics are no near-tie, and the
    same metric."""
    rng = np.random.default_rng(7)
    llr = torch.from_numpy(
        rng.integers(-1, 2, size=(256, 40, 3)).astype(np.float32))
    bits, metric = vk.schedule_model(llr)
    ref_bits, ref_metric = viterbi.viterbi_decode_wa(llr)
    differ = (bits != ref_bits).any(dim=1)
    assert not (differ & ~near_tie(llr)).any()
    assert torch.equal(metric, ref_metric)


@pytest.mark.parametrize("batch,blocks,waves", [
    (1, 1, 1), (48, 6, 1), (4096, 512, 1), (73728, 9216, 10)])
def test_launch_plan(batch, blocks, waves):
    plan = vk.launch_plan(batch)
    assert (plan["blocks"], plan["waves"]) == (blocks, waves)
    assert plan["threads"] == 128 and plan["cluster"] == 1
    assert 2 * vk.WARPS * plan["blocks"] >= batch
    # static shared memory, and 7 blocks a SM in 228 KB (1 KB each kept)
    assert plan["smem_bytes"] == 29696 <= 48 * 1024
    assert 7 * (plan["smem_bytes"] + 1024) <= 228 * 1024


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
    """The first-use build names its library by a hash of every source and
    header: an edited or an added .cu or .cuh names a new library, so a
    stale one is never loaded."""
    src = pathlib.Path(build.CSRC)
    for f in (*src.glob("*.cu"), *src.glob("*.cuh")):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    first = build.library_path(tmp_path)
    assert build.library_path(tmp_path) == first
    assert first.parent == build.BUILD_DIR
    assert build.library_path(src) == first
    (tmp_path / "zz_new.cu").write_text("// a new kernel\n")
    added = build.library_path(tmp_path)
    assert added != first
    (tmp_path / "zz_new.cu").write_text("// a new kernel, edited\n")
    edited = build.library_path(tmp_path)
    assert edited not in (first, added)
    (tmp_path / "tma.cuh").write_text("// a header, edited\n")
    assert build.library_path(tmp_path) not in (first, added, edited)
    assert {p.name for p in src.glob("*.cu*")} >= {
        "matched_filter.cu", "pass_b.cu", "viterbi.cu", "tma.cuh"}


def test_library_name_follows_flags_and_place(tmp_path):
    """A variant build (extra -D flags, another directory) gets a library
    of its own: the flags name it, `out_dir` holds it, and the port's own
    library keeps its name."""
    own = build.library_path()
    assert build.library_path(build.CSRC, build.BUILD_DIR, ()) == own
    stamped = build.library_path(out_dir=tmp_path,
                                 extra_flags=("-DPB_STAMPS",))
    assert stamped.parent == tmp_path and stamped.name != own.name
    assert build.library_path(out_dir=tmp_path).name == own.name
    assert build.library_path(extra_flags=("-DPB_STAMPS",)) \
        == build.BUILD_DIR / stamped.name
    assert build.library_path(extra_flags=("-DA", "-DB")) \
        != build.library_path(extra_flags=("-DB", "-DA"))


# ------------------------------------------------- on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,sigma", SEEDS_SIGMAS)
@pytest.mark.parametrize("batch", [48, 4096, 73728])
def test_kernel_matches_plain_on_card(cuda_device, seed, sigma, batch):
    """Bits equal the plain version's except near-ties, metric rtol 1e-5;
    bits equal the kernel's schedule in PyTorch on every codeword."""
    llr, _ = codewords(seed, batch, sigma)
    x = torch.from_numpy(llr).to(cuda_device)
    bits, metric = vk.viterbi_decode_wa_kernel(x)
    ref_bits, ref_metric = viterbi.viterbi_decode_wa(x)
    model_bits, _ = vk.schedule_model(x)
    torch.cuda.synchronize()
    differ = (bits != ref_bits).any(dim=1)
    assert not (differ & ~near_tie(x)).any(), int(differ.sum())
    torch.testing.assert_close(metric, ref_metric, rtol=1e-5, atol=0)
    assert torch.equal(bits, model_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [48, 4096])
def test_kernel_on_ties_on_card(cuda_device, batch):
    """LLRs of -1, 0 and +1 (ties everywhere): the kernel's first-occurrence
    decisions and traceback equal its schedule in PyTorch bit for bit, and
    the plain version's bits wherever the final metrics are no near-tie."""
    rng = np.random.default_rng(batch)
    x = torch.from_numpy(rng.integers(-1, 2, size=(batch, 40, 3))
                         .astype(np.float32)).to(cuda_device)
    bits, metric = vk.viterbi_decode_wa_kernel(x)
    model_bits, model_metric = vk.schedule_model(x)
    ref_bits, _ = viterbi.viterbi_decode_wa(x)
    torch.cuda.synchronize()
    assert torch.equal(bits, model_bits)
    torch.testing.assert_close(metric, model_metric, rtol=1e-5, atol=0)
    differ = (bits != ref_bits).any(dim=1)
    assert not (differ & ~near_tie(x)).any(), int(differ.sum())


@pytest.mark.cuda
def test_kernel_info_on_card(cuda_device):
    """The card holds the launch plan's blocks a SM."""
    info = vk.kernel_info()
    assert info["blocks_per_sm"] >= vk.BLOCKS_PER_SM, info
    assert info["smem_bytes"] == vk.launch_plan(1)["smem_bytes"], info
