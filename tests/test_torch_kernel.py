"""The matched-filter kernel's contract: on the CPU through its plain
version, and (marked `cuda`) the kernel itself on a card.

The reference here is the definition written out in numpy float64: row j of
lane b is the 256 samples from lo + 128 j as [re | im | re+128 | im+128],
times W, squared per complex column; samples at or past N are zeros.
Tolerance rtol 1e-4 / atol 1e-5 throughout (float32 sums in another order;
the float32 kernel sums three TF32 products, ~1e-6 relative).
"""

import numpy as np
import pytest
import torch

from ltetrigger_tpu_torch.ops import correlate
from ltetrigger_tpu_torch.ops.kernels import matched_filter as mf

TOL = dict(rtol=1e-4, atol=1e-5)
# (label, B, N, lo, m): ragged row counts, unaligned lo and N, reads past N
CASES = [
    ("one_block_row", 1, 400, 0, 1),
    ("window", 2, 9728, 0, 75),
    ("ragged_130_rows", 2, 20000, 128, 130),
    ("lo_and_n_odd", 3, 20001, 3, 77),
    ("lo_mod4_is_2", 1, 30003, 1002, 150),
    ("past_the_end", 2, 10001, 5001, 75),
    ("all_past_the_end", 1, 500, 700, 5),
]


def stream(kind: str, b: int, n: int, seed: int = 0):
    """[b, n] float32 pair: gaussian noise, or a ramp whose value names its
    position (a row read one block off shows)."""
    if kind == "ramp":
        idx = np.arange(b * n, dtype=np.float64).reshape(b, n)
        re = (idx % 977) / 977.0 - 0.5
        im = (idx % 1013) / 1013.0 - 0.5
    else:
        rng = np.random.default_rng(seed)
        re, im = rng.normal(size=(2, b, n))
    return (torch.from_numpy(re.astype(np.float32)),
            torch.from_numpy(im.astype(np.float32)))


def by_definition(re, im, lo: int, m: int, bf16: bool) -> np.ndarray:
    """[B, m, 384] float64 from the definition, row by row."""
    W = correlate.weights_fat("cpu")
    if bf16:
        W = correlate.round_bf16(W)
        re, im = correlate.round_bf16(re), correlate.round_bf16(im)
    W = W.numpy().astype(np.float64)
    re, im = re.numpy().astype(np.float64), im.numpy().astype(np.float64)
    b, n = re.shape
    pad = max(0, lo + 128 * (m + 1) - n)
    re = np.pad(re, ((0, 0), (0, pad)))
    im = np.pad(im, ((0, 0), (0, pad)))
    out = np.empty((b, m, 384))
    for j in range(m):
        a = lo + 128 * j
        x = np.concatenate([re[:, a:a + 128], im[:, a:a + 128],
                            re[:, a + 128:a + 256], im[:, a + 128:a + 256]],
                           axis=1)
        c = x @ W
        out[:, j] = c[:, :384] ** 2 + c[:, 384:] ** 2
    return out


# ------------------------------------------------------------ on the CPU --
@pytest.mark.parametrize("kind", ["noise", "ramp"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_rows_match_definition(case, kind):
    _, b, n, lo, m = case
    re, im = stream(kind, b, n)
    for dt in (torch.float32, torch.bfloat16):
        got = mf.rows_power_plain(re, im, lo, m, dt)
        assert got.shape == (b, m, 384) and got.dtype == torch.float32
        ref = by_definition(re, im, lo, m, dt == torch.bfloat16)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_reads_past_n_are_zeros():
    """A buffer cut short equals the same buffer padded with zeros, bit for
    bit, and rows wholly past N are zero power."""
    re, im = stream("noise", 2, 12000)
    padded = tuple(torch.nn.functional.pad(c, (0, 9000)) for c in (re, im))
    for dt in (torch.float32, torch.bfloat16):
        a = mf.group_power(re, im, 4000, 2, dt)
        b = mf.group_power(*padded, 4000, 2, dt)
        assert torch.equal(a, b)
        assert float(a[:, 1, 10:].abs().max()) == 0.0


def test_entry_points_share_rows():
    """group_power and pss_correlate_power are reshapes of the same rows."""
    re, im = stream("ramp", 2, 9728 + 9600)
    rows = mf.rows_power_plain(re, im, 0, 150, torch.float32)
    grid = mf.group_power(re, im, 0, 2, torch.float32)
    assert torch.equal(grid.reshape(2, 150, 384), rows)
    win = mf.pss_correlate_power((re[:, :9728].contiguous(),
                                  im[:, :9728].contiguous()), torch.float32)
    torch.testing.assert_close(
        win, rows[:, :75].reshape(2, 75, 3, 128).permute(0, 2, 1, 3)
        .reshape(2, 3, 9600), **TOL)
    with pytest.raises(ValueError, match="grid start"):
        mf.group_power(re, im, -1, 1)


def test_split_tf32_is_exact_and_products_hold():
    """hi + lo == x exactly; hi is a TF32 number; the three-product sum the
    float32 kernel computes (operands cut to TF32 as the tensor core reads
    them) stays within rtol 1e-5 of the float32 product, where one TF32
    product does not."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(300, 512)).astype(np.float32))
    w = correlate.weights_fat("cpu")
    x_hi, x_lo = mf.split_tf32(x)
    w_hi, w_lo = mf.split_tf32(w)
    assert torch.equal(x_hi + x_lo, x) and torch.equal(w_hi + w_lo, w)
    assert int((x_hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float((x_lo.abs() / x.abs()).max()) < 2.0 ** -10

    def cut(t):                   # what a TF32 multiplier reads of a float32
        return mf.split_tf32(t)[0]

    ref = x.double() @ w.double()
    scale = float(ref.abs().max())
    three = (cut(x_lo).double() @ w_hi.double()
             + x_hi.double() @ cut(w_lo).double()
             + x_hi.double() @ w_hi.double())
    one = x_hi.double() @ w_hi.double()
    assert float((three - ref).abs().max()) < 1e-5 * scale
    assert float((one - ref).abs().max()) > 1e-4 * scale
    f32 = (x @ w).double()
    torch.testing.assert_close(three, f32, rtol=1e-5, atol=1e-5 * scale)


def test_weights_by_root_layout():
    """Row 256 r + 128 c + m of the kernel's weights is column
    384 c + 128 r + m of W_fat, so a unit's 256 columns are one root's
    re then im."""
    W = correlate.weights_fat("cpu")
    wt = mf.weights_by_root("cpu")
    assert wt.shape == (768, 512) and wt.is_contiguous()
    for r in range(3):
        for c in range(2):
            assert torch.equal(wt[256 * r + 128 * c:256 * r + 128 * c + 128],
                               W[:, 384 * c + 128 * r:][:, :128].T)
    hl = mf._kernel_weights("cpu", False)
    assert hl.shape == (2, 768, 512) and torch.equal(hl[0] + hl[1], wt)
    assert mf._kernel_weights("cpu", True).dtype == torch.bfloat16


# ------------------------------------------------- on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["noise", "ramp"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_rows_match_plain_on_card(cuda_device, case, kind, dtype):
    """The kernel against its plain version on the card, at row counts that
    are no multiple of the 64- or 128-row tile, with lo and N unaligned and
    with reads past N."""
    _, b, n, lo, m = case
    re, im = (c.to(cuda_device) for c in stream(kind, b, n))
    before = mf.launches
    got = mf.rows_power(re, im, lo, m, dtype)
    torch.cuda.synchronize()
    assert mf.launches == before + 1
    ref = mf.rows_power_plain(re, im, lo, m, dtype)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_many_lanes_on_card(cuda_device, dtype):
    """Enough lanes for the 128-row tile (two consumer warpgroups), from an
    offset view of a larger buffer (a base pointer that is not 16-byte
    aligned)."""
    re, im = (c.to(cuda_device) for c in stream("ramp", 40, 2 * 9600 + 131))
    re, im = re[3:39], im[3:39]           # lane 3 starts 3 * 19331 floats in
    assert re.is_contiguous() and re.data_ptr() % 16 != 0
    got = mf.group_power(re, im, 129, 2, dtype)
    ref = mf.group_power_plain(re, im, 129, 2, dtype)
    torch.testing.assert_close(got, ref, **TOL)
