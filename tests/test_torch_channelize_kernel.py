"""The channelizer's kernel (ops/kernels/channelize.py, csrc/channelize.cu):
the kernel's order of work in PyTorch (`channelize_model`: taps modulated
from the ramp table, the polyphase sum, the rotation at the narrow rate)
against the plain chunk loop and the JAX package's `channelize`, at ratios
1, 2, 4 and 16 and 1, 3 and 17 centres, with output counts that are no
multiple of a chunk or a tile; a streaming segment with real context and
phase origins past 2^29 against a float64 reference; the modulated taps
against taps made from float64 offsets; the CPU path is the plain loop;
the launch plan; a numpy capture's upload to the padded pair through the
ring of slabs (`upload_padded`, on the CPU here) against `cplx.from_numpy`
and a pad, bit for bit; (marked `cuda`) the kernel against the plain
version at the band's 170 centres, one launch a call, and what the wrapper
refuses; the upload through pinned slabs against the old upload feeding
the same kernel, bit for bit, over back-to-back captures, its counters,
and no pageable copy inside `channelize`.

Tolerances: CHAN_TOL (rtol 1e-4, atol 1e-5 on a unit-rms band), the
channelizer's tolerance in test_torch_wideband: the model sums the filter
in another order than the convolution and rotates once at the narrow rate
instead of once a wide sample, each within ~1e-6 of the exact lane.  Taps:
1e-6 (f32 mod-1 phases against float64 ones).  On the card the kernel
against the plain version: CHAN_TOL, and a relative error of the lanes'
norm at most 1e-5 (the benchmark's `chan_rel_err` reads ~1.8e-6).
"""

import collections
import math

import numpy as np
import pytest
import torch

from ltetrigger_tpu_torch.ops import channelize as chan
from ltetrigger_tpu_torch.ops import cplx, resample
from ltetrigger_tpu_torch.ops.kernels import channelize as kc

CHAN_TOL = dict(rtol=1e-4, atol=1e-5)
BLOCK = kc.BLOCK


@pytest.fixture(autouse=True)
def own_counts(monkeypatch):
    """Each test counts into a Counter of its own: a key it adds
    ("upload_slabs") must not reach other files' tests in the process."""
    monkeypatch.setattr(chan, "counts", collections.Counter())


def unit_noise(rng, n: int) -> np.ndarray:
    return ((rng.normal(size=n) + 1j * rng.normal(size=n))
            / math.sqrt(2)).astype(np.complex64)


def pair(x: np.ndarray, device="cpu"):
    return (torch.from_numpy(np.ascontiguousarray(x.real)).to(device),
            torch.from_numpy(np.ascontiguousarray(x.imag)).to(device))


def offsets(c: int, rate: float) -> np.ndarray:
    """c centres across +-0.45 of the band, off any simple fraction."""
    return (np.linspace(-0.45, 0.45, c) + 1.234567e-3) * rate


def segment(x: np.ndarray, offs_norm: np.ndarray, start: int = -BLOCK,
            device="cpu"):
    """What `channelize` hands `_channelize_scan` for a capture x padded by
    a block of zeros a side, or, with `start`, a segment of a longer stream
    whose first sample has the wide index `start`: (xpad, origins,
    ramps)."""
    xpad = pair(x, device)
    # normalised offsets are centres in Hz at a rate of 1 Hz
    origins = chan._phase_tables(offs_norm, 1.0, start,
                                 -(-x.size // BLOCK))
    return (xpad, torch.from_numpy(origins).to(device),
            torch.from_numpy(chan._ramp_table(offs_norm)).to(device))


def padded(x: np.ndarray) -> np.ndarray:
    return np.pad(x, (BLOCK, BLOCK))


def assert_lanes(got, want, tol=CHAN_TOL):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g.cpu(), w.cpu(), **tol)


def rel_err(got, want) -> float:
    num = sum(float(((g.double() - w.double()) ** 2).sum())
              for g, w in zip(got, want))
    den = sum(float((w.double() ** 2).sum()) for w in want)
    return math.sqrt(num / den)


# ------------------------------------------------- the model on the CPU --
@pytest.mark.parametrize("ratio", [1, 2, 4, 16])
@pytest.mark.parametrize("centres", [1, 3, 17])
def test_model_equals_the_plain_loop_and_the_jax_package(ratio, centres):
    """Two chunks of the plain loop, the second short: n_out = one chunk's
    outputs + 1111, no multiple of a chunk or of a tile, and a capture
    that is no multiple of the ratio."""
    from ltetrigger_tpu.ops import channelize as jchan

    rate = 1.92e6 * ratio
    n_out = kc.CHUNK_BLOCKS * BLOCK // ratio + 1111
    n = n_out * ratio + ratio - 1
    x = unit_noise(np.random.default_rng(ratio * 100 + centres), n)
    offs = offsets(centres, rate)
    xpad, origins, ramps = segment(padded(x), offs / rate)
    model = kc.channelize_model(xpad, origins, ramps, ratio, n_out)
    plain = chan.channelize(x, rate, offs, device="cpu")
    assert plain[0].shape == (centres, n_out)
    assert_lanes(model, plain)
    ref = jchan.channelize(x, rate, offs)
    assert_lanes(model, tuple(torch.from_numpy(np.array(r)) for r in ref))


def float64_lanes(x: np.ndarray, offs_norm: np.ndarray, start: int,
                  ratio: int, n_out: int) -> tuple:
    """The exact lanes of a segment x whose first sample has the wide index
    `start`: each centre mixed with a float64 phase, filtered with the
    decimator's taps in float64 and taken at x index BLOCK + n ratio."""
    h = resample._taps(ratio).astype(np.float64)
    i = np.arange(x.size, dtype=np.float64) + start
    out = []
    for f in offs_norm:
        mixed = x.astype(np.complex128) * np.exp(
            2j * np.pi * np.mod(-f * i, 1.0))
        full = np.convolve(np.pad(mixed, (8 * ratio, 8 * ratio)), h[::-1],
                           mode="valid")
        out.append(full[BLOCK + ratio * np.arange(n_out)])
    y = np.stack(out)
    return (torch.from_numpy(y.real), torch.from_numpy(y.imag))


def test_a_streaming_segment_with_real_context_past_2_29():
    """As the streaming front end feeds it: context blocks of real samples,
    origins at an absolute wide index past 2^29, a segment that is no
    multiple of a block; the model and the plain loop against the float64
    lanes."""
    ratio, n_out = 8, 5 * 1200 + 37
    x = unit_noise(np.random.default_rng(29), n_out * ratio + 2 * BLOCK)
    offs_norm = offsets(5, 1.0) * 0.9
    start = 2 ** 29 + 123457
    xpad, origins, ramps = segment(x, offs_norm, start=start)
    want = float64_lanes(x, offs_norm, start, ratio, n_out)
    model = kc.channelize_model(xpad, origins, ramps, ratio, n_out)
    plain = chan._channelize_scan(xpad, origins, ramps, ratio, n_out)
    for got in (model, plain):
        assert_lanes(tuple(g.double() for g in got), want)
    assert rel_err(model, want) < 2e-6


@pytest.mark.parametrize("ratio", [2, 4, 16])
def test_taps_from_the_ramp_table_equal_float64_taps(ratio):
    offs_norm = np.concatenate([offsets(9, 1.0), [0.0, -0.5 + 1e-7, 1 / 3]])
    g = kc.modulated_taps(torch.from_numpy(chan._ramp_table(offs_norm)),
                          ratio)
    h = resample._taps(ratio).astype(np.float64)
    d = np.arange(h.size) - 8 * ratio
    g64 = h[None] * np.exp(-2j * np.pi * offs_norm[:, None] * d[None])
    assert g[0].shape == (offs_norm.size, 16 * ratio)
    np.testing.assert_allclose(g[0].numpy(), g64.real, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g[1].numpy(), g64.imag, rtol=0, atol=1e-6)


def test_the_cpu_runs_the_plain_loop_and_counts_its_chunks():
    ratio, centres = 16, 3
    n_out = 2 * kc.CHUNK_BLOCKS * BLOCK // ratio + 5
    x = unit_noise(np.random.default_rng(5), n_out * ratio)
    xpad, origins, ramps = segment(padded(x), offsets(centres, 1.0))
    chunks, launches = chan.counts["chunks"], kc.launches
    got = chan._channelize_scan(xpad, origins, ramps, ratio, n_out)
    want = kc.channelize_plain(xpad, origins, ramps, ratio, n_out)
    assert chan.counts["chunks"] - chunks == 3 == kc.n_chunks(n_out, ratio)
    assert kc.launches == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA"):
        kc.channelize_kernel(xpad, origins, ramps, ratio, n_out)


def test_the_ratios_the_kernel_takes():
    got = kc.RATIOS
    for r in (1, 2, 4, 8, 12, 16, 32, 960):
        assert r in got
    for r in (3 * 7, 1200, 9600, 7):
        assert r not in got
    assert all(BLOCK % r == 0 and 8 * r < BLOCK for r in got)
    assert [kc.phases_per_piece(r) for r in (1, 2, 12, 16, 24, 32, 960)] \
        == [1, 2, 12, 16, 12, 16, 16]


def test_launch_plan():
    # the band: 170 centres, 2 s at 30.72 Msps
    band = kc.launch_plan(170, 3_840_000, 16)
    assert (band["threads"], band["tile"], band["phases"]) == (256, 512, 16)
    assert band["groups"] == 11 and band["blocks"] == 11 * 7500
    # the x piece (16 phases x 594 floats, re and im) and the taps; two
    # blocks a SM in its 228 KB, 1 KB of each block reserved
    assert band["smem_bytes"] == 4 * (2 * 16 * 594 + 2 * 16 * 16 * 16)
    assert 2 * (band["smem_bytes"] + 1024) <= 233472
    # a streaming segment: 3 centres, 4800 outputs at 15.36 Msps; the
    # staged outputs outgrow 8 phases of input
    seg = kc.launch_plan(3, 4800, 8)
    assert (seg["groups"], seg["blocks"], seg["phases"]) == (1, 10, 8)
    assert seg["smem_bytes"] == 4 * (2 * 16 * 576 + 2 * 8 * 16 * 16)
    for r in kc.RATIOS[1:]:
        plan = kc.launch_plan(170, 100_000, r)
        assert plan["smem_bytes"] <= band["smem_bytes"]
        assert r % plan["phases"] == 0 and plan["phases"] <= 16


# ------------------------------------------------------------ the upload --
def old_upload(x: np.ndarray, device="cpu"):
    """The upload before the ring: a host split, then a pad a side."""
    return tuple(torch.nn.functional.pad(c, (BLOCK, BLOCK))
                 for c in cplx.from_numpy(np.ascontiguousarray(x), device))


def assert_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.is_contiguous()
        assert g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


SLAB = 64           # bytes: 8 samples a slab


@pytest.mark.parametrize("n,kind,slab", [
    (5, "complex64", SLAB), (8, "complex64", SLAB), (9, "complex64", SLAB),
    (37, "complex64", SLAB), (37, "complex128", SLAB),
    (37, "strided", SLAB), (37, "float32", SLAB),
    (1000, "complex64", chan.SLAB_BYTES)])
def test_the_upload_through_slabs_is_the_split_and_pad_bit_for_bit(
        n, kind, slab):
    """Below a slab, one slab, one slab + 1, an odd length; a complex128
    capture (one cast), a strided view x[::2] and a real float32 array; and
    the module's own slab size."""
    z = np.random.default_rng(n).normal(size=(2, 2 * n)) * 3
    z = z[0] + 1j * z[1]
    z[:3] = [-0.0, np.inf, 1e-42]       # a sign, an infinity, a denormal
    x = {"complex64": z[:n].astype(np.complex64), "complex128": z[:n],
         "strided": z.astype(np.complex64)[::2],
         "float32": z.real[:n].astype(np.float32)}[kind]
    slabs = chan.counts["upload_slabs"]
    got = chan.upload_padded(x, "cpu", slab)
    assert_bits(got, old_upload(x))
    assert got[0].shape == (BLOCK + n + BLOCK,)
    assert chan.counts["upload_slabs"] - slabs == -(-8 * n // slab)


# ------------------------------------------------- on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def band_centres() -> np.ndarray:
    """The Band 12 sweep's 170 EARFCN centres (5010-5179, 100 kHz apart)
    around a capture centre of 737.5 MHz, in Hz."""
    dl = 729.0e6 + 0.1e6 * np.arange(170)
    return dl + 0.05e6 - 737.5e6


@pytest.mark.cuda
def test_kernel_equals_plain_at_the_band_shape(cuda_device):
    """170 centres at 30.72 Msps, 0.05 s: the kernel through `channelize`
    against the plain loop on the same card."""
    rate, seconds = 30.72e6, 0.05
    x = unit_noise(np.random.default_rng(170), int(rate * seconds))
    offs = band_centres()
    got = chan.channelize(x, rate, offs, device=cuda_device)
    xpad, origins, ramps = segment(padded(x), offs / rate,
                                   device=cuda_device)
    want = kc.channelize_plain(xpad, origins, ramps, 16, x.size // 16)
    torch.cuda.synchronize()
    assert got[0].shape == (170, 96000)
    assert_lanes(got, want)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [1, 2, 4, 16])
@pytest.mark.parametrize("centres", [1, 3, 17])
def test_kernel_equals_its_model_on_card(cuda_device, ratio, centres):
    n_out = 3 * 512 + 77
    x = unit_noise(np.random.default_rng(ratio + centres), n_out * ratio)
    xpad, origins, ramps = segment(padded(x), offsets(centres, 1.0),
                                   device=cuda_device)
    got = kc.channelize_kernel(xpad, origins, ramps, ratio, n_out)
    want = kc.channelize_model(xpad, origins, ramps, ratio, n_out)
    plain = kc.channelize_plain(xpad, origins, ramps, ratio, n_out)
    torch.cuda.synchronize()
    assert_lanes(got, want)
    assert_lanes(got, plain)


@pytest.mark.cuda
def test_one_launch_a_call_and_no_chunks(cuda_device):
    rate = 30.72e6
    x = unit_noise(np.random.default_rng(3), 3 * 307200 + 999)
    offs = band_centres()[:16]
    chunks, launches = chan.counts["chunks"], kc.launches
    for k in range(3):
        chan.channelize(x, rate, offs, device=cuda_device)
        assert kc.launches - launches == k + 1
    torch.cuda.synchronize()
    assert chan.counts["chunks"] == chunks


@pytest.mark.cuda
def test_the_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x = unit_noise(np.random.default_rng(4), 20 * 1200)
    xpad, origins, ramps = segment(padded(x), offsets(3, 1.0),
                                   device=cuda_device)
    with pytest.raises(ValueError, match="ratio 7"):
        kc.channelize_kernel(xpad, origins, ramps, 7, 1000)
    with pytest.raises(ValueError, match="ratio 9600"):
        chan._channelize_scan(xpad, origins, ramps, 9600, 1)
    with pytest.raises(ValueError, match="xpad"):
        kc.channelize_kernel(tuple(c.double() for c in xpad), origins,
                             ramps, 8, 1000)
    with pytest.raises(ValueError, match="contiguous"):
        kc.channelize_kernel(tuple(c[::2] for c in xpad), origins, ramps, 8,
                             1000)
    with pytest.raises(ValueError, match="origins"):
        kc.channelize_kernel(xpad, origins[:, :2].contiguous(), ramps, 8,
                             3000)
    info = kc.kernel_info()
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2, info
    assert info["smem_bytes"] == kc.launch_plan(170, 3_840_000,
                                                16)["smem_bytes"]


@pytest.mark.cuda
def test_the_kernel_is_the_mix_spans_only_kernel(cuda_device, tmp_path):
    """Under a profiler: inside "channelize.mix" the card runs the kernel
    once and at most one other kernel, the copy of the ramp table's every
    ratio-th column: no convolution, no mixer op, no concatenation."""
    import json

    rate = 30.72e6
    x = unit_noise(np.random.default_rng(6), 307200 + 4321)
    offs = band_centres()[:24]
    chan.channelize(x, rate, offs, device=cuda_device)          # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        chan.channelize(x, rate, offs, device=cuda_device)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    mix, launch, kernels = [], {}, []
    for e in json.loads(path.read_text())["traceEvents"]:
        cat, args = e.get("cat", ""), e.get("args") or {}
        if e.get("ph") != "X":
            continue
        if cat == "user_annotation" and e["name"] == "channelize.mix":
            mix.append((e["ts"], e["ts"] + e["dur"], e["tid"]))
        elif cat in ("cuda_runtime", "cuda_driver") \
                and "correlation" in args:
            launch[args["correlation"]] = (e["ts"], e["tid"])
        elif cat == "kernel":
            kernels.append((e["name"], args.get("correlation")))
    inside = [name for name, corr in kernels
              if any(a <= launch[corr][0] <= b and tid == launch[corr][1]
                     for a, b, tid in mix)]
    assert len(mix) == 1
    assert sum("chan_decimate_kernel" in k for k in inside) == 1, inside
    others = [k for k in inside if "chan_" not in k]
    assert len(others) <= 1 and all("copy" in k for k in others), inside


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["complex64", "strided"])
def test_the_lanes_equal_the_old_upload_through_the_same_kernel(
        cuda_device, kind):
    """170 centres, 0.2 s at 30.72 Msps (3 slabs): `channelize` of the numpy
    capture against the old upload's pair through the same kernel."""
    rate = 30.72e6
    x = unit_noise(np.random.default_rng(17), 2 * int(0.2 * rate))
    x = x[:x.size // 2] if kind == "complex64" else x[::2]
    offs = band_centres()
    got = chan.channelize(x, rate, offs, device=cuda_device)
    want = chan.channelize(cplx.from_numpy(np.ascontiguousarray(x),
                                           cuda_device), rate, offs)
    torch.cuda.synchronize()
    assert got[0].shape == (170, x.size // 16)
    assert_bits(got, want)


@pytest.mark.cuda
def test_back_to_back_captures_each_equal_their_own_reference(cuda_device):
    """Three captures of 8 slabs each, every slab different, channelized
    back to back without a wait: a slab refilled before the copy that read
    it ran would hand one call another's samples."""
    rate = 30.72e6
    n = chan.SLAB_BYTES // 8 * 7 + 12345                # 8 slabs
    rng = np.random.default_rng(3)
    xs = [unit_noise(rng, n) for _ in range(3)]
    offs = band_centres()[::17]
    chan.channelize(xs[0], rate, offs, device=cuda_device)      # warm-up
    torch.cuda.synchronize()
    got = [chan.channelize(x, rate, offs, device=cuda_device) for x in xs]
    torch.cuda.synchronize()
    for x, g in zip(xs, got):
        assert_bits(g, chan.channelize(cplx.from_numpy(x, cuda_device),
                                       rate, offs))


@pytest.mark.cuda
def test_the_upload_counts_slabs_and_bytes_and_copies_nothing_pageable(
        cuda_device, tmp_path):
    """counts["upload_slabs"] grows by ceil(8 n / SLAB_BYTES) a call and
    "upload_bytes" by 8 n; under a profiler no pageable host-to-device copy
    runs inside "channelize"."""
    import json

    rate = 30.72e6
    n = chan.SLAB_BYTES // 8 * 3 + 1001                 # 4 slabs
    x = unit_noise(np.random.default_rng(8), n)
    offs = band_centres()[:16]
    chan.channelize(x, rate, offs, device=cuda_device)          # warm-up
    before = dict(chan.counts)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            chan.channelize(x, rate, offs, device=cuda_device)
        torch.cuda.synchronize()
    assert chan.counts["upload_slabs"] - before["upload_slabs"] == 2 * 4
    assert chan.counts["upload_bytes"] - before["upload_bytes"] == 2 * 8 * n
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    copies = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"]
    assert sum("HtoD" in c and "Pinned" in c for c in copies) >= 2 * 4, \
        copies
    assert not [c for c in copies if "Pageable" in c], copies
