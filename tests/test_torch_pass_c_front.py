"""Pass C's front end (ops/kernels/pass_c_front.py): the plain version
against a loop of itself one step at a time with the state carried, at the
main path's lane shapes ([S, 8, 3], [S, 3], [S, 4, 3]) with lost steps,
published and pending_fresh set, slot-0 reads past either end of the
buffer, steps past `data_valid` and more captures than slots; the CPU entry
is the plain version; (marked `cuda`) the kernels against the plain version
on a card at the shapes of a Trigger, a MultiTrigger(8), scan512 and the
Band 12 sweep.  Imports no JAX: the cuda cases run on the card's machine
with `--noconftest`.

Tolerances: on the CPU integers exact and floats within 1e-6 of the
tensor's largest value, a few float32 roundings: ATen's CPU atan2, sin and
cos round some values one unit differently on their vectorized and scalar
paths, and which elements take which path depends on the tensor's length,
so a step alone and the same step in a batch can differ there.  On the card
the kernels sum in another order: integers and flags exact except where the
plain version's decision lies within a relative 1e-5 of a tie (the two CP
scores, the top two of an SSS argmax, a CFO estimate at +-1 subcarrier,
where the angle wraps); a lane with such a step is left out of the lane's
capture comparison and counted.  The CFO ring, its means, the rotation and
the channel estimate within a relative 1e-5 (of each value, or of the
tensor's largest near 0).
"""

import math

import numpy as np
import pytest
import torch

from ltetrigger_tpu_torch.ltecore import synth
from ltetrigger_tpu_torch.models import trigger as trig
from ltetrigger_tpu_torch.ops import cfo as cfo_ops
from ltetrigger_tpu_torch.ops import cplx, dft, sync
from ltetrigger_tpu_torch.ops.kernels import pass_c_front as pcf

HALF = 9600
FRAME = 19200
CELLS = (125, 80, 301, 7)


def _frames(device) -> torch.Tensor:
    """[len(CELLS), 2, FRAME] float32: one synthetic frame a cell."""
    f = np.stack([synth.synthesize_frame(c, nof_prb_field=6) for c in CELLS])
    return torch.from_numpy(np.stack([f.real, f.imag], 1)
                            .astype(np.float32)).to(device)


def make_case(batch: tuple, s: int, k: int, seed: int, device="cpu",
              grid0: int = trig.LOOKBACK, short: int = 0, cut: int = 0,
              p_emit: float = 0.5):
    """Seeded inputs of the front end for lanes batch + (3,) and s steps:
    (state0, raw, buffer, data_valid, k).  Every other channel carries a
    cell (a tiled synthetic frame at a random delay and level, slot 0 where
    its root's lane peaks), all of them noise; the other lanes peak at
    random.  The buffer ends `short` samples before the last step's
    slot-0 tail would (reads past the end), `data_valid` `cut` samples
    before its end; grid0 < 384 reads before the start."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    nb = math.prod(batch)
    lead = tuple(batch) + (3,)
    n = grid0 + s * HALF + 640 - short
    buf = torch.randn((nb, 2, n), generator=gen, device=device) \
        * float(np.sqrt(0.5))
    frames = _frames(device)
    peak = rng.integers(0, HALF, (s, nb, 3))
    for b in range(0, nb, 2):
        cell = CELLS[(b // 2) % len(CELLS)]
        delay = int(rng.integers(0, FRAME))
        amp = float(10 ** (rng.uniform(-10, 10) / 20))
        reps = -(-(n + delay) // FRAME) + 1
        tiled = frames[(b // 2) % len(CELLS)].repeat(1, reps)
        buf[b] += amp * tiled[:, FRAME - delay:FRAME - delay + n]
        # slot 0 of each half-frame starts at delay + 9600 m; a step's
        # slot-0 start is grid0 + 9600 t + peak - 832
        peak[:, b, cell % 3] = (delay - grid0 + trig.LOOKBACK) % HALF
    # root 0 carries no cell: its first step reads from the buffer's
    # earliest position, its last from the latest
    peak[0, -1, 0], peak[-1, -1, 0] = 0, HALF - 1
    tracking = rng.random((s, nb, 3)) < 0.6
    lost = (rng.random((s, nb, 3)) < 0.1) & ~tracking
    lost[-1, -1, 0], tracking[-1, -1, 0] = True, False   # at least one
    emit = (rng.random((s, nb, 3)) < p_emit) | lost
    d = trig.state_to_numpy(trig.init_state(batch=tuple(batch),
                                            device="cpu"))
    d["cfo_count"] = rng.integers(0, 400, lead).astype(np.int32)
    ring = rng.uniform(-0.3, 0.3, d["cfo_ring"].shape)
    d["cfo_ring"] = np.where(np.arange(200) < d["cfo_count"][..., None],
                             ring, 0.0).astype(np.float32)
    d["published"] = (rng.random(lead) < 0.3) | (np.arange(3) == 0)
    d["pending_fresh"] = (rng.random(lead) < 0.5) | (np.arange(3) == 2)
    d["mib_cell"] = np.where(rng.random(lead) < 0.3, -1,
                             rng.integers(0, 504, lead)).astype(np.int32)
    d["chest"] = rng.normal(size=d["chest"].shape).astype(np.float32)
    state0 = trig.state_from_numpy(d, device=device)

    def on(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    steps = torch.arange(s, dtype=torch.int32, device=device)
    zi = torch.zeros((s,) + lead, dtype=torch.int32, device=device)
    raw = trig.RawStepOutput(
        grid=grid0 + HALF * steps, active=torch.ones(s, dtype=torch.bool,
                                                     device=device),
        peak=on(peak.reshape((s,) + lead), torch.int32),
        psr=torch.zeros((s,) + lead, device=device), score=zi,
        tracking=on(tracking.reshape((s,) + lead), torch.bool),
        emit=on(emit.reshape((s,) + lead), torch.bool),
        lost=on(lost.reshape((s,) + lead), torch.bool), consumed=zi)
    buffer = (buf[:, 0].reshape(tuple(batch) + (n,)).contiguous(),
              buf[:, 1].reshape(tuple(batch) + (n,)).contiguous())
    return state0, raw, buffer, n - cut, k


# --------------------------------------------- the plain version vs a loop --
def step_loop(state0, raw, buffer, data_valid: int, k: int) -> pcf.Front:
    """The front end one step at a time: `front_plain` of each step alone,
    its ring, channel estimate, published gate, pending_fresh and cell of
    the last capture carried to the next, its captures counted into the k
    slots here."""
    s = raw.peak.shape[0]
    lead = tuple(raw.peak.shape[1:])
    ring, count, chest = state0.cfo_ring, state0.cfo_count, state0.chest
    pub, pf, cell = state0.published, state0.pending_fresh, state0.mib_cell
    cum = torch.zeros(lead, dtype=torch.int64)
    overflow = torch.zeros(lead, dtype=torch.int32)
    cand = {f: torch.zeros(lead + (k,), dtype=dt)
            for f, dt in (("cand_cell", torch.int32),
                          ("cand_cp", torch.bool), ("cand_fresh", torch.bool),
                          ("cand_start", torch.int64),
                          ("cand_freq", torch.float32))}
    rows = {f: [] for f in ("cfo_mean", "freq", "normal_cp", "cell_id",
                            "want_cap", "at")}
    for t in range(s):
        raw_t = raw._replace(**{f: getattr(raw, f)[t:t + 1]
                                for f in raw._fields})
        st_t = state0._replace(cfo_ring=ring, cfo_count=count, chest=chest,
                               published=pub, pending_fresh=pf,
                               mib_cell=cell)
        fr = pcf.front_plain(st_t, raw_t, buffer, data_valid, 1)
        elig = fr.want_cap[0]                # one slot: every eligible step
        took = elig & (cum < k)
        slot = torch.where(took, cum, k)
        overflow = overflow + fr.overflow + (elig & ~took).to(torch.int32)
        for f in cand:
            v = getattr(fr, f)[..., 0]
            full = torch.cat([cand[f], torch.zeros_like(cand[f][..., :1])],
                             dim=-1)
            cand[f] = full.scatter(-1, slot[..., None], v[..., None])[..., :k]
        lost = raw.lost[t]
        pf = torch.where(lost, True, torch.where(took, False, pf))
        cell = torch.where(took, fr.cell_id[0], cell)
        pub = pub & ~lost
        cum = cum + elig.to(torch.int64)
        ring, count, chest = fr.ring, fr.count, fr.chest
        for f in ("cfo_mean", "freq", "normal_cp", "cell_id"):
            rows[f].append(getattr(fr, f)[0])
        rows["want_cap"].append(took)
        rows["at"].append(slot)
    cnt = torch.clamp(cum, max=k)
    return pcf.Front(
        ring=ring, count=count, chest=chest, pending_fresh=pf,
        overflow=overflow, cnt=cnt,
        valid=torch.arange(k) < cnt[..., None],
        at=torch.stack(rows.pop("at"), dim=-1),
        **{f: torch.stack(v) for f, v in rows.items()}, **cand)


LOOP_CASES = [
    # (batch, s, k, grid0, short, cut, p_emit)
    ((8,), 1, 1, trig.LOOKBACK, 0, 0, 0.5),
    ((8,), 2, 2, trig.LOOKBACK, 0, 0, 0.9),
    ((8,), 4, 4, trig.LOOKBACK, 0, 0, 0.5),
    ((), 3, 3, 100, 0, 0, 0.9),              # reads before the start
    ((), 5, 5, trig.LOOKBACK, 5000, 0, 0.9),  # reads past the end
    ((4,), 5, 5, trig.LOOKBACK, 0, 4000, 0.9),  # not gatherable at the end
    ((4,), 4, 1, trig.LOOKBACK, 0, 0, 1.0),   # more captures than slots
    ((8,), 48, 16, trig.LOOKBACK, 3000, 6000, 0.9),   # past K_STEP_CAP
    ((), 48, 16, 200, 0, 0, 1.0),
    ((4,), 48, 16, trig.LOOKBACK, 0, 0, 0.9),
]


@pytest.mark.parametrize("batch,s,k,grid0,short,cut,p_emit", LOOP_CASES)
def test_plain_matches_a_loop_of_itself_one_step_at_a_time(
        batch, s, k, grid0, short, cut, p_emit):
    case = make_case(batch, s, k, seed=1000 * s + 17 * k + len(batch),
                     grid0=grid0, short=short, cut=cut, p_emit=p_emit)
    got = pcf.front_plain(*case)
    ref = step_loop(*case)
    for f in pcf.Front._fields:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-6 * float(b.abs().max()))
        else:
            assert torch.equal(a, b), f
    # the case holds what it is meant to hold
    st0, raw, buffer, data_valid, _ = case
    assert raw.lost.any() and st0.published.any() and \
        st0.pending_fresh.any() and got.want_cap.any()
    if s > k:
        assert (got.overflow > 0).any()
    n = buffer[0].shape[-1]
    start = raw.grid.reshape((s,) + (1,) * len(batch) + (1,)) + raw.peak \
        - trig.LOOKBACK + trig.SEG_OFF
    if grid0 < trig.LOOKBACK - trig.SEG_OFF:
        assert (start < 0).any()
    if short:
        assert (start + trig.SEG > n).any()
    if cut:
        assert (start - trig.SEG_OFF + 2 * trig.SLOT_LENGTH > data_valid).any()


def test_cpu_entry_is_the_plain_version():
    case = make_case((4,), 5, 5, seed=3)
    n0 = pcf.launches
    got, ref = pcf.front(*case), pcf.front_plain(*case)
    assert pcf.launches == n0
    for f in pcf.Front._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        pcf.front_kernel(*make_case((), 1, 1, seed=5))


def test_tables_and_launch_plan():
    tab = pcf.tables()
    re, im = dft.dft_sync62()
    w = tab[:128 * 64 * 2].reshape(128, 64, 2)
    assert np.array_equal(w[:, :62, 0], re.T)
    assert np.array_equal(w[:, :62, 1], im.T) and not w[:, 62:].any()
    tre, tim = cfo_ops.replica_pairs()
    assert np.array_equal(tab[-768:], np.concatenate([tre.ravel(),
                                                      tim.ravel()]))
    plan = pcf.launch_plan(1536, 200)
    assert plan["blocks"] == 1536 and plan["threads"] == 256
    assert plan["estimate_blocks"] == 1536 * 200 // 8
    assert plan["smem_bytes"] == 4 * (tab.size - 2 * 186 - 768) \
        + 8 * 512 * 8 + 2 * 32 * 12 + 16
    assert plan["waves"] == 6


# ------------------------------------------------- on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def near_ties(case, plain: pcf.Front, rel: float = 1e-5) -> torch.Tensor:
    """[S, .., R] bool: the plain version's decisions that lie within `rel`
    of a tie: the two CP scores, the top two of either SSS argmax (m0 at
    the CP it chose, m1 at that m0), a CFO estimate within rel of +-1."""
    state0, raw, buffer, _, _ = case
    s = raw.peak.shape[0]
    st0 = raw.grid.to(torch.int64).reshape((s,) + (1,) * (raw.peak.ndim - 1)) \
        + raw.peak - trig.LOOKBACK
    seg = tuple(pcf.read(c, st0 + trig.SEG_OFF, trig.SEG, lead=1)
                for c in buffer)
    est = cfo_ops.cfo_estimate(cplx.index(seg, (..., slice(384, 512))),
                               cfo_ops.on_device("time", str(seg[0].device)))
    sf = cfo_ops.cfo_rotate(seg, plain.freq, trig.SEG_OFF)

    def cp_score(cp):
        num, den, pos = (0.0, 0.0), 1e-30, 384
        for _ in range(2):
            pos -= 128 + cp
            c = cplx.index(sf, (..., slice(pos - cp, pos)))
            t = cplx.index(sf, (..., slice(pos + 128 - cp, pos + 128)))
            num = cplx.add(num, cplx.dot_conj_sum(c, t))
            den = den + 0.5 * (cplx.abs2(c).sum(-1) + cplx.abs2(t).sum(-1))
        return torch.sqrt(cplx.abs2(num)) / den

    def close(a, b):
        return (a - b).abs() <= rel * torch.maximum(a.abs(), b.abs())

    def top_two(metric):
        v = metric.topk(2, dim=-1).values
        return close(v[..., 0], v[..., 1])

    dev = seg[0].device
    bank, cs, zb, _ = sync._tables(str(dev))
    at = torch.where(plain.normal_cp, 247, 224)[..., None] \
        + torch.arange(128, device=dev)
    sym = tuple(torch.gather(c, -1, at) for c in sf)
    y = dft.dft_sync(sym)
    nid2 = torch.arange(3, device=dev)
    ce = cplx.scale(cplx.index(y, (..., slice(0, None, 2))), cs[nid2, 0])
    m0_metric = sync._partial_corr_metric(ce, bank, 3)
    m0 = m0_metric.argmax(-1)
    co = cplx.scale(cplx.index(y, (..., slice(1, None, 2))),
                    cs[nid2, 1] * zb[m0 % 8])
    m1_metric = sync._partial_corr_metric(co, bank, 3)
    return (close(cp_score(9), cp_score(32)) | top_two(m0_metric)
            | top_two(m1_metric) | ((est.abs() - 1).abs() <= rel))


def assert_close_rel(a, b, what):
    """Within 1e-5 of each value, or of the tensor's largest near 0."""
    scale = float(b.abs().max()) if b.numel() else 0.0
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale,
                               msg=lambda m: f"{what}: {m}")


# the main path's shapes: a Trigger dispatch, a MultiTrigger(8) dispatch,
# scan512's call, the Band 12 sweep's call, and a streaming dispatch with
# more captures than slots
CUDA_CASES = [((), 16, 16), ((8,), 4, 4), ((512,), 200, 16),
              ((170,), 400, 16), ((8,), 48, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,s,k", CUDA_CASES)
def test_kernels_match_plain_on_card(cuda_device, batch, s, k):
    case = make_case(batch, s, k, seed=7 * s + k, device=cuda_device,
                     cut=3000, p_emit=0.9)
    n0 = pcf.launches
    got = pcf.front(*case)
    assert pcf.launches == n0 + 1
    ref = pcf.front_plain(*case)
    torch.cuda.synchronize()
    ties = near_ties(case, ref)
    lead = tuple(case[1].peak.shape[1:])
    tied_lane = ties.any(dim=0)
    n_ties = int(ties.sum())
    print(f"lanes {lead} x S={s}: {n_ties} near-tie decisions in "
          f"{int(tied_lane.sum())} lanes")
    ok = ~ties
    for f in ("normal_cp", "cell_id"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a[ok], b[ok]), f
    assert torch.equal(got.count, ref.count)
    assert_close_rel(got.ring, ref.ring, "ring")
    assert_close_rel(got.cfo_mean, ref.cfo_mean, "cfo_mean")
    assert_close_rel(got.freq, ref.freq, "freq")
    assert_close_rel(got.chest, ref.chest, "chest")
    # the capture chain and the slots, lane by lane where no step tied
    keep = ~tied_lane
    for f in ("want_cap", "at", "cand_cell", "cand_cp", "cand_fresh",
              "cand_start", "valid", "cnt", "pending_fresh", "overflow"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f == "want_cap":
            a, b = a.movedim(0, -1), b.movedim(0, -1)
        assert torch.equal(a[keep], b[keep]), f
    assert_close_rel(got.cand_freq[keep], ref.cand_freq[keep], "cand_freq")
    assert bool(got.want_cap.any()) and bool((got.cnt > 0).any())
    if s > k:
        assert bool((got.overflow > 0).any())


@pytest.mark.cuda
def test_kernel_info_on_card(cuda_device):
    info = pcf.kernel_info()
    plan = pcf.launch_plan(1, 1)
    # sincosf's reduction of large arguments keeps 28 bytes on the stack;
    # its arguments here (|2 pi freq n| < 48) never take that path
    assert info["local_bytes"] <= 32, info
    assert info["blocks_per_sm"] >= plan["blocks_per_sm"], info
    assert info["smem_bytes"] == plan["smem_bytes"], info
