"""Pass C's CFO telemetry ring (ops/kernels/cfo_ring.py), which pass C
takes at every dispatch length: the port's `_mib_postpass` at s = 201 and
230 steps and a 208-step `channel_scan` against the JAX package's (its
`lax.scan` of `ring_step`); `ring_scan_plain` against the loop it replaced,
bit for bit, and up to 200 steps against the JAX package's closed form
(`_ring_series`); the kernel's schedule in PyTorch (`schedule_model`)
against the plain version; the CPU entry is the plain version and pass C
calls it once a dispatch; the launch plan; (marked `cuda`) the kernel
against the plain version and the schedule on a card.

Tolerances: integers and booleans exact, floats within test_torch_common's
FLOAT_TOL (the CFO mean and ring atol 1e-4 subcarriers: the two packages
estimate the CFO in other orders).  On the card the kernel's ring and count
are exact and its mean, a sum over the ring in another order, within atol
1e-5 subcarriers; the schedule in PyTorch sums in the kernel's order, so the
kernel equals it bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltetrigger_tpu.models import trigger as jtrig
from ltetrigger_tpu.ops import cplx as jcplx
from ltetrigger_tpu.parallel import channel_scan as jchannel_scan
from ltetrigger_tpu_torch.models import trigger as trig
from ltetrigger_tpu_torch.ops.kernels import cfo_ring as ck
from ltetrigger_tpu_torch.ops.kernels.pass_b import ring_push
from ltetrigger_tpu_torch.parallel import channel_scan
from test_torch_common import (assert_fields, engine_buffer, frames, noise,
                               to_pair_torch)

HALF = 9600


def _stream(s: int) -> np.ndarray:
    """[2, LOOKBACK + s half-frames + WINDOW] plus the s x 9600 + 640 zeros
    scan_engine pads a dispatch with.  Channel 0: cell 125 (25 PRB) for 40
    half-frames, loud noise for 10 (a loss), the cell again; channel 1:
    cell 80 throughout.  Noise of rms 0.1 on both."""
    rng = np.random.default_rng(s)
    n = s * HALF
    cell0 = frames(125, -(-n // 19200), nof_prb_field=25)[:n]
    cell0[40 * HALF:50 * HALF] = noise(rng, 10 * HALF, 10.0)
    cell1 = frames(80, -(-n // 19200), nof_prb_field=25)[:n]
    rows = [engine_buffer((x + noise(rng, n, 0.1)).astype(np.complex64),
                          trig.LOOKBACK, trig.WINDOW + n + trig._PAD_TAIL)
            for x in (cell0, cell1)]
    return np.stack(rows)


def _state0() -> dict:
    """A fresh carry for 2 channels whose CFO rings hold values and counts
    near 200 (channel 0) or past 60 (channel 1), so that the dispatch's
    pushes wrap the ring."""
    rng = np.random.default_rng(7)
    d = trig.state_to_numpy(trig.init_state(batch=(2,), device="cpu"))
    d["cfo_count"] = np.array([[190, 195, 199], [100, 150, 60]], np.int32)
    d["cfo_ring"] = _filled(rng.uniform(-0.5, 0.5, d["cfo_ring"].shape),
                            d["cfo_count"])
    return d


def _filled(ring: np.ndarray, count: np.ndarray) -> np.ndarray:
    """`ring` with the slots a ring of `count` pushes has not reached yet
    set to 0, as every ring the engine carries has them."""
    return np.where(np.arange(200) < count[..., None], ring, 0.0) \
        .astype(np.float32)


@functools.partial(jax.jit, static_argnames=("n_steps", "data_valid"))
def _jax_dispatch(buffer, state0, n_steps, data_valid):
    """The JAX passes A+B and `_mib_postpass` in one jit, as JAX
    `scan_engine` runs them."""
    final, raw = jtrig.scan_pass(buffer, state0, n_steps, 4.0,
                                 grid0_static=trig.LOOKBACK)
    return raw, jtrig._mib_postpass(state0, final, raw, buffer,
                                    data_valid=data_valid)


@pytest.mark.parametrize("s", [201, 230])
def test_mib_postpass_past_the_ring_matches_jax(s):
    buf = _stream(s)
    n = buf.shape[-1]
    d = _state0()
    jst0 = jtrig.TriggerState(**{f: jnp.asarray(v) for f, v in d.items()})
    jraw, (jst, jout) = _jax_dispatch(jcplx.from_numpy(buf), jst0, s, n)
    st0 = trig.state_from_numpy(d, device="cpu")
    tb = to_pair_torch(buf)
    fin, raw = trig.scan_pass(tb, st0, s, 4.0, grid0=trig.LOOKBACK)
    st, out = trig._mib_postpass(st0, fin, raw, tb, n)
    assert_fields(out, jout, trig.StepOutput._fields, f"s={s} out")
    assert_fields(st, jst, trig.TriggerState._fields, f"s={s} state")
    # the ring wrapped before channel 0's loss reset it mid-dispatch, and
    # channel 1's wrapped without a reset
    lost = raw.lost.numpy()
    push = (raw.emit & raw.tracking).numpy()
    r0, r1 = 125 % 3, 80 % 3
    first = int(np.argmax(lost[:, 0, r0]))
    assert lost[:, 0, r0].any() and 0 < first < s - 20
    assert d["cfo_count"][0, r0] + push[:first, 0, r0].sum() > 200
    assert not lost[:, 1, r1].any()
    assert d["cfo_count"][1, r1] + push[:, 1, r1].sum() > 200
    ev = out.track_event.numpy()
    assert ev[:, 0, r0].any() and ev[:, 1, r1].any()


def test_channel_scan_of_208_steps_matches_jax():
    """2 channels x 208 steps in one call: the branch past the ring held
    end to end, fresh states."""
    buf = _stream(208)
    jst, jout = jchannel_scan(jcplx.from_numpy(buf), 208, 4.0)
    st, out = channel_scan(to_pair_torch(buf), 208, 4.0, device="cpu")
    assert_fields(out, jout, trig.StepOutput._fields, "out")
    assert_fields(st, jst, trig.TriggerState._fields, "state")
    assert set(out.cell_id.numpy()[out.track_event.numpy()]) == {125, 80}
    assert out.drop_event.numpy()[:, 0, 125 % 3].any()


# ------------------------------------------ the plain version vs the loop --
def _loop(ring0, count0, est, push, lost):
    """The ring as trigger._mib_postpass ran it before the kernel."""
    ring, count, means = ring0, count0, []
    for t in range(est.shape[0]):
        ring = torch.where(lost[t][..., None], 0.0, ring)
        count = torch.where(lost[t], 0, count)
        ring = torch.where(push[t][..., None],
                           ring_push(ring, count, est[t]), ring)
        count = count + push[t].to(torch.int32)
        means.append(trig._ring_mean(ring, count))
    return ring, count, torch.stack(means)


def ring_inputs(lead: tuple, s: int, seed: int, device="cpu",
                lost_p: float = 0.01):
    """Random ring inputs: counts in [0, 400), a ring of values in the
    slots they reached, estimates in [-0.5, 0.5) subcarriers, rare losses
    (p `lost_p`) and pushes (p 0.8) on the other steps (a step that loses
    tracking pushes nothing)."""
    rng = np.random.default_rng(seed)
    count0 = rng.integers(0, 400, size=lead).astype(np.int32)
    lost = rng.random((s,) + lead) < lost_p
    arrays = (_filled(rng.uniform(-0.5, 0.5, lead + (200,)), count0), count0,
              rng.uniform(-0.5, 0.5, (s,) + lead).astype(np.float32),
              (rng.random((s,) + lead) < 0.8) & ~lost, lost)
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


@pytest.mark.parametrize("lead,s", [((2, 3), 201), ((48,), 400),
                                    ((1, 3), 1)])
def test_plain_matches_the_loop_it_replaced(lead, s):
    ins = ring_inputs(lead, s, seed=s)
    got = ck.ring_scan_plain(*ins)
    ref = _loop(*ins)
    for g, r, what in zip(got, ref, ("ring", "count", "mean")):
        assert g.dtype == r.dtype and torch.equal(g, r), what


@pytest.mark.parametrize("s", [1, 50, 200])
def test_plain_matches_the_closed_form_up_to_200(s):
    """Up to 200 steps the JAX package takes its closed form
    (`_ring_series`); the port's plain ring agrees with it on the same
    inputs: ring and count exact, the mean within atol 1e-5."""
    ins = ring_inputs((4, 3), s, seed=s)
    got = ck.ring_scan_plain(*ins)
    ref = jtrig._ring_series(*(jnp.asarray(x.numpy()) for x in ins))
    for g, r, what in zip(got[:2], ref[:2], ("ring", "count")):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype, what
        np.testing.assert_array_equal(g.numpy(), r, err_msg=what)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=0,
                               atol=1e-5)


def test_cpu_entry_is_the_plain_version():
    ins = ring_inputs((2, 3), 230, seed=1)
    before = ck.launches
    got = ck.ring_scan(*ins)
    ref = ck.ring_scan_plain(*ins)
    assert ck.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# the name is historical: pass C once ran the ring scan past 200 steps only
@pytest.mark.parametrize("s", [200, 201])
def test_pass_c_takes_the_ring_scan_only_past_200(monkeypatch, s):
    """Pass C takes `ring_scan` at every dispatch length, once a dispatch:
    up to the ring's 200 slots and past them."""
    seen = []
    real = ck.ring_scan

    def spy(*a):
        seen.append(tuple(a[2].shape))
        return real(*a)
    monkeypatch.setattr(ck, "ring_scan", spy)
    buf = _stream(201)[:1]
    tb = to_pair_torch(buf)
    st0 = trig.init_state(batch=(1,), device="cpu")
    fin, raw = trig.scan_pass(tb, st0, s, 4.0, grid0=trig.LOOKBACK)
    trig._mib_postpass(st0, fin, raw, tb, buf.shape[-1])
    assert seen == [(s, 1, 3)]


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ck.ring_scan_kernel(*ring_inputs((2, 3), 201, seed=0))


def near_200(lead: tuple, s: int, seed: int, device="cpu"):
    """`ring_inputs` with counts in [190, 210): the dispatch's first pushes
    wrap the ring or fill its last slots."""
    ring0, count0, *rest = ring_inputs(lead, s, seed)
    count0 = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        190, 210, size=lead).astype(np.int32))
    ring0 = torch.from_numpy(_filled(np.random.default_rng(seed + 2).uniform(
        -0.5, 0.5, lead + (200,)), count0.numpy()))
    return tuple(x.to(device) for x in (ring0, count0, *rest))


def rare_losses(lead: tuple, s: int, seed: int, device="cpu"):
    """`ring_inputs` with losses 10x rarer (p 0.001): over 1000 steps most
    lanes wrap the ring four or five times before their first loss."""
    return ring_inputs(lead, s, seed, device, lost_p=0.001)


@pytest.mark.parametrize("make", [ring_inputs, near_200, rare_losses])
@pytest.mark.parametrize("lead,s", [((2, 3), 201), ((48,), 400),
                                    ((16, 3), 1000), ((1, 3), 1),
                                    ((5,), 33)])
def test_schedule_model_matches_plain(make, lead, s):
    """The kernel's schedule in PyTorch (ballot counts a tile of 32 steps,
    the slots' walk, the tile's sums) against the plain version: ring and
    count exact, the mean within atol 1e-5 subcarriers."""
    ins = make(lead, s, seed=s)
    got = ck.schedule_model(*ins)
    ref = ck.ring_scan_plain(*ins)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert got[2].dtype == ref[2].dtype
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=1e-5)
    if s >= 400:            # several resets and wraps in one dispatch
        assert int(ins[4].sum()) >= 3
    if make is rare_losses and s == 1000:
        first = torch.where(ins[4].any(0), ins[4].float().argmax(0), s)
        pushed = (ins[3].cumsum(0) * (torch.arange(s)[:, None, None]
                                      < first)).amax(0)
        assert int((ins[1] + pushed).max()) >= 5 * 200


def test_schedule_model_takes_any_ring_and_count():
    """Counts that wrap int32 or start negative, values past the count,
    a step that loses and pushes: still the plain version."""
    ring0, count0, est, push, lost = ring_inputs((6,), 300, seed=1)
    count0 = torch.tensor([2 ** 31 - 50, -7, -400, 0, 199, 2 ** 31 - 1],
                          dtype=torch.int32)
    ring0 = torch.from_numpy(np.random.default_rng(2).uniform(
        -0.5, 0.5, (6, 200)).astype(np.float32))
    lost[:, [0, 5]] = False             # these two counts wrap int32
    push = push | lost
    got = ck.schedule_model(ring0, count0, est, push, lost)
    ref = ck.ring_scan_plain(ring0, count0, est, push, lost)
    assert int(ref[1].min()) < 0
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=1e-5)


def test_launch_plan():
    """A block of 256 threads a lane, 6 a SM: the 2-s scan's 48 lanes in
    one wave, 3072 lanes in four."""
    plan = ck.launch_plan(48)
    assert plan["threads"] == 256 and plan["blocks"] == 48
    assert plan["blocks_per_sm"] == 6 and plan["waves"] == 1
    assert plan["smem_bytes"] == 4 * (32 * 204 + 7 * 32 + 2 * 2 * 32 + 2)
    assert ck.launch_plan(3072)["waves"] == 4


# ------------------------------------------------- on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("make", [ring_inputs, near_200, rare_losses])
@pytest.mark.parametrize("lead,s", [((48,), 201), ((16, 3), 400),
                                    ((5,), 600), ((48,), 1000),
                                    ((1, 3), 1), ((512, 3), 200),
                                    ((3,), 16)])
def test_kernel_matches_plain_on_card(cuda_device, make, lead, s):
    """Ring and count exact, the mean within atol 1e-5 subcarriers of the
    plain version; all three equal to the kernel's schedule in PyTorch,
    which sums in the kernel's order."""
    ins = make(lead, s, seed=s, device=cuda_device)
    ring, count, mean = ck.ring_scan_kernel(*ins)
    ref = ck.ring_scan_plain(*ins)
    model = ck.schedule_model(*ins)
    torch.cuda.synchronize()
    assert torch.equal(ring, ref[0]) and torch.equal(count, ref[1])
    torch.testing.assert_close(mean, ref[2], rtol=0, atol=1e-5)
    assert torch.equal(ring, model[0]) and torch.equal(count, model[1])
    assert torch.equal(mean, model[2])


@pytest.mark.cuda
def test_kernel_info_on_card(cuda_device):
    info = ck.kernel_info()
    assert info["local_bytes"] == 0, info
    assert info["blocks_per_sm"] >= ck.launch_plan(1)["blocks_per_sm"], info
    assert info["smem_bytes"] == ck.launch_plan(1)["smem_bytes"], info
