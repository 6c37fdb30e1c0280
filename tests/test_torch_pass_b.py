"""Pass B of the port's grid engine (ops/kernels/pass_b.py) against the JAX
package's, on the CPU, and (marked `cuda`) the hand-written kernel against
its plain version on a card.

On the CPU `scan_group` runs `scan_group_plain`.  Two ways in:
  * through `scan_pass`, against `jtrig.scan_pass` on the same buffer:
    batch shapes (), (2,), (8,); groups of g = 1, 5 and 25 steps
    (GROUP_BUDGET); a last group only partly active (n_valid);
    acquisition, loss and reacquisition with `track_every` skips;
  * on planted power, group by group, against the JAX package's
    `_step_core` step by step: peaks at the stream's edge bins (0, 63, 64,
    127, 128, 9535, 9598, 9599), equal maxima in different blocks, strong
    and silent stretches (acquisition and loss), a partial group.

Integer and boolean rows and state exact; PSR, PSR ring and EMA within the
engine's rtol 1e-4 / atol 1e-5 (the JAX package may contract the EMA's
multiply-add; the port rounds each product).  On the card the kernel must
equal the plain version: integers exact and the EMA bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltetrigger_tpu.models import trigger as jtrig
from ltetrigger_tpu.ops import cplx as jcplx
from ltetrigger_tpu_torch.models import trigger as trig
from ltetrigger_tpu_torch.ops import correlate
from ltetrigger_tpu_torch.ops.kernels import pass_b
from test_torch_common import (acq_loss_reacq, assert_fields, engine_buffer,
                               to_pair_torch)

STATE = trig.TriggerState._fields[:10]        # what pass B carries
EDGE_BINS = (0, 63, 64, 127, 128, 9535, 9598, 9599)
HFL = trig.HALF_FRAME_LENGTH


def _jax_state(batch):
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, tuple(batch) + x.shape),
        jtrig.init_state())


def _stream(batch, seed: int) -> np.ndarray:
    """[*batch, N] engine buffer: each lane an acquisition / loss /
    reacquisition stream of its own cell."""
    n = int(np.prod(batch, dtype=np.int64))
    rows = [acq_loss_reacq(100 + 37 * i, seed=seed + i) for i in range(n)]
    buf = np.stack([engine_buffer(x, trig.LOOKBACK, trig.WINDOW)
                    for x in rows])
    return buf.reshape(tuple(batch) + buf.shape[-1:])


# ------------------------------------------------ through scan_pass --------
@pytest.mark.parametrize("batch", [(), (2,), (8,)])
@pytest.mark.parametrize("budget,g", [(4096, 25), (5, 5), (1, 1)])
def test_scan_pass_matches_jax(monkeypatch, batch, budget, g):
    """25 steps of acquisition, loss and reacquisition (track_after 4,
    track_every 3) in groups of g; the last group's final steps inactive."""
    nb = int(np.prod(batch, dtype=np.int64))
    monkeypatch.setattr(trig, "GROUP_BUDGET", budget * nb)
    monkeypatch.setattr(jtrig, "GROUP_BUDGET", budget * nb)
    assert trig._pick_group(25, nb) == g
    buf = _stream(batch, seed=len(batch) + g)
    # steps 0..22 active, 23 and 24 not (their window crosses n_valid)
    n_valid = trig.LOOKBACK + 22 * HFL + correlate.V2_WINDOW + 5
    jst, jraw = jtrig.scan_pass(jcplx.from_numpy(buf), _jax_state(batch), 25,
                                4.0, 4, 3, n_valid=n_valid)
    st, raw = trig.scan_pass(to_pair_torch(buf),
                             trig.init_state(batch=batch, device="cpu"), 25,
                             4.0, 4, 3, n_valid=n_valid)
    active = np.asarray(jraw.active)
    assert active[:23].all() and not active[23:].any()
    assert np.asarray(jraw.lost).any() and np.asarray(jraw.tracking).any()
    assert_fields(raw, jraw, trig.RawStepOutput._fields, "raw")
    assert_fields(st, jst, STATE, "state")


def test_scan_pass_no_active_group(monkeypatch):
    """Groups of 5 steps, only steps 0-3 active: the second group has no
    active step (no pass A there, the state repeats)."""
    monkeypatch.setattr(trig, "GROUP_BUDGET", 5)
    monkeypatch.setattr(jtrig, "GROUP_BUDGET", 5)
    buf = _stream((), seed=3)
    n_valid = trig.LOOKBACK + 3 * HFL + correlate.V2_WINDOW
    jst, jraw = jtrig.scan_pass(jcplx.from_numpy(buf), jtrig.init_state(),
                                10, 4.0, 4, 2, n_valid=n_valid)
    st, raw = trig.scan_pass(to_pair_torch(buf), trig.init_state(
        device="cpu"), 10, 4.0, 4, 2, n_valid=n_valid)
    assert np.asarray(jraw.active).tolist() == [True] * 4 + [False] * 6
    assert_fields(raw, jraw, trig.RawStepOutput._fields, "raw")
    assert_fields(st, jst, STATE, "state")


# ------------------------------------------------ on planted power ---------
def planted_power(batch, g: int, strong, seed: int) -> np.ndarray:
    """[*batch, g, 75, 3, 128] float32 pass-A power: unit exponential noise;
    where strong[t], roots 0 and 1 of each lane carry a peak with a short
    lobe at an edge bin of their own, and root 2 two equal maxima in
    different blocks (equal at every step, so the tie lasts); silent steps
    carry noise only.  `strong` may be shorter than g."""
    strong = np.pad(np.asarray(strong, bool), (0, g - len(strong)))
    rng = np.random.default_rng(seed)
    n = int(np.prod(batch, dtype=np.int64))
    p = rng.exponential(size=(n, g, 3, 9600)).astype(np.float32)
    for lane in range(n):
        b1 = 1000 + 17 * lane               # root 2: a tie, equal at every
        b2 = b1 + 128 * (3 + lane % 5)      # step; the first one wins
        p[lane, :, 2, b1] = np.where(strong, 40.0, p[lane, :, 2, b1])
        p[lane, :, 2, b2] = p[lane, :, 2, b1]
        for r in range(2):
            pk = EDGE_BINS[(3 * lane + r) % len(EDGE_BINS)]
            for t in np.nonzero(strong)[0]:
                for d in range(4):
                    for b in (pk - d, pk + d):
                        if 0 <= b < 9600:
                            p[lane, t, r, b] = 60.0 * 0.6 ** d
    blk = p.reshape(n, g, 3, 75, 128).transpose(0, 1, 3, 2, 4)
    return np.ascontiguousarray(blk).reshape(tuple(batch) + (g, 75, 3, 128))


def _jax_group(jst, power, grid0, n_active, thresh, ta, te):
    """The JAX package's pass B over one group, step by step."""
    nbatch = power.ndim - 4
    rows = []
    for t in range(power.shape[nbatch]):
        p_t = jnp.asarray(np.take(power, t, axis=nbatch))
        jst, o = jtrig._step_core(jst, p_t, jnp.int32(grid0 + t * HFL),
                                  jnp.asarray(t < n_active),
                                  jnp.float32(thresh), ta, te)
        rows.append(o)
    return jst, jax.tree_util.tree_map(lambda *x: jnp.stack(x), *rows)


SCHEDULES = {
    # steps strong, then silent, then strong; groups of g steps, the last
    # one partial where g does not divide the steps
    "acquire_lose_reacquire": (12, 24, 12, 32),
    "partial_group": (8, 0, 3, 16),
    "one_step_groups": (6, 10, 4, 1),
}


@pytest.mark.parametrize("batch", [(), (2,), (8,)])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_scan_group_planted_power_matches_jax(batch, schedule):
    """scan_group (its plain version on the CPU) group by group against the
    JAX package's _step_core; track_after 4, track_every 3."""
    on1, off, on2, g = SCHEDULES[schedule]
    steps = on1 + off + on2
    strong = np.array([t < on1 or t >= on1 + off for t in range(steps)])
    st = trig.init_state(batch=batch, device="cpu")
    jst = _jax_state(batch)
    grid = trig.LOOKBACK
    acquired = lost = False
    for gi, lo in enumerate(range(0, steps, g)):
        n_act = min(g, steps - lo)
        power = planted_power(batch, g, strong[lo:lo + g], seed=gi)
        st, rows = pass_b.scan_group(st, torch.from_numpy(power), grid,
                                     n_act, 4.0, 4, 3)
        jst, jrows = _jax_group(jst, power, grid, n_act, 4.0, 4, 3)
        got = dict(zip(("peak", "psr", "score", "tracking", "emit", "lost",
                        "consumed"), rows))
        for f in got:
            g_, r_ = got[f].numpy(), np.asarray(getattr(jrows, f))
            assert g_.shape == r_.shape, (f, g_.shape, r_.shape)
            if f == "psr":
                np.testing.assert_allclose(g_, r_, rtol=1e-4, err_msg=f)
            else:
                np.testing.assert_array_equal(g_, r_, err_msg=f)
        assert_fields(st, jst, STATE, f"state after group {gi}")
        acquired |= bool(rows[3].any())
        lost |= bool(rows[5].any())
        grid += n_act * HFL
    peaks = np.asarray(jst.peak).reshape(-1, 3)
    assert (peaks[:, 2] == 1000 + 17 * np.arange(len(peaks))).all(), peaks
    if schedule == "acquire_lose_reacquire":
        # the stream ends strong: roots 0 and 1 on their planted edge bins
        want = [[EDGE_BINS[(3 * lane + r) % len(EDGE_BINS)] for r in (0, 1)]
                for lane in range(len(peaks))]
        np.testing.assert_array_equal(peaks[:, :2], want)
        assert acquired and lost


def test_routing_rule():
    """A CPU tensor runs the plain version; the kernel's own entry refuses
    anything but a CUDA tensor."""
    st = trig.init_state(device="cpu")
    power = torch.from_numpy(planted_power((), 2, np.ones(2, bool), 0))
    a_st, a_rows = pass_b.scan_group(st, power, trig.LOOKBACK, 2, 4.0, 4, 3)
    b_st, b_rows = pass_b.scan_group_plain(st, power, trig.LOOKBACK, 2, 4.0,
                                           4, 3)
    for x, y in zip(a_rows + tuple(a_st), b_rows + tuple(b_st)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        pass_b.scan_group_kernel(st, power, trig.LOOKBACK, 2, 4.0, 4, 3)


def test_idle_rows():
    st = trig.init_state(batch=(2,), device="cpu")
    rows = pass_b.idle_rows(st, 4)
    assert [tuple(x.shape) for x in rows] == [(4, 2, 3)] * 7
    assert torch.equal(rows[0][3], st.peak) and not rows[4].any()
    assert not rows[6].any()


@pytest.mark.parametrize("batch", [1, 8, 16, 32, 64, 128])
def test_launch_plan(batch):
    """A block of 320 threads per (channel, root), no cluster; 3 blocks a
    SM in 228 KB of shared memory (1 KB each kept by the card) and in the
    register file at __launch_bounds__(320, 3): every batch up to 128
    channels (384 blocks) in one wave on 132 SMs; 256 channels in two."""
    plan = pass_b.launch_plan(batch)
    assert (plan["blocks"], plan["threads"], plan["cluster"]) == (
        3 * batch, 320, 1)
    assert plan["waves"] == 1 and plan["blocks_per_sm"] == 3
    assert 38400 < plan["smem_bytes"] <= 48 * 1024
    assert 3 * (plan["smem_bytes"] + 1024) <= 228 * 1024
    assert 3 * plan["threads"] * 64 <= 65536
    assert pass_b.launch_plan(256)["waves"] == 2


# ------------------------------------------------- on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,g,n_active", [((8,), 32, 32), ((1,), 32, 20),
                                              ((), 5, 5), ((16,), 32, 32),
                                              ((1,), 32, 32), ((16,), 32, 11),
                                              ((128,), 25, 25)])
def test_kernel_matches_plain_on_card(cuda_device, batch, g, n_active):
    """The kernel against scan_group_plain on the card, over three groups
    (acquisition, loss, reacquisition): integers exact, EMA bit for bit."""
    strong = np.array([t < 12 or t >= 22 for t in range(3 * g)])
    st_k = st_p = trig.init_state(batch=batch, device=cuda_device)
    for gi in range(3):
        power = torch.from_numpy(planted_power(
            batch, g, strong[gi * g:(gi + 1) * g], seed=gi)).to(cuda_device)
        n_act = n_active if gi == 2 else g
        st_k, rk = pass_b.scan_group_kernel(st_k, power, 832 + gi * g * HFL,
                                            n_act, 4.0, 4, 3)
        st_p, rp = pass_b.scan_group_plain(st_p, power, 832 + gi * g * HFL,
                                           n_act, 4.0, 4, 3)
        torch.cuda.synchronize()
        for i, (x, y) in enumerate(zip(rk, rp)):
            assert x.dtype == y.dtype and torch.equal(x, y), i
        for f in trig.TriggerState._fields:
            assert torch.equal(getattr(st_k, f), getattr(st_p, f)), f


@pytest.mark.cuda
def test_kernel_info_on_card(cuda_device):
    """The card holds the launch plan's 3 blocks a SM: a 128-channel group
    in one wave."""
    info = pass_b.kernel_info()
    assert info["blocks_per_sm"] >= pass_b.BLOCKS_PER_SM, info
