"""Parity of the PyTorch port's grid engine (ltetrigger_tpu_torch.models.
trigger) with the JAX package's, on the CPU: passes A+B field for field,
the whole scan_engine for one channel and for a batch of two, the
capture-overflow case, and a carry handed over from JAX to the port.

Integer and boolean fields must match exactly.  Float fields: PSR rtol 1e-4
(a ratio of correlation powers that agree to rtol 1e-4 / atol 1e-5, see
test_torch_ops), the CFO mean atol 1e-4 subcarriers, the EMA'd power rtol
1e-4 / atol 1e-5, the TTI LLR accumulator atol 1e-6 of its largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltetrigger_tpu.models import trigger as jtrig
from ltetrigger_tpu.ops import cplx as jcplx
from ltetrigger_tpu_torch.models import trigger as trig
from test_torch_common import (acq_loss_reacq, engine_buffer, frames,
                               noise, to_pair_torch)
from test_torch_common import assert_fields as _assert_fields

# one compile per (shape, n_steps, track_after, track_every), shared by tests
_jax_engine = jax.jit(jtrig.scan_engine, static_argnums=(2, 4, 5))


def _buffers(sig: np.ndarray):
    buf = engine_buffer(sig, trig.LOOKBACK, trig.WINDOW)
    return jcplx.from_numpy(buf), to_pair_torch(buf)


def _jax_batched_state(c: int):
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (c,) + x.shape), jtrig.init_state())


def test_passes_a_b_acquire_lose_reacquire():
    """RawStepOutput field for field over acquisition, loss (loud noise)
    and reacquisition, with a short hysteresis (track_after=4,
    track_every=2) so all three happen in 30 steps."""
    sig = acq_loss_reacq(152)
    jb, tb = _buffers(sig)
    jst, jraw = jtrig.scan_pass(jb, jtrig.init_state(), 30, 4.0, 4, 2)
    st, raw = trig.scan_pass(tb, trig.init_state(device="cpu"), 30, 4.0, 4, 2)
    emit = np.asarray(jraw.emit)
    assert np.asarray(jraw.tracking).any() and np.asarray(jraw.lost).any()
    assert np.asarray(jraw.tracking)[-1].any(), "must reacquire"
    _assert_fields(raw, jraw, trig.RawStepOutput._fields, "raw")
    assert emit.sum() > 10
    _assert_fields(st, jst, trig.TriggerState._fields[:10], "state")


@pytest.mark.parametrize("chunks", [(15, 15), (30,)])
def test_scan_engine_one_channel(chunks):
    """Whole engine: StepOutput field for field, one dispatch of 30 steps
    or two of 15 with the carry passed between them."""
    sig = acq_loss_reacq(301)
    jb, tb = _buffers(sig)
    jst, st = jtrig.init_state(), trig.init_state(device="cpu")
    published = False
    for n in chunks:
        jst, jout = _jax_engine(jb, jst, n, 4.0, 4, 2)
        st, out = trig.scan_engine(tb, st, n, 4.0, 4, 2)
        _assert_fields(out, jout, trig.StepOutput._fields, f"out[{n}]")
        published |= bool(np.asarray(jout.track_event).any())
    assert published
    _assert_fields(st, jst, trig.TriggerState._fields, "state")


def test_scan_engine_batched_two_channels():
    """A [C=2] buffer: an extended-CP 2-port cell beside a normal-CP cell
    that fades into noise."""
    rng = np.random.default_rng(4)
    a = frames(302, 8, nof_prb_field=25, normal_cp=False, nof_ports=2)
    b = np.concatenate([frames(40, 4, nof_prb_field=100),
                        noise(rng, 4 * 19200, 3.0)])
    sig = np.stack([a, b]) + noise(rng, 2 * a.size, 0.1).reshape(2, -1)
    buf = np.stack([engine_buffer(x, trig.LOOKBACK, trig.WINDOW)
                    for x in sig.astype(np.complex64)])
    jb, tb = jcplx.from_numpy(buf), to_pair_torch(buf)
    jst, jout = _jax_engine(jb, _jax_batched_state(2), 16, 4.0, 4,
                             2)
    st, out = trig.scan_engine(tb, trig.init_state(batch=(2,), device="cpu"),
                               16, 4.0, 4, 2)
    assert np.asarray(jout.track_event)[:, 0].any()
    assert np.asarray(jout.track_event)[:, 1].any()
    _assert_fields(out, jout, trig.StepOutput._fields, "out")
    _assert_fields(st, jst, trig.TriggerState._fields, "state")


def _hostile_burst(cell_id: int, n_bad: int, n_good: int):
    """`n_bad` PBCH-corrupted + `n_good` clean copies of one subframe-0
    half-frame: every half-frame tags a MIB capture."""
    from ltetrigger_tpu.ltecore import synth
    rng = np.random.default_rng(3)
    half = synth.synthesize_frame(cell_id, nof_prb_field=50)[:9600]
    bad = half.copy()
    bad[960:1920] = 0.2 * (rng.normal(size=960) + 1j * rng.normal(size=960))
    return np.concatenate([np.tile(bad, n_bad), np.tile(half, n_good)]) \
        .astype(np.complex64)


@pytest.mark.parametrize("bad,good,chunks", [(20, 5, (25, 4)),
                                             (40, 0, (40,))])
def test_capture_overflow(bad, good, chunks):
    """tests/test_trigger.py's hostile bursts, where every step wants a MIB
    capture: 25 then silence (a slot per step, all decode in-dispatch), and
    one 40-step dispatch (K_CANDIDATES slots, the rest counted in
    cap_overflow)."""
    sig = np.concatenate([_hostile_burst(151, bad, good),
                          np.zeros(4 * 9600, np.complex64)])
    jb, tb = _buffers(sig)
    jst, st = jtrig.init_state(), trig.init_state(device="cpu")
    for n in chunks:
        jst, jout = _jax_engine(jb, jst, n, 4.0, 16, 8)
        st, out = trig.scan_engine(tb, st, n, 4.0, 16, 8)
        _assert_fields(out, jout, trig.StepOutput._fields, f"out[{n}]")
    if good:
        assert np.asarray(jst.mib_n).max() > 16
    else:
        assert np.asarray(jst.cap_overflow).max() > 0
    _assert_fields(st, jst, trig.TriggerState._fields, "state")


def test_carry_from_jax_continues_in_port():
    """Chunk 1 runs in JAX; its carry goes through state_from_numpy; chunk
    2 runs in both packages and agrees.  state_to_numpy round-trips."""
    sig = acq_loss_reacq(77)
    jb, tb = _buffers(sig)
    jst, _ = _jax_engine(jb, jtrig.init_state(), 15, 4.0, 4, 2)
    d = {f: np.asarray(getattr(jst, f)) for f in jtrig.TriggerState._fields}
    st = trig.state_from_numpy(d, device="cpu")
    back = trig.state_to_numpy(st)
    for f in d:
        assert back[f].dtype == d[f].dtype
        np.testing.assert_array_equal(back[f], d[f])
    jst2, jout = _jax_engine(jb, jst, 15, 4.0, 4, 2)
    st2, out = trig.scan_engine(tb, st, 15, 4.0, 4, 2)
    assert np.asarray(jout.track_event).any() \
        or np.asarray(jout.drop_event).any()
    _assert_fields(out, jout, trig.StepOutput._fields, "out")
    _assert_fields(st2, jst2, trig.TriggerState._fields, "state")


def test_pack_output_roundtrip():
    sig = acq_loss_reacq(152)
    _, tb = _buffers(sig)
    _, out = trig.scan_engine(tb, trig.init_state(device="cpu"), 10, 4.0, 4, 2)
    packed = trig.pack_output(out)
    assert packed.shape == (10, 3, 15) and packed.dtype == torch.float32
    back = trig.unpack_output(packed)
    for f in trig.StepOutput._fields:
        np.testing.assert_array_equal(back[trig.StepOutput._fields.index(f)],
                                      getattr(out, f).numpy())


def _edge_packed(lead, seed):
    """A packed output of leading shape `lead` holding every edge value:
    ints -1 / 0 / 503 / 1020, psr and cfo_mean NaN / +-inf / -0.0 beside
    plain values, bools 0.0 / 1.0."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead))
    cols = []
    for f in trig.StepOutput._fields:
        if f in trig._BOOL_FIELDS:
            vals = [0.0, 1.0]
        elif f in trig._F32_FIELDS:
            vals = [np.nan, np.inf, -np.inf, -0.0, 0.0, 4.75, -1.5e-3]
        else:
            vals = [-1, 0, 503, 1020]
        cols.append(rng.permutation(np.resize(np.float32(vals), n)))
    return torch.from_numpy(np.stack(cols, axis=-1).reshape(lead + (15,)))


@pytest.mark.parametrize("lead", [(8, 3), (8, 5, 3), (8, 2, 5, 3), (0, 3)])
def test_split_fields_views_equal_the_host_split(lead):
    """unpack_output of a numpy array and of a CPU tensor, and the card's
    split (split_fields, run here on the CPU) read back as views
    (field_views), each equal the JAX package's unpack_output of the same
    packed array byte for byte, in dtype and shape, NaN / +-inf / -0.0
    included; the array and the tensor take the host path."""
    packed = _edge_packed(lead, sum(lead))
    want = jtrig.unpack_output(packed.numpy())._asdict()
    paths = dict(trig.readback_paths)
    from_array = trig.unpack_output(packed.numpy())
    from_tensor = trig.unpack_output(packed)
    assert trig.readback_paths["host"] == paths.get("host", 0) + 2
    assert trig.readback_paths["device"] == paths.get("device", 0)
    buf = trig.split_fields(packed)
    n = int(np.prod(lead))
    assert buf.dtype == torch.uint8 and buf.shape == (48 * n,)
    got = trig.field_views(buf.numpy(), lead)
    if n:
        assert np.isnan(want["psr"]).any()
        assert np.isinf(want["cfo_mean"]).any()
        assert np.signbit(want["psr"][want["psr"] == 0]).any()
    for f, g, a, t in zip(trig.StepOutput._fields, got, from_array,
                          from_tensor):
        w = want[f]
        for x in (g, a, t):
            assert x.dtype == w.dtype and x.shape == w.shape == lead, f
            assert x.tobytes() == w.tobytes(), f
