"""The engine surface the PyTorch port's example tools need, on the CPU,
against the JAX package:

- `_mib_postpass(do_extract=, do_decode=)` against the JAX function on a
  C=2, S=8 dispatch (the JAX passes run in one jit, as its `scan_engine`
  runs them): integers exact, floats within test_torch_common's FLOAT_TOL
  (rtol 1e-4 / atol 1e-5 and kin); the named host reads "emit" and
  "capture" counted only where no override is given;
- the `cplx` helpers the port lacked (`to_numpy`, `neg`, `sum`, `take`,
  `concat`), against JAX `cplx`.

The example tools themselves are in test_torch_examples_tools.py and
test_torch_examples_spawn.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltetrigger_tpu.models import trigger as jtrig
from ltetrigger_tpu.ops import cplx as jcplx
from ltetrigger_tpu_torch.models import trigger as trig
from ltetrigger_tpu_torch.ops import cplx
from test_torch_common import (assert_fields, engine_buffer, frames, noise,
                               to_pair_torch)


# ------------------------------------------------- pass C's gate overrides --
def _dispatch(kind: str):
    """[2, LOOKBACK + 8 half-frames + WINDOW] + the 8 x 9600 + 640 zeros
    scan_engine pads a dispatch with: a 25-PRB cell beside noise ("cell"),
    or noise in both channels ("noise")."""
    rng = np.random.default_rng(61)
    rows = []
    for c in range(2):
        x = noise(rng, 4 * 19200, 0.1 if kind == "cell" else 1.0)
        if kind == "cell" and c == 0:
            x = x + frames(77, 4, nof_prb_field=25)
        rows.append(engine_buffer(x.astype(np.complex64), trig.LOOKBACK,
                                  trig.WINDOW + 8 * 9600 + trig._PAD_TAIL))
    return np.stack(rows)


@functools.partial(jax.jit, static_argnames=("data_valid", "do_extract",
                                             "do_decode"))
def _jax_dispatch(buffer, state0, data_valid, do_extract, do_decode):
    """The JAX passes A+B and `_mib_postpass` in one jit, as JAX
    `scan_engine` runs them."""
    final, raw = jtrig.scan_pass(buffer, state0, 8, 4.0,
                                 grid0_static=trig.LOOKBACK)
    return raw, jtrig._mib_postpass(state0, final, raw, buffer,
                                    data_valid=data_valid,
                                    do_extract=do_extract,
                                    do_decode=do_decode)


@pytest.mark.parametrize("kind,do_extract,do_decode", [
    ("cell", None, None), ("cell", True, True), ("cell", True, False),
    ("cell", False, None), ("noise", True, True), ("noise", True, None)])
def test_mib_postpass_overrides_match_jax(kind, do_extract, do_decode):
    buf = _dispatch(kind)
    n = buf.shape[-1]
    jb, tb = jcplx.from_numpy(buf), to_pair_torch(buf)
    jst0 = jtrig.TriggerState(*(jnp.broadcast_to(x, (2,) + x.shape)
                                for x in jtrig.init_state()))
    jraw, (jst, jout) = _jax_dispatch(jb, jst0, n, do_extract, do_decode)
    st0 = trig.init_state(batch=(2,), device="cpu")
    fin, raw = trig.scan_pass(tb, st0, 8, 4.0, grid0=trig.LOOKBACK)
    trig.host_syncs.clear()
    st, out = trig._mib_postpass(st0, fin, raw, tb, n, do_extract=do_extract,
                                 do_decode=do_decode)
    assert_fields(out, jout, trig.StepOutput._fields, "out")
    assert_fields(st, jst, trig.TriggerState._fields, "state")
    emitted = bool(np.asarray(jraw.emit).any())
    assert emitted == (kind == "cell")
    extract = emitted if do_extract is None else do_extract
    assert trig.host_syncs["emit"] == (do_extract is None)
    assert trig.host_syncs["capture"] == (extract and do_decode is None)
    if kind == "cell" and do_extract is not False and do_decode is not False:
        assert np.asarray(jout.track_event).any()     # the decode ran
    if kind == "cell" and do_extract is False:
        assert not out.track_event.any()


# --------------------------------------------------------- cplx helpers ----
def _pairs():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 4, 5)) + 1j * rng.normal(size=(3, 4, 5))) \
        .astype(np.complex64)
    return x, jcplx.from_numpy(x), cplx.from_numpy(x, device="cpu")


@pytest.mark.parametrize("what", ["to_numpy", "neg", "sum_all", "sum_dim",
                                  "take_last", "take_dim1", "concat"])
def test_cplx_helpers_match_jax(what):
    x, jp, tp = _pairs()
    idx = np.array([[4, 0], [2, 2]])
    if what == "to_numpy":
        got, ref = cplx.to_numpy(tp), jcplx.to_numpy(jp)
        assert got.dtype == ref.dtype == np.complex64
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, x)
        return
    got, ref = {
        "neg": lambda: (cplx.neg(tp), jcplx.neg(jp)),
        "sum_all": lambda: (cplx.sum(tp), jcplx.sum(jp)),
        "sum_dim": lambda: (cplx.sum(tp, dim=1), jcplx.sum(jp, axis=1)),
        "take_last": lambda: (cplx.take(tp, torch.from_numpy(idx)),
                              jcplx.take(jp, jnp.asarray(idx))),
        "take_dim1": lambda: (cplx.take(tp, torch.tensor([3, 1]), dim=1),
                              jcplx.take(jp, jnp.asarray([3, 1]), axis=1)),
        "concat": lambda: (cplx.concat([tp, cplx.neg(tp)], dim=2),
                           jcplx.concat([jp, jcplx.neg(jp)], axis=2)),
    }[what]()
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape, what
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
