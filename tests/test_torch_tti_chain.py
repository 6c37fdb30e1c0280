"""Pass C's TTI soft-combining chain (ops/kernels/tti_chain.py): the port's
`_decode_candidates`, which runs it, against the JAX package's (its
`lax.scan` of `chain`, the gather path: grid0=None) on one synthetic buffer
and one set of candidates; `tti_chain_plain` against the loop it replaced,
bit for bit; the kernel's schedule in PyTorch (`schedule_model`) against
the plain version, bit for bit; the CPU entry is the plain version; the
launch plan; (marked `cuda`) the kernel against the plain version and the
schedule on a card, bit for bit.

Tolerances: verdicts, MIB fields, `n` and `cell` exact; the accumulator
within test_torch_common's llr_acc tolerance (atol 1e-6 of its largest
value: the two packages' PBCH front ends sum in other orders).  On the card
the kernel makes the plain version's one add an element with __fadd_rn, so
it is held to it bit for bit.
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltetrigger_tpu.models import trigger as jtrig
from ltetrigger_tpu.ops import cplx as jcplx
from ltetrigger_tpu_torch.ltecore import synth as tsynth
from ltetrigger_tpu_torch.models import trigger as trig
from ltetrigger_tpu_torch.ops.kernels import tti_chain as tk
from test_torch_common import assert_fields, noise, to_pair_torch

CELLS = (77, 151)        # channel 0 and 1 (roots 2 and 1)
N_FRAMES = 4             # one TTI: quarters 0-3
FRAME = 19200
OUT = ("found", "nof_prb", "nof_ports", "phich_ext", "phich_res",
       "sfn_offset", "llr_acc", "mib_n", "mib_cell")


def _buffer(rng) -> np.ndarray:
    """[2, 4 frames + 2000] complex64: channel c carries CELLS[c] at 25 PRB
    over one TTI (frame f holds PBCH quarter f) from sample 1000, in
    noise of rms 0.05."""
    rows = []
    for cid in CELLS:
        sig = np.concatenate([
            tsynth.synthesize_frame(cid, nof_prb_field=25, sfn=f, quarter=f)
            for f in range(N_FRAMES)])
        x = np.zeros(N_FRAMES * FRAME + 2000, np.complex64)
        x[1000:1000 + sig.size] = sig
        rows.append(x + noise(rng, x.size, 0.05))
    return np.stack(rows)


def _candidates(k: int, seed: int):
    """Candidates [2, 3, k] for the cell lanes and noise lanes, and a
    carried state: the cell's lane reads its subframe-0 slot 1 of frame
    j mod 4 at slot j; a fresh restart at slot 0 and at random slots
    (p 0.2), the cell id changed at slot k // 2 (and back at 3k // 4),
    the slots at and after a random count per lane invalid.  The carry
    holds a random accumulator, n in [0, 6) and the lane's cell or -1."""
    rng = np.random.default_rng(seed)
    n = _buffer(rng).shape[-1]
    start = rng.integers(0, n - 960, size=(2, 3, k))
    cell = rng.integers(0, 504, size=(2, 3, k))
    fresh = rng.random((2, 3, k)) < 0.2
    fresh[..., 0] = True
    for c, cid in enumerate(CELLS):
        r = cid % 3
        start[c, r] = 1000 + FRAME * (np.arange(k) % N_FRAMES) + 960
        cell[c, r] = cid
        cell[c, r, k // 2:(3 * k) // 4] = (cid + 3) % 504
    cnt = rng.integers(k // 2, k + 1, size=(2, 3))
    cnt[0, CELLS[0] % 3] = k                   # one lane uses every slot
    valid = np.arange(k) < cnt[..., None]
    freq = rng.uniform(-1e-4, 1e-4, size=(2, 3, k)).astype(np.float32)
    d = trig.state_to_numpy(trig.init_state(batch=(2,), device="cpu"))
    d["llr_acc"] = rng.normal(size=d["llr_acc"].shape).astype(np.float32)
    d["mib_n"] = rng.integers(0, 6, size=(2, 3)).astype(np.int32)
    d["mib_cell"] = np.where(rng.random((2, 3)) < 0.5,
                             np.array([[c] * 3 for c in CELLS]),
                             -1).astype(np.int32)
    return d, dict(cand_start=start.astype(np.int32), cand_freq=freq,
                   cand_cell=cell.astype(np.int32),
                   cand_cp=np.ones((2, 3, k), bool), cand_fresh=fresh,
                   valid=valid)


_jax_decode = jax.jit(jtrig._decode_candidates,
                      static_argnames=("combine",))


@pytest.mark.parametrize("combine", [True, False])
@pytest.mark.parametrize("k", [4, 16, 32])
def test_decode_candidates_match_jax(k, combine):
    """The port's `_decode_candidates` (the chain through `tti_chain`)
    against the JAX package's on the same buffer, candidates and carry."""
    buf = _buffer(np.random.default_rng(5))
    d, cands = _candidates(k, seed=k)
    jst = jtrig.TriggerState(**{f: jnp.asarray(v) for f, v in d.items()})
    jres = _jax_decode(jst, jcplx.from_numpy(buf),
                       *(jnp.asarray(v) for v in cands.values()),
                       combine=combine)
    st = trig.state_from_numpy(d, device="cpu")
    tc = {f: torch.from_numpy(v) for f, v in cands.items()}
    tc["cand_start"] = tc["cand_start"].to(torch.int64)
    res = trig._decode_candidates(st, to_pair_torch(buf), *tc.values(),
                                  combine=combine)
    lead = (2, 3)
    got = dict(zip(OUT, res))
    got["llr_acc"] = got["llr_acc"].reshape(lead + (12, 120))
    ref = dict(zip(OUT, jres))
    ref["llr_acc"] = np.asarray(ref["llr_acc"]).reshape(lead + (12, 120))
    row = namedtuple("Row", OUT)
    assert_fields(row(**got), row(**ref), OUT, f"k={k} combine={combine}")
    found = got["found"].numpy()
    assert found[0, CELLS[0] % 3].any() and found[1, CELLS[1] % 3].any()
    assert not found[0, (CELLS[0] + 1) % 3].any()
    # the chain was exercised: restarts and combined slots both
    assert cands["cand_fresh"].any() and (~cands["cand_fresh"]).any()
    assert (~cands["valid"]).any()


# ------------------------------------------ the plain version vs the loop --
def _loop(acc, n, cell, contrib, cand_fresh, cand_cell, valid, combine):
    """The chain as trigger._decode_candidates ran it before the kernel
    (quarters int64)."""
    ar4 = torch.arange(4, device=acc.device)
    accs, qs = [], []
    for j in range(contrib.shape[-4]):
        c_k = contrib[..., j, :, :, :]
        fresh_k, cell_k, valid_k = (cand_fresh[..., j], cand_cell[..., j],
                                    valid[..., j])
        if not combine:
            fresh_k = torch.ones_like(fresh_k)
        restart = fresh_k | (cell_k != cell)
        n_k = torch.where(restart, 0, n)
        q = torch.remainder(n_k[..., None] + ar4, 4)
        sel = torch.take_along_dim(c_k, q[..., None, :, None], dim=-2)
        acc_base = torch.where(restart[..., None, None, None], 0.0, acc)
        acc_new = torch.where((q == 0)[..., None, :, None], sel,
                              acc_base + sel)
        acc = torch.where(valid_k[..., None, None, None], acc_new, acc)
        n = torch.where(valid_k, n_k + 1, n)
        cell = torch.where(valid_k, cell_k, cell)
        accs.append(acc)
        qs.append(q)
    return torch.stack(accs, dim=-4), torch.stack(qs, dim=-2), acc, n, cell


def chain_inputs(lead: tuple, k: int, seed: int, device="cpu"):
    """Random chain inputs of lanes `lead` x K slots: LLRs with signed
    zeros among them, fresh restarts (p 0.2), cell ids from a set of two
    (changes mid-chain), a random prefix of valid slots, n in [0, 9)."""
    rng = np.random.default_rng(seed)
    contrib = rng.normal(size=lead + (k, 3, 4, 120)).astype(np.float32)
    contrib[rng.random(contrib.shape) < 0.01] = -0.0
    acc0 = rng.normal(size=lead + (3, 4, 120)).astype(np.float32)
    cell0 = rng.integers(10, 12, size=lead).astype(np.int32)
    cells = rng.integers(10, 12, size=lead + (k,)).astype(np.int32)
    arrays = (acc0, rng.integers(0, 9, size=lead).astype(np.int32), cell0,
              contrib, rng.random(lead + (k,)) < 0.2, cells,
              np.arange(k) < rng.integers(0, k + 1, size=lead + (1,)))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


@pytest.mark.parametrize("combine", [True, False])
@pytest.mark.parametrize("lead,k", [((2, 3), 4), ((5, 3), 16), ((3,), 32),
                                    ((1, 3), 1)])
def test_plain_matches_the_loop_it_replaced(lead, k, combine):
    ins = chain_inputs(lead, k, seed=k + len(lead))
    got = tk.tti_chain_plain(*ins, combine)
    ref = _loop(*ins, combine)
    assert got[1].dtype == torch.int32
    for g, r, what in zip(got, ref, ("accs", "qs", "acc", "n", "cell")):
        assert torch.equal(g, r.to(g.dtype)), what
        assert tuple(g.shape) == tuple(r.shape), what
    assert torch.equal(torch.signbit(got[0]), torch.signbit(ref[0]))


def test_cpu_entry_is_the_plain_version():
    ins = chain_inputs((2, 3), 8, seed=3)
    before = tk.launches
    got = tk.tti_chain(*ins, True)
    ref = tk.tti_chain_plain(*ins, True)
    assert tk.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_trigger_runs_the_chain_through_the_module(monkeypatch):
    """`_decode_candidates` reaches the chain through `tti_chain.tti_chain`
    (a CUDA tensor would launch the kernel there)."""
    calls = []
    real = tk.tti_chain

    def spy(*a):
        calls.append(a[3].shape)
        return real(*a)
    monkeypatch.setattr(tk, "tti_chain", spy)
    d, cands = _candidates(4, seed=1)
    tc = {f: torch.from_numpy(v) for f, v in cands.items()}
    trig._decode_candidates(trig.state_from_numpy(d, device="cpu"),
                            to_pair_torch(_buffer(np.random.default_rng(5))),
                            *tc.values(), combine=True)
    assert calls == [(2, 3, 4, 3, 4, 120)]


def test_kernel_refuses_cpu_tensors():
    ins = chain_inputs((2, 3), 4, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        tk.tti_chain_kernel(*ins, True)


@pytest.mark.parametrize("combine", [True, False])
@pytest.mark.parametrize("lead,k,sms", [((1, 3), 4, 132), ((1, 3), 16, 132),
                                        ((1, 3), 32, 132), ((16, 3), 4, 132),
                                        ((16, 3), 16, 132),
                                        ((16, 3), 32, 132), ((16, 3), 16, 1),
                                        ((7,), 40, 132), ((7,), 40, 1)])
def test_schedule_model_matches_plain(lead, k, sms, combine):
    """The kernel's schedule in PyTorch (lane split, ballots, the valid
    slots' loads `depth` ahead) against the plain version, bit for bit;
    sms=1 takes the four-warp launch (4 slots in flight), K=40 two chunks
    of slot scalars."""
    ins = chain_inputs(lead, k, seed=k + len(lead) + 2 * combine)
    got = tk.schedule_model(*ins, combine, sms=sms)
    ref = tk.tti_chain_plain(*ins, combine)
    for g, r, what in zip(got, ref, ("accs", "qs", "acc", "n", "cell")):
        assert g.dtype == r.dtype and torch.equal(g, r), what
    assert torch.equal(torch.signbit(got[0]), torch.signbit(ref[0]))


def test_schedule_model_wraps_the_count_as_int32():
    """n near 2^31 wraps in both; the quarters follow the low two bits."""
    ins = list(chain_inputs((4, 3), 20, seed=3))
    ins[1] = torch.full_like(ins[1], 2 ** 31 - 3)
    ins[4][:] = False
    ins[5][:] = ins[2][..., None]
    ins[6][:] = True
    got = tk.schedule_model(*ins, True)
    ref = tk.tti_chain_plain(*ins, True)
    assert int(ref[3].max()) < 0
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_launch_plan():
    """One-warp blocks (32 slots in flight) while they fit one wave at 8
    a SM, four-warp blocks (4 in flight) past it; 12 warps a lane."""
    plan = tk.launch_plan(3)
    assert plan["threads"] == 32 and plan["blocks"] == 36
    assert plan["depth"] == 32 and not plan["wide"] and plan["waves"] == 1
    assert tk.launch_plan(48)["blocks"] == 576
    assert not tk.launch_plan(88)["wide"] and tk.launch_plan(89)["wide"]
    plan = tk.launch_plan(384)
    assert plan["wide"] and plan["threads"] == 128 and plan["depth"] == 4
    assert plan["blocks"] == 1152 and plan["blocks_per_sm"] == 9
    assert plan["waves"] == 1 and plan["smem_bytes"] == 0
    assert tk.launch_plan(397)["waves"] == 2


# ------------------------------------------------- on a card (marker cuda) --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("combine", [True, False])
@pytest.mark.parametrize("lead,k", [((128, 3), 16), ((16, 3), 16),
                                    ((1, 3), 4), ((1, 3), 32), ((7,), 40)])
def test_kernel_matches_plain_on_card(cuda_device, lead, k, combine):
    """Bit for bit: accs, qs, the accumulator, n and cell, against the
    plain version and against the kernel's schedule in PyTorch."""
    ins = chain_inputs(lead, k, seed=k, device=cuda_device)
    got = tk.tti_chain_kernel(*ins, combine)
    ref = tk.tti_chain_plain(*ins, combine)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    model = tk.schedule_model(*ins, combine, sms=sms)
    torch.cuda.synchronize()
    for g, r, m, what in zip(got, ref, model, ("accs", "qs", "acc", "n",
                                               "cell")):
        assert g.dtype == r.dtype and torch.equal(g, r), what
        assert torch.equal(g, m), what
    assert torch.equal(torch.signbit(got[0]), torch.signbit(ref[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [3, 384])
def test_kernel_info_on_card(cuda_device, lanes):
    """Both launch shapes: no spill, no shared memory, the blocks a SM
    their launch plan counts on."""
    plan = tk.launch_plan(lanes)
    info = tk.kernel_info(lanes)
    assert info["local_bytes"] == 0, info
    assert info["blocks_per_sm"] >= plan["blocks_per_sm"], info
    assert info["smem_bytes"] == plan["smem_bytes"], info
