"""Batched tail-biting Viterbi decoders (K=7, rate 1/3).

Port of ltetrigger_tpu/ops/viterbi.py.

  * `viterbi_decode_wa` (what the engine runs): the 40-symbol LLR block is
    replicated 3x and one 64-state trellis runs over the 120 symbols, two
    trellis stages per step (radix-4, 60 serial steps); the middle copy's
    decisions are the output, carried by register exchange.
  * `viterbi_decode_tb`: exact maximum-likelihood tail-biting decode, the
    64 possible initial states as a batch dimension and a traceback over
    the stored decisions.  64x the state-metric traffic of `_wa`: the golden
    reference of the tests, and for small offline batches.

The JAX decoder keeps the 40 survivor bits in a uint32 plus a uint8
register; PyTorch's unsigned shifts are partial, so here one int64 register
holds all 40 bits.  The decoded bits are identical.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ltecore import coding

N_STATES = coding.N_STATES


@functools.lru_cache(maxsize=None)
def _tables():
    prev_state, out_bits = coding.trellis_tables()
    return (np.asarray(prev_state, dtype=np.int32),
            np.asarray(out_bits, dtype=np.float32))


@functools.lru_cache(maxsize=None)
def _trellis_on(device: str):
    prev_state, out_bits = _tables()
    return (torch.from_numpy(prev_state.astype(np.int64)).to(device),
            torch.from_numpy(out_bits).to(device))


def viterbi_decode_tb(llr: torch.Tensor):
    """Exact tail-biting decode.

    llr: [B, 40, 3] float32 — +1 favours bit 0 (matches out_bits polarity).
    returns: (bits [B, 40] int32, metric [B] float32)
    """
    prev_state, out_bits = _trellis_on(str(llr.device))   # [64, 2], [64, 2, 3]
    B, n = llr.shape[0], llr.shape[1]
    dev = llr.device
    # m[b, i, s]: best metric of a path from initial state i to state s
    m = ((torch.eye(N_STATES, device=dev) - 1.0) * 1e9) \
        .expand(B, N_STATES, N_STATES)
    decisions = []
    for t in range(n):
        br = torch.einsum("sdc,bc->bsd", out_bits, llr[:, t])   # [B, 64, 2]
        cand = m[:, :, prev_state] + br[:, None]                # [B, I, S, 2]
        decisions.append(torch.argmax(cand, dim=-1))
        m = cand.amax(dim=-1)
    diag = torch.diagonal(m, dim1=1, dim2=2)                    # [B, I]
    best_init = torch.argmax(diag, dim=-1)                      # [B]
    metric = diag.amax(dim=-1)

    bidx = torch.arange(B, device=dev)
    s = best_init
    bits = []
    for dec in reversed(decisions):
        bits.append((s >> 5) & 1)
        s = prev_state[s, dec[bidx, best_init, s]]
    return torch.stack(bits[::-1], dim=1).to(torch.int32), metric


@functools.lru_cache(maxsize=None)
def _radix4_tables():
    """Two trellis stages fused (radix-4 ACS): for new state ns and
    j = (drop_last << 1) | drop_first, the two-step predecessor is
    pp = 4*(ns & 15) + j, with branch symbols OB2[ns, j, 0:3] = first
    transition, [3:6] = second, and the two survivor bits
    BITS2[ns, j] = (bit(ps1) << 1) | bit(ns)."""
    prev_np, out_np = _tables()
    OB2 = np.zeros((N_STATES, 4, 6), dtype=np.float32)
    BITS2 = np.zeros((N_STATES, 4), dtype=np.uint32)
    for ns in range(N_STATES):
        for d0 in range(2):                     # last transition's drop
            ps1 = int(prev_np[ns, d0])
            for d1 in range(2):                 # first transition's drop
                j = (d0 << 1) | d1
                pp = int(prev_np[ps1, d1])
                assert pp == 4 * (ns & 15) + j  # the static tile layout
                OB2[ns, j, 0:3] = out_np[ps1, d1]
                OB2[ns, j, 3:6] = out_np[ns, d0]
                BITS2[ns, j] = ((ps1 >> 5) << 1) | (ns >> 5)
    return OB2, BITS2


@functools.lru_cache(maxsize=None)
def _tables_on(device: str):
    OB2, BITS2 = _radix4_tables()
    return (torch.from_numpy(OB2).to(device),
            torch.from_numpy(BITS2.astype(np.int64)).to(device))


def viterbi_decode_wa(llr: torch.Tensor):
    """Wrap-around tail-biting decode, radix-4, in three phases:

      phase 1 (symbols   0..39): ACS only;
      phase 2 (symbols  40..79): ACS + register-exchange recording, 2 bits
              a step into the survivor register (20 steps = the 40 bits);
      phase 3 (symbols 80..119): ACS + register exchange only.

    llr: [B, 40, 3] float32 — +1 favours bit 0.
    returns: (bits [B, 40] int32, metric [B] float32)
    """
    OB2, BITS2 = _tables_on(str(llr.device))
    B, n = llr.shape[0], llr.shape[1]
    assert n == 40, "wrap-around layout is sized for the 40-bit PBCH block"
    r6 = torch.cat([llr, llr, llr], dim=1).reshape(B, 3 * n // 2, 6)
    # predecessors of state ns are 4*(ns & 15) + j: the [B, 16, 4] metric
    # tile repeated for the 4 successor quarters
    pred = (4 * (torch.arange(N_STATES, device=llr.device) & 15)[:, None]
            + torch.arange(4, device=llr.device))              # [64, 4]

    def acs(m, r_t):
        br = torch.einsum("njc,bc->bnj", OB2, r_t)             # [B, 64, 4]
        cand = m[:, pred] + br
        dec = torch.argmax(cand, dim=-1)                       # [B, 64]
        return cand.amax(dim=-1), dec

    def exchange(reg, dec):
        return torch.take_along_dim(reg[:, pred], dec[..., None],
                                    dim=-1)[..., 0]

    m = torch.zeros((B, N_STATES), device=llr.device)
    for t in range(20):
        m, _ = acs(m, r6[:, t])
    reg = torch.zeros((B, N_STATES), dtype=torch.int64, device=llr.device)
    bits2 = BITS2.expand(B, N_STATES, 4)
    for t in range(20, 40):
        m, dec = acs(m, r6[:, t])
        new_bits = torch.take_along_dim(bits2, dec[..., None], dim=-1)[..., 0]
        reg = (exchange(reg, dec) << 2) | new_bits
    for t in range(40, 60):
        m, dec = acs(m, r6[:, t])
        reg = exchange(reg, dec)

    best = torch.argmax(m, dim=-1)
    metric = m.amax(dim=-1) / 3.0
    word = reg[torch.arange(B, device=llr.device), best]
    # middle-copy symbol 40 + i was recorded at register bit 39 - i
    shift = 2 * n - 1 - (torch.arange(n, device=llr.device) + n)
    bits = (word[:, None] >> shift[None, :]) & 1
    return bits.to(torch.int32), metric
