"""PBCH/MIB decoder on (re, im) pairs, batched over leading dims.

Port of ltetrigger_tpu/ops/pbch.py: OFDM demodulation as a [72, 128] DFT
matmul per symbol, CRS channel estimation with linear frequency
interpolation, MRC / SFBC / SFBC-FSTD combining under the 1, 2 and 4 port
hypotheses, descrambling, rate dematching into the 4 TTI quarters, then the
Viterbi + CRC/port-mask codeword search.  The JAX package selects the
cell-dependent CRS and PBCH resource elements with one-hot matmuls (TPU
gathers are slow); here they are plain indexing, with the index tables
derived from the same selection matrices.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ltecore import coding, scrambling
from ..ltecore.constants import (NOF_PRB_TABLE, SLOT_LENGTH, SYMBOL_SZ,
                                 symbol_data_offsets)
from . import cplx, dft
from .viterbi import viterbi_decode_wa

N_RB_MAX = 110
E_BITS = {True: 480, False: 432}


# --------------------------------------------------------------- static maps
@functools.lru_cache(maxsize=None)
def _gold_mats(length: int):
    G, x1c = scrambling.gold_matrix(length)
    return G.astype(np.float32), x1c.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dematch_onehot(normal_cp: bool) -> np.ndarray:
    """[4, e_bits, 120] one-hot scatter matrices, one per quarter."""
    e = E_BITS[normal_cp]
    m = coding.ratematch_map(40, 4 * e)
    out = np.zeros((4, e, 120), dtype=np.float32)
    for q in range(4):
        seg = m[q * e:(q + 1) * e]
        out[q, np.arange(e), seg] = 1.0
    return out


@functools.lru_cache(maxsize=None)
def _crc_matrix() -> np.ndarray:
    """[16, 24] GF(2) matrix: crc16(payload) = C @ payload mod 2."""
    C = np.zeros((16, 24), dtype=np.float32)
    for i in range(24):
        b = np.zeros(24, dtype=np.uint8)
        b[i] = 1
        C[:, i] = coding.crc16(b)
    return C


@functools.lru_cache(maxsize=None)
def _crc_masks() -> np.ndarray:
    """[3, 16] port masks for 1/2/4 ports."""
    out = np.zeros((3, 16), dtype=np.float32)
    for row, ports in enumerate(coding.PORT_HYPOTHESES):
        mask = coding.CRC_MASKS[ports]
        out[row] = [(mask >> (15 - i)) & 1 for i in range(16)]
    return out


@functools.lru_cache(maxsize=None)
def _crs_interp_mats() -> np.ndarray:
    """[6, 12, 72] float32 (the JAX package's `_crs_sel_mats()[1]`): for
    CRS offset v, the exact linear-interp-with-flat-extrapolation map from
    the 12 pilots (k = v + 6m) to the 72 subcarriers."""
    W = np.zeros((6, 12, 72), dtype=np.float32)
    for v in range(6):
        j = np.arange(72)
        t = (j - v) / 6.0
        mf = np.clip(np.floor(t), 0, 10).astype(int)
        fr = np.clip(t - mf, 0.0, 1.0)
        mh = np.minimum(mf + 1, 11)
        for jj in range(72):
            W[v, mf[jj], jj] += 1.0 - fr[jj]
            W[v, mh[jj], jj] += fr[jj]
    return W


@functools.lru_cache(maxsize=None)
def _pbch_sel_mats(normal_cp: bool):
    """(P [3, 288, E], K72 [3, 72, E]) float32 selection matrices per
    v3 = cell_id mod 3: P maps the flattened 4x72 PBCH symbol grid to the E
    used REs (frequency-first order; CRS-reserved symbols skip k % 3 == v3:
    k_j = 3*(j//2) + (a if j even else b) with {a,b} = {0,1,2}\\{v3}); K72
    maps a 72-subcarrier channel estimate to the same E positions."""
    e = E_BITS[normal_cp] // 2
    crs_syms = (0, 1) if normal_cp else (0, 1, 3)
    P = np.zeros((3, 4 * 72, e), dtype=np.float32)
    K72 = np.zeros((3, 72, e), dtype=np.float32)
    for v3 in range(3):
        ab = [x for x in (0, 1, 2) if x != v3]
        idx = 0
        for l in range(4):
            if l in crs_syms:
                ks = [3 * (j // 2) + ab[j % 2] for j in range(48)]
            else:
                ks = list(range(72))
            for k in ks:
                P[v3, l * 72 + k, idx] = 1.0
                K72[v3, k, idx] = 1.0
                idx += 1
        assert idx == e
    return P, K72


@functools.lru_cache(maxsize=None)
def _tables(normal_cp: bool, device: str):
    """Device tables: PBCH RE index maps [3, E] into the 288-grid and into
    the 72 subcarriers, the CRS interpolation maps [6, 12, 72] and the
    dematching one-hots."""
    P, K72 = _pbch_sel_mats(normal_cp)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"re_idx": t(P.argmax(axis=1).astype(np.int64)),
            "k_idx": t(K72.argmax(axis=1).astype(np.int64)),
            "interp": t(_crs_interp_mats()),
            "dematch": t(_dematch_onehot(normal_cp))}


@functools.lru_cache(maxsize=None)
def _decode_tables(device: str):
    """Device tables of the codeword search, uploaded once per device (a
    copy from pageable memory per call would make every decoding dispatch
    wait for the stream): the CRC matrix [16, 24], the port masks of the 12
    hypotheses [12, 16], the MIB's bandwidth table [8] and the port count
    of each hypothesis [12]."""
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)
    return {"crc": t(_crc_matrix(), np.float32),
            "masks": t(np.repeat(_crc_masks(), 4, axis=0), np.float32),
            "prb": t(list(NOF_PRB_TABLE) + [0, 0], np.int32),
            "ports": t(_PORTS_OF, np.int32)}


@functools.lru_cache(maxsize=None)
def _gold_on(length: int, device: str):
    return tuple(torch.from_numpy(a).to(device) for a in _gold_mats(length))


def _gold_signs(c_init: torch.Tensor, length: int) -> torch.Tensor:
    """(+1/-1)^c(n) for integer c_init [...] -> [..., length] float32: one
    [31] @ [31, length] GF(2) product + parity per element."""
    G, x1c = _gold_on(length, str(c_init.device))
    sh = torch.arange(31, device=c_init.device)
    bits = ((c_init.to(torch.int64)[..., None] >> sh) & 1).to(torch.float32)
    c = torch.remainder(bits @ G.T + x1c, 2.0)
    return 1.0 - 2.0 * c


# ------------------------------------------------------------------- OFDM --
def ofdm_demod_slot(slot: cplx.Pair, normal_cp: bool) -> cplx.Pair:
    """pair of [..., 960] -> pair of [..., nsym, 72] (6 PRB grid)."""
    offs = symbol_data_offsets(normal_cp)
    wins = cplx.stack(
        [cplx.index(slot, (..., slice(o, o + SYMBOL_SZ))) for o in offs],
        dim=-2)
    return dft.dft_grid(wins)


# ------------------------------------------------------------------ chest --
def _crs_pilots(cell_id: torch.Tensor, slot_no: int, sym: int,
                normal_cp: bool) -> cplx.Pair:
    """pair of [..., 12] pilots for the centered 6 PRB."""
    c_init = scrambling.crs_c_init(cell_id.to(torch.int64), slot_no, sym,
                                   normal_cp)
    signs = _gold_signs(c_init, 4 * N_RB_MAX)
    m = torch.arange(12, device=cell_id.device) + (N_RB_MAX - 6)
    return (signs[..., 2 * m] / math.sqrt(2.0),
            signs[..., 2 * m + 1] / math.sqrt(2.0))


def _crs_v(port: int, sym: int, slot_no: int) -> int:
    if port == 0:
        return 0 if sym == 0 else 3
    if port == 1:
        return 3 if sym == 0 else 0
    if port == 2:
        return 3 * (slot_no % 2)
    return 3 + 3 * (slot_no % 2)


def _chest_port(slot_syms: cplx.Pair, cell_id: torch.Tensor, slot_no: int,
                port: int, normal_cp: bool) -> cplx.Pair:
    """pair of [..., 72]: LS estimate at the port's CRS, linearly
    interpolated over frequency (flat extrapolation), averaged over the
    port's CRS symbols.  slot_syms: pair of [..., nsym, 72]."""
    if port in (0, 1):
        crs_syms = (0, 4) if normal_cp else (0, 3)
    else:
        crs_syms = (1,)
    dev = cell_id.device
    interp = _tables(normal_cp, str(dev))["interp"]
    v_shift = torch.remainder(cell_id.to(torch.int64), 6)
    acc = None
    for sym in crs_syms:
        pil = _crs_pilots(cell_id, slot_no, sym, normal_cp)
        k0 = torch.remainder(v_shift + _crs_v(port, sym, slot_no), 6)
        ks = k0[..., None] + 6 * torch.arange(12, device=dev)   # [..., 12]
        y = (torch.take_along_dim(slot_syms[0][..., sym, :], ks, dim=-1),
             torch.take_along_dim(slot_syms[1][..., sym, :], ks, dim=-1))
        h = cplx.div_real(cplx.mul_conj(y, pil), cplx.abs2(pil))
        Wk = interp[k0]                                        # [.., 12, 72]
        h72 = ((h[0][..., None, :] @ Wk)[..., 0, :],
               (h[1][..., None, :] @ Wk)[..., 0, :])
        acc = h72 if acc is None else cplx.add(acc, h72)
    return cplx.scale(acc, 1.0 / len(crs_syms))


# ---------------------------------------------------------------- equalize --
# MRC weighting (conj(h)*y, no division by |h|^2): each RE is weighted by its
# channel confidence in the Viterbi metric.
def _sfbc(y: cplx.Pair, g0: cplx.Pair, g1: cplx.Pair) -> cplx.Pair:
    """Alamouti SFBC combine over adjacent RE pairs."""
    y0 = cplx.index(y, (..., slice(0, None, 2)))
    y1 = cplx.index(y, (..., slice(1, None, 2)))
    a0 = cplx.index(g0, (..., slice(0, None, 2)))
    a1 = cplx.index(g1, (..., slice(0, None, 2)))
    x0 = cplx.add(cplx.mul(cplx.conj(a0), y0), cplx.mul(a1, cplx.conj(y1)))
    x1 = cplx.sub(cplx.mul(cplx.conj(a0), y1), cplx.mul(a1, cplx.conj(y0)))
    re = torch.stack([x0[0], x1[0]], dim=-1).reshape(y[0].shape)
    im = torch.stack([x0[1], x1[1]], dim=-1).reshape(y[1].shape)
    return (re, im)


def _equalize(y: cplx.Pair, h: list, nof_ports: int) -> cplx.Pair:
    """y pair [..., E]; h = list of 4 per-port pairs [..., E] -> symbols."""
    if nof_ports == 1:
        return cplx.mul_conj(y, h[0])
    if nof_ports == 2:
        return _sfbc(y, h[0], h[1])
    # 4 ports: SFBC-FSTD on groups of 4; pairs (0,2) on REs {0,1} and
    # (1,3) on REs {2,3} of each group
    e = y[0].shape[-1]
    sh = y[0].shape[:-1]

    def grp(p, sel):
        r = p[0].reshape(sh + (e // 4, 4))[..., sel].reshape(sh + (e // 2,))
        i = p[1].reshape(sh + (e // 4, 4))[..., sel].reshape(sh + (e // 2,))
        return (r, i)

    first = slice(0, 2)
    second = slice(2, 4)
    d02 = _sfbc(grp(y, first), grp(h[0], first), grp(h[2], first))
    d13 = _sfbc(grp(y, second), grp(h[1], second), grp(h[3], second))
    re = torch.cat([d02[0].reshape(sh + (e // 4, 2)),
                    d13[0].reshape(sh + (e // 4, 2))], dim=-1)
    im = torch.cat([d02[1].reshape(sh + (e // 4, 2)),
                    d13[1].reshape(sh + (e // 4, 2))], dim=-1)
    return (re.reshape(sh + (e,)), im.reshape(sh + (e,)))


# ------------------------------------------------------------- full decode --
def pbch_quarter_llrs_slot1(slot1_td: cplx.Pair, cell_id: torch.Tensor,
                            normal_cp: bool) -> torch.Tensor:
    """Dematched LLR contributions of one subframe's slot 1:
    [..., 3 ports, 4 quarters, 120].

    Element [p, q] is the contribution to the 120 codeword LLRs under the
    hypothesis of p TX ports (index 0/1/2 -> 1/2/4) and of the subframe
    carrying rate-match quarter q of the 40 ms PBCH TTI; contributions add
    across the subframes of one TTI.

    slot1_td: pair of [..., 960] float32; cell_id: [...] integer."""
    tabs = _tables(normal_cp, str(cell_id.device))
    slot1 = ofdm_demod_slot(slot1_td, normal_cp)          # [.., nsym, 72]
    bshape = slot1[0].shape[:-2]
    v3 = torch.remainder(cell_id.to(torch.int64), 3)
    re_idx = tabs["re_idx"][v3]                           # [..., E]
    k_idx = tabs["k_idx"][v3]
    grid = cplx.reshape(cplx.index(slot1, (..., slice(0, 4), slice(None))),
                        bshape + (288,))
    y = (torch.take_along_dim(grid[0], re_idx, dim=-1),
         torch.take_along_dim(grid[1], re_idx, dim=-1))
    h = []
    for p in range(4):
        hp = _chest_port(slot1, cell_id, 1, p, normal_cp)
        h.append((torch.take_along_dim(hp[0], k_idx, dim=-1),
                  torch.take_along_dim(hp[1], k_idx, dim=-1)))

    e_bits = E_BITS[normal_cp]
    llr = torch.stack(
        [torch.stack(_equalize(y, h, p), dim=-1).reshape(bshape + (e_bits,))
         for p in (1, 2, 4)], dim=-2)                     # [..., 3, e]

    signs = _gold_signs(scrambling.pbch_c_init(cell_id), 4 * e_bits)
    signs_q = signs.reshape(bshape + (4, e_bits))
    return torch.einsum("...pe,...qe,qek->...pqk", llr, signs_q,
                        tabs["dematch"])


def pbch_quarter_llrs(subframe: cplx.Pair, cell_id,
                      normal_cp: bool) -> torch.Tensor:
    """`pbch_quarter_llrs_slot1` of a whole subframe: pair of [..., 1920]
    float32 (aligned: a subframe-0 candidate), cell_id an integer or an
    integer tensor of the leading shape -> [..., 3, 4, 120]."""
    cell_id = torch.as_tensor(cell_id, device=subframe[0].device)
    return pbch_quarter_llrs_slot1(
        cplx.index(subframe, (..., slice(SLOT_LENGTH, 2 * SLOT_LENGTH))),
        cell_id, bool(normal_cp))


def quarter_llrs_both_cp(slot1_td: cplx.Pair, cell_id: torch.Tensor
                         ) -> torch.Tensor:
    """[..., 2, 3, 4, 120]: quarter LLR contributions under both CP
    hypotheses (index 0 = Extended, 1 = Normal)."""
    e = pbch_quarter_llrs_slot1(slot1_td, cell_id, False)
    n = pbch_quarter_llrs_slot1(slot1_td, cell_id, True)
    return torch.stack([e, n], dim=-4)


def codeword_search(llrs: torch.Tensor, port_masks: torch.Tensor):
    """Viterbi + CRC/port-mask check over codeword hypotheses.

    llrs:       [H, 120] accumulated LLRs, stream-major [d0(40),d1(40),d2(40)]
    port_masks: [H, 16] CRC xor-mask bits per hypothesis
    returns dict: bits [H, 40] int32, crc_ok [H] bool, metric [H] float32
    """
    h = llrs.shape[0]
    r = llrs.reshape(h, 3, 40).transpose(1, 2)            # step-major [40, 3]
    bits, metric = viterbi_decode_wa(r.contiguous())
    C = _decode_tables(str(llrs.device))["crc"]
    payload = bits[:, :24].to(torch.float32)
    crc_calc = torch.remainder(payload @ C.T, 2.0)
    expect = torch.remainder(crc_calc + port_masks, 2.0)
    crc_ok = torch.all(expect.to(torch.int32) == bits[:, 24:], dim=-1)
    return {"bits": bits, "crc_ok": crc_ok, "metric": metric}


def _unpack_fields(bits: torch.Tensor):
    """[..., 24] payload bits -> MIB fields."""
    bw = bits[..., 0] * 4 + bits[..., 1] * 2 + bits[..., 2]
    prb_tab = _decode_tables(str(bits.device))["prb"]
    nof_prb = prb_tab[torch.clamp(bw, 0, 7).to(torch.int64)]
    phich_ext = bits[..., 3]
    phich_res = bits[..., 4] * 2 + bits[..., 5]
    sfn = torch.zeros(bits.shape[:-1], dtype=torch.int32, device=bits.device)
    for i in range(8):
        sfn = (sfn << 1) | bits[..., 6 + i]
    # 36.331 6.2.2: the MIB's 10 spare bits are transmitted as zeros;
    # requiring zeros cuts the CRC-collision false-publish rate by 2^10
    spare_zero = torch.all(bits[..., 14:24] == 0, dim=-1)
    return {"nof_prb": nof_prb.to(torch.int32),
            "bw_valid": (bw < 6) & spare_zero,
            "phich_ext": phich_ext.to(torch.int32),
            "phich_res": phich_res.to(torch.int32),
            "sfn_offset": (sfn << 2).to(torch.int32)}


_PORTS_OF = (1, 1, 1, 1, 2, 2, 2, 2, 4, 4, 4, 4)


def search_and_unpack(llrs12: torch.Tensor, quarter_of: torch.Tensor):
    """12-hypothesis codeword search -> MIB fields, batched.

    llrs12:     [..., 12, 120] hypothesis-major LLRs (index = port * 4 + j)
    quarter_of: [..., 12] integer -> reported `quarter` of each hypothesis
    returns dict of [...] tensors: found, nof_prb, nof_ports, phich_ext,
    phich_res, sfn_offset, quarter, metric.  Ties between CRC-passing
    hypotheses go to the first in (ports, quarter) order, like srsLTE's
    search loop.
    """
    bshape = llrs12.shape[:-2]
    dev = llrs12.device
    tabs = _decode_tables(str(dev))
    masks = tabs["masks"]
    flat = llrs12.reshape(-1, 120)
    res = codeword_search(flat, masks.repeat(flat.shape[0] // 12, 1))
    bits = res["bits"].reshape(bshape + (12, 40))
    fields = _unpack_fields(bits[..., :24])
    ok = res["crc_ok"].reshape(bshape + (12,)) & fields["bw_valid"]
    prio = torch.where(ok, torch.arange(12, 0, -1, device=dev), 0)
    best = torch.argmax(prio, dim=-1, keepdim=True)
    ports_tab = tabs["ports"]

    def pick(a):
        return torch.take_along_dim(a, best, dim=-1)[..., 0]

    return {
        "found": torch.any(ok, dim=-1),
        "nof_prb": pick(fields["nof_prb"]),
        "nof_ports": ports_tab[best[..., 0]],
        "phich_ext": pick(fields["phich_ext"]),
        "phich_res": pick(fields["phich_res"]),
        "sfn_offset": pick(fields["sfn_offset"]),
        "quarter": pick(quarter_of.to(torch.int32)),
        "metric": pick(res["metric"].reshape(bshape + (12,))),
    }


def mib_decode(subframe: cplx.Pair, cell_id, normal_cp: bool):
    """Stateless single-subframe MIB decode attempt.

    subframe:  pair of [..., 1920] float32 (aligned: subframe 0 candidate)
    cell_id:   integer, or integer tensor of the leading shape
    normal_cp: bool, the CP hypothesis to run (a host value)

    returns dict of [...] tensors: found (bool), nof_prb, nof_ports,
    phich_ext, phich_res, sfn_offset, quarter, metric
    """
    contrib = pbch_quarter_llrs(subframe, cell_id, normal_cp)  # [.., 3,4,120]
    quarter_of = torch.remainder(
        torch.arange(12, device=contrib.device), 4)
    return search_and_unpack(
        contrib.reshape(contrib.shape[:-3] + (12, 120)),
        quarter_of.expand(contrib.shape[:-3] + (12,)))


def mib_combine_decode(subframe: cplx.Pair, cell_id, normal_cp: bool,
                       llr_acc: torch.Tensor, n):
    """MIB decode with soft-combining across the 40 ms PBCH TTI.

    4 TTI-phase hypotheses are carried as an accumulator axis.  Under phase
    h, subframe-0 attempt number n is quarter q = (n + h) mod 4 of a TTI; at
    q == 0 that phase's accumulator restarts (a new TTI is a new codeword),
    otherwise the contribution adds.  Phase h = (-n) mod 4 always restarts
    fresh, so one hypothesis per attempt equals the stateless decode:
    combining can only add sensitivity.  (The grid engine runs the same
    chain batched over its captured candidates, trigger._decode_candidates.)

    subframe:  pair of [1920] float32 (a subframe-0 candidate)
    llr_acc:   [12, 120] float32 accumulator, index = port * 4 + phase
    n:         attempts combined so far for this cell (a host integer or a
               0-d integer tensor)

    returns: (llr_acc_new [12, 120], result dict like mib_decode)
    """
    contrib = pbch_quarter_llrs(subframe, cell_id, normal_cp)   # [3, 4, 120]
    q = torch.remainder(torch.as_tensor(n, device=contrib.device)
                        + torch.arange(4, device=contrib.device), 4)
    sel = contrib[:, q]                                         # [3, 4(h), 120]
    acc = llr_acc.reshape(3, 4, 120)
    acc_new = torch.where((q == 0)[None, :, None], sel, acc + sel)
    res = search_and_unpack(acc_new.reshape(12, 120), q.tile(3))
    return acc_new.reshape(12, 120), res
