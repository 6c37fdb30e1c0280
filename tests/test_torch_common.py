"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*).

Every input is built from a numpy seed and `ltecore.synth`; the same arrays
go to the JAX reference and to the port.
"""

import numpy as np
import torch

from ltetrigger_tpu.ltecore import synth
from ltetrigger_tpu_torch.ops import viterbi as torch_viterbi

torch.set_num_threads(2)          # tier-1 runs the files in 6 workers


def upsample(x: np.ndarray, factor: int) -> np.ndarray:
    """FFT zero-padding interpolation by an integer factor (complex64)."""
    F = np.fft.fft(x.astype(np.complex128))
    n = x.size
    Fw = np.zeros(n * factor, dtype=np.complex128)
    Fw[:n // 2] = F[:n // 2]
    Fw[-n // 2:] = F[-n // 2:]
    return (np.fft.ifft(Fw) * factor).astype(np.complex64)


def noise(rng, n: int, sigma: float = 1.0) -> np.ndarray:
    return (sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))
            / np.sqrt(2.0)).astype(np.complex64)


def frames(cell_id: int, n: int, **kw) -> np.ndarray:
    """`n` copies of one synthetic radio frame (complex64)."""
    return np.tile(synth.synthesize_frame(cell_id, **kw), n) \
        .astype(np.complex64)


def acq_loss_reacq(cell_id: int, seed: int = 1) -> np.ndarray:
    """Acquisition (5 frames), loss (5 frames of loud noise), then
    reacquisition (5 frames): 30 half-frames at 1.92 Msps, plus noise."""
    rng = np.random.default_rng(seed)
    sig = frames(cell_id, 5, nof_prb_field=50)
    mid = noise(rng, sig.size, 10.0)
    x = np.concatenate([sig, mid, sig])
    return (x + noise(rng, x.size, 0.1)).astype(np.complex64)


def engine_buffer(sig: np.ndarray, lookback: int, window: int) -> np.ndarray:
    """LOOKBACK zeros + signal + WINDOW zeros (the engine's buffer)."""
    return np.concatenate([np.zeros(lookback, np.complex64), sig,
                           np.zeros(window, np.complex64)])


def to_pair_torch(x: np.ndarray):
    return (torch.from_numpy(np.ascontiguousarray(x.real, np.float32)),
            torch.from_numpy(np.ascontiguousarray(x.imag, np.float32)))


def offset(x: np.ndarray, subcarriers: float) -> np.ndarray:
    """`x` shifted in frequency by `subcarriers` x 15 kHz (complex64)."""
    n = np.arange(x.size, dtype=np.float64)
    return (x * np.exp(2j * np.pi * subcarriers / 128.0 * n)) \
        .astype(np.complex64)


DECISIVE = ("cell_id", "nof_prb", "nof_tx_ports", "cp_len")


def fields(cell, keys=None) -> dict:
    """A Cell as a dict without its wall-clock stamp (or only `keys`)."""
    d = cell.to_dict()
    d.pop("tracking_start_time")
    return {k: d[k] for k in keys} if keys else d


# engine outputs: PSR rtol 1e-4 (a ratio of correlation powers that agree to
# rtol 1e-4 / atol 1e-5), the CFO mean atol 1e-4 subcarriers, the EMA'd power
# rtol 1e-4 / atol 1e-5, the TTI LLR accumulator atol 1e-6 of its largest value
FLOAT_TOL = {"psr": dict(rtol=1e-4), "cfo_mean": dict(atol=1e-4),
             "ema": dict(rtol=1e-4, atol=1e-5), "psr_max": dict(rtol=1e-4),
             "psr_ring": dict(rtol=1e-4), "cfo_ring": dict(atol=1e-4),
             "chest": dict(rtol=1e-3, atol=1e-3)}


def assert_fields(got, ref, fields, what):
    """Named fields of two engine tuples (state, raw or step output; the
    port's tensors against the JAX package's arrays): integers and booleans
    equal, floats within FLOAT_TOL."""
    for f in fields:
        g = getattr(got, f)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(getattr(ref, f))
        assert g.shape == r.shape, (what, f, g.shape, r.shape)
        if f == "llr_acc":
            np.testing.assert_allclose(g, r, rtol=1e-4,
                                       atol=1e-6 * max(np.abs(r).max(), 1),
                                       err_msg=f"{what}.{f}")
        elif f in FLOAT_TOL:
            np.testing.assert_allclose(g, r, err_msg=f"{what}.{f}",
                                       **FLOAT_TOL[f])
        else:
            np.testing.assert_array_equal(g, r, err_msg=f"{what}.{f}")


def near_tie(llr: torch.Tensor, rel: float = 1e-4) -> torch.Tensor:
    """[B] bool: the plain Viterbi decoder's two best final path metrics
    differ by at most `rel` of the best's magnitude, where two correct
    decoders may keep different paths."""
    top = torch_viterbi.final_metrics(llr)[0].topk(2, dim=-1).values
    return top[:, 0] - top[:, 1] <= rel * top[:, 0].abs().clamp(min=1.0)
