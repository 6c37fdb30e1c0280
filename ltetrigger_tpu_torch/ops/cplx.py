"""Complex arithmetic on (re, im) float32 tensor pairs.

The port keeps the JAX package's pair layout at its public functions so the
tests compare like with like (ltetrigger_tpu/ops/cplx.py).  Pairs are plain
tuples of two tensors of one shape, dtype and device.
"""

from __future__ import annotations

import numpy as np
import torch

Pair = tuple  # (re, im), matching float32 tensors


# ------------------------------------------------------------- boundary ----
def from_numpy(x: np.ndarray, device="cpu") -> Pair:
    x = np.asarray(x)
    return (torch.from_numpy(np.ascontiguousarray(x.real, np.float32))
            .to(device),
            torch.from_numpy(np.ascontiguousarray(x.imag, np.float32))
            .to(device))


def to_numpy(p: Pair) -> np.ndarray:
    """Pair (on any device) -> numpy complex64 (host copy)."""
    return p[0].detach().cpu().numpy().astype(np.complex64) \
        + 1j * p[1].detach().cpu().numpy().astype(np.complex64)


def const(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Static complex constant -> numpy float32 pair (for kernel weights)."""
    x = np.asarray(x)
    return (x.real.astype(np.float32), x.imag.astype(np.float32))


# -------------------------------------------------------------- algebra ----
def add(a: Pair, b: Pair) -> Pair:
    return (a[0] + b[0], a[1] + b[1])


def sub(a: Pair, b: Pair) -> Pair:
    return (a[0] - b[0], a[1] - b[1])


def mul(a: Pair, b: Pair) -> Pair:
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def mul_conj(a: Pair, b: Pair) -> Pair:
    """a * conj(b)."""
    return (a[0] * b[0] + a[1] * b[1], a[1] * b[0] - a[0] * b[1])


def conj(a: Pair) -> Pair:
    return (a[0], -a[1])


def neg(a: Pair) -> Pair:
    return (-a[0], -a[1])


def scale(a: Pair, s) -> Pair:
    return (a[0] * s, a[1] * s)


def abs2(a: Pair) -> torch.Tensor:
    return a[0] * a[0] + a[1] * a[1]


def angle(a: Pair) -> torch.Tensor:
    return torch.atan2(a[1], a[0])


def div_real(a: Pair, d) -> Pair:
    return (a[0] / d, a[1] / d)


def expi(theta: torch.Tensor) -> Pair:
    """exp(j*theta)."""
    return (torch.cos(theta), torch.sin(theta))


def zeros(shape, device="cpu") -> Pair:
    return (torch.zeros(shape, device=device),
            torch.zeros(shape, device=device))


def where(c, a: Pair, b: Pair) -> Pair:
    return (torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1]))


def sum(a: Pair, dim=None) -> Pair:  # noqa: A001
    """Sum along `dim` (all elements when None)."""
    return (torch.sum(a[0], dim=dim), torch.sum(a[1], dim=dim))


def dot_conj_sum(a: Pair, b: Pair, dim=-1) -> Pair:
    """sum(a * conj(b)) along dim — the complex correlation inner product."""
    re = torch.sum(a[0] * b[0] + a[1] * b[1], dim=dim)
    im = torch.sum(a[1] * b[0] - a[0] * b[1], dim=dim)
    return (re, im)


def matmul_pair_real(a: Pair, m: torch.Tensor) -> Pair:
    """(complex pair) @ (real matrix)."""
    return (a[0] @ m, a[1] @ m)


def matmul_real_pair(m_re: torch.Tensor, m_im: torch.Tensor,
                     x: Pair) -> Pair:
    """(static complex matrix given as two real parts) @ (pair batch):
    x [..., K] pairs -> y [..., N] pairs for M = m_re + j m_im of [N, K]."""
    xr, xi = x
    yr = xr @ m_re.T - xi @ m_im.T
    yi = xr @ m_im.T + xi @ m_re.T
    return (yr, yi)


def index(a: Pair, idx) -> Pair:
    return (a[0][idx], a[1][idx])


def take(a: Pair, idx, dim=-1) -> Pair:
    """Elements `idx` (an integer tensor, any shape) along `dim`, as
    `numpy.take` / `jnp.take` with an axis."""
    idx = torch.as_tensor(idx, device=a[0].device)
    return tuple(torch.index_select(c, dim, idx.reshape(-1)).reshape(
        c.shape[:dim % c.ndim] + idx.shape + c.shape[dim % c.ndim + 1:])
        for c in a)


def stack(pairs, dim=0) -> Pair:
    return (torch.stack([p[0] for p in pairs], dim=dim),
            torch.stack([p[1] for p in pairs], dim=dim))


def concat(pairs, dim=0) -> Pair:
    return (torch.cat([p[0] for p in pairs], dim=dim),
            torch.cat([p[1] for p in pairs], dim=dim))


def reshape(a: Pair, shape) -> Pair:
    return (a[0].reshape(shape), a[1].reshape(shape))
