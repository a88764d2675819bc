"""float32 arithmetic in the reference's compiled order.

The reference computes its rate-distortion costs in float32 inside XLA
programs compiled for the CPU, and a float32 result depends on how each
operation rounds. Three things differ from plain PyTorch arithmetic:

- XLA's CPU compiler lets LLVM contract a multiply feeding an add into one
  fused multiply-add (one rounding instead of two). `fma` evaluates such a
  contraction exactly: the product of two float32 values is exact in
  float64, and a two-sum correction settles the one case where the float64
  sum lands on a float32 rounding midpoint.
- XLA's `log` is its own polynomial (Cephes' logf, the coefficients and
  the contractions above), not the C library's, and `log2(x)` is
  `log(x) * (1 / ln 2)`. It differs from torch.log2 in the last place on
  about a third of the integers below 2^16, and floor(log2(8192)) is 12.
  The reference takes logs only of integers (and of integers times 1/3),
  so the port reads them from tables built here on the host with numpy.
- A division by a constant becomes a multiplication by its float32
  reciprocal (x / 3.0 is x * 0.33333334).

Every function is exact on the CPU and on the card alike.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_F32, _F64 = np.float32, np.float64
THIRD = _F32(1.0) / _F32(3.0)          # XLA's x / 3.0 is x * THIRD
INV_LN2 = _F32(1.44269502)             # and log2(x) is log(x) * INV_LN2


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding (LLVM's contraction), for
    float32 tensors (b and c may be float32 scalars or tensors)."""
    dev = a.device
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev) \
        .to(torch.float64)
    a64, b64, c64 = t(a), t(b), t(c)
    p = a64 * b64                      # exact: 48 significant bits
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)  # the float64 sum's exact error
    r = s.to(torch.float32)
    rd = r.to(torch.float64)
    diff = s - rd
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    nb = torch.nextafter(r, torch.where(diff > 0, inf, -inf))
    mid = (rd + nb.to(torch.float64)) * 0.5
    # s rounded onto a float32 midpoint: the exact value lies past it on
    # err's side
    past = (diff != 0) & (s == mid) & (err != 0) & \
        ((err > 0) == (diff > 0))
    return torch.where(past, nb, r)


def _fma_np(a, b, c):
    """numpy float32 a * b + c with one rounding (as `fma`)."""
    a, b, c = (np.asarray(x, _F32).astype(_F64) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(_F32)
    rd = r.astype(_F64)
    diff = s - rd
    nb = np.nextafter(r, np.where(diff > 0, _F32(np.inf), _F32(-np.inf)))
    mid = (rd + nb.astype(_F64)) * 0.5
    past = (diff != 0) & (s == mid) & (err != 0) & ((err > 0) == (diff > 0))
    return np.where(past, nb, r).astype(_F32)


def _c(h: str) -> np.float32:
    """A float32 constant from the hex of its float64 value."""
    return _F32(np.frombuffer(bytes.fromhex(h)[::-1], _F64)[0])


def xla_log(x) -> np.ndarray:
    """XLA's float32 natural log on the CPU (Cephes' logf with LLVM's
    multiply-add contractions) for positive normal float32 inputs."""
    x = np.asarray(x, _F32)
    bits = x.view(np.int32)
    e = ((bits >> 23) - 127).astype(_F32)
    m = ((bits & np.int32(-2139095041)) | np.int32(0x3F000000)).view(_F32)
    small = m < _c("3FE6A09E60000000")           # m < sqrt(1/2)
    ee = ((_F32(1.0) + e) - np.where(small, _F32(1), _F32(0))).astype(_F32)
    xx = ((m - _F32(1.0)) + np.where(small, m, _F32(0))).astype(_F32)
    x2 = (xx * xx).astype(_F32)
    x3 = (x2 * xx).astype(_F32)
    y1 = _fma_np(xx, _c("3FB2043760000000"), _c("BFBD7A3700000000"))
    y2 = _fma_np(xx, _c("BFBFCBA9E0000000"), _c("3FC23D37E0000000"))
    y3 = _fma_np(xx, _c("3FC999D580000000"), _c("BFCFFFFF80000000"))
    y1 = _fma_np(y1, xx, _c("3FBDE4A340000000"))
    y2 = _fma_np(y2, xx, _c("BFC555CA00000000"))
    y3 = _fma_np(y3, xx, _c("3FD5555540000000"))
    y = _fma_np(_fma_np(y1, x3, y2), x3, y3)
    y = _fma_np(y, x3, (_c("BF2BD01060000000") * ee).astype(_F32))
    r = (_fma_np(_F32(-0.5), x2, xx) + y).astype(_F32)
    return _fma_np(_c("3FE6300000000000"), ee, r)


_LN2 = float(_F32(np.log(2.0)))


@lru_cache(maxsize=None)
def lambda_table(scale: float, div: float) -> np.ndarray:
    """scale * 2^((qp - 12) / div) for QP 0..75 in float32 (51 plus
    12 bits' QpBdOffset of 24, which RDOQ's lambda takes), 2^x evaluated
    as exp(x * ln 2) like the reference's compiled program (torch's exp2
    differs from it at 21 of the 52 QPs to 51)."""
    q = torch.arange(76, dtype=torch.float32)
    return (scale * torch.exp((q - 12.0) / div * _LN2)).numpy()


def xla_log2(x) -> np.ndarray:
    """XLA's float32 log2 (log(x) * (1 / ln 2))."""
    return (xla_log(x) * INV_LN2).astype(_F32)


@lru_cache(maxsize=None)
def _tables(n: int):
    """Tables over the integers 0..n (entry 0 unused): the floor of XLA's
    log2, the floor of log2(k / 3.0), 2 * log2(k) + 1 as XLA evaluates it
    (the constants folded into log(k) * (2 / ln 2) and the product
    contracted into the add), and XLA's log(k)."""
    k = np.arange(1, n + 1, dtype=_F32)
    lg = xla_log(k)
    pad = lambda a, dt: np.concatenate([[0], a]).astype(dt)
    return {"floor_log2": pad(np.floor((lg * INV_LN2).astype(_F32)),
                              np.int32),
            "floor_log2_third": pad(np.floor(
                xla_log2((k * THIRD).astype(_F32))), np.int32),
            "eg_bits": pad(_fma_np(lg, _F32(2.0) * INV_LN2, _F32(1.0)),
                           _F32),
            "log": pad(lg, _F32)}


_DEV_TABLES = {}
_N = 1 << 16       # every argument: levels and remainders are below 2^16


def _lookup(name: str, k: torch.Tensor) -> torch.Tensor:
    key = (name, str(k.device))
    if key not in _DEV_TABLES:
        _DEV_TABLES[key] = torch.as_tensor(_tables(_N)[name]).to(k.device)
    return _DEV_TABLES[key][k.long()]


def floor_log2_int(k: torch.Tensor) -> torch.Tensor:
    """floor of XLA's log2 of integers k in [1, 2^16], int32."""
    return _lookup("floor_log2", k)


def floor_log2_third(k: torch.Tensor) -> torch.Tensor:
    """floor of XLA's log2(k / 3.0) (k * THIRD) for integers k in
    [1, 2^16], int32."""
    return _lookup("floor_log2_third", k)


def eg_bits_int(k: torch.Tensor) -> torch.Tensor:
    """2 * log2(k) + 1 in XLA's float32 for integers k in [1, 2^16]."""
    return _lookup("eg_bits", k)


def eg_bits_host(k: np.ndarray) -> np.ndarray:
    """eg_bits_int of a host (numpy) integer array."""
    return _tables(_N)["eg_bits"][k]


def mv_log_bits(mx: torch.Tensor, my: torch.Tensor) -> torch.Tensor:
    """The uniform B program's MV rate, 4 + 2 log2(1 + |mx|) + 2 log2(1 +
    |my|), in XLA's float32 for integer MVs with |mv| < 2^16: each 2 *
    log2(1 + k) folded into log(1 + k) * (2 / ln 2) and contracted into
    the sum, (log(1 + |my|) * c) + ((log(1 + |mx|) * c) + 4) with one
    rounding per step (equal to XLA's value at every |mx|, |my| up to
    268, tests/test_torch_uniform_b.py)."""
    c = _F32(2.0) * INV_LN2
    lg = lambda v: _lookup("log", v.abs() + 1)
    return fma(lg(my), c, fma(lg(mx), c, _F32(4.0)))
