"""Building blocks of the plain references, in any float dtype.

``precision`` picks the arithmetic: ``"float64"`` is the judge; the
controls are ``"tf32"`` (float32, with the inputs of every dense float
product rounded to TF32's 10 mantissa bits, as a TF32 tensor-core product
takes them) and ``"bfloat16"`` (every float tensor held in bfloat16).
"""
from __future__ import annotations

import warnings

import torch

# a sign is open where |value| < EPS * (magnitude of the terms summed into
# it): float32 leaves such a value's side of 0 to its rounding (a dot of K
# terms rounds by about sqrt(K) * 2^-24 of their magnitude, 1e-6 at most
# here), where TF32 inputs move it by about 2^-11 / sqrt(K), 2e-5 and more
EPS = 1e-5

DTYPES = {"float64": torch.float64, "tf32": torch.float32,
          "bfloat16": torch.bfloat16}


def dtype(precision: str) -> torch.dtype:
    return DTYPES[precision]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero, as ``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return round_tf32(a) @ round_tf32(b)
    return a @ b


def sign(x: torch.Tensor) -> torch.Tensor:
    """+1 where x >= 0, else -1 (sign(0) = +1), in x's dtype."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def sign3(x: torch.Tensor, magnitude: torch.Tensor) -> tuple:
    """(s, open): s is +-1 where |x| >= EPS * magnitude and 0 where the
    sign is open; ``open`` is 1.0 there, else 0.0."""
    shut = x.abs() >= EPS * magnitude
    s = torch.where(shut, sign(x), torch.zeros_like(x))
    return s, (~shut).to(x.dtype)


def gcn_aggregate(rows, cols, n: int, z: torch.Tensor) -> torch.Tensor:
    """D^-1/2 (A + I) D^-1/2 @ z, with D the degrees of A + I, in z's
    dtype."""
    rows_hat, cols_hat = with_self_loops(rows, cols, n)
    deg = torch.bincount(rows_hat, minlength=n).to(torch.float64)
    dinv = (1.0 / deg.clamp(min=1.0).sqrt()).to(z.dtype)
    a_hat = csr(rows_hat, cols_hat, n, dt=z.dtype)
    return dinv[:, None] * spmm(a_hat, dinv[:, None] * z)


def batch_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Standardize each column by its mean and population deviation + eps,
    the statistics taken from ``x`` itself (BN frozen on the graph it
    serves)."""
    mu = x.mean(dim=0, keepdim=True)
    sd = x.std(dim=0, keepdim=True, correction=0) + eps
    return (x - mu) / sd


def weight_signs(w: torch.Tensor, dt: torch.dtype):
    """sign(W) and the per-output-column mean |W| of a (in, out) weight."""
    w = w.to(dt)
    return sign(w), w.abs().mean(dim=0)


def csr(rows: torch.Tensor, cols: torch.Tensor, n: int, values=None,
        dt: torch.dtype = torch.float64) -> torch.Tensor:
    """The n x n sparse CSR matrix with ``values`` (ones by default) at the
    (row-sorted) coordinates (rows, cols)."""
    crow = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    if values is None:
        values = torch.ones(rows.numel(), dtype=dt, device=rows.device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        return torch.sparse_csr_tensor(crow, cols, values.to(dt), size=(n, n),
                                       check_invariants=False)


def spmm(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` for a sparse CSR ``a``. bfloat16 operands are summed in
    float32 and the result rounded to bfloat16 (a bfloat16 aggregation
    that accumulates in float32)."""
    if x.dtype == torch.bfloat16:
        return torch.sparse.mm(a.to(torch.float32), x.to(torch.float32)) \
            .to(torch.bfloat16)
    return torch.sparse.mm(a, x)


def with_self_loops(rows: torch.Tensor, cols: torch.Tensor, n: int):
    """(rows, cols) of A + I, sorted by row then column."""
    loop = torch.arange(n, device=rows.device)
    key = torch.cat([rows * n + cols, loop * n + loop])
    key = torch.unique(key)
    return key // n, key % n
