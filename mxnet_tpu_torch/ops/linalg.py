"""Linear-algebra operators (counterpart of ``mxnet_tpu/ops/linalg.py``),
each under a ``_linalg_`` and a ``linalg_`` name. Each body is one
``torch.linalg`` (cuSOLVER/cuBLAS on the card) or matmul expression over
the last two axes, batched over the leading ones.

- ``gelqf`` is the LQ factorization through a QR of Aᵀ; ``syevd``
  returns the eigenvectors as rows. Their signs come from the solver
  (LAPACK on the host, cuSOLVER on the card), so compare products
  (L·Q, Vᵀ·diag(w)·V), not entries.
- The factorizations use the ``_ex`` variants (``cholesky_ex``,
  ``inv_ex``): they do not read an error flag back to the host, so a
  CUDA graph can hold them; a failed factorization gives NaNs or
  garbage, as XLA's does.
"""
from __future__ import annotations

import torch

from .registry import register


def _t(x, transpose):
    return x.transpose(-1, -2) if transpose else x


def _reg(name, fn, arg_names=("A",), **kwargs):
    register("_linalg_" + name, fn, arg_names=arg_names,
             aliases=("linalg_" + name,), **kwargs)


def _gemm2(attrs, a, b):
    return float(attrs.get("alpha", 1.0)) * torch.matmul(
        _t(a, attrs.get("transpose_a", False)),
        _t(b, attrs.get("transpose_b", False)))


_reg("gemm2", _gemm2, arg_names=("A", "B"),
     defaults={"alpha": 1.0, "transpose_a": False, "transpose_b": False,
               "axis": -2})


def _gemm(attrs, a, b, c):
    return _gemm2(attrs, a, b) + float(attrs.get("beta", 1.0)) * c


_reg("gemm", _gemm, arg_names=("A", "B", "C"),
     defaults={"alpha": 1.0, "beta": 1.0, "transpose_a": False,
               "transpose_b": False, "axis": -2})


def _potrf(attrs, a):
    low = torch.linalg.cholesky_ex(a).L
    return low if attrs.get("lower", True) else low.transpose(-1, -2)


_reg("potrf", _potrf, defaults={"lower": True})


def _potri(attrs, a):
    """The inverse of A = L Lᵀ from its Cholesky factor L."""
    low = a if attrs.get("lower", True) else a.transpose(-1, -2)
    eye = torch.eye(a.shape[-1], dtype=a.dtype,
                    device=a.device).expand(a.shape)
    inv = torch.linalg.solve_triangular(low, eye, upper=False, left=True)
    return torch.matmul(inv.transpose(-1, -2), inv)


_reg("potri", _potri, defaults={"lower": True})


def _trsm(attrs, a, b):
    """Solves op(A) X = alpha B (X op(A) with ``rightside``) for a
    triangular A; op(A) = Aᵀ with ``transpose``."""
    lower = bool(attrs.get("lower", True))
    transpose = bool(attrs.get("transpose", False))
    return torch.linalg.solve_triangular(
        _t(a, transpose), float(attrs.get("alpha", 1.0)) * b,
        upper=lower if transpose else not lower,
        left=not attrs.get("rightside", False))


_reg("trsm", _trsm, arg_names=("A", "B"),
     defaults={"alpha": 1.0, "transpose": False, "rightside": False,
               "lower": True})


def _trmm(attrs, a, b):
    tri = torch.tril(a) if attrs.get("lower", True) else torch.triu(a)
    tri = _t(tri, attrs.get("transpose", False))
    alpha = float(attrs.get("alpha", 1.0))
    if attrs.get("rightside", False):
        return alpha * torch.matmul(b, tri)
    return alpha * torch.matmul(tri, b)


_reg("trmm", _trmm, arg_names=("A", "B"),
     defaults={"alpha": 1.0, "transpose": False, "rightside": False,
               "lower": True})


def _syrk(attrs, a):
    at = _t(a, attrs.get("transpose", False))
    return float(attrs.get("alpha", 1.0)) * torch.matmul(
        at, at.transpose(-1, -2))


_reg("syrk", _syrk, defaults={"alpha": 1.0, "transpose": False})
_reg("sumlogdiag", lambda attrs, a: torch.sum(
    torch.log(torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1))
_reg("extractdiag", lambda attrs, a: torch.diagonal(
    a, offset=int(attrs.get("offset", 0)), dim1=-2, dim2=-1),
    defaults={"offset": 0})
_reg("makediag", lambda attrs, a: torch.diag_embed(
    a, offset=int(attrs.get("offset", 0))), defaults={"offset": 0})


def _extracttrian(attrs, a):
    """The lower (upper) triangle from the ``offset``-th diagonal, row by
    row, as a vector."""
    n = a.shape[-1]
    offset = int(attrs.get("offset", 0))
    idx = (torch.tril_indices if attrs.get("lower", True)
           else torch.triu_indices)(n, n, offset, device=a.device)
    return a[..., idx[0], idx[1]]


_reg("extracttrian", _extracttrian, defaults={"offset": 0, "lower": True})


def _gelqf(attrs, a):
    q, r = torch.linalg.qr(a.transpose(-1, -2))
    return r.transpose(-1, -2), q.transpose(-1, -2)


_reg("gelqf", _gelqf, num_outputs=2)


def _syevd(attrs, a):
    w, v = torch.linalg.eigh(a)
    return v.transpose(-1, -2), w


_reg("syevd", _syevd, num_outputs=2)
_reg("inverse", lambda attrs, a: torch.linalg.inv_ex(a).inverse)
_reg("det", lambda attrs, a: torch.linalg.det(a))
_reg("slogdet", lambda attrs, a: tuple(torch.linalg.slogdet(a)),
     num_outputs=2)
