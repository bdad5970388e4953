"""Python side of the shared GEMM (``csrc/gemm.cu``) and its plain twin.

:func:`gemm` launches the hand-written forward kernel and
:func:`gemm_any` / :func:`dgrad` / :func:`wgrad` / :func:`colsum` its
backward forms; they are used only inside the fused-layer wrappers, on
CUDA tensors.  :func:`linear_plain` is the same arithmetic in plain
PyTorch for the ``*_plain`` versions: the operand and the weight are
rounded to the model dtype, the product and the bias are taken in f32
(flax ``Dense(dtype=...)`` with f32 accumulation, as inside the Pallas
kernels).  Rounding goes through :func:`ste`, whose gradient passes
unrounded, as the Pallas backward kernels take their gradients in f32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _lib

ACT = {None: 0, "gelu": 1, "relu": 2}


def ste(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded through ``dtype``, as an f32 tensor whose gradient
    is the identity (the kernels' "ship at the model dtype" casts)."""
    xf = x.float()
    if dtype == torch.float32:
        return xf
    return xf + (xf.to(dtype).float() - xf).detach()


def gemm(segments: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
         weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
         act: Optional[str] = None, out_dtype: torch.dtype = torch.float32,
         row_scale: Optional[torch.Tensor] = None,
         emul: Optional[torch.Tensor] = None,
         pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(sum_s A_s[idx_s] @ weight[:, cols_s].T + bias) * emul *
    row_scale``; ``pre`` (f32 ``[M, N]``) receives the pre-activation.

    ``segments``: up to three ``(A [R, K_s], idx [M] int32 | None)``;
    ``idx`` gathers row ``idx[m]`` of ``A`` (a zero row where it is
    negative).  ``weight`` is a torch Linear weight ``[N, sum K_s]``.
    Returns ``[M, N]`` at ``out_dtype``.  A bf16 weight runs on the
    tensor cores and needs every ``K_s`` and row pitch to be a multiple
    of 4 elements (the kernel returns an error otherwise).
    """
    assert 1 <= len(segments) <= 3
    n, ktot = weight.shape
    m = None
    args = []
    # the operand is rounded to the weight's dtype (a no-op on the path)
    segments = [(a.to(weight.dtype), idx) for a, idx in segments]
    for a, idx in segments:
        if m is None:
            m = idx.shape[0] if idx is not None else a.shape[0]
        _lib.check_cuda(a, idx)
        assert a.dim() == 2
        if a.numel() >= 2 ** 31:      # the kernel's row offsets are 32-bit
            raise ValueError(f"gemm takes operands under 2^31 elements "
                             f"(got {tuple(a.shape)})")
        assert idx is None or (idx.dtype == torch.int32 and idx.shape[0] == m)
        assert idx is not None or a.shape[0] == m
        args += [a.data_ptr(), _lib.ptr(idx), a.shape[1], a.shape[1]]
    assert sum(a.shape[1] for a, _ in segments) == ktot
    while len(args) < 12:
        args += [None, None, 0, 0]
    _lib.check_cuda(weight, bias, row_scale, emul, pre)
    for t in (emul, pre):
        assert t is None or (t.dtype == torch.float32 and t.shape == (m, n))
    out = torch.empty((m, n), dtype=out_dtype, device=weight.device)
    _lib.call("isg_gemm", *args, len(segments), weight.data_ptr(), ktot,
              _lib.ptr(bias), _lib.ptr(row_scale), _lib.ptr(emul),
              _lib.ptr(pre), out.data_ptr(), n, m, n,
              ACT[act], _lib.dt(segments[0][0]), _lib.dt(weight),
              _lib.dt(out))
    return out


def _split_k(tiles: int, k: int) -> int:
    """Slices of the reduction dimension: enough blocks to fill the
    card's 132 SMs about twice, at least 256 rows a slice."""
    want = max(1, -(-264 // max(tiles, 1)))
    return max(1, min(want, k // 256, 64))


def gemm_any(a: torch.Tensor, b: torch.Tensor, m: int, n: int, k: int, *,
             a_trans: bool = False, b_idx: Optional[torch.Tensor] = None,
             out: Optional[torch.Tensor] = None, accumulate: bool = False
             ) -> torch.Tensor:
    """``out (+)= A @ B`` in f32 (``csrc/gemm.cu:isg_gemm_any``).  ``a``
    is f32 ``[m, k]`` (``[k, m]`` read transposed with ``a_trans``), ``b``
    f32 or bf16 ``[k, n]`` whose stored rows ``b_idx`` gathers (a zero row
    where the index is negative); both row-major 2-D views whose row pitch
    is their stride.  ``out`` is an f32 ``[m, n]`` view with unit column
    stride (a column slice of a wider tensor is fine)."""
    _lib.check_cuda(b_idx)
    for t in (a, b):
        if not t.is_cuda or t.stride(-1) != 1:
            raise ValueError("gemm_any takes CUDA row-major operands")
    if a.dtype != torch.float32:
        raise TypeError(f"gemm_any takes an f32 A, got {a.dtype}")
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.dtype != torch.float32 or out.stride(-1) != 1 \
            or tuple(out.shape) != (m, n):
        raise ValueError("gemm_any writes an f32 [m, n] row-major view")
    splits = _split_k(-(-m // 128) * -(-n // 128), k)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    _lib.call("isg_gemm_any", a.data_ptr(), a.stride(0), int(a_trans),
              b.data_ptr(), _lib.ptr(b_idx), b.stride(0), _lib.dt(b),
              out.data_ptr(), out.stride(0), m, n, k, int(accumulate),
              _lib.ptr(work), splits)
    return out


def dgrad(dy: torch.Tensor, weight: torch.Tensor,
          out: Optional[torch.Tensor] = None,
          accumulate: bool = False) -> torch.Tensor:
    """``dy [M, N] @ weight [N, K]`` (the input gradient of ``x @ W^T``);
    ``weight`` may be a column slice of a wider weight."""
    m, n = dy.shape
    return gemm_any(dy, weight, m, weight.shape[1], n, out=out,
                    accumulate=accumulate)


def wgrad(dy: torch.Tensor, x: torch.Tensor,
          idx: Optional[torch.Tensor] = None,
          out: Optional[torch.Tensor] = None,
          accumulate: bool = False) -> torch.Tensor:
    """``dy[M, N]^T @ x[idx]`` -> ``[N, K]`` (the weight gradient of
    ``x[idx] @ W^T``); the M rows are split across blocks (split-K) and
    the partial tiles summed in a second pass."""
    m, n = dy.shape
    k = x.shape[1]
    return gemm_any(dy, x, n, k, m, a_trans=True, b_idx=idx, out=out,
                    accumulate=accumulate)


def colsum(x: torch.Tensor, out: Optional[torch.Tensor] = None,
           accumulate: bool = False) -> torch.Tensor:
    """Column sums of an f32 ``[M, N]`` view (a bias gradient), in two
    deterministic passes."""
    m, n = x.shape
    if out is None:
        out = torch.empty((n,), dtype=torch.float32, device=x.device)
    chunks = max(1, min(256, m // 64))
    work = torch.empty((chunks, n), dtype=torch.float32, device=x.device)
    _lib.call("isg_colsum", x.data_ptr(), x.stride(0), m, n, out.data_ptr(),
              int(accumulate), work.data_ptr(), chunks)
    return out


def reduce_rows(part: torch.Tensor) -> torch.Tensor:
    """``part [Z, ...]`` summed over its first axis, in order, f32."""
    z = part.shape[0]
    n = part[0].numel()
    out = torch.empty(part.shape[1:], dtype=torch.float32,
                      device=part.device)
    _lib.call("isg_reduce_rows", part.data_ptr(), out.data_ptr(), n, 1, n,
              z, 0)
    return out


def linear_plain(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 act: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """f32 result of ``x @ weight.T + bias`` with ``x`` and ``weight``
    rounded to ``dtype`` (the weight's own dtype by default) first."""
    dt = dtype or weight.dtype
    y = ste(x, dt) @ ste(weight, dt).t()
    if bias is not None:
        y = y + bias.float()
    if act == "gelu":
        y = F.gelu(y)
    elif act == "relu":
        y = torch.relu(y)
    return y
