"""Python side of the shared GEMM (``csrc/gemm.cu``, backward forms in
``csrc/gemm_any.cu``) and its plain twin.

:func:`gemm` launches the hand-written forward kernel and
:func:`gemm_any` / :func:`dgrad` / :func:`wgrad` / :func:`colsum` its
backward forms; they are used only inside the fused-layer wrappers, on
CUDA tensors.  :func:`linear_plain` is the same arithmetic in plain
PyTorch for the ``*_plain`` versions: the operand and the weight are
rounded to the model dtype, the product and the bias are taken in f32
(flax ``Dense(dtype=...)`` with f32 accumulation, as inside the Pallas
kernels).  Rounding goes through :func:`ste`, whose gradient passes
unrounded, as the Pallas backward kernels take their gradients in f32.

The kernels take their f32 products in the 3xTF32 form on the tensor
cores (``csrc/tensor_core.cuh``); :func:`split_tf32` and :func:`tf32x3_mm` are
that arithmetic in plain PyTorch.  The plain versions' products go
through :func:`plain_product`, whose backward (the dgrad and wgrad
products) calls :data:`backward_product`: a plain f32 matmul by
default, so the plain versions stay the f32 oracle, or
:func:`tf32x3_mm` when a test routes them through the kernels'
arithmetic.
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
    Returns ``[M, N]`` at ``out_dtype``.  Both weight types run on the
    tensor cores (bf16 directly, f32 in the 3xTF32 form) and need every
    ``K_s`` and row pitch to be a multiple of 4 elements (the kernel
    returns an error otherwise).  bf16 operands against an f32 weight
    are exact in TF32, and the f32 path then drops their lo products.
    """
    assert 1 <= len(segments) <= 3
    n, ktot = weight.shape
    m = None
    args = []
    a_exact = weight.dtype == torch.float32 and all(
        a.dtype == torch.bfloat16 for a, _ in segments)
    # the operand is rounded to the weight's dtype (exact for a bf16
    # operand and an f32 weight, a no-op on the rest of the path)
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
              _lib.dt(out), int(a_exact))
    return out


_SM90_RULE = ("bf16 row-major operands whose width K, weight rows N and row "
              "pitches are multiples of 8 elements, 16-byte aligned")


def _sm90_check(a: torch.Tensor, weight: torch.Tensor, *vectors) -> None:
    """What Python must check before the Hopper GEMM: the types, CUDA,
    unit column strides and matching K (the kernel itself refuses widths,
    pitches and alignments that TMA cannot tile).  Few attribute reads:
    the question stack calls it nine times a decoder layer."""
    if a.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(f"gemm_sm90 takes {_SM90_RULE} (got {a.dtype}, "
                        f"{weight.dtype})")
    if (a.dim() != 2 or a.shape[1] != weight.shape[1] or a.stride(1) != 1
            or weight.stride(1) != 1 or not a.is_cuda or not weight.is_cuda):
        raise ValueError(f"gemm_sm90 takes {_SM90_RULE}: A {tuple(a.shape)}, "
                         f"weight {tuple(weight.shape)}")
    for t in vectors:
        if t is not None and not (t.is_cuda and t.is_contiguous()):
            raise ValueError("gemm_sm90: contiguous CUDA tensors expected")


def gemm_sm90(a: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
              out_dtype: torch.dtype = torch.bfloat16,
              emul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(a @ weight.T + bias) * emul`` on the Hopper GEMM
    (``csrc/gemm_sm90.cu``: TMA and wgmma).  ``a [M, K]`` and ``weight
    [N, K]`` bf16, ungathered, K, N and the row pitches multiples of 8
    elements and 16-byte aligned; ``bias [N]`` and ``emul [M, N]`` f32.
    Returns ``[M, N]`` at ``out_dtype`` (f32 or bf16).  Raises on an
    operand the kernel cannot take."""
    _sm90_check(a, weight, bias, emul)
    m = a.shape[0]
    n = weight.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    _lib.call("isg_gemm_sm90", a.data_ptr(), a.stride(0), weight.data_ptr(),
              weight.stride(0), _lib.ptr(bias), _lib.ptr(emul),
              out.data_ptr(), _lib.dt(out), m, n, a.shape[1], ACT[act],
              invalid=_SM90_RULE)
    return out


def gemm_ln_sm90(a: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 final_ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 out_f32: bool = True,
                 out_t: Optional[torch.dtype] = None,
                 ymask: Optional[torch.Tensor] = None,
                 z_out: Optional[torch.Tensor] = None, eps: float = 1e-6):
    """``LN(x + (a @ weight.T + bias) * ymask)`` with the LayerNorm in the
    Hopper GEMM's epilogue, optionally followed by ``final_ln``; the
    LayerNorm's rows are ``N = weight.shape[0] <= 512`` wide.  ``x [M, N]``
    f32 or bf16, the rest f32; ``z_out`` (f32 ``[M, N]``) receives the
    pre-LN sum.  Returns ``(f32 result or None, result at out_t or None)``,
    as :func:`.text_kernel._residual_ln`."""
    fs, fb = final_ln if final_ln is not None else (None, None)
    _sm90_check(a, weight, bias, x, ymask, z_out)
    m = a.shape[0]
    n = weight.shape[0]
    if tuple(x.shape) != (m, n):
        raise ValueError(f"gemm_ln_sm90: x {tuple(x.shape)} for [{m}, {n}]")
    dev = a.device
    of = torch.empty((m, n), dtype=torch.float32, device=dev) \
        if out_f32 else None
    ot = torch.empty((m, n), dtype=out_t, device=dev) \
        if out_t is not None else None
    _lib.call("isg_gemm_ln_sm90", a.data_ptr(), a.stride(0),
              weight.data_ptr(), weight.stride(0), bias.data_ptr(),
              x.data_ptr(), _lib.dt(x), _lib.ptr(ymask), scale.data_ptr(),
              shift.data_ptr(), _lib.ptr(fs), _lib.ptr(fb), _lib.ptr(z_out),
              _lib.ptr(of), _lib.ptr(ot),
              _lib.dt(ot) if ot is not None else 0, m, n, a.shape[1], eps,
              invalid=_SM90_RULE + ", N <= 512")
    return of, ot


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``x ~= hi + lo``: ``hi`` is ``x`` rounded to TF32
    (a 10-bit mantissa, to nearest, ties away from zero: PTX
    ``cvt.rna.tf32.f32``) and ``lo`` the same rounding of ``x - hi``,
    both f32 tensors."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    xf = x.float()
    hi = rna(xf)
    return hi, rna(xf - hi)


def tf32x3_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels' 3xTF32 form takes it: ``a_lo b_hi +
    a_hi b_lo + a_hi b_hi``, each product of TF32 values exact in f32,
    summed in f32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


# The dgrad / wgrad products of :func:`plain_product`'s backward.
backward_product = torch.matmul


class _Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        mm = backward_product
        da = mm(g, b.t()) if ctx.needs_input_grad[0] else None
        db = (mm(a.reshape(-1, a.shape[-1]).t(), g.reshape(-1, g.shape[-1]))
              if ctx.needs_input_grad[1] else None)
        return da, db


def plain_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [..., K] @ b [K, N]`` in f32, differentiable; its input and
    weight gradients are taken by :data:`backward_product`, the plain
    counterpart of the kernels' dgrad and wgrad."""
    return _Product.apply(a, b)


_MAX_SPLIT_TILES = 264     # two blocks on each of the card's 132 SMs


def _split_k(tiles: int, k: int) -> int:
    """Slices of the reduction dimension: as many blocks as the card's 132
    SMs hold at once (two each), not more (a second, mostly idle wave
    would cost as much as the first), at least 256 rows a slice."""
    want = max(1, _MAX_SPLIT_TILES // max(tiles, 1))
    return max(1, min(want, k // 256, 64))


_COUNTERS = {}


def _tile_counters(device: torch.device) -> torch.Tensor:
    """Per-tile arrival counters of the split-K epilogue, zeroed once per
    device; each call's last block resets the counters it used, so they
    stay zeroed between the calls on a stream."""
    t = _COUNTERS.get(device)
    if t is None:
        t = _COUNTERS[device] = torch.zeros(_MAX_SPLIT_TILES,
                                            dtype=torch.int32, device=device)
    return t


def gemm_any(a: torch.Tensor, b: torch.Tensor, m: int, n: int, k: int, *,
             a_trans: bool = False, b_idx: Optional[torch.Tensor] = None,
             out: Optional[torch.Tensor] = None, accumulate: bool = False
             ) -> torch.Tensor:
    """``out (+)= A @ B`` at f32-level accuracy (3xTF32 on the tensor
    cores, ``csrc/gemm_any.cu:isg_gemm_any``).  ``a``
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
    tiles = -(-m // 128) * -(-n // 128)
    splits = _split_k(tiles, k)
    work = counters = None
    if splits > 1:
        assert tiles <= _MAX_SPLIT_TILES
        work = torch.empty((splits, m, n), dtype=torch.float32,
                           device=a.device)
        counters = _tile_counters(a.device)
    _lib.call("isg_gemm_any", a.data_ptr(), a.stride(0), int(a_trans),
              b.data_ptr(), _lib.ptr(b_idx), b.stride(0), _lib.dt(b),
              out.data_ptr(), out.stride(0), m, n, k, int(accumulate),
              _lib.ptr(work), _lib.ptr(counters), splits)
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
    the partial tiles summed in order by each tile's last block."""
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
    y = plain_product(ste(x, dt), ste(weight, dt).t())
    if bias is not None:
        y = y + bias.float()
    if act == "gelu":
        y = F.gelu(y)
    elif act == "relu":
        y = torch.relu(y)
    return y
