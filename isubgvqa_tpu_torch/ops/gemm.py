"""Python side of the port's GEMMs and their plain twins.

* :func:`gemm_gather` launches the graph layers' bf16 products on the
  Hopper form that gathers its rows (``csrc/gemm_gather_sm90.cu``:
  cp.async into swizzled tiles, wgmma); :func:`gemm_gather_plain` is the
  same composition in plain PyTorch, for the CPU tests.
* :func:`gemm_sm90` / :func:`gemm_ln_sm90` launch the question stack's
  bf16 products (``csrc/gemm_sm90.cu``: TMA and wgmma).
* :func:`gemm` launches the f32 products (``csrc/gemm.cu``, 3xTF32 on the
  tensor cores) and :func:`gemm_any` / :func:`dgrad` / :func:`wgrad` /
  :func:`colsum` the backward forms of the GAT conv and the encoder layer
  (``csrc/gemm_any.cu``).
* :func:`bwd_stage` launches one stage of the MetaLayer's or the decoder
  layer's backward chain, every dgrad (:func:`stage_dgrad`) and wgrad
  (:func:`stage_wgrad`) of it, with the bias gradients and the
  activation's derivative in the epilogue (``csrc/gemm_bwd.cu``: bf16x3
  on wgmma for a bf16 model, 3xTF32 on mma.sync for an f32 one);
  :func:`bwd_stage_plain` is its plain twin.
* :func:`product` sends a layer's product to :func:`gemm_gather` for a
  bf16 weight and to :func:`gemm` for an f32 one.

They are used only inside the fused-layer wrappers, on CUDA tensors.
:func:`linear_plain` is the same arithmetic in plain PyTorch for the
``*_plain`` versions: the operand and the weight are rounded to the
model dtype, the product and the bias are taken in f32 (flax
``Dense(dtype=...)`` with f32 accumulation, as inside the Pallas
kernels).  Rounding goes through :func:`ste`, whose gradient passes
unrounded, as the Pallas backward kernels take their gradients in f32.

:func:`split_tf32` and :func:`tf32x3_mm` are the 3xTF32 arithmetic in
plain PyTorch, :func:`split_bf16x3` and :func:`bf16x3_mm` the bf16x3.
The plain versions' products go through :func:`plain_product`, whose
backward (the dgrad and wgrad products) calls :data:`backward_product`:
a plain f32 matmul by default, so the plain versions stay the f32
oracle, or :func:`tf32x3_mm` when a test routes them through the
kernels' arithmetic.
"""

from __future__ import annotations

import struct
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

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


Segments = Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def gemm(segments: Segments, weight: torch.Tensor,
         bias: Optional[torch.Tensor] = None,
         act: Optional[str] = None, out_dtype: torch.dtype = torch.float32,
         row_scale: Optional[torch.Tensor] = None,
         emul: Optional[torch.Tensor] = None,
         pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(sum_s A_s[idx_s] @ weight[:, cols_s].T + bias) * emul *
    row_scale`` against an f32 weight, in the 3xTF32 form; ``pre`` (f32
    ``[M, N]``) receives the pre-activation.

    ``segments``: up to three ``(A [R, K_s], idx [M] int32 | None)``;
    ``idx`` gathers row ``idx[m]`` of ``A`` (a zero row where it is
    negative).  ``weight`` is a torch Linear weight ``[N, sum K_s]``.
    Returns ``[M, N]`` at ``out_dtype``.  Every ``K_s`` and row pitch must
    be a multiple of 4 elements (the kernel returns an error otherwise).
    A bf16 operand is widened, exactly, and then drops its lo products.
    bf16 weights go to :func:`gemm_gather`.
    """
    if weight.dtype != torch.float32:
        raise TypeError(f"gemm takes an f32 weight (got {weight.dtype}); "
                        f"bf16 products go to gemm_gather")
    assert 1 <= len(segments) <= 3
    n, ktot = weight.shape
    m = None
    args = []
    a_exact = all(a.dtype == torch.bfloat16 for a, _ in segments)
    segments = [(a.float(), idx) for a, idx in segments]
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
              _lib.ptr(pre), out.data_ptr(), n, m, n, ACT[act],
              _lib.dt(out), int(a_exact))
    return out


def cached(owner: torch.Tensor, key, deps: Sequence[torch.Tensor],
           make: Callable[[], object]):
    """``make()``, kept on ``owner`` (an attribute of the tensor, so it
    goes with it) while ``owner`` and ``deps`` are the same tensors at the
    same storage and version: an eval model's weights are fixed, and an
    in-place update bumps a tensor's version.  What ``make()`` returns is
    an ordinary tensor even when the first call runs under
    ``torch.inference_mode()`` (an inference tensor has no version to
    check); tensors made under that mode are not kept.  Nothing is kept
    while a CUDA graph captures: a replay updates the weights in place
    without a new version, so the graph makes its copy each replay, and
    whoever replays a graph drops the memos of the weights it updates
    (:func:`forget_cached`)."""
    ts = (owner, *deps)
    if any(t.is_inference() for t in ts) or (
            owner.is_cuda and torch.cuda.is_current_stream_capturing()):
        return make()
    state = tuple(t._version for t in ts) + tuple(t.data_ptr() for t in ts)
    memo = owner.__dict__.setdefault("_isg_memo", {})
    hit = memo.get(key)
    if hit is not None and hit[1] == state and all(
            a is b for a, b in zip(hit[0], deps)):
        return hit[2]
    with torch.inference_mode(False), torch.no_grad():
        out = make()
    memo[key] = (tuple(deps), state, out)
    return out


def forget_cached(tensors) -> None:
    """Drop what :func:`cached` keeps on each of ``tensors`` (weights a
    CUDA graph's replay updated in place)."""
    for t in tensors:
        t.__dict__.pop("_isg_memo", None)


def _tma_weight(ks: Sequence[int], w: torch.Tensor) -> torch.Tensor:
    """A torch Linear weight ``[N, sum ks]`` laid out for the graph-layer
    GEMM's TMA loads: segment s from column ``sum_{t<s} ceil(K_t / 64) *
    64``, rows a multiple of 16 bytes apart, zeros between (a view)."""
    starts = [0]
    for k in ks[:-1]:
        starts.append(starts[-1] + -(-k // 64) * 64)
    width = starts[-1] + ks[-1]
    out = torch.zeros((w.shape[0], -(-width // 8) * 8), dtype=w.dtype,
                      device=w.device)
    koff = 0
    for k, start in zip(ks, starts):
        out[:, start:start + k] = w[:, koff:koff + k]
        koff += k
    return out[:, :width]


_GATHER_RULE = ("bf16 operands and weight, every segment's K and row pitch "
                "and the weight's N multiples of 4 elements, 8-byte aligned")


def gemm_gather(segments: Segments, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None,
                out_dtype: torch.dtype = torch.float32,
                row_scale: Optional[torch.Tensor] = None,
                emul: Optional[torch.Tensor] = None,
                pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`gemm`'s function for bf16 segments and a bf16 weight, on the
    Hopper form that gathers its rows (``csrc/gemm_gather_sm90.cu``).  A
    weight whose rows are not 16 bytes apart (K = 300) or whose segments
    do not start at multiples of 64 columns is read from a copy laid out
    for TMA (:func:`_tma_weight`), made once while the weight stands
    (:func:`cached`).

    ``segments``: up to three ``(A [R, K_s] bf16, idx [M] int32 | None)``,
    row-major with unit column stride; ``weight [N, sum K_s]`` bf16;
    ``bias [N]``, ``row_scale [M]``, ``emul [M, N]`` and ``pre [M, N]``
    f32.  Returns ``[M, N]`` at ``out_dtype`` (f32 or bf16).  On CPU
    tensors it runs :func:`gemm_gather_plain`; on CUDA tensors it launches
    the kernel or raises."""
    if not weight.is_cuda:
        return gemm_gather_plain(segments, weight, bias, act, out_dtype,
                                 row_scale, emul, pre)
    # few attribute reads: the graph layers issue ten of these a forward,
    # and the kernel itself refuses widths, pitches and alignments
    bf = torch.bfloat16
    a0, i0 = segments[0]
    m = a0.shape[0] if i0 is None else i0.shape[0]
    n = weight.shape[0]
    args = []
    ks = ()
    for a, idx in segments:
        if a.dtype != bf or weight.dtype != bf:
            raise TypeError(f"gemm_gather takes {_GATHER_RULE}")
        if (a.stride(1) != 1 or not a.is_cuda or a.numel() >= 2 ** 31
                or (a.shape[0] if idx is None else idx.shape[0]) != m
                or idx is not None and (idx.dtype != torch.int32
                                        or not idx.is_contiguous()
                                        or not idx.is_cuda)):
            raise ValueError(f"gemm_gather: CUDA segment {tuple(a.shape)} "
                             f"for {m} rows (int32 contiguous indices)")
        ks += (a.shape[1],)
        args += (a.data_ptr(), None if idx is None else idx.data_ptr(),
                 a.stride(0), a.shape[1])
    if len(ks) > 3 or sum(ks) != weight.shape[1] or weight.stride(1) != 1:
        raise ValueError(f"gemm_gather: weight {tuple(weight.shape)} for "
                         f"segments of {list(ks)}")
    args += [None, None, 0, 0] * (3 - len(ks))
    if (weight.stride(0) % 8 or weight.data_ptr() % 16
            or any(k % 64 for k in ks[:-1])):
        w = weight
        weight = cached(w, ks, (), lambda: _tma_weight(ks, w))
    for t, shape in ((bias, (n,)), (row_scale, (m,)), (emul, (m, n)),
                     (pre, (m, n))):
        if t is not None and (t.dtype != torch.float32 or t.shape != shape
                              or not t.is_contiguous() or not t.is_cuda):
            raise ValueError(f"gemm_gather: contiguous CUDA f32 {shape} "
                             f"expected, got {t.dtype} {tuple(t.shape)}")
    out = torch.empty((m, n), dtype=out_dtype, device=weight.device)
    _lib.call("isg_gemm_gather", *args, len(ks), weight.data_ptr(),
              weight.stride(0), _lib.ptr(bias), _lib.ptr(row_scale),
              _lib.ptr(emul), _lib.ptr(pre), out.data_ptr(), _lib.dt(out), m,
              n, ACT[act], invalid=_GATHER_RULE)
    return out


def gather_segments(segments: Segments) -> torch.Tensor:
    """The segments' rows side by side, ``[M, sum K_s]``: row ``idx[m]``
    of each (a zero row where the index is negative)."""
    parts = []
    for a, idx in segments:
        if idx is not None:
            rows = a[idx.clamp(min=0).long()]
            a = torch.where((idx >= 0)[:, None], rows, torch.zeros_like(rows))
        parts.append(a)
    return torch.cat(parts, 1) if len(parts) > 1 else parts[0]


def gemm_gather_plain(segments: Segments, weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      act: Optional[str] = None,
                      out_dtype: torch.dtype = torch.float32,
                      row_scale: Optional[torch.Tensor] = None,
                      emul: Optional[torch.Tensor] = None,
                      pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`gemm_gather` in plain PyTorch: the gathered segments, each
    product of the operands rounded to the weight's dtype taken in f32
    (:func:`linear_plain`), summed, then the kernel's epilogue."""
    y = None
    koff = 0
    for a, idx in segments:
        k = a.shape[1]
        part = linear_plain(gather_segments([(a, idx)]),
                            weight[:, koff:koff + k])
        y = part if y is None else y + part
        koff += k
    if bias is not None:
        y = y + bias.float()
    if pre is not None:
        pre.copy_(y)
    if act == "gelu":
        y = F.gelu(y)
    elif act == "relu":
        y = torch.relu(y)
    if emul is not None:
        y = y * emul
    if row_scale is not None:
        y = y * row_scale[:, None]
    return y.to(out_dtype)


def product(segments: Segments, weight: torch.Tensor, *args,
            **kwargs) -> torch.Tensor:
    """A graph layer's product: :func:`gemm_gather` for a bf16 weight,
    :func:`gemm` (3xTF32) for an f32 one; the same arguments."""
    fn = gemm_gather if weight.dtype == torch.bfloat16 else gemm
    return fn(segments, weight, *args, **kwargs)


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


def split_bf16x3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """``(x1, x2, x3)`` with ``x ~= x1 + x2 + x3``, f32 tensors of bf16
    values: ``x1`` is ``x`` rounded to bf16 (to nearest even), ``x2`` the
    same rounding of ``x - x1`` and ``x3`` of ``x - x1 - x2``; together
    they carry f32's 24 mantissa bits."""
    xf = x.float()
    x1 = xf.to(torch.bfloat16).float()
    r = xf - x1
    x2 = r.to(torch.bfloat16).float()
    return x1, x2, (r - x2).to(torch.bfloat16).float()


def bf16x3_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the staged backward GEMM's bf16x3 core takes it: the
    f32 ``a`` split into three bf16 planes, ``b`` exact in bf16, the
    products ``a3 b + a2 b + a1 b`` (each exact in f32) summed in f32."""
    a1, a2, a3 = split_bf16x3(a)
    bf = b.float()
    return (a3 @ bf + a2 @ bf) + a1 @ bf


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
_COUNTER_SLOTS = 1024     # the last one: finish_counter's


def _tile_counters(device: torch.device) -> torch.Tensor:
    """Arrival counters of the kernels whose last block finishes a sum
    (the split-K epilogues, one a tile; the LayerNorm backward, the last
    slot), zeroed once per device; each call's last block resets the
    counters it used, so they stay zeroed between the calls on a
    stream."""
    t = _COUNTERS.get(device)
    if t is None:
        t = _COUNTERS[device] = torch.zeros(_COUNTER_SLOTS,
                                            dtype=torch.int32, device=device)
    return t


def finish_counter(device: torch.device) -> int:
    """Address of the counter a kernel's last block uses to finish a sum
    over its blocks (one launch at a time on a stream)."""
    return _tile_counters(device).data_ptr() + 4 * (_COUNTER_SLOTS - 1)


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


# ------------------------------------------------ staged backward GEMM

class Out(NamedTuple):
    """A column range of a dgrad's result: ``out = act'(acc + add)``, with
    ``act'`` None, ``"gelu"`` (exact GELU's derivative at the f32
    pre-activation ``pre``) or ``"relu"`` (``(pre > 0) * keep``, ``pre``
    the saved ReLU output, ``keep`` its dropout mask or None).  Every
    tensor is ``[M, width]`` with unit column stride, f32 or bf16; ``out``
    may be ``add`` (an accumulation in place)."""
    out: torch.Tensor
    add: Optional[torch.Tensor] = None
    act: Optional[str] = None
    pre: Optional[torch.Tensor] = None
    keep: Optional[torch.Tensor] = None


class Problem(NamedTuple):
    """One product of a backward stage (:func:`stage_dgrad`,
    :func:`stage_wgrad`)."""
    kind: int                     # 0 dgrad, 1 wgrad
    g: torch.Tensor               # the f32 gradient
    segs: Tuple                   # ((S, idx | None), ...)
    outs: Tuple                   # (Out, ...)
    bias: Optional[torch.Tensor]


def stage_dgrad(g: torch.Tensor, weight: torch.Tensor,
                outs: Sequence[Out]) -> Problem:
    """``g [M, N'] @ weight [N', K]``, the input gradient of ``x @ W^T``
    (``weight`` may be a row range of a wider weight), its K columns
    split over ``outs`` in order."""
    return Problem(0, g, ((weight, None),), tuple(outs), None)


def stage_wgrad(g: torch.Tensor, segs: Segments, out: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> Problem:
    """``g [rows, N']^T @ [x_0[idx_0] | x_1[idx_1] | ...]`` into ``out
    [N', sum K_s]`` (f32), the weight gradient of a product whose input
    is the segments side by side (row ``idx[r]`` of ``x``, a zero row
    where it is negative); ``bias [N']`` (f32) receives the column sums
    of ``g``, the bias gradient."""
    return Problem(1, g, tuple(segs), (Out(out),), bias)


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU's derivative, ``Phi(x) + x phi(x)``."""
    return (0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
            + x * 0.3989422804014327 * torch.exp(-0.5 * x * x))


def bwd_stage_plain(*problems: Problem) -> None:
    """:func:`bwd_stage` in plain PyTorch: each product in the kernel's
    arithmetic (:func:`bf16x3_mm` for a bf16 S, :func:`tf32x3_mm` for an
    f32 one), the bias as the f32 column sum, then the epilogue."""
    for pr in problems:
        mm = bf16x3_mm if pr.segs[0][0].dtype == torch.bfloat16 \
            else tf32x3_mm
        g = pr.g.float()
        if pr.kind == 0:
            y = mm(g, pr.segs[0][0].float())
        else:
            y = mm(g.t(), gather_segments(pr.segs).float())
            if pr.bias is not None:
                pr.bias.copy_(g.sum(0))
        col = 0
        for o in pr.outs:
            w = o.out.shape[1]
            v = y[:, col:col + w]
            if o.add is not None:
                v = v + o.add.float()
            if o.act == "gelu":
                v = v * gelu_grad(o.pre.float())
            elif o.act == "relu":
                v = torch.where(o.pre.float() > 0, v, torch.zeros_like(v))
                if o.keep is not None:
                    v = v * o.keep.float()
            o.out.copy_(v)
            col += w


# S's dtype -> (core code, block rows, block columns, reduction slice,
# blocks the card holds at once)
_BWD_CORES = {torch.bfloat16: (1, 64, 304, 64, 132),
              torch.float32: (0, 64, 128, 32, 264)}
_BWD_ACT = {None: 0, "gelu": 1, "relu": 2}
_BWD_DT = {torch.float32: 0, torch.bfloat16: 1}
_BWD_RULE = ("an f32 gradient G, S tensors of one type (bf16 or f32) whose "
             "row pitches and column starts are multiples of 4 elements, "
             "N a multiple of 4, a dgrad's K and a wgrad's M multiples of "
             "4, 16-byte aligned G")
_BWD_NONE = (0, 0, 0)


def _bwd_ref(t: Optional[torch.Tensor], rows: int):
    """``(pointer, row pitch, dtype code)`` of a contiguous CUDA ``[rows,
    *]`` f32 or bf16 tensor (a row range of one is fine)."""
    if t is None:
        return _BWD_NONE
    if not (t.is_cuda and t.is_contiguous() and t.shape[0] == rows
            and t.dtype in _BWD_DT):
        raise ValueError(f"bwd_stage takes contiguous CUDA f32 or bf16 "
                         f"[{rows}, *] tensors, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.data_ptr(), t.shape[1], _BWD_DT[t.dtype]


def bwd_stage(*problems: Problem) -> None:
    """One stage of a training layer's backward: every problem's product
    and epilogue in one launch (``csrc/gemm_bwd.cu:isg_gemm_bwd``), the
    wgrads' blocks first.  Every tensor is contiguous (a row range of a
    contiguous tensor is).  On CPU tensors it runs
    :func:`bwd_stage_plain`; on CUDA tensors it launches the kernel or
    raises.  Few attribute reads: a decoder layer's backward issues six
    of these."""
    if not problems[0].g.is_cuda:
        return bwd_stage_plain(*problems)
    if len(problems) > 4:
        raise ValueError("bwd_stage takes at most four problems")
    if len(problems) > 1:
        problems = ([pr for pr in problems if pr.kind]
                    + [pr for pr in problems if not pr.kind])
    s_dt = problems[0].segs[0][0].dtype
    if s_dt not in _BWD_CORES:
        raise TypeError(f"bwd_stage takes {_BWD_RULE}")
    core, bm, bn, bk, at_once = _BWD_CORES[s_dt]
    words = []
    splits = []            # (word index of the work pointer, floats, tiles)
    block0 = 0
    for pr in problems:
        g, bias = pr.g, pr.bias
        gp, ldg, gdt = _bwd_ref(g, g.shape[0])
        if gdt:
            raise TypeError(f"bwd_stage takes {_BWD_RULE}")
        if pr.kind:
            k, m = g.shape
        else:
            m, k = g.shape
        words += [pr.kind, gp, ldg, m, 0, k,
                  0 if bias is None else _bwd_ref(bias[:, None], m)[0]]
        ni = len(words) - 3                       # N, known below
        n = 0
        for x, idx in pr.segs:
            xp, ldx, _ = _bwd_ref(x, x.shape[0])
            if x.dtype != s_dt or x.shape[0] * ldx >= 2 ** 31:
                raise TypeError(f"bwd_stage takes {_BWD_RULE}; S under 2^31 "
                                f"elements")
            if idx is not None and not (idx.dtype == torch.int32
                                        and idx.is_contiguous()
                                        and idx.is_cuda
                                        and idx.shape[0] == k):
                raise ValueError(f"bwd_stage: int32 [{k}] row index "
                                 f"expected")
            words += [xp, 0 if idx is None else idx.data_ptr(), ldx, n]
            n += x.shape[1]
        words[ni] = n
        words += [0, 0, 0, 0] * (3 - len(pr.segs)) + [len(pr.segs)]
        n0 = 0
        for out, add, act, pre, keep in pr.outs:
            w = out.shape[1]
            if (add is not None and add.shape[1] != w
                    or pre is not None and pre.shape[1] != w
                    or keep is not None and keep.shape[1] != w):
                raise ValueError("bwd_stage: epilogue inputs must match "
                                 "their output's width")
            words += _bwd_ref(out, m)
            words += _BWD_NONE if add is None else _bwd_ref(add, m)
            words.append(_BWD_ACT[act])
            words += _BWD_NONE if pre is None else _bwd_ref(pre, m)
            words += _BWD_NONE if keep is None else _bwd_ref(keep, m)
            words.append(n0)
            n0 += w
        if n0 != n:
            raise ValueError(f"bwd_stage: outputs of {n0} columns for a "
                             f"product of {n}")
        # tiles, and a wgrad's reduction over rows split so that its blocks
        # about fill the card once, at least 512 rows a slice
        nw = n + (bias is not None)
        tm, tn = -(-m // bm), -(-nw // bn)
        z = max(1, min(at_once // (tm * tn), k // 512, 64)) if pr.kind else 1
        kchunk = -(-(-(-k // z)) // bk) * bk
        z = -(-k // kchunk)
        words += [0] * 14 * (3 - len(pr.outs)) + [len(pr.outs), tn, z,
                                                   kchunk, block0, 0, 0]
        if z > 1:      # partial tiles at a row pitch of N + 1 rounded to 4
            splits.append((len(words) - 2, z * m * (-(-nw // 4) * 4),
                           tm * tn))
        block0 += tm * tn * z
    if splits:
        dev = problems[0].g.device
        if sum(t for _, _, t in splits) > _COUNTER_SLOTS - 1:
            raise ValueError("bwd_stage: too many split tiles")
        work = torch.empty(sum(f for _, f, _ in splits), dtype=torch.float32,
                           device=dev)
        wp, cp = work.data_ptr(), _tile_counters(dev).data_ptr()
        for i, floats, tiles in splits:
            words[i], words[i + 1] = wp, cp
            wp += 4 * floats
            cp += 4 * tiles
    _lib.call("isg_gemm_bwd", struct.pack(f"{len(words)}q", *words),
              len(problems), core, invalid=_BWD_RULE)


def bwd_stage_checked(*problems: Problem) -> dict:
    """:func:`bwd_stage` and, first, its plain twin on copies of every
    output, epilogue addend and bias (an output that is also its addend
    keeps that: the copy is shared).  Returns the worst error by output
    type, ``{"float32": e, "bfloat16": e}``: an output's max abs error over
    its scale, the twin's max abs (at least 1), or for a bias gradient the
    largest sum of absolute values it adds up (a bias that cancels to
    rounding noise, as the one before GraphNorm does, holds noise of that
    size); a NaN sticks.  For checks on the card; the layers call
    :func:`bwd_stage`."""
    copies = {}

    def copy(t):
        if t is None:
            return None
        if id(t) not in copies:
            copies[id(t)] = (t, t.clone())
        return copies[id(t)][1]

    twins = [pr._replace(
        outs=tuple(o._replace(out=copy(o.out), add=copy(o.add))
                   for o in pr.outs), bias=copy(pr.bias))
        for pr in problems]
    bwd_stage_plain(*twins)
    bwd_stage(*problems)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for pr, tw in zip(problems, twins):
        pairs = [(o.out, t.out, 0.0) for o, t in zip(pr.outs, tw.outs)]
        if pr.bias is not None:
            pairs.append((pr.bias, tw.bias,
                          pr.g.abs().sum(0).max().item()))
        for got, want, terms in pairs:
            scale = max(1.0, want.float().abs().max().item(), terms)
            err = (got.float() - want.float()).abs().max().item() / scale
            key = str(got.dtype)[6:]
            if not err <= worst[key]:
                worst[key] = err
    return worst
