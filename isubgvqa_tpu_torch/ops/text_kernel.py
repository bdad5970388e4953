"""Post-LN transformer layers of the question stack, on the card.

Replaces ``isubgvqa_tpu/ops/pallas/text_kernel.py:fused_encoder_layer``
(``_enc_kernel``) and ``fused_decoder_layer`` (``_dec_kernel``).

Design on the H100: a short fixed sequence of hand-written launches per
layer, by the model dtype (fixed per call site, no fallback between
them):

* bf16 — the Hopper GEMM (``csrc/gemm_sm90.cu``: TMA loads, ``wgmma``)
  for the QKV and FFN-in products; the out projection and FFN-out
  products with the residual add and LayerNorm in their epilogue (the
  stack's final LayerNorm folded into the last one); the tensor-core
  attention core (``csrc/text_kernel.cu:isg_attention_mma``, one block per
  question and four heads, one warp per head).  4 launches per encoder
  layer, 9 per decoder layer;
* f32 — the shared GEMM of the graph layers (``csrc/gemm.cu``, 3xTF32),
  the scalar attention core (``isg_attention``) and the residual +
  LayerNorm kernel (``isg_residual_ln``).

Intermediates that the Pallas kernel rounds to the model dtype before
their next product (q, k, v, the attention output, the ReLU activations)
are stored at that dtype; residual streams stay f32.

Bound: at L = 16/32 tokens and B = 32..1024 questions a layer's
products (about 2 * 12 * D^2 FLOPs per token, D = 512) dominate, so it
is operation-bound, and its time is mostly the GEMM's.

On a CPU tensor the wrapper runs the ``*_plain`` version, the same
arithmetic in plain PyTorch.  On a CUDA tensor it launches the kernels
or raises.  The plain versions take optional dropout keep masks (the
training layers' forward, :mod:`.text_train`); the launches can keep
what the training backward reads (``save=True``).

:func:`encoder_layer_library` and :func:`decoder_layer_library` are the
one-call PyTorch layers that compute the same functions
(``nn.TransformerEncoderLayer`` / ``nn.TransformerDecoderLayer``), for
measurements only: the port never calls them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _lib
from .gemm import gemm, gemm_ln_sm90, gemm_sm90, linear_plain, ste

LN_EPS = 1e-6      # flax nn.LayerNorm default, as in the JAX package

ENC_KEYS = ("in_w", "in_b", "out_w", "out_b", "n1s", "n1b",
            "w1", "b1", "w2", "b2", "n2s", "n2b")
DEC_KEYS = ("s_in_w", "s_in_b", "s_out_w", "s_out_b", "n1s", "n1b",
            "c_in_w", "c_in_b", "c_out_w", "c_out_b", "n2s", "n2b",
            "w1", "b1", "w2", "b2", "n3s", "n3b")


# ------------------------------------------------------------ plain twins

def ln_plain(x: torch.Tensor, scale, bias):
    """flax LayerNorm numerics in f32: fast variance clamped at 0."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale.float() + bias.float()


def mha_plain(q_in, kv_in, colbias, in_w, in_b, out_w, out_b,
              num_heads: int, dtype: torch.dtype,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention as inside ``_mha``: q/k/v and the
    probabilities (times the dropout ``keep`` mask ``[B, H, Lq, Lk]``,
    when given) rounded to ``dtype`` before their products, the key
    bias ADDED to the logits.  Returns the f32 output projection."""
    b, lq, d = q_in.shape
    lk = kv_in.shape[1]
    dh = d // num_heads

    def heads(t, n):
        return ste(t, dtype).reshape(b, n, num_heads, dh).transpose(1, 2)

    q = heads(linear_plain(q_in, in_w[:d], in_b[:d], dtype=dtype), lq)
    k = heads(linear_plain(kv_in, in_w[d:2 * d], in_b[d:2 * d],
                           dtype=dtype), lk)
    v = heads(linear_plain(kv_in, in_w[2 * d:], in_b[2 * d:], dtype=dtype),
              lk)
    sc = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    if colbias is not None:
        sc = sc + colbias.float()[:, None, None, :]
    p = torch.softmax(sc, dim=-1)
    if keep is not None:
        p = p * keep
    o = ste(ste(p, dtype) @ v, dtype).transpose(1, 2).reshape(b, lq, d)
    return linear_plain(o, out_w, out_b, dtype=dtype)


def masks_at(masks, dtype):
    """Dropout keep masks as f32 tensors holding values of ``dtype`` (the
    Pallas training kernels ship them at the model dtype); ``{}`` when
    there are none."""
    return {k: v.to(dtype).float() for k, v in (masks or {}).items()}


def _mul(x, m):
    return x if m is None else x * m


def fused_encoder_layer_plain(x, key_mask, params, num_heads: int = 8,
                              final_ln: Optional[Tuple] = None,
                              masks: Optional[dict] = None):
    """``masks``: the training layer's keep masks (``attn [B,H,L,L]``,
    ``post_attn``, ``ffn``, ``post_ffn``), or None for no dropout."""
    p = params
    dtype = x.dtype
    m = masks_at(masks, dtype)
    xf = x.float()
    attn = mha_plain(xf, xf, key_mask, p["in_w"], p["in_b"], p["out_w"],
                     p["out_b"], num_heads, dtype, m.get("attn"))
    x1 = ln_plain(xf + _mul(attn, m.get("post_attn")), p["n1s"], p["n1b"])
    h = _mul(linear_plain(x1, p["w1"], p["b1"], "relu", dtype), m.get("ffn"))
    y = _mul(linear_plain(h, p["w2"], p["b2"], dtype=dtype), m.get("post_ffn"))
    out = ln_plain(x1 + y, p["n2s"], p["n2b"])
    if final_ln is not None:
        out = ln_plain(out, *final_ln)
    return out.to(dtype)


def fused_decoder_layer_plain(tgt, memory, params, num_heads: int = 8,
                              final_ln: Optional[Tuple] = None,
                              masks: Optional[dict] = None):
    """``masks``: ``self_attn [B,H,T,T]``, ``post_sa``, ``cross_attn
    [B,H,T,L]``, ``post_ca``, ``ffn``, ``post_ffn``, or None."""
    p = params
    dtype = memory.dtype
    m = masks_at(masks, dtype)
    t = ste(tgt, dtype)
    mem = memory.float()
    sa = mha_plain(t, t, None, p["s_in_w"], p["s_in_b"], p["s_out_w"],
                   p["s_out_b"], num_heads, dtype, m.get("self_attn"))
    t = ln_plain(t + _mul(sa, m.get("post_sa")), p["n1s"], p["n1b"])
    ca = mha_plain(t, mem, None, p["c_in_w"], p["c_in_b"], p["c_out_w"],
                   p["c_out_b"], num_heads, dtype, m.get("cross_attn"))
    t = ln_plain(t + _mul(ca, m.get("post_ca")), p["n2s"], p["n2b"])
    h = _mul(linear_plain(t, p["w1"], p["b1"], "relu", dtype), m.get("ffn"))
    y = _mul(linear_plain(h, p["w2"], p["b2"], dtype=dtype), m.get("post_ffn"))
    t = ln_plain(t + y, p["n3s"], p["n3b"])
    if final_ln is not None:
        t = ln_plain(t, *final_ln)
    return t.to(dtype)


# ------------------------------------------------------------- launches

def _attention(q, q_off, q_rs, kv, k_off, v_off, kv_rs, bias, b, lq, lk,
               d, num_heads, keep=None, probs=None):
    """Attention core over row-major activations; head h of row r of
    question i sits at ``base[(i * L + r) * rs + off + h * dh]``.
    ``keep [B, H, Lq, Lk]`` (f32) multiplies the probabilities; ``probs``
    (f32, same shape) receives them before the mask."""
    es = q.element_size()
    o = torch.empty((b * lq, d), dtype=q.dtype, device=q.device)
    dh = d // num_heads
    _lib.check_cuda(q, kv, bias, keep, probs)
    qp, kp, vp = (q.data_ptr() + q_off * es, kv.data_ptr() + k_off * es,
                  kv.data_ptr() + v_off * es)
    if q.dtype == torch.bfloat16:
        # tensor cores: 16-byte staging, so pitches and offsets in 8s
        if (q_off | k_off | v_off) % 8:
            raise ValueError("isg_attention_mma takes column offsets in 8s")
        _lib.call("isg_attention_mma", qp, q_rs, kp, kv_rs, vp, kv_rs,
                  _lib.ptr(bias), _lib.ptr(keep), _lib.ptr(probs),
                  o.data_ptr(), b, lq, lk, num_heads, dh,
                  1.0 / math.sqrt(dh),
                  invalid=f"takes L <= 64, head width 16/32/64/128, H <= 16 "
                          f"and row pitches in 8s (got Lq={lq}, Lk={lk}, "
                          f"dh={dh}, H={num_heads})")
    else:
        _lib.call("isg_attention", qp, q_rs, kp, kv_rs, vp, kv_rs,
                  _lib.ptr(bias), _lib.ptr(keep), _lib.ptr(probs),
                  o.data_ptr(), d, b, lq, lk, num_heads,
                  dh, 1.0 / math.sqrt(dh), _lib.dt(q))
    return o


def _linear(a, w, bias, act=None, out_dtype=torch.float32, emul=None):
    """One product of the layer: the Hopper GEMM for bf16 operands, the
    shared GEMM (3xTF32) for f32 ones."""
    if w.dtype == torch.bfloat16:
        return gemm_sm90(a, w, bias, act, out_dtype, emul)
    return gemm([(a, None)], w, bias, act=act, out_dtype=out_dtype,
                emul=emul)


def _linear_ln(a, w, bias, x, s, bb, final_ln=None, out_f32=True,
               out_t=None, ymask=None, z_out=None):
    """``LN(x + (a @ w.T + bias) * ymask)``: for bf16 the LayerNorm runs in
    the Hopper GEMM's epilogue; for f32 the product goes to the shared
    GEMM and then :func:`_residual_ln`.  Returns ``(f32, at out_t)``."""
    if w.dtype == torch.bfloat16:
        return gemm_ln_sm90(a, w, bias, x, s, bb, final_ln, out_f32, out_t,
                            ymask, z_out, LN_EPS)
    y = gemm([(a, None)], w, bias)
    return _residual_ln(x, y, s, bb, final_ln, out_f32, out_t, ymask, z_out)


def _residual_ln(x, y, s, bb, final_ln=None, out_f32=True, out_t=None,
                 ymask=None, z_out=None):
    """LN(x + y * ymask), optionally followed by ``final_ln``; ``z_out``
    (f32 ``[M, D]``) receives the pre-LN sum.  ``D <= 1024``, a multiple
    of 4."""
    m, d = x.shape
    of = (torch.empty((m, d), dtype=torch.float32, device=x.device)
          if out_f32 else None)
    ot = (torch.empty((m, d), dtype=out_t, device=x.device)
          if out_t is not None else None)
    fs, fb = final_ln if final_ln is not None else (None, None)
    _lib.check_cuda(x, y, s, bb, fs, fb, ymask, z_out)
    _lib.call("isg_residual_ln", x.data_ptr(), _lib.dt(x), _lib.ptr(y),
              s.data_ptr(), bb.data_ptr(), _lib.ptr(fs), _lib.ptr(fb),
              _lib.ptr(ymask), _lib.ptr(z_out),
              _lib.ptr(of), _lib.ptr(ot), _lib.dt(ot) if ot is not None else 0,
              m, d, LN_EPS, invalid="takes rows of D <= 1024, a multiple of 4")
    return of, ot


def _check_shapes(l: int, d: int, num_heads: int):
    if l > 64 or d % num_heads or d // num_heads > 128 or d > 1024:
        raise ValueError(f"text kernels take L <= 64, D <= 1024 and head "
                         f"width <= 128 (got L={l}, D={d}, H={num_heads})")


def _rows(m, r):
    return None if m is None else m.reshape(r, -1).contiguous()


def encoder_launch(x, key_mask, params, num_heads: int = 8,
                   final_ln: Optional[Tuple] = None,
                   masks: Optional[dict] = None, save: bool = False):
    """The encoder layer's launches on CUDA tensors.  ``params`` shipped
    (weights at the model dtype), ``masks`` f32 keep masks or None.
    Returns ``(out [B, L, D], saved)``; ``saved`` holds what the training
    backward reads when ``save``."""
    p = params
    b, l, d = x.shape
    _check_shapes(l, d, num_heads)
    dtype = x.dtype
    r = b * l
    m = masks or {}
    keep = None if m.get("attn") is None else m["attn"].contiguous()
    m1, mf, m2 = (_rows(m.get(k), r) for k in ("post_attn", "ffn",
                                                "post_ffn"))
    xt = x.reshape(r, d).contiguous()
    kb = key_mask.to(torch.float32).contiguous()
    _lib.check_cuda(kb)
    f32 = dict(dtype=torch.float32, device=x.device)
    probs = torch.empty((b, num_heads, l, l), **f32) if save else None
    z1 = torch.empty((r, d), **f32) if save else None
    z2 = torch.empty((r, d), **f32) if save else None
    qkv = _linear(xt, p["in_w"], p["in_b"], out_dtype=dtype)
    o = _attention(qkv, 0, 3 * d, qkv, d, 2 * d, 3 * d, kb, b, l, l, d,
                   num_heads, keep, probs)
    x1f, x1t = _linear_ln(o, p["out_w"], p["out_b"], xt, p["n1s"], p["n1b"],
                          out_t=dtype, ymask=m1, z_out=z1)
    hid = _linear(x1t, p["w1"], p["b1"], "relu", dtype, mf)
    _, out = _linear_ln(hid, p["w2"], p["b2"], x1f, p["n2s"], p["n2b"],
                        final_ln, out_f32=False, out_t=dtype, ymask=m2,
                        z_out=z2)
    saved = (dict(xt=xt, kb=kb, keep=keep, m1=m1, mf=mf, m2=m2, qkv=qkv,
                  probs=probs, o=o, z1=z1, x1t=x1t, hid=hid, z2=z2)
             if save else None)
    return out.reshape(b, l, d), saved


def fused_encoder_layer(x, key_mask, params, num_heads: int = 8,
                        final_ln: Optional[Tuple] = None):
    """One post-LN encoder layer.  ``x [B, L, D]`` at the model dtype,
    ``key_mask [B, L]`` (the CLIP attention mask, added to the key
    logits).  ``params``: :data:`ENC_KEYS` — weights as torch Linear
    ``[out, in]`` at the model dtype, biases and LN vectors f32.
    Returns ``[B, L, D]`` at ``x.dtype``."""
    if not x.is_cuda:
        return fused_encoder_layer_plain(x, key_mask, params, num_heads,
                                         final_ln)
    out, _ = encoder_launch(x, key_mask, params, num_heads, final_ln)
    fused_encoder_layer.launches += 1
    return out


fused_encoder_layer.launches = 0


def decoder_launch(tgt, memory, params, num_heads: int = 8,
                   final_ln: Optional[Tuple] = None,
                   masks: Optional[dict] = None, save: bool = False):
    """The decoder layer's launches on CUDA tensors (see
    :func:`encoder_launch`)."""
    p = params
    b, t, d = tgt.shape
    l = memory.shape[1]
    _check_shapes(max(t, l), d, num_heads)
    dtype = memory.dtype
    rt = b * t
    m = masks or {}
    ks = None if m.get("self_attn") is None else m["self_attn"].contiguous()
    kc = None if m.get("cross_attn") is None else m["cross_attn"].contiguous()
    m1, m2, mf, m3 = (_rows(m.get(k), rt) for k in ("post_sa", "post_ca",
                                                     "ffn", "post_ffn"))
    f32 = dict(dtype=torch.float32, device=tgt.device)
    ps = torch.empty((b, num_heads, t, t), **f32) if save else None
    pc = torch.empty((b, num_heads, t, l), **f32) if save else None
    z1, z2, z3 = ((torch.empty((rt, d), **f32) if save else None)
                  for _ in range(3))
    tt = tgt.to(dtype).reshape(rt, d).contiguous()
    mt = memory.reshape(b * l, d).contiguous()
    # the memory's K/V projection, the layer's largest product, needs
    # nothing of the self-attention: launched first, it runs while the
    # host issues the rest
    kv = _linear(mt, p["c_in_w"][d:], p["c_in_b"][d:], out_dtype=dtype)
    qkv = _linear(tt, p["s_in_w"], p["s_in_b"], out_dtype=dtype)
    o_s = _attention(qkv, 0, 3 * d, qkv, d, 2 * d, 3 * d, None, b, t, t, d,
                     num_heads, ks, ps)
    t1f, t1t = _linear_ln(o_s, p["s_out_w"], p["s_out_b"], tt, p["n1s"],
                          p["n1b"], out_t=dtype, ymask=m1, z_out=z1)
    q = _linear(t1t, p["c_in_w"][:d], p["c_in_b"][:d], out_dtype=dtype)
    o_c = _attention(q, 0, d, kv, 0, d, 2 * d, None, b, t, l, d, num_heads,
                     kc, pc)
    t2f, t2t = _linear_ln(o_c, p["c_out_w"], p["c_out_b"], t1f, p["n2s"],
                          p["n2b"], out_t=dtype, ymask=m2, z_out=z2)
    hid = _linear(t2t, p["w1"], p["b1"], "relu", dtype, mf)
    _, out = _linear_ln(hid, p["w2"], p["b2"], t2f, p["n3s"], p["n3b"],
                        final_ln, out_f32=False, out_t=dtype, ymask=m3,
                        z_out=z3)
    saved = (dict(tt=tt, mt=mt, ks=ks, kc=kc, m1=m1, m2=m2, mf=mf, m3=m3,
                  qkv=qkv, ps=ps, o_s=o_s, z1=z1, t1t=t1t, q=q, kv=kv, pc=pc,
                  o_c=o_c, z2=z2, t2t=t2t, hid=hid, z3=z3)
             if save else None)
    return out.reshape(b, t, d), saved


def fused_decoder_layer(tgt, memory, params, num_heads: int = 8,
                        final_ln: Optional[Tuple] = None):
    """One post-LN decoder layer: self-attention over the ``T`` learned
    queries, cross-attention to every memory token (no padding mask),
    the ReLU FFN, three LayerNorms.  ``tgt [B, T, D]``, ``memory
    [B, L, D]``; ``params``: :data:`DEC_KEYS`.  Returns ``[B, T, D]``
    at ``memory.dtype``."""
    if not memory.is_cuda:
        return fused_decoder_layer_plain(tgt, memory, params, num_heads,
                                         final_ln)
    out, _ = decoder_launch(tgt, memory, params, num_heads, final_ln)
    fused_decoder_layer.launches += 1
    return out


fused_decoder_layer.launches = 0


def attention_library(q, k, v, bias):
    """``F.scaled_dot_product_attention`` on the same attention core
    (``[B, H, L, dh]`` operands, ``bias [B, L]`` added to the key
    logits).  A yardstick for measurements only; the port never calls
    it."""
    mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


_ENC_LIBRARY = {"self_attn.in_proj_weight": "in_w",
                "self_attn.in_proj_bias": "in_b",
                "self_attn.out_proj.weight": "out_w",
                "self_attn.out_proj.bias": "out_b",
                "norm1.weight": "n1s", "norm1.bias": "n1b",
                "linear1.weight": "w1", "linear1.bias": "b1",
                "linear2.weight": "w2", "linear2.bias": "b2",
                "norm2.weight": "n2s", "norm2.bias": "n2b"}
_DEC_LIBRARY = {"self_attn.in_proj_weight": "s_in_w",
                "self_attn.in_proj_bias": "s_in_b",
                "self_attn.out_proj.weight": "s_out_w",
                "self_attn.out_proj.bias": "s_out_b",
                "multihead_attn.in_proj_weight": "c_in_w",
                "multihead_attn.in_proj_bias": "c_in_b",
                "multihead_attn.out_proj.weight": "c_out_w",
                "multihead_attn.out_proj.bias": "c_out_b",
                "norm1.weight": "n1s", "norm1.bias": "n1b",
                "norm2.weight": "n2s", "norm2.bias": "n2b",
                "norm3.weight": "n3s", "norm3.bias": "n3b",
                "linear1.weight": "w1", "linear1.bias": "b1",
                "linear2.weight": "w2", "linear2.bias": "b2"}


def _library_layer(cls, names, params, num_heads, dtype, dropout):
    d = params[names["linear1.weight"]].shape[1]
    f = params[names["linear1.weight"]].shape[0]
    dev = params[names["linear1.weight"]].device
    layer = cls(d, num_heads, dim_feedforward=f, dropout=dropout,
                activation="relu", layer_norm_eps=LN_EPS, batch_first=True,
                norm_first=False, device=dev, dtype=dtype)
    layer.load_state_dict({k: params[v].detach() for k, v in names.items()})
    return layer.train(dropout > 0)


def _no_fastpath(fn):
    """``fn`` with the MHA fast path off: in eval mode it would read the
    additive key mask (the CLIP attention mask, ADDED to the logits) as a
    padding mask and compute another function."""
    def run(*args):
        was = torch.backends.mha.get_fastpath_enabled()
        torch.backends.mha.set_fastpath_enabled(False)
        try:
            return fn(*args)
        finally:
            torch.backends.mha.set_fastpath_enabled(was)
    return run


def encoder_layer_library(params, num_heads: int = 8,
                          dtype: torch.dtype = torch.float32,
                          dropout: float = 0.0):
    """The one PyTorch call that computes :func:`fused_encoder_layer` (no
    final LayerNorm): ``nn.TransformerEncoderLayer`` (post-LN, ReLU,
    ``batch_first``, eps 1e-6) loaded from the port's parameter dict
    (:data:`ENC_KEYS`) at ``dtype``; ``dropout > 0`` builds it in train
    mode.  Returns ``run(x, key_mask)`` (the module as ``run.layer``);
    the float key mask is added to the key logits.  A yardstick for
    measurements only."""
    layer = _library_layer(torch.nn.TransformerEncoderLayer, _ENC_LIBRARY,
                           params, num_heads, dtype, dropout)
    run = _no_fastpath(lambda x, key_mask: layer(
        x, src_key_padding_mask=key_mask.to(x.dtype)))
    run.layer = layer
    return run


def decoder_layer_library(params, num_heads: int = 8,
                          dtype: torch.dtype = torch.float32,
                          dropout: float = 0.0):
    """The one PyTorch call that computes :func:`fused_decoder_layer` (no
    final LayerNorm): ``nn.TransformerDecoderLayer`` from the port's
    parameter dict (:data:`DEC_KEYS`), as :func:`encoder_layer_library`.
    Returns ``run(tgt, memory)``."""
    layer = _library_layer(torch.nn.TransformerDecoderLayer, _DEC_LIBRARY,
                           params, num_heads, dtype, dropout)
    run = _no_fastpath(lambda tgt, memory: layer(tgt.to(memory.dtype),
                                                 memory))
    run.layer = layer
    return run
