"""Training layers of the question stack: the encoder and decoder layer
with live dropout, forward and backward on the card.

Replaces ``isubgvqa_tpu/ops/pallas/text_train.py:fused_encoder_layer_train``
(``_enc_call``: ``_make_enc_fwd`` / ``_make_enc_bwd``) and
``fused_decoder_layer_train`` (``_dec_call``: ``_make_dec_fwd`` /
``_make_dec_bwd``).

Each is a :class:`torch.autograd.Function`:

* forward — the eval layer's launches (:func:`.text_kernel.encoder_launch`,
  :func:`.text_kernel.decoder_launch`) with the dropout keep masks
  applied where the Pallas kernel applies them (the attention
  probabilities inside the attention core, the residual branches inside
  the LayerNorm epilogue, the FFN activation in the GEMM's epilogue),
  keeping what the backward reads: q, k, v at the model dtype, the
  softmax probabilities, the pre-LN sums, the FFN activation.  The TPU
  recomputes those in VMEM instead; on the H100 the largest saved tensor
  of a layer at B = 256 questions, L = 32 is the FFN activation (16 MB in
  bf16), so saving is cheap;
* backward — hand-written launches only.  The encoder layer
  (:func:`encoder_backward`): ``isg_ln_bwd`` (one warp per row, its scale
  and bias gradients summed by its last block), the shared
  backward GEMM's dgrad and wgrad forms (``csrc/gemm_any.cu``, split-K,
  the slices summed in order by each tile's last block), ``isg_colsum``
  for the biases, ``isg_relu_bwd`` and ``isg_attention_bwd`` (one block
  per question and head).  The decoder layer (:func:`decoder_backward`):
  eleven launches, the three LayerNorm backwards, the two attention
  backwards, and six stages of the
  staged backward GEMM (:func:`.gemm.bwd_stage`, ``csrc/gemm_bwd.cu``):
  each product's weight and bias gradient and its input gradient in one
  launch, ReLU's derivative times the keep mask, the accumulation into
  the residual gradient and the output casts of ``dtgt`` / ``dmem`` in
  the epilogue, the cross-attention's q and kv halves in one launch.
  Gradients are f32 throughout, as in the Pallas backward.

Bound on the H100: the encoder layer's backward products (about 3 x 2 x
12 D^2 FLOPs per token for forward and backward) make it
operation-bound, run in the 3xTF32 form on the TF32 tensor cores.  The
decoder layer's backward is small (3.2e10 FLOP at B = 256, L = 32: tens
of microseconds of tensor-core time) and is bound by the host's issue of
its launches, which the staged form keeps to eleven.

The plain version is the eval plain (:func:`.text_kernel.
fused_encoder_layer_plain`) with the masks, differentiated by autograd;
its roundings go through :func:`.gemm.ste`, so its gradients are f32
like the kernels'.  On a CPU tensor the wrapper runs it; on a CUDA
tensor it launches the kernels or raises.  :func:`decoder_backward` runs
on CPU tensors too, through each launch's plain twin
(:func:`decoder_saved_plain` makes the forward's saved tensors there).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _lib
from .gemm import (Out, bwd_stage, colsum, dgrad, finish_counter,
                   linear_plain, stage_dgrad, stage_wgrad, wgrad)
from .text_kernel import (DEC_KEYS, ENC_KEYS, LN_EPS, _mul, _rows,
                          decoder_launch, encoder_launch,
                          fused_decoder_layer_plain,
                          fused_encoder_layer_plain, ln_plain, masks_at)


def ship_params(params: dict, dtype: torch.dtype) -> dict:
    """Weights (2-D) at the model dtype, vectors f32, detached: what the
    kernels read (flax ``Dense(dtype=...)`` rounds weights on every
    call)."""
    return {k: (v.detach().to(dtype) if v.dim() == 2 else v.detach().float())
            .contiguous() for k, v in params.items()}


def fused_encoder_layer_train_plain(x, key_mask, masks, params,
                                    num_heads: int = 8):
    return fused_encoder_layer_plain(x, key_mask, params, num_heads,
                                     masks=masks)


def fused_decoder_layer_train_plain(tgt, memory, masks, params,
                                    num_heads: int = 8):
    return fused_decoder_layer_plain(tgt, memory, params, num_heads,
                                     masks=masks)


# ------------------------------------------------------------ backward

def ln_bwd(g, z, scale, ymask=None):
    """Backward of ``LN(z)`` with ``z = x + y * ymask``: returns
    ``(dz, dy, d scale, d bias)`` (``dy`` is ``dz`` without a mask)."""
    m, d = z.shape
    g = g.reshape(m, d)
    if not z.is_cuda:
        gf = g.float()
        mean = z.mean(-1, keepdim=True)
        var = torch.clamp((z * z).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        r = torch.rsqrt(var + LN_EPS)
        zh = (z - mean) * r
        gs = gf * scale
        dz = r * (gs - gs.mean(-1, keepdim=True)
                  - zh * (gs * zh).mean(-1, keepdim=True))
        return (dz, dz if ymask is None else dz * ymask, (gf * zh).sum(0),
                gf.sum(0))
    g = g.contiguous()
    dz = torch.empty((m, d), dtype=torch.float32, device=z.device)
    dy = torch.empty_like(dz) if ymask is not None else None
    # few enough blocks that the last one sums their partials quickly
    blocks = max(1, min(64, -(-m // 8)))
    part = torch.empty((blocks, 2, d), dtype=torch.float32, device=z.device)
    dsb = torch.empty((2, d), dtype=torch.float32, device=z.device)
    _lib.check_cuda(g, z, scale, ymask)
    _lib.call("isg_ln_bwd", g.data_ptr(), _lib.dt(g), z.data_ptr(),
              scale.data_ptr(), _lib.ptr(ymask), dz.data_ptr(),
              _lib.ptr(dy), part.data_ptr(), dsb.data_ptr(),
              finish_counter(z.device), blocks, m, d, LN_EPS)
    return dz, dy if dy is not None else dz, dsb[0], dsb[1]


def relu_bwd(dy, act, keep=None):
    """``dy * keep * (act > 0)`` (``act`` the saved ReLU output)."""
    dx = torch.empty_like(dy)
    _lib.check_cuda(dy, act, keep)
    _lib.call("isg_relu_bwd", dy.data_ptr(), act.data_ptr(), _lib.dt(act),
              _lib.ptr(keep), dx.data_ptr(), dy.numel())
    return dx


def attention_bwd(q, q_off, q_rs, kv, k_off, v_off, kv_rs, probs, keep,
                  dout, dq, dq_off, dq_rs, dkv, dk_off, dv_off, dkv_rs, b,
                  lq, lk, d, num_heads):
    """Gradients of one attention core, written into the f32 buffers
    ``dq`` / ``dkv`` at the given column offsets (the layouts of
    :func:`.text_kernel._attention`)."""
    es, fs = q.element_size(), 4
    dh = d // num_heads
    if not q.is_cuda:
        cols = lambda t, off, rs: t.reshape(-1, rs)[:, off:off + d]
        heads = lambda t, l: t.float().reshape(b, l, num_heads,
                                               dh).transpose(1, 2)
        qh = heads(cols(q, q_off, q_rs), lq)
        kh = heads(cols(kv, k_off, kv_rs), lk)
        vh = heads(cols(kv, v_off, kv_rs), lk)
        do = heads(dout, lq)
        kp = 1.0 if keep is None else keep
        dpk = (do @ vh.transpose(-1, -2)) * kp
        ds = probs * (dpk - (dpk * probs).sum(-1, keepdim=True))
        rows = lambda t, l: t.transpose(1, 2).reshape(b * l, d)
        scale = 1.0 / math.sqrt(dh)
        cols(dkv, dv_off, dkv_rs).copy_(rows(
            (probs * kp).to(q.dtype).float().transpose(-1, -2) @ do, lk))
        cols(dq, dq_off, dq_rs).copy_(rows(scale * (ds @ kh), lq))
        cols(dkv, dk_off, dkv_rs).copy_(rows(
            scale * (ds.transpose(-1, -2) @ qh), lk))
        return
    _lib.check_cuda(probs, keep, dout, dq, dkv)
    _lib.call("isg_attention_bwd", q.data_ptr() + q_off * es, q_rs,
              kv.data_ptr() + k_off * es, kv_rs, kv.data_ptr() + v_off * es,
              kv_rs, probs.data_ptr(), _lib.ptr(keep), dout.data_ptr(), d,
              dq.data_ptr() + dq_off * fs, dq_rs,
              dkv.data_ptr() + dk_off * fs, dkv_rs,
              dkv.data_ptr() + dv_off * fs, dkv_rs, b, lq, lk, num_heads, dh,
              1.0 / math.sqrt(dh), _lib.dt(q))


def _ffn_bwd(g, z_out, scale_key, s, p, hid, x_in, mf, m_out, grads):
    """The FFN block's backward from the gradient of its LN output.
    Returns the f32 gradient of the block input (the residual and the
    FFN's input)."""
    n = scale_key[1]
    dz, dy, grads[f"n{n}s"], grads[f"n{n}b"] = ln_bwd(g, z_out, p[scale_key],
                                                      m_out)
    grads["w2"] = wgrad(dy, hid)
    grads["b2"] = colsum(dy)
    df1 = relu_bwd(dgrad(dy, p["w2"]), hid, mf)
    grads["w1"] = wgrad(df1, x_in)
    grads["b1"] = colsum(df1)
    return dgrad(df1, p["w1"], out=dz, accumulate=True)


def encoder_backward(g, s, p, num_heads):
    """Gradients of one encoder layer from ``g`` (the output's), the
    forward's ``saved`` ``s`` and the shipped params ``p``; returns
    ``(dx f32 [B*L, D], grads)``."""
    grads = {}
    r, d = s["xt"].shape
    b, l = s["kb"].shape
    dh1 = _ffn_bwd(g, s["z2"], "n2s", s, p, s["hid"], s["x1t"], s["mf"],
                   s["m2"], grads)
    dz1, dattn, grads["n1s"], grads["n1b"] = ln_bwd(dh1, s["z1"], p["n1s"],
                                                    s["m1"])
    grads["out_w"] = wgrad(dattn, s["o"])
    grads["out_b"] = colsum(dattn)
    do = dgrad(dattn, p["out_w"])
    dqkv = torch.empty((r, 3 * d), dtype=torch.float32, device=dz1.device)
    attention_bwd(s["qkv"], 0, 3 * d, s["qkv"], d, 2 * d, 3 * d, s["probs"],
                  s["keep"], do, dqkv, 0, 3 * d, dqkv, d, 2 * d, 3 * d, b, l,
                  l, d, num_heads)
    grads["in_w"] = wgrad(dqkv, s["xt"])
    grads["in_b"] = colsum(dqkv)
    return dgrad(dqkv, p["in_w"], out=dz1, accumulate=True), grads


def decoder_backward(g, s, p, num_heads, dtypes, stage=bwd_stage):
    """Gradients of one decoder layer from ``g`` (the output's), the
    forward's ``saved`` ``s`` and the shipped params ``p``: ``(d tgt
    [B*T, D], d memory [B*L, D])`` at ``dtypes`` (tgt's and memory's) and
    the f32 parameter gradients.  ``stage`` runs each product stage
    (:func:`.gemm.bwd_stage`; a check may wrap it)."""
    rt, d = s["tt"].shape
    rm = s["mt"].shape[0]
    b, _, t, l = s["pc"].shape
    f = p["w1"].shape[0]
    f32 = dict(dtype=torch.float32, device=s["tt"].device)
    w = {k: torch.empty(tuple(p[k].shape), **f32)
         for k in ("w2", "w1", "c_out_w", "c_in_w", "s_out_w", "s_in_w")}
    bias = {k: torch.empty(tuple(p[k].shape), **f32)
            for k in ("b2", "b1", "c_out_b", "c_in_b", "s_out_b", "s_in_b")}
    grads = {**w, **bias}
    dz3, dy3, grads["n3s"], grads["n3b"] = ln_bwd(g, s["z3"], p["n3s"],
                                                  s["m3"])
    df1 = torch.empty((rt, f), **f32)
    stage(stage_wgrad(dy3, [(s["hid"], None)], w["w2"], bias["b2"]),
          stage_dgrad(dy3, p["w2"], [Out(df1, act="relu", pre=s["hid"],
                                         keep=s["mf"])]))
    stage(stage_wgrad(df1, [(s["t2t"], None)], w["w1"], bias["b1"]),
          stage_dgrad(df1, p["w1"], [Out(dz3, add=dz3)]))
    dz2, dca, grads["n2s"], grads["n2b"] = ln_bwd(dz3, s["z2"], p["n2s"],
                                                  s["m2"])
    do_c = torch.empty((rt, d), **f32)
    stage(stage_wgrad(dca, [(s["o_c"], None)], w["c_out_w"],
                      bias["c_out_b"]),
          stage_dgrad(dca, p["c_out_w"], [Out(do_c)]))
    dq = torch.empty((rt, d), **f32)
    dkv = torch.empty((rm, 2 * d), **f32)
    attention_bwd(s["q"], 0, d, s["kv"], 0, d, 2 * d, s["pc"], s["kc"], do_c,
                  dq, 0, d, dkv, 0, d, 2 * d, b, t, l, d, num_heads)
    dmem = torch.empty((rm, d), dtype=dtypes[1], device=dq.device)
    stage(stage_wgrad(dq, [(s["t1t"], None)], w["c_in_w"][:d],
                      bias["c_in_b"][:d]),
          stage_wgrad(dkv, [(s["mt"], None)], w["c_in_w"][d:],
                      bias["c_in_b"][d:]),
          stage_dgrad(dkv, p["c_in_w"][d:], [Out(dmem)]),
          stage_dgrad(dq, p["c_in_w"][:d], [Out(dz2, add=dz2)]))
    dz1, dsa, grads["n1s"], grads["n1b"] = ln_bwd(dz2, s["z1"], p["n1s"],
                                                  s["m1"])
    do_s = torch.empty((rt, d), **f32)
    stage(stage_wgrad(dsa, [(s["o_s"], None)], w["s_out_w"],
                      bias["s_out_b"]),
          stage_dgrad(dsa, p["s_out_w"], [Out(do_s)]))
    dqkv = torch.empty((rt, 3 * d), **f32)
    attention_bwd(s["qkv"], 0, 3 * d, s["qkv"], d, 2 * d, 3 * d, s["ps"],
                  s["ks"], do_s, dqkv, 0, 3 * d, dqkv, d, 2 * d, 3 * d, b, t,
                  t, d, num_heads)
    dtgt = torch.empty((rt, d), dtype=dtypes[0], device=dq.device)
    stage(stage_wgrad(dqkv, [(s["tt"], None)], w["s_in_w"], bias["s_in_b"]),
          stage_dgrad(dqkv, p["s_in_w"], [Out(dtgt, add=dz1)]))
    return dtgt, dmem, grads


def _attention_plain(q, k, v, keep, b, lq, lk, num_heads):
    """The attention core over row-major ``q [B*Lq, D]``, ``k``, ``v
    [B*Lk, D]`` at the model dtype as :func:`.text_kernel.mha_plain`
    takes it; returns ``(out [B*Lq, D] at the model dtype, the f32
    probabilities before the keep mask)``."""
    d = q.shape[1]
    dh = d // num_heads
    heads = lambda x, n: x.float().reshape(b, n, num_heads, dh).transpose(1, 2)
    qh, kh, vh = heads(q, lq), heads(k, lk), heads(v, lk)
    probs = torch.softmax((qh @ kh.transpose(-1, -2)) / math.sqrt(dh), -1)
    pk = probs if keep is None else probs * keep
    o = (pk.to(q.dtype).float() @ vh).to(q.dtype)
    return o.transpose(1, 2).reshape(b * lq, d), probs


def decoder_saved_plain(tgt, memory, masks, p, num_heads: int = 8):
    """What :func:`.text_kernel.decoder_launch` saves with ``save=True``
    (``masks`` as :func:`.text_kernel.masks_at` gives them, ``p``
    shipped), in plain PyTorch with the same roundings: the CPU twin that
    :func:`decoder_backward` runs on there."""
    dtype = memory.dtype
    b, t, d = tgt.shape
    l = memory.shape[1]
    rt = b * t
    m = masks or {}
    m1, m2, mf, m3 = (_rows(m.get(k), rt) for k in ("post_sa", "post_ca",
                                                     "ffn", "post_ffn"))
    tt = tgt.to(dtype).reshape(rt, d)
    mt = memory.reshape(b * l, d)
    kv = linear_plain(mt, p["c_in_w"][d:], p["c_in_b"][d:]).to(dtype)
    qkv = linear_plain(tt, p["s_in_w"], p["s_in_b"]).to(dtype)
    o_s, ps = _attention_plain(qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:],
                               m.get("self_attn"), b, t, t, num_heads)
    z1 = tt.float() + _mul(linear_plain(o_s, p["s_out_w"], p["s_out_b"]),
                           m1)
    t1 = ln_plain(z1, p["n1s"], p["n1b"])
    t1t = t1.to(dtype)
    q = linear_plain(t1t, p["c_in_w"][:d], p["c_in_b"][:d]).to(dtype)
    o_c, pc = _attention_plain(q, kv[:, :d], kv[:, d:], m.get("cross_attn"),
                               b, t, l, num_heads)
    z2 = t1 + _mul(linear_plain(o_c, p["c_out_w"], p["c_out_b"]), m2)
    t2 = ln_plain(z2, p["n2s"], p["n2b"])
    t2t = t2.to(dtype)
    hid = _mul(linear_plain(t2t, p["w1"], p["b1"], "relu"), mf).to(dtype)
    z3 = t2 + _mul(linear_plain(hid, p["w2"], p["b2"]), m3)
    return dict(tt=tt, mt=mt, ks=m.get("self_attn"), kc=m.get("cross_attn"),
                m1=m1, m2=m2, mf=mf, m3=m3, qkv=qkv, ps=ps, o_s=o_s, z1=z1,
                t1t=t1t, q=q, kv=kv, pc=pc, o_c=o_c, z2=z2, t2t=t2t, hid=hid,
                z3=z3)


# ------------------------------------------------------------ functions

class _EncoderLayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key_mask, masks, num_heads, *params):
        p = ship_params(dict(zip(ENC_KEYS, params)), x.dtype)
        out, saved = encoder_launch(x, key_mask, p, num_heads, None, masks,
                                    save=True)
        ctx.saved = saved
        ctx.p = p
        ctx.num_heads = num_heads
        ctx.x_dtype = x.dtype
        ctx.param_dtypes = [t.dtype for t in params]
        fused_encoder_layer_train.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        dx, grads = encoder_backward(g, ctx.saved, ctx.p, ctx.num_heads)
        fused_encoder_layer_train.bwd_launches += 1
        del ctx.saved, ctx.p
        b, l = g.shape[:2]
        return (dx.reshape(b, l, -1).to(ctx.x_dtype), None, None, None,
                *(grads[k].to(dt) for k, dt in zip(ENC_KEYS,
                                                    ctx.param_dtypes)))


class _DecoderLayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tgt, memory, masks, num_heads, *params):
        p = ship_params(dict(zip(DEC_KEYS, params)), memory.dtype)
        out, saved = decoder_launch(tgt, memory, p, num_heads, None, masks,
                                    save=True)
        ctx.saved = saved
        ctx.p = p
        ctx.num_heads = num_heads
        ctx.dtypes = (tgt.dtype, memory.dtype)
        ctx.param_dtypes = [t.dtype for t in params]
        fused_decoder_layer_train.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        dtgt, dmem, grads = decoder_backward(g, ctx.saved, ctx.p,
                                             ctx.num_heads, ctx.dtypes)
        fused_decoder_layer_train.bwd_launches += 1
        b, l = ctx.saved["pc"].shape[0], ctx.saved["pc"].shape[3]
        del ctx.saved, ctx.p
        return (dtgt.reshape(g.shape), dmem.reshape(b, l, -1), None, None,
                *(grads[k].to(dt) for k, dt in zip(DEC_KEYS,
                                                    ctx.param_dtypes)))


def fused_encoder_layer_train(x, key_mask, masks: Optional[dict], params,
                              num_heads: int = 8):
    """One post-LN encoder layer with live dropout, differentiable.

    ``x [B, L, D]`` at the model dtype; ``key_mask [B, L]`` float (added
    to the key logits); ``masks`` None or the keep masks ``attn
    [B, H, L, L]``, ``post_attn [B, L, D]``, ``ffn [B, L, F]``,
    ``post_ffn [B, L, D]`` (values ``{0, 1/(1-p)}``, used at the model
    dtype); ``params`` keyed by :data:`ENC_KEYS`, f32
    masters (or any dtype; gradients come back at each one's dtype)."""
    if not x.is_cuda:
        return fused_encoder_layer_train_plain(x, key_mask, masks, params,
                                               num_heads)
    return _EncoderLayerTrain.apply(
        x, key_mask, masks_at(masks, x.dtype), num_heads,
        *(params[k] for k in ENC_KEYS))


fused_encoder_layer_train.launches = 0
fused_encoder_layer_train.bwd_launches = 0


def fused_decoder_layer_train(tgt, memory, masks: Optional[dict], params,
                              num_heads: int = 8):
    """One post-LN decoder layer with live dropout, differentiable:
    ``tgt [B, T, D]``, ``memory [B, L, D]``, ``masks`` None or the keep
    masks ``self_attn [B, H, T, T]``, ``post_sa``, ``cross_attn
    [B, H, T, L]``, ``post_ca``, ``ffn``, ``post_ffn`` (``[B, T, ·]``);
    ``params`` keyed by :data:`DEC_KEYS`.
    Gradients reach ``tgt``, ``memory`` and every parameter."""
    if not memory.is_cuda:
        return fused_decoder_layer_train_plain(tgt, memory, masks, params,
                                               num_heads)
    return _DecoderLayerTrain.apply(
        tgt, memory, masks_at(masks, memory.dtype), num_heads,
        *(params[k] for k in DEC_KEYS))


fused_decoder_layer_train.launches = 0
fused_decoder_layer_train.bwd_launches = 0
