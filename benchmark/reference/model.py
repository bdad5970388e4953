"""ISubGVQA's forward and training step in plain PyTorch: the benchmark's
reference.

Written from the model's description (the upstream ISubGVQA repository:
a CLIP-style question encoder of post-LN transformer layers, a program
decoder of learned queries, a scene-graph encoder with one MetaLayer
round and GraphNorm, four masked GATv2 layers whose last samples k nodes
with a Gumbel or SIMPLE sampler, question-conditioned attention pooling
and a fusion classifier) and the port's published numerics: flax's
LayerNorm (fast variance, eps 1e-6), the CLIP attention mask added to the
key logits, the instruction-weighted GraphNorm of the GAT layers, the
edge gate's backward to destination nodes only, the clamped relaxed
top-k's backward, SIMPLE's exact k-subset marginals, Adam with optax's
clip at global norm 2.0 and the non-finite skip.

Parameters are a flat dict of f32 tensors under the upstream
``state_dict`` names.  Every product goes through ``prec`` (default: f32
as it stands; :func:`fp8` for the lower-precision control).  Gathers and
scatters by index replace incidence products.  Training draws every
dropout keep mask and the sampler's noise from the step's generator in
the model's order (encoder layers, decoder layers, the mask head's
dropout, the sampler's Gumbel draw, the head's dropout).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

NEG = -1.0e30
TINY = float(torch.finfo(torch.float32).tiny)
HEADS, GAT_HEADS, FFN = 8, 4, 2048


def identity(x):
    return x


class _Fp8(torch.autograd.Function):
    """Per-tensor scaled float8 rounding: e4m3 forward, e5m2 backward."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


def _round8(x, dtype, top):
    s = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / s).to(dtype).to(x.dtype) * s


def fp8(x):
    """``x`` through float8 (the control's precision)."""
    return _Fp8.apply(x)


def bf16(x):
    """``x`` through bfloat16 (the configuration's compute precision),
    for the reference's own estimate of each output's rounding error."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def lin(x, w, b=None, prec=identity):
    y = prec(x) @ prec(w).t()
    return y if b is None else y + b


def layer_norm(x, w, b, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def keep_mask(shape, rate, gen, device):
    u = torch.rand(shape, generator=gen, device=device)
    return (u < 1.0 - rate).float() / (1.0 - rate)


def mlp(P, name, x, n, gelu_last, prec):
    """``name.0``, ``name.2`` ... Linear layers with GELU between them
    (and after the last with ``gelu_last``)."""
    for i in range(n):
        x = lin(x, P[f"{name}.{2 * i}.weight"], P[f"{name}.{2 * i}.bias"], prec)
        if i < n - 1 or gelu_last:
            x = F.gelu(x)
    return x


def attention(q_in, kv_in, P, pre, colbias, keep, prec):
    b, lq, d = q_in.shape
    lk, dh = kv_in.shape[1], d // HEADS
    w, bias = P[pre + "in_proj_weight"], P[pre + "in_proj_bias"]

    def heads(t, n):
        return t.reshape(b, n, HEADS, dh).transpose(1, 2)

    q = heads(lin(q_in, w[:d], bias[:d], prec), lq)
    k = heads(lin(kv_in, w[d:2 * d], bias[d:2 * d], prec), lk)
    v = heads(lin(kv_in, w[2 * d:], bias[2 * d:], prec), lk)
    sc = prec(q) @ prec(k).transpose(-1, -2) / math.sqrt(dh)
    if colbias is not None:
        sc = sc + colbias[:, None, None, :]
    p = torch.softmax(sc, -1)
    if keep is not None:
        p = p * keep
    o = (prec(p) @ prec(v)).transpose(1, 2).reshape(b, lq, d)
    return lin(o, P[pre + "out_proj.weight"], P[pre + "out_proj.bias"], prec)


def _drop(x, m):
    return x if m is None else x * m


def encoder(P, x, colbias, train, gen, prec, n_layers):
    b, l, d = x.shape
    for i in range(n_layers):
        pre = f"question_encoder.transformer_encoder.layers.{i}."
        m = {}
        if train:
            for k, s in (("attn", (b, HEADS, l, l)), ("post_attn", (b, l, d)),
                         ("ffn", (b, l, FFN)), ("post_ffn", (b, l, d))):
                m[k] = keep_mask(s, 0.1, gen, x.device)
        a = attention(x, x, P, pre + "self_attn.", colbias, m.get("attn"), prec)
        x1 = layer_norm(x + _drop(a, m.get("post_attn")),
                        P[pre + "norm1.weight"], P[pre + "norm1.bias"])
        h = _drop(torch.relu(lin(x1, P[pre + "linear1.weight"],
                                 P[pre + "linear1.bias"], prec)), m.get("ffn"))
        y = _drop(lin(h, P[pre + "linear2.weight"], P[pre + "linear2.bias"],
                      prec), m.get("post_ffn"))
        x = layer_norm(x1 + y, P[pre + "norm2.weight"], P[pre + "norm2.bias"])
    pre = "question_encoder.transformer_encoder.norm."
    return layer_norm(x, P[pre + "weight"], P[pre + "bias"])


def decoder(P, memory, train, gen, prec, n_layers):
    b, l, d = memory.shape
    q = P["program_decoder.query_embed.weight"]
    t = q[None].expand(b, *q.shape)
    nt = q.shape[0]
    for i in range(n_layers):
        pre = f"program_decoder.coarse_decoder.layers.{i}."
        m = {}
        if train:
            for k, s in (("self_attn", (b, HEADS, nt, nt)),
                         ("post_sa", (b, nt, d)),
                         ("cross_attn", (b, HEADS, nt, l)),
                         ("post_ca", (b, nt, d)), ("ffn", (b, nt, FFN)),
                         ("post_ffn", (b, nt, d))):
                m[k] = keep_mask(s, 0.1, gen, memory.device)
        sa = attention(t, t, P, pre + "self_attn.", None, m.get("self_attn"),
                       prec)
        t = layer_norm(t + _drop(sa, m.get("post_sa")),
                       P[pre + "norm1.weight"], P[pre + "norm1.bias"])
        ca = attention(t, memory, P, pre + "multihead_attn.", None,
                       m.get("cross_attn"), prec)
        t = layer_norm(t + _drop(ca, m.get("post_ca")),
                       P[pre + "norm2.weight"], P[pre + "norm2.bias"])
        h = _drop(torch.relu(lin(t, P[pre + "linear1.weight"],
                                 P[pre + "linear1.bias"], prec)), m.get("ffn"))
        y = _drop(lin(h, P[pre + "linear2.weight"], P[pre + "linear2.bias"],
                      prec), m.get("post_ffn"))
        t = layer_norm(t + y, P[pre + "norm3.weight"], P[pre + "norm3.bias"])
    pre = "program_decoder.coarse_decoder.norm."
    return layer_norm(t, P[pre + "weight"], P[pre + "bias"])


def batch_norm(P, name, x, mask, train, eps=1e-5):
    """BatchNorm over the rows where ``mask`` is set (training), or with
    the running statistics (eval, every row)."""
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    if train:
        m = mask.float().reshape(-1, 1)
        count = torch.clamp(m.sum(), min=1.0)
        mean = (xf * m).sum(0) / count
        var = torch.clamp(((xf - mean) ** 2 * m).sum(0) / count, min=0.0)
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    out = (xf - mean) * torch.rsqrt(var + eps) * P[name + ".weight"] \
        + P[name + ".bias"]
    return out.reshape(x.shape)


def take(x, idx):
    """Rows ``idx [B, E]`` of ``x [B, N, C]``."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def scatter_sum(x, idx, n):
    """``x [B, E, C]`` summed into ``n`` rows by ``idx [B, E]``."""
    out = x.new_zeros(x.shape[0], n, x.shape[-1])
    return out.scatter_add(1, idx[..., None].expand(-1, -1, x.shape[-1]), x)


def graph_norm(p, nm, w, b, a, instr=None):
    """GraphNorm over each graph's valid nodes, after the instruction's
    softmax weighting of the nodes where ``instr`` is given."""
    nmf = nm.float()[..., None]
    if instr is not None:
        lg = (p * instr[:, None, :]).sum(-1) / math.sqrt(p.shape[-1])
        lg = torch.where(nm, lg, torch.full_like(lg, NEG))
        ex = torch.exp(lg - lg.amax(1, keepdim=True)) * nmf[..., 0]
        den = ex.sum(1, keepdim=True)
        p = p * (ex / torch.where(den > 1e-12, den,
                                  torch.ones_like(den)))[..., None]
    count = torch.clamp(nmf.sum(1, keepdim=True), min=1.0)
    mean = (p * nmf).sum(1, keepdim=True) / count
    shifted = p - a * mean
    var = (shifted * shifted * nmf).sum(1, keepdim=True) / count
    return shifted * torch.rsqrt(var + 1e-5) * nmf * w + b


def scene_graph_encoder(P, B, train, prec):
    pre = "scene_graph_encoder."
    emb = P[pre + "sg_vocab_embedding.weight"]
    nm = B["node_mask"]
    x_sum = emb[B["node_tokens"]].sum(-2)
    bb = batch_norm(P, pre + "bbox_encoding.0", B["node_bbox"], nm, train)
    bb = F.gelu(lin(bb, P[pre + "bbox_encoding.1.weight"],
                    P[pre + "bbox_encoding.1.bias"], prec))
    bb = batch_norm(P, pre + "bbox_encoding.3", bb, nm, train)
    bb = F.gelu(lin(bb, P[pre + "bbox_encoding.4.weight"],
                    P[pre + "bbox_encoding.4.bias"], prec))
    x = batch_norm(P, pre + "feat_reduc.0", torch.cat([x_sum, bb], -1), nm,
                   train)
    x = F.gelu(lin(x, P[pre + "feat_reduc.1.weight"],
                   P[pre + "feat_reduc.1.bias"], prec))
    e = emb[B["edge_token"]] * B["edge_sign"][..., None]
    # the MetaLayer round
    L = pre + "scene_graph_encoding_layer."
    c, n = x.shape[-1], x.shape[1]
    em = B["edge_mask"].float()[..., None]
    src, dst = B["edge_src"], B["edge_dst"]
    xs, xd = take(x, src) * em, take(x, dst) * em
    w1 = P[L + "edge_model.edge_mlp.0.weight"]
    h = F.gelu(lin(xs, w1[:, :c], None, prec) + lin(xd, w1[:, c:2 * c], None,
                                                      prec)
               + lin(e, w1[:, 2 * c:], None, prec)
               + P[L + "edge_model.edge_mlp.0.bias"])
    e_out = lin(h, P[L + "edge_model.edge_mlp.2.weight"],
                P[L + "edge_model.edge_mlp.2.bias"], prec)
    n1 = P[L + "node_model.node_mlp_1.0.weight"]
    m = F.gelu(lin(xs, n1[:, :c], None, prec) + lin(e_out, n1[:, c:], None,
                                                      prec)
               + P[L + "node_model.node_mlp_1.0.bias"])
    m = lin(m, P[L + "node_model.node_mlp_1.2.weight"],
            P[L + "node_model.node_mlp_1.2.bias"], prec) * em
    deg = torch.clamp(scatter_sum(em, dst, n), min=1.0)
    agg = scatter_sum(m, dst, n) / deg
    n2 = P[L + "node_model.node_mlp_2.0.weight"]
    out = F.gelu(lin(x, n2[:, :c], None, prec) + lin(agg, n2[:, c:], None,
                                                       prec)
                 + P[L + "node_model.node_mlp_2.0.bias"])
    out = lin(out, P[L + "node_model.node_mlp_2.2.weight"],
              P[L + "node_model.node_mlp_2.2.bias"], prec)
    g = pre + "graph_layer_norm."
    x_out = graph_norm(out, nm, P[g + "weight"], P[g + "bias"],
                       P[g + "mean_scale"])
    return x_out, e_out


class _EdgeGate(torch.autograd.Function):
    """``gate[src] * gate[dst]`` on valid edges; the backward sums each
    edge's cotangent into its destination node only."""

    @staticmethod
    def forward(ctx, gate, src, dst, valid):
        ctx.save_for_backward(dst, valid)
        ctx.n = gate.shape[1]
        eg = torch.gather(gate, 1, src) * torch.gather(gate, 1, dst)
        return torch.where(valid, eg, torch.zeros_like(eg))

    @staticmethod
    def backward(ctx, g):
        dst, valid = ctx.saved_tensors
        gv = torch.where(valid, g, torch.zeros_like(g))
        out = g.new_zeros(g.shape[0], ctx.n).scatter_add(1, dst, gv)
        return out, None, None, None


def edge_gate(gate, src, dst, valid):
    """:class:`_EdgeGate` over ``gate [B, N]``."""
    return _EdgeGate.apply(gate, src, dst, valid)


def gat_layer(P, i, h, xf, ins, gate, B, e_attr, prec):
    pre = f"gat_seq.convs.{i}."
    b, n, c = h.shape
    e = B["edge_src"].shape[1]
    src, dst, em = B["edge_src"], B["edge_dst"], B["edge_mask"]
    emf = em.float()[..., None]
    x_l = lin(xf, P[pre + "lin_l.weight"], P[pre + "lin_l.bias"], prec)
    x_r = lin(xf, P[pre + "lin_r.weight"], P[pre + "lin_r.bias"], prec)
    ep = lin(e_attr, P[pre + "lin_edge.weight"], None, prec)
    eg = edge_gate(gate[..., 0], src, dst, em)[..., None]
    xs = take(x_l, src) * emf
    m = (xs + take(x_r, dst) * emf + ep) * eg
    m = torch.where(m >= 0, m, 0.2 * m) * eg
    att = P[pre + "att"].reshape(GAT_HEADS, c)
    logits = (m.reshape(b, e, GAT_HEADS, c) * att).sum(-1)
    logits = torch.where(em[..., None], logits, torch.full_like(logits, NEG))
    mx = torch.full((b, n, GAT_HEADS), NEG, device=h.device).scatter_reduce(
        1, dst[..., None].expand(-1, -1, GAT_HEADS), logits.detach(), "amax")
    ex = torch.exp(logits - torch.clamp(take(mx, dst), min=NEG)) * emf
    den = take(scatter_sum(ex, dst, n), dst)
    alpha = ex / torch.where(den > 1e-12, den, torch.ones_like(den))
    w = (alpha * eg)[..., None]
    msg = (xs.reshape(b, e, GAT_HEADS, c) * w).reshape(b, e, GAT_HEADS * c)
    conv = scatter_sum(msg, dst, n) + P[pre + "bias"]
    q = F.gelu(lin(conv, P[f"gat_seq.x_proj.{i}.0.weight"],
                   P[f"gat_seq.x_proj.{i}.0.bias"], prec))
    q = F.gelu(lin(q, P[f"gat_seq.x_proj.{i}.2.weight"],
                   P[f"gat_seq.x_proj.{i}.2.bias"], prec))
    g = f"gat_seq.bns.{i}."
    return graph_norm(q, B["node_mask"], P[g + "weight"], P[g + "bias"],
                      P[g + "mean_scale"], instr=ins) + h


class _ClampGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, -100.0, 100.0)


def _bounded_log(m, floor=1e-3):
    safe = torch.clamp(m, min=floor)
    return torch.log(safe) + (torch.log(m) - torch.log(safe)).detach()


def topk_mask(s, k):
    thresh = torch.topk(s, k, dim=-1).values[..., -1:]
    return (s >= thresh).float()


def relaxed_topk(s, k, tau=0.1):
    """k rounds of masked softmax, the input's gradient clamped to +-100
    and the log mask's cut below 1e-3."""
    s = _ClampGrad.apply(s)
    khot = torch.zeros_like(s)
    onehot = torch.zeros_like(s)
    for _ in range(k):
        s = s + _bounded_log(torch.clamp(1.0 - onehot, min=TINY))
        onehot = torch.softmax(s / tau, -1)
        khot = khot + onehot
    return khot


def gumbel(shape, gen, device):
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=TINY)))


def log1mexp(x):
    x = -x.abs()
    return torch.where(x > -0.6931471805599453,
                       torch.log(-torch.expm1(torch.clamp(x, max=-1e-10))),
                       torch.log1p(-torch.exp(torch.clamp(x, min=-50.0))))


def k_subset_marginals(scores, k):
    """``p(i in S | |S| = k)`` of independent items with log-odds-like
    weights ``exp(scores)`` against ``1 - exp(-|scores|)``: the elementary
    symmetric polynomials of ``1 + exp(r_i) x`` over the items before and
    after each item, one item a step."""
    lw0 = torch.clamp(log1mexp(-scores.detach()), min=NEG)
    r = scores - lw0

    def scan(r):
        carry = torch.cat([torch.zeros_like(r[:, :1]),
                           torch.full_like(r[:, :1], NEG).expand(-1, k)], 1)
        prefix = []
        for i in range(r.shape[1]):
            prefix.append(carry)
            carry = torch.cat([carry[:, :1], torch.logaddexp(
                carry[:, 1:], carry[:, :-1] + r[:, i, None])], 1)
        return torch.stack(prefix, 1), carry

    prefix, total = scan(r)
    suffix = scan(r.flip(1))[0].flip(1)
    combo = prefix[..., :k] + suffix[..., :k].flip(-1)
    log_p = r + torch.logsumexp(combo, -1) - total[:, k, None]
    return torch.exp(torch.clamp(log_p, max=0.0))


def sample_mask(dense, sampler, k, gen, noise):
    """The sampler's hard k-subset ``[B, N]`` of the Gumbel-perturbed
    scores, with its straight-through gradient: the top k of their
    relaxed k-hot, through it (Gumbel), or their top k, through the exact
    marginals (SIMPLE)."""
    if noise is None:
        noise = gumbel(dense.shape, gen, dense.device)
    perturbed = dense + noise
    if sampler == "gumbel":
        khot = relaxed_topk(perturbed, k)
        hard = topk_mask(khot.detach(), k)
        return hard - khot.detach() + khot
    if sampler == "simple":
        marg = k_subset_marginals(dense, k)
        hard = topk_mask(perturbed.detach(), k)
        return (hard - marg).detach() + marg
    raise ValueError(f"the reference has no sampler {sampler!r}")


def forward(P: Dict[str, torch.Tensor], B: Dict[str, torch.Tensor], cfg: dict,
            train: bool = False, gen: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None,
            mask: Optional[torch.Tensor] = None,
            prec: Callable = identity) -> dict:
    """The model on batch ``B`` (tensors of :func:`.data.dense_batch`).
    ``noise [B, N]`` replaces the sampler's Gumbel draw; ``mask [B, N]``
    (0/1) replaces the sampled node mask's values downstream of the
    sampler, whose own scores and gradient stay.  Returns ``logits``, the
    sampler's ``own`` node mask and the ``mask`` used."""
    k = cfg["sample_k"]
    ids = B["qst_tokens"]
    x = P["text_vocab_embedding.token_embedding.weight"][ids] + \
        P["text_vocab_embedding.position_embedding.weight"][
            :ids.shape[1]][None]
    enc = encoder(P, x, B["qst_mask"].float(), train, gen, prec,
                  cfg["encoder_layers"])
    feats = decoder(P, enc, train, gen, prec, cfg["decoder_layers"])
    b = feats.shape[0]
    lang = mlp(P, "qsts_reduction", feats.reshape(b, -1), 1, True, prec)
    instr = mlp(P, "instr_reduction", feats, 1, True, prec)
    h, e = scene_graph_encoder(P, B, train, prec)
    nm = B["node_mask"]
    used = own = None
    for i, thr in enumerate(cfg["mgat_masks"]):
        ins = instr[:, i]
        xf = F.gelu(h * ins[:, None, :])
        if float(thr) != 1.0:
            pre = f"gat_seq.convs.{i}.mask."
            xq = mlp(P, pre + "node_nn", xf, 1, True, prec)
            uq = mlp(P, pre + "ques_nn", lang, 1, True, prec)
            gate = F.gelu((xq * uq[:, None, :]).sum(-1) / math.sqrt(
                xq.shape[-1]))
            if train:
                gate = gate * keep_mask(gate.shape, 0.2, gen, gate.device)
            dense = torch.where(nm, gate, torch.zeros_like(gate))
            sampled = sample_mask(dense, cfg["sampler_type"], k, gen, noise)
            used = own = torch.where(nm, sampled, torch.zeros_like(sampled))
            if mask is not None:      # its values, the sampler's gradient
                used = mask.float() + (own - own.detach())
            g = used[..., None]
        else:
            g = torch.ones_like(h[..., :1])
        h = gat_layer(P, i, h, xf, ins, g, B, e, prec)
    # question-conditioned attention pooling
    pre = "graph_global_attention_pooling."
    xn = mlp(P, pre + "node_nn", h, 2, False, prec)
    if used is not None:
        xn = xn * used[..., None]
    uq = mlp(P, pre + "ques_nn", lang, 2, False, prec)
    lg = (xn * uq[:, None, :]).sum(-1) / math.sqrt(xn.shape[-1])
    lg = torch.where(nm, lg, torch.full_like(lg, NEG))
    ex = torch.where(nm, torch.exp(lg - lg.amax(1, keepdim=True)),
                     torch.zeros_like(lg))
    gate = ex / torch.clamp(ex.sum(1, keepdim=True), min=TINY)
    pooled = torch.where(nm[..., None], gate[..., None] * xn,
                         torch.zeros_like(xn)).sum(1)
    fused = torch.cat([pooled, lang, pooled * lang], 1)
    fused = F.gelu(lin(fused, P["embedding.0.weight"], P["embedding.0.bias"],
                       prec))
    if train:
        fused = fused * keep_mask(fused.shape, 0.2, gen, fused.device)
    logits = lin(fused, P["logit_fc.weight"], P["logit_fc.bias"], prec)
    return {"logits": logits, "mask": used, "own": own}


def loss_fn(logits, labels, sample_mask):
    nll = -F.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]
    return (nll * sample_mask).sum() / torch.clamp(sample_mask.sum(), min=1.0)


class Adam:
    """optax's global-norm clip at ``clip``, then Adam (0.9, 0.999, eps
    1e-8 outside the root) at a constant rate ``lr``; a step whose
    gradients hold a non-finite value changes nothing."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 clip: float = 2.0):
        self.lr, self.clip, self.count = lr, clip, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads) -> dict:
        """Updates ``params`` in place; returns the clipped gradients."""
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()]))
        if not torch.isfinite(norm):
            return {k: torch.zeros_like(g) for k, g in grads.items()}
        scale = 1.0 if norm < self.clip else float(self.clip / norm)
        self.count += 1
        t = self.count
        out = {}
        for k, g in grads.items():
            g = g * scale
            out[k] = g
            self.m[k].mul_(0.9).add_(0.1 * g)
            self.v[k].mul_(0.999).add_(0.001 * g * g)
            mh = self.m[k] / (1 - 0.9 ** t)
            vh = self.v[k] / (1 - 0.999 ** t)
            params[k].sub_(self.lr * mh / (vh.sqrt() + 1e-8))
        return out
