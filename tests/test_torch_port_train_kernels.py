"""The training layers' plain versions, the gumbel backward, masked
BatchNorm in train mode and the optimizer against the JAX package, in
float32 on the CPU.

Each train kernel's plain version (what a CPU tensor runs; the CUDA
kernels are held against it on the card by ``test_torch_port_cuda.py``
and ``chip_smoke.py``) is compared with ``jax.grad`` of the JAX
package's own reference (``encoder_layer_reference`` /
``decoder_layer_reference`` with the same numpy dropout masks,
``metalayer_reference``, ``gat_conv_reference``), which the JAX package's
tests pin to its Pallas training kernels.  The loss is ``sum(out * w)``
with a fixed random cotangent ``w``, so every output element's gradient
path is exercised.

Tolerances: outputs 1e-4 abs (f32 in both, summation order differs;
observed ~1e-6); gradients relative to each gradient's own scale (its
max abs): 1e-4 unless stated, since the two frameworks sum in other
orders and the attention and softmax backward subtract near-equal terms.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from isubgvqa_tpu.models.layers import (MaskedBatchNorm as JaxBatchNorm,
                                        decoder_layer_reference,
                                        encoder_layer_reference)
from isubgvqa_tpu.ops.pallas.gat_kernel import gat_conv_reference
from isubgvqa_tpu.ops.pallas.metalayer_kernel import metalayer_reference
from isubgvqa_tpu.sampling.gumbel import (GumbelSamplerConfig,
                                          _clamped_relaxed_topk,
                                          gumbel_topk_sample)
from isubgvqa_tpu.train.schedule import make_optimizer as jax_optimizer
from isubgvqa_tpu_torch.models.layers import MaskedBatchNorm
from isubgvqa_tpu_torch.ops import gat_train, metalayer_train, text_train
from isubgvqa_tpu_torch.sampling import gumbel as tgumbel
from isubgvqa_tpu_torch.train.schedule import make_optimizer

from test_torch_port_kernels import (D, FF, H, _graphs, _ln_w, _mha_w,
                                     _port_ffn_ln, _port_mha, _t)
from test_torch_port_model import one_torch_thread  # noqa: F401
from test_torch_port_model import quick_xla  # noqa: F401

OUT_ATOL = 1e-4
GRAD_RTOL = 1e-4


def assert_grad(got, want, name, rtol=GRAD_RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: max err {err:.3g}, scale {scale:.3g}"


def leaves(params):
    """Port params as f32 leaves with gradients."""
    return {k: v.clone().requires_grad_(True) for k, v in params.items()}


def keep(rng, shape, rate=0.25):
    return ((rng.random(shape) >= rate) / (1 - rate)).astype(np.float32)


# ------------------------------------------------------------ text layers

@pytest.fixture(scope="module")
def jit_grads():
    def enc(x, key_mask, masks, params):
        return encoder_layer_reference(x, key_mask, masks, params,
                                       num_heads=H)

    def dec(tgt, mem, masks, params):
        return decoder_layer_reference(tgt, mem, masks, params, num_heads=H)

    def vg(fn, argnums):
        def loss(*a):
            *args, w = a
            out = fn(*args)
            return jnp.sum(out * w), out
        return jax.jit(jax.value_and_grad(loss, argnums, has_aux=True))

    return {"enc": vg(enc, (0, 3)), "dec": vg(dec, (0, 1, 3))}


def _text_case(rng, names):
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    w = {"w1": f(D, FF, k=0.1), "b1": f(FF, k=0.1), "w2": f(FF, D, k=0.1),
         "b2": f(D, k=0.1)}
    for prefix in names:
        w.update(_mha_w(f, prefix))
    return f, w


def _mha_grads(g, src="", dst=""):
    return {
        dst + "in_w": np.concatenate([g[src + "wq"].T, g[src + "wk"].T,
                                      g[src + "wv"].T]),
        dst + "in_b": np.concatenate([g[src + "bq"], g[src + "bk"],
                                      g[src + "bv"]]),
        dst + "out_w": g[src + "wo"].T, dst + "out_b": g[src + "bo"],
    }


def _ffn_ln_grads(g, lns):
    out = {"w1": g["w1"].T, "b1": g["b1"], "w2": g["w2"].T, "b2": g["b2"]}
    out.update({k: g[k] for ln in lns for k in (ln + "s", ln + "b")})
    return out


@pytest.mark.parametrize("with_masks", [True, False], ids=["masks", "none"])
def test_encoder_train_plain_grads_match_jax(jit_grads, with_masks):
    rng = np.random.default_rng(21 + with_masks)
    b, l = 3, 10
    f, w = _text_case(rng, [""])
    w.update(_ln_w(f, "n1", "n2"))
    x = f(b, l, D)
    km = np.ones((b, l), np.float32)
    km[0, 6:] = 0.0                       # padded question tokens
    masks = ({"attn": keep(rng, (b, H, l, l)), "post_attn": keep(rng, (b, l, D)),
              "ffn": keep(rng, (b, l, FF)), "post_ffn": keep(rng, (b, l, D))}
             if with_masks else None)
    cot = f(b, l, D)
    jm = None if masks is None else {k: jnp.asarray(v) for k, v in masks.items()}
    (_, out_j), (dx_j, dw_j) = jit_grads["enc"](
        jnp.asarray(x), jnp.asarray(km), jm,
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(cot))
    pw = leaves({**_port_mha(w), **_port_ffn_ln(w, ("n1", "n2"))})
    xt = _t(x).requires_grad_(True)
    tm = None if masks is None else {k: _t(v) for k, v in masks.items()}
    out_t = text_train.fused_encoder_layer_train(xt, _t(km), tm, pw, H)
    (out_t * _t(cot)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=OUT_ATOL)
    assert_grad(xt.grad, dx_j, "x")
    dw_j = {k: np.asarray(v) for k, v in dw_j.items()}
    want = {**_mha_grads(dw_j), **_ffn_ln_grads(dw_j, ("n1", "n2"))}
    for k, v in want.items():
        assert_grad(pw[k].grad, v, k)


def test_decoder_train_plain_grads_match_jax(jit_grads):
    rng = np.random.default_rng(33)
    b, t, l = 3, 4, 9
    f, w = _text_case(rng, ["s", "c"])
    w.update(_ln_w(f, "n1", "n2", "n3"))
    tgt, mem = f(b, t, D), f(b, l, D)
    masks = {"self_attn": keep(rng, (b, H, t, t)),
             "post_sa": keep(rng, (b, t, D)),
             "cross_attn": keep(rng, (b, H, t, l)),
             "post_ca": keep(rng, (b, t, D)), "ffn": keep(rng, (b, t, FF)),
             "post_ffn": keep(rng, (b, t, D))}
    cot = f(b, t, D)
    (_, out_j), (dt_j, dm_j, dw_j) = jit_grads["dec"](
        jnp.asarray(tgt), jnp.asarray(mem),
        {k: jnp.asarray(v) for k, v in masks.items()},
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(cot))
    pw = leaves({**_port_mha(w, "s", "s_"), **_port_mha(w, "c", "c_"),
                 **_port_ffn_ln(w, ("n1", "n2", "n3"))})
    tt, mt = _t(tgt).requires_grad_(True), _t(mem).requires_grad_(True)
    out_t = text_train.fused_decoder_layer_train(
        tt, mt, {k: _t(v) for k, v in masks.items()}, pw, H)
    (out_t * _t(cot)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=OUT_ATOL)
    assert_grad(tt.grad, dt_j, "tgt")
    assert_grad(mt.grad, dm_j, "memory")
    dw_j = {k: np.asarray(v) for k, v in dw_j.items()}
    want = {**_mha_grads(dw_j, "s", "s_"), **_mha_grads(dw_j, "c", "c_"),
            **_ffn_ln_grads(dw_j, ("n1", "n2", "n3"))}
    for k, v in want.items():
        assert_grad(pw[k].grad, v, k)


# ------------------------------------------------------------ MetaLayer

def test_metalayer_train_plain_grads_match_jax():
    rng = np.random.default_rng(5)
    b, n, e, c = 3, 12, 40, 16
    nm, em, src, dst = _graphs(rng, b, n, e)
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    w = dict(ew1=f(3 * c, c, k=0.2), eb1=f(c, k=0.1), ew2=f(c, c, k=0.2),
             eb2=f(c, k=0.1), n1w1=f(2 * c, c, k=0.2), n1b1=f(c, k=0.1),
             n1w2=f(c, c, k=0.2), n1b2=f(c, k=0.1), n2w1=f(2 * c, c, k=0.2),
             n2b1=f(c, k=0.1), n2w2=f(c, c, k=0.2), n2b2=f(c, k=0.1),
             gn_w=np.abs(f(c)) + 0.5, gn_b=f(c, k=0.1),
             gn_a=np.abs(f(c)) + 0.5)
    x, ea = f(b, n, c), f(b, e, c)
    cx, ce = f(b, n, c), f(b, e, c)

    def loss(x, ea, params):
        xo, eo = metalayer_reference(x, ea, src, dst, em, nm, params)
        return jnp.sum(xo * cx) + jnp.sum(eo * ce), (xo, eo)

    (_, (xo_j, eo_j)), (dx_j, de_j, dw_j) = jax.jit(jax.value_and_grad(
        loss, (0, 1, 2), has_aux=True))(
        jnp.asarray(x), jnp.asarray(ea), {k: jnp.asarray(v) for k, v in w.items()})
    pw = leaves({k: _t(v.T if v.ndim == 2 else v) for k, v in w.items()})
    xt, et = _t(x).requires_grad_(True), _t(ea).requires_grad_(True)
    xo, eo = metalayer_train.fused_metalayer_train(
        xt, et, _t(src), _t(dst), _t(em), _t(nm), pw)
    ((xo * _t(cx)).sum() + (eo * _t(ce)).sum()).backward()
    np.testing.assert_allclose(xo.detach().numpy(), np.asarray(xo_j), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(eo.detach().numpy(), np.asarray(eo_j), rtol=0,
                               atol=OUT_ATOL)
    assert_grad(xt.grad, dx_j, "x")
    assert_grad(et.grad, de_j, "e_attr")
    for k, v in dw_j.items():
        v = np.asarray(v)
        assert_grad(pw[k].grad, v.T if v.ndim == 2 else v, k)


# ------------------------------------------------------------ GAT conv

C_GAT, HEADS = 12, 4


def _jax_attb(att):
    hc = att.shape[0] * att.shape[1]
    attb = jnp.zeros((hc, att.shape[0]), jnp.float32)
    expand = jnp.zeros((att.shape[0], hc), jnp.float32)
    c = att.shape[1]
    for i in range(att.shape[0]):
        attb = attb.at[i * c:(i + 1) * c, i].set(att[i])
        expand = expand.at[i, i * c:(i + 1) * c].set(1.0)
    return attb, expand


@pytest.fixture(scope="module")
def gat_case():
    rng = np.random.default_rng(17)
    b, n, e, c, hc = 3, 10, 36, C_GAT, C_GAT * HEADS
    nm, em, src, dst = _graphs(rng, b, n, e)
    em[0, 2] = False                      # a padding edge among valid ones
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    w = dict(wl=f(c, hc, k=0.2), bl=f(hc, k=0.1), wr=f(c, hc, k=0.2),
             br=f(hc, k=0.1), att=f(HEADS, c, k=0.3), cbias=f(hc, k=0.1),
             we=f(c, hc, k=0.2))
    # a sampled gate that is not all ones: zeros, ones and fractions
    gate = rng.choice([0.0, 1.0, 0.5, 0.8], size=(b, n, 1)).astype(np.float32)
    a = dict(xf=f(b, n, c), gate=gate, e_attr=f(b, e, c))
    cot = (f(b, n, hc), f(b, e, HEADS))

    def loss(xf, gate, e_attr, params, egate=None):
        attb, expand = _jax_attb(params["att"])
        eproj = e_attr @ params["we"]
        conv, alpha = gat_conv_reference(
            xf, gate, src, dst, em, eproj,
            {**params, "attb": attb, "expand": expand}, egate=egate)
        return jnp.sum(conv * cot[0]) + jnp.sum(alpha * cot[1]), (conv, alpha)

    grad = jax.jit(jax.value_and_grad(loss, (0, 1, 2, 3), has_aux=True))
    (_, (conv_j, alpha_j)), grads_j = grad(
        *(jnp.asarray(a[k]) for k in ("xf", "gate", "e_attr")),
        {k: jnp.asarray(v) for k, v in w.items()})
    return dict(arrays=a, w=w, graph=(nm, em, src, dst), cot=cot,
                ref=(conv_j, alpha_j), grads=grads_j, loss=loss)


def _port_gatconv(case, node_gate_fn=None):
    a, w = case["arrays"], case["w"]
    nm, em, src, dst = case["graph"]
    pw = leaves({k: _t(w[k].T if k in ("wl", "wr", "we") else w[k])
                 for k in w})
    xf, gate, ea = (_t(a[k]).requires_grad_(True)
                    for k in ("xf", "gate", "e_attr"))
    conv, alpha = gat_train.fused_gatconv(xf, gate, _t(src), _t(dst), _t(em),
                                          ea, pw)
    cot = case["cot"]
    ((conv * _t(cot[0])).sum() + (alpha * _t(cot[1])).sum()).backward()
    return conv, alpha, xf, gate, ea, pw


def test_gatconv_train_plain_grads_match_jax(gat_case):
    conv, alpha, xf, gate, ea, pw = _port_gatconv(gat_case)
    conv_j, alpha_j = gat_case["ref"]
    np.testing.assert_allclose(conv.detach().numpy(), np.asarray(conv_j),
                               rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(alpha_j),
                               rtol=0, atol=1e-5)
    # the zero-edge graph (1) has all-zero attention
    assert np.all(alpha.detach().numpy()[1] == 0)
    dxf_j, dgate_j, dea_j, dw_j = gat_case["grads"]
    assert_grad(xf.grad, dxf_j, "xf")
    assert_grad(gate.grad, dgate_j, "gate")
    assert_grad(ea.grad, dea_j, "e_attr")
    for k, v in dw_j.items():
        v = np.asarray(v)
        assert_grad(pw[k].grad, v.T if k in ("wl", "wr", "we") else v, k)


def test_gatconv_gate_gradient_is_dst_only(gat_case):
    """The node-gate gradient follows the reference's quirk: the edge
    gate's cotangent is summed to destination nodes only.  A product-rule
    gate (the JAX reference with an explicit ``egate``) gives a different
    gradient, so the match above is not an accident."""
    _, _, _, gate, _, _ = _port_gatconv(gat_case)
    a = gat_case["arrays"]
    nm, em, src, dst = gat_case["graph"]
    w = {k: jnp.asarray(v) for k, v in gat_case["w"].items()}

    def product_rule(g):
        oh = lambda i: jax.nn.one_hot(i, g.shape[1]) * em[..., None]
        egate = (jnp.einsum("ben,bnk->bek", oh(src), g)
                 * jnp.einsum("ben,bnk->bek", oh(dst), g))
        return gat_case["loss"](jnp.asarray(a["xf"]), g,
                                jnp.asarray(a["e_attr"]), w, egate)[0]

    d_product = np.asarray(jax.jit(jax.grad(product_rule))(
        jnp.asarray(a["gate"])))
    dst_only = gate.grad.numpy()
    assert not np.allclose(dst_only, d_product, rtol=1e-2, atol=1e-2)
    # a node that is only ever a source gets no gate gradient at all
    for g in range(dst.shape[0]):
        srcs = set(src[g][em[g]].tolist()) - set(dst[g][em[g]].tolist())
        for node in srcs:
            assert dst_only[g, node, 0] == 0.0


# ------------------------------------------------------------ gumbel

def _shared_noise(monkeypatch, noise):
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(noise, dtype).reshape(shape))


def test_gumbel_backward_cpu_branch_matches_jax(monkeypatch):
    rng = np.random.default_rng(8)
    scores = rng.normal(size=(4, 11)).astype(np.float32)
    scores[:, -2:] = 0.0
    noise = rng.gumbel(size=(4, 11)).astype(np.float32)
    cot = rng.normal(size=(1, 4, 11)).astype(np.float32)
    _shared_noise(monkeypatch, noise)
    g_j = jax.jit(jax.grad(lambda s: jnp.sum(gumbel_topk_sample(
        s, jax.random.PRNGKey(0), GumbelSamplerConfig(k=3), train=True)
        * cot)))(jnp.asarray(scores))
    st = _t(scores).requires_grad_(True)
    out = tgumbel.gumbel_topk_sample(st, tgumbel.GumbelSamplerConfig(k=3),
                                     train=True, noise=_t(noise))
    (out * _t(cot)).sum().backward()
    assert_grad(st.grad, g_j, "scores", rtol=1e-4)


def test_gumbel_bounded_branch_matches_jax_at_saturation():
    """At a saturated score gap (a round's softmax rounds to 1.0, so the
    log-mask sits at FLT_MIN) the bounded form — floor 1e-3 on the log's
    backward, the input gradient clamped to +-100 — matches
    ``_clamped_relaxed_topk``, the JAX package's accelerator branch,
    called directly.  A large cotangent makes the clamp bite."""
    rng = np.random.default_rng(9)
    scores = rng.normal(size=(3, 9)).astype(np.float32)
    scores[:, 0] += 40.0                 # saturates the first round
    scores[1, 1] += 20.0
    cot = (1e4 * rng.normal(size=(3, 9))).astype(np.float32)
    (_, out_j), g_j = jax.jit(jax.value_and_grad(
        lambda s: (jnp.sum((o := _clamped_relaxed_topk(s, 3, 0.1)) * cot), o),
        has_aux=True))(jnp.asarray(scores))
    st = _t(scores).requires_grad_(True)
    out = tgumbel.relaxed_topk(st, 3, 0.1, bounded=True)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-6)
    assert np.isfinite(st.grad.numpy()).all()
    assert np.abs(st.grad.numpy()).max() == 100.0
    assert_grad(st.grad, g_j, "bounded scores", rtol=1e-4)
    # the exact form (the CPU branch) is not clamped
    se = _t(scores).requires_grad_(True)
    (tgumbel.relaxed_topk(se, 3, 0.1) * _t(cot)).sum().backward()
    assert np.abs(se.grad.numpy()).max() > 100.0


def test_bounded_log_cuts_the_gradient_below_the_floor():
    m = torch.tensor([0.5, 2e-3, 5e-4, 1e-30], requires_grad=True)
    y = tgumbel._bounded_log(m, tgumbel.BWD_FLOOR)
    torch.testing.assert_close(y, torch.log(m.detach()))
    y.sum().backward()
    torch.testing.assert_close(m.grad, torch.tensor([2.0, 500.0, 0.0, 0.0]))


# ------------------------------------------------------------ BatchNorm

def test_masked_batchnorm_train_matches_flax():
    """Batch statistics over valid rows (two-pass variance) on
    pixel-scale bbox inputs, input and parameter gradients, and the
    running statistics (unbiased variance, keep 0.9)."""
    rng = np.random.default_rng(3)
    b, n = 4, 9
    x = rng.uniform(0, 800, size=(b, n, 4)).astype(np.float32)
    mask = rng.random((b, n)) > 0.3
    cot = rng.normal(size=(b, n, 4)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=4)).astype(np.float32)
    bias = (0.1 * rng.normal(size=4)).astype(np.float32)
    rmean = (230 + rng.normal(size=4)).astype(np.float32)
    rvar = (180.0 ** 2 * (1 + 0.1 * rng.random(4))).astype(np.float32)
    bn = JaxBatchNorm(4)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(rmean),
                                 "var": jnp.asarray(rvar)}}

    def loss(params, x):
        out, upd = bn.apply({**variables, "params": params}, x, mask,
                            use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    (_, (out_j, stats_j)), (dp_j, dx_j) = jax.jit(jax.value_and_grad(
        loss, (0, 1), has_aux=True))(variables["params"], jnp.asarray(x))
    tbn = MaskedBatchNorm(4)
    with torch.no_grad():
        tbn.weight.copy_(_t(scale))
        tbn.bias.copy_(_t(bias))
        tbn.running_mean.copy_(_t(rmean))
        tbn.running_var.copy_(_t(rvar))
    xt = _t(x).requires_grad_(True)
    out = tbn(xt, _t(mask), train=True)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-5)
    assert_grad(xt.grad, dx_j, "x")
    assert_grad(tbn.weight.grad, dp_j["scale"], "scale")
    assert_grad(tbn.bias.grad, dp_j["bias"], "bias")
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(stats_j["mean"]), rtol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(stats_j["var"]), rtol=1e-6)


# ------------------------------------------------------------ optimizer

def test_optimizer_matches_optax():
    """Schedule values across the warmup boundary, clipping, and the
    non-finite skip (nothing moves; Adam's count and so the learning rate
    stay put while the step count advances) against ``make_optimizer``
    over a few updates of a small parameter vector."""
    spe, warm, base = 2, 2, 1e-2
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=7).astype(np.float32)
    grads = [rng.normal(size=7).astype(np.float32) * s
             for s in (0.3, 5.0, 0.2, 1.0, 3.0, 0.5, 0.7)]
    grads[3][2] = np.nan                 # a non-finite step, skipped
    opt_j = jax_optimizer(base, spe, warmup_epochs=warm, warmup_start_lr=1e-4,
                          gamma=0.5, grad_clip_norm=2.0)
    pj = {"w": jnp.asarray(p0)}
    sj = opt_j.init(pj)
    update = jax.jit(opt_j.update)
    pt = torch.nn.Parameter(_t(p0))
    opt_t = make_optimizer([pt], base, spe, warmup_epochs=warm,
                           warmup_start_lr=1e-4, gamma=0.5,
                           grad_clip_norm=2.0)
    lrs = []
    for g in grads:
        upd, sj = update({"w": jnp.asarray(g)}, sj, pj)
        pj = optax.apply_updates(pj, upd)
        lrs.append(opt_t.lr())
        pt.grad = _t(g).clone()     # the optimizer clips in place
        norm = opt_t.step()
        np.testing.assert_allclose(float(norm), np.linalg.norm(g), rtol=1e-6)
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj["w"]),
                                   rtol=1e-6, atol=1e-7)
    # Adam's count: 7 steps, one skipped
    assert opt_t.count == 6 and opt_t.notfinite_count == 0
    sched = [1e-4, 1e-4, 1e-4 + (base - 1e-4) * 0.5,
             1e-4 + (base - 1e-4) * 0.5, 1e-4 + (base - 1e-4) * 0.5, base,
             base]
    # the skipped fourth step leaves the fifth at Adam's count 3
    np.testing.assert_allclose(lrs, sched, rtol=1e-6)
    assert opt_t.schedule(6) == base * 0.5
