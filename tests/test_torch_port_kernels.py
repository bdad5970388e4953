"""The port's fused-layer kernels (plain PyTorch versions, which the CPU
runs) against the JAX package's Pallas kernels in interpret mode and
their ``*_reference`` twins, on the same numpy inputs, in float32.

Tolerances: f32 max abs 1e-4 on ``out`` / ``x_out`` / ``e_out`` — the
layers chain several f32 products of width <= 48 plus LayerNorm /
GraphNorm rescaling, and the two frameworks sum in different orders
(observed errors are ~1e-6); 1e-5 on ``alpha`` — a softmax output in
[0, 1] taken from a single dot product per head.

The CUDA kernels themselves cannot run here: the ``gpu``-marked test in
``test_torch_port_cuda.py`` holds them against these plain versions on
the card and skips without one (``chip_smoke.py`` does the same at the
main path's shapes).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from isubgvqa_tpu.models.layers import (decoder_layer_reference,
                                        encoder_layer_reference)
from isubgvqa_tpu.ops.pallas.gat_kernel import (fused_gat_layer,
                                                gat_layer_reference,
                                                pack_gat_params)
from isubgvqa_tpu.ops.pallas.metalayer_kernel import (fused_metalayer,
                                                      metalayer_reference)
from isubgvqa_tpu.ops.pallas.text_kernel import (fused_decoder_layer,
                                                 fused_encoder_layer)
from isubgvqa_tpu_torch import ops as tops

from test_torch_port_model import one_torch_thread  # noqa: F401
from test_torch_port_model import quick_xla  # noqa: F401

OUT_ATOL = 1e-4
ALPHA_ATOL = 1e-5

# the references are jitted: one compile per shape instead of op-by-op
# dispatch (~0.3 s against ~2.7 s each); the interpret-mode Pallas calls
# compile as one program already
gat_reference = jax.jit(gat_layer_reference)
metalayer_ref = jax.jit(metalayer_reference)
encoder_ref = jax.jit(encoder_layer_reference, static_argnames="num_heads")
decoder_ref = jax.jit(decoder_layer_reference, static_argnames="num_heads")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _graphs(rng, b, n, e):
    """Padded graph layout with: padding nodes and edges, graph 1 with
    zero edges, and in graph 0 a valid node with no incoming edge."""
    node_mask = np.zeros((b, n), bool)
    edge_mask = np.zeros((b, e), bool)
    src = np.zeros((b, e), np.int32)
    dst = np.zeros((b, e), np.int32)
    for g in range(b):
        nn_ = int(rng.integers(4, n + 1)) if g else n - 2
        ne = 0 if g == 1 else int(rng.integers(4, e))
        node_mask[g, :nn_] = True
        edge_mask[g, :ne] = True
        src[g, :ne] = rng.integers(0, nn_, ne)
        dst[g, :ne] = rng.integers(0, nn_ - 1 if g == 0 else nn_, ne)
    return node_mask, edge_mask, src, dst


# ------------------------------------------------------------------ GAT

def _gat_case(rng, b, n, e, c=12, heads=4, masked=True):
    hc, p_dim = heads * c, heads * c // 2
    nm, em, src, dst = _graphs(rng, b, n, e)
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    w = dict(wl=f(c, hc, k=0.2), bl=f(hc, k=0.1), wr=f(c, hc, k=0.2),
             br=f(hc, k=0.1), att=f(heads, c, k=0.3), cbias=f(hc, k=0.1),
             w1=f(hc, p_dim, k=0.1), b1=f(p_dim, k=0.1), w2=f(p_dim, c, k=0.1),
             b2=f(c, k=0.1), gn_w=np.abs(f(c)) + 0.5, gn_b=f(c, k=0.1),
             gn_a=np.abs(f(c)) + 0.5)
    we = f(c, hc, k=0.2)
    # a masked layer's sampled 0/1 node gate, or an unmasked layer's ones
    gate = (rng.random((b, n, 1)) > 0.4).astype(np.float32)
    if not masked:
        gate = np.ones_like(gate)
    arrays = dict(h=f(b, n, c), xf=f(b, n, c), instr=f(b, c), gate=gate,
                  src=src, dst=dst, edge_mask=em, node_mask=nm,
                  e_attr=f(b, e, c))
    return arrays, w, we


def _port_gat_params(w, we):
    p = {k: _t(w[k].T if k in ("wl", "wr", "w1", "w2") else w[k])
         for k in w}
    p["we"] = _t(we.T)
    return p


@pytest.mark.parametrize("n,e", [(8, 24), (16, 48)])
@pytest.mark.parametrize("fuse_instr,masked", [(False, False), (True, False),
                                              (False, True)])
def test_gat_layer_plain_matches_pallas_and_reference(n, e, fuse_instr,
                                                      masked):
    rng = np.random.default_rng(n * 10 + e + fuse_instr + 2 * masked)
    a, w, we = _gat_case(rng, 3, n, e, masked=masked)
    jp = pack_gat_params(4, 12, **w)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    out_k, alpha_k = fused_gat_layer(
        **{**j, "xf": j["h"] if fuse_instr else j["xf"]},
        params={**jp, "we": jnp.asarray(we)}, fuse_instr=fuse_instr,
        interpret=True)
    xf_ref = (jnp.asarray(_gelu(a["h"] * a["instr"][:, None, :]))
              if fuse_instr else j["xf"])
    ref_args = {k: v for k, v in j.items() if k != "e_attr"}
    out_r, alpha_r = gat_reference(
        **{**ref_args, "xf": xf_ref}, eproj=jnp.asarray(a["e_attr"] @ we),
        params=jp)

    t = {k: _t(v) for k, v in a.items()}
    out_t, alpha_t = tops.fused_gat_layer(
        **t, params=_port_gat_params(w, we), fuse_instr=fuse_instr)
    for ref_out, ref_alpha in ((out_k, alpha_k), (out_r, alpha_r)):
        np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_out),
                                   rtol=0, atol=OUT_ATOL)
        np.testing.assert_allclose(alpha_t.numpy(), np.asarray(ref_alpha),
                                   rtol=0, atol=ALPHA_ATOL)
    # the zero-edge graph has all-zero attention; padding rows of the
    # output are GraphNorm's bias plus the residual
    assert np.all(alpha_t.numpy()[1] == 0)


def _gelu(x):
    return np.asarray(torch.nn.functional.gelu(torch.from_numpy(x)))


# ------------------------------------------------------------ MetaLayer

@pytest.mark.parametrize("n,e", [(8, 24), (16, 48)])
def test_metalayer_plain_matches_pallas_and_reference(n, e):
    rng = np.random.default_rng(n + e)
    b, c = 3, 16
    nm, em, src, dst = _graphs(rng, b, n, e)
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    w = dict(ew1=f(3 * c, c, k=0.2), eb1=f(c, k=0.1), ew2=f(c, c, k=0.2),
             eb2=f(c, k=0.1), n1w1=f(2 * c, c, k=0.2), n1b1=f(c, k=0.1),
             n1w2=f(c, c, k=0.2), n1b2=f(c, k=0.1), n2w1=f(2 * c, c, k=0.2),
             n2b1=f(c, k=0.1), n2w2=f(c, c, k=0.2), n2b2=f(c, k=0.1),
             gn_w=np.abs(f(c)) + 0.5, gn_b=f(c, k=0.1),
             gn_a=np.abs(f(c)) + 0.5)
    x, ea = f(b, n, c), f(b, e, c)
    args = [x, ea, src, dst, em, nm]
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jk = fused_metalayer(*map(jnp.asarray, args), jw, interpret=True)
    jr = metalayer_ref(*map(jnp.asarray, args), jw)
    pw = {k: _t(v.T if v.ndim == 2 else v) for k, v in w.items()}
    x_t, e_t = tops.fused_metalayer(*map(_t, args), pw)
    for xo, eo in (jk, jr):
        np.testing.assert_allclose(x_t.numpy(), np.asarray(xo), rtol=0,
                                   atol=OUT_ATOL)
        np.testing.assert_allclose(e_t.numpy(), np.asarray(eo), rtol=0,
                                   atol=OUT_ATOL)


# ------------------------------------------------------------ text stack

D, H, FF = 64, 4, 128


def _mha_w(f, prefix=""):
    return {prefix + k: v for k, v in dict(
        wq=f(D, D, k=0.15), bq=f(D, k=0.1), wk=f(D, D, k=0.15),
        bk=f(D, k=0.1), wv=f(D, D, k=0.15), bv=f(D, k=0.1),
        wo=f(D, D, k=0.15), bo=f(D, k=0.1)).items()}


def _ln_w(f, *names):
    out = {}
    for nm in names:
        out[nm + "s"] = np.abs(f(D)) + 0.5
        out[nm + "b"] = f(D, k=0.1)
    return out


def _port_mha(w, src="", dst=""):
    return {
        dst + "in_w": _t(np.concatenate([w[src + "wq"].T, w[src + "wk"].T,
                                         w[src + "wv"].T])),
        dst + "in_b": _t(np.concatenate([w[src + "bq"], w[src + "bk"],
                                         w[src + "bv"]])),
        dst + "out_w": _t(w[src + "wo"].T), dst + "out_b": _t(w[src + "bo"]),
    }


def _port_ffn_ln(w, lns):
    p = {"w1": _t(w["w1"].T), "b1": _t(w["b1"]), "w2": _t(w["w2"].T),
         "b2": _t(w["b2"])}
    p.update({k: _t(w[k]) for ln in lns for k in (ln + "s", ln + "b")})
    return p


@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("final", [False, True])
def test_encoder_layer_plain_matches_pallas_and_reference(l, final):
    rng = np.random.default_rng(l + 7 * final)
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    w = {**_mha_w(f), **_ln_w(f, "n1", "n2"), "w1": f(D, FF, k=0.1),
         "b1": f(FF, k=0.1), "w2": f(FF, D, k=0.1), "b2": f(D, k=0.1)}
    x = f(3, l, D)
    mask = np.ones((3, l), np.float32)
    mask[0, l // 2:] = 0.0            # padded question tokens
    mask[2, -3:] = 0.0
    fl = (np.abs(f(D)) + 0.5, f(D, k=0.1)) if final else None
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jfl = tuple(map(jnp.asarray, fl)) if final else None
    yk = fused_encoder_layer(jnp.asarray(x), jnp.asarray(mask), jw,
                             num_heads=H, final_ln=jfl, interpret=True)
    yr = encoder_ref(jnp.asarray(x), jnp.asarray(mask), None, jw, num_heads=H)
    if final:
        from isubgvqa_tpu.models.layers import ln_apply
        yr = ln_apply(yr, *jfl, None)
    pw = {**_port_mha(w), **_port_ffn_ln(w, ("n1", "n2"))}
    yt = tops.fused_encoder_layer(_t(x), _t(mask), pw, num_heads=H,
                                  final_ln=tuple(map(_t, fl)) if final else None)
    for ref in (yk, yr):
        np.testing.assert_allclose(yt.numpy(), np.asarray(ref), rtol=0,
                                   atol=OUT_ATOL)


@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("final", [False, True])
def test_decoder_layer_plain_matches_pallas_and_reference(l, final):
    rng = np.random.default_rng(100 + l + 7 * final)
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    w = {**_mha_w(f, "s"), **_mha_w(f, "c"), **_ln_w(f, "n1", "n2", "n3"),
         "w1": f(D, FF, k=0.1), "b1": f(FF, k=0.1), "w2": f(FF, D, k=0.1),
         "b2": f(D, k=0.1)}
    tgt, mem = f(3, 4, D), f(3, l, D)
    fl = (np.abs(f(D)) + 0.5, f(D, k=0.1)) if final else None
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jfl = tuple(map(jnp.asarray, fl)) if final else None
    yk = fused_decoder_layer(jnp.asarray(tgt), jnp.asarray(mem), jw,
                             num_heads=H, final_ln=jfl, interpret=True)
    yr = decoder_ref(jnp.asarray(tgt), jnp.asarray(mem), None, jw,
                     num_heads=H)
    if final:
        from isubgvqa_tpu.models.layers import ln_apply
        yr = ln_apply(yr, *jfl, None)
    pw = {**_port_mha(w, "s", "s_"), **_port_mha(w, "c", "c_"),
          **_port_ffn_ln(w, ("n1", "n2", "n3"))}
    yt = tops.fused_decoder_layer(_t(tgt), _t(mem), pw, num_heads=H,
                                  final_ln=tuple(map(_t, fl)) if final else None)
    for ref in (yk, yr):
        np.testing.assert_allclose(yt.numpy(), np.asarray(ref), rtol=0,
                                   atol=OUT_ATOL)


def test_cpu_tensors_take_the_plain_path_without_counting():
    rng = np.random.default_rng(3)
    a, w, we = _gat_case(rng, 2, 8, 24)
    tops.reset_launch_counts()
    t = {k: _t(v) for k, v in a.items()}
    out, alpha = tops.fused_gat_layer(**t, params=_port_gat_params(w, we))
    ref = tops.fused_gat_layer_plain(**t, params=_port_gat_params(w, we))
    assert torch.equal(out, ref[0]) and torch.equal(alpha, ref[1])
    train = ("fused_gatconv", "fused_metalayer_train",
             "fused_encoder_layer_train", "fused_decoder_layer_train")
    assert tops.launch_counts() == {
        "fused_gat_layer": 0, "fused_encoder_layer": 0,
        "fused_decoder_layer": 0, "fused_metalayer": 0,
        **{k: 0 for k in train}, **{k + "_bwd": 0 for k in train}}
