"""The bf16x3 arithmetic of the staged backward GEMM and the staged
backward chains of the MetaLayer and the decoder layer, on the CPU.

``csrc/gemm_bwd.cu`` splits each f32 gradient into three bf16 planes
(``x1 = bf16(x)``, ``x2 = bf16(x - x1)``, ``x3 = bf16(x - x1 - x2)``, each
to nearest even) and sums the three products with an exact bf16 operand
in f32; :func:`isubgvqa_tpu_torch.ops.gemm.bf16x3_mm` is the same
arithmetic.  Checks:

* the split: every plane holds bf16 values, and the planes' sum is
  within 2^-22 of x, relative;
* the emulated product against an f64 product at K = 300, 1200 and 8192,
  within 4e-6 of the f64 result's max abs, with a bf16 B (the kernel's
  case) and with an f32 B;
* the MetaLayer's and the decoder layer's plain versions with every
  dgrad / wgrad product routed through the emulation (its first operand
  split), against ``jax.grad`` of the JAX package's references with the
  comparison and ``GRAD_RTOL = 1e-4`` of
  ``test_torch_port_train_kernels.py``;
* the staged backward chains (:func:`metalayer_backward`,
  :func:`decoder_backward`), run on CPU tensors through each launch's
  plain twin, against autograd of the plain layer on the same inputs:
  every parameter gradient and both input gradients, f32 to 1e-4 of each
  gradient's max abs (products of the same values in another order and
  split form), and bf16 by the RMS error over the RMS to 2e-3 (the same
  roundings of the forward, but a sum taken in another order may land on
  the other side of a bf16 rounding and carry it on).
"""

import numpy as np
import pytest
import torch

from isubgvqa_tpu_torch.models.layers import DecoderLayer
from isubgvqa_tpu_torch.models.scene_graph_encoder import SceneGraphEncoder
from isubgvqa_tpu_torch.ops import gemm, metalayer_train, text_train
from isubgvqa_tpu_torch.ops.metalayer_kernel import KEYS
from isubgvqa_tpu_torch.ops.text_kernel import DEC_KEYS, masks_at

import test_torch_port_train_kernels as tk
from test_torch_port_kernels import _graphs
from test_torch_port_model import one_torch_thread  # noqa: F401
from test_torch_port_model import quick_xla  # noqa: F401
from test_torch_port_train_kernels import jit_grads  # noqa: F401


def test_split_bf16x3_planes_are_bf16_and_sum_to_x():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.normal(size=4000), rng.normal(size=1000) * 1e-30,
        rng.normal(size=1000) * 1e30]).astype(np.float32))
    planes = gemm.split_bf16x3(x)
    for p in planes:
        assert p.dtype == torch.float32
        assert torch.equal(p, p.to(torch.bfloat16).float())
    err = (sum(p.double() for p in planes) - x.double()).abs()
    assert torch.all(err <= x.double().abs() * 2.0 ** -22)
    # two planes would not do
    two = ((planes[0].double() + planes[1].double()) - x.double()).abs()
    assert torch.any(two > x.double().abs() * 2.0 ** -20)


@pytest.mark.parametrize("k", [300, 1200, 8192])
@pytest.mark.parametrize("b_bf16", [True, False], ids=["bf16_b", "f32_b"])
def test_bf16x3_product_keeps_f32_accuracy(k, b_bf16):
    rng = np.random.default_rng(k)
    a = rng.normal(size=(48, k)).astype(np.float32)
    b = torch.from_numpy(rng.normal(size=(k, 40)).astype(np.float32))
    if b_bf16:
        b = b.to(torch.bfloat16).float()
    exact = a.astype(np.float64) @ b.double().numpy()
    scale = np.abs(exact).max()
    got = gemm.bf16x3_mm(torch.from_numpy(a), b).numpy()
    assert np.abs(got - exact).max() / scale <= 4e-6
    # the first plane alone is a bf16 product, far from it
    one = (gemm.split_bf16x3(torch.from_numpy(a))[0] @ b).numpy()
    assert np.abs(one - exact).max() / scale > 1e-4


@pytest.fixture
def bf16x3_backward(monkeypatch):
    """Route the plain versions' dgrad / wgrad products through the
    emulation; yields the list of product shapes it saw."""
    seen = []

    def product(a, b):
        seen.append((tuple(a.shape), tuple(b.shape)))
        return gemm.bf16x3_mm(a, b)

    monkeypatch.setattr(gemm, "backward_product", product)
    return seen


def test_metalayer_bf16x3_grads_match_jax(bf16x3_backward):
    tk.test_metalayer_train_plain_grads_match_jax()
    # ten products (the first layers' weights taken in column blocks),
    # dgrad and wgrad
    assert len(bf16x3_backward) == 2 * 10


def test_decoder_bf16x3_grads_match_jax(jit_grads, bf16x3_backward):
    tk.test_decoder_train_plain_grads_match_jax(jit_grads)
    assert len(bf16x3_backward) >= 2 * 10


# ------------------------------------------------------------ staged chains

def _grads_close(got, want, names, dtype):
    for g, w, name in zip(got, want, names):
        assert g is not None and torch.isfinite(g.float()).all(), name
        g, w = g.float(), w.float()
        if dtype == torch.float32:
            err = (g - w).abs().max() / max(w.abs().max(), 1e-12)
            tol = 1e-4
        else:
            rms = lambda t: t.square().mean().sqrt()
            err = rms(g - w) / max(rms(w), 1e-12)
            tol = 2e-3
        assert err <= tol, (name, float(err))


def _masters(params):
    return {k: v.detach().float().clone().requires_grad_(True)
            for k, v in params.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_staged_metalayer_backward_matches_autograd(dtype):
    torch.manual_seed(3)
    rng = np.random.default_rng(8)
    b, n, e, c = 3, 12, 40, 16
    nm, em, src, dst = (torch.from_numpy(a) for a in _graphs(rng, b, n, e))
    x = torch.randn(b, n, c).to(dtype).requires_grad_(True)
    ea = torch.randn(b, e, c).to(dtype).requires_grad_(True)
    master = _masters(SceneGraphEncoder(10, c).kernel_params())
    cx, ce = torch.randn(b, n, c), torch.randn(b, e, c)
    xo, eo = metalayer_train.fused_metalayer_train_plain(
        x, ea, src, dst, em, nm, master)
    want = torch.autograd.grad((xo.float() * cx).sum()
                               + (eo.float() * ce).sum(),
                               [x, ea] + [master[k] for k in KEYS])
    p = text_train.ship_params(master, dtype)
    s = metalayer_train.metalayer_saved_plain(x.detach(), ea.detach(), src,
                                              dst, em, nm, p)
    dx, de, g = metalayer_train.metalayer_backward(
        cx.to(dtype), ce.to(dtype), s, p, (dtype, dtype))
    assert dx.dtype == dtype and de.dtype == dtype
    _grads_close([dx.reshape(b, n, c), de.reshape(b, e, c)]
                 + [g[k] for k in KEYS], want, ["x", "e_attr", *KEYS], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_staged_decoder_backward_matches_autograd(dtype):
    torch.manual_seed(4)
    b, t, l, d, ff, heads = 3, 4, 9, 64, 128, 4
    keep = lambda *s: (torch.rand(*s) > 0.25).float() / 0.75
    masks = {"self_attn": keep(b, heads, t, t), "post_sa": keep(b, t, d),
             "cross_attn": keep(b, heads, t, l), "post_ca": keep(b, t, d),
             "ffn": keep(b, t, ff), "post_ffn": keep(b, t, d)}
    tgt = torch.randn(b, t, d).to(dtype).requires_grad_(True)
    mem = torch.randn(b, l, d).to(dtype).requires_grad_(True)
    master = _masters(DecoderLayer(d, ff).kernel_params())
    cot = torch.randn(b, t, d)
    out = text_train.fused_decoder_layer_train_plain(tgt, mem, masks, master,
                                                     heads)
    want = torch.autograd.grad((out.float() * cot).sum(),
                               [tgt, mem] + [master[k] for k in DEC_KEYS])
    p = text_train.ship_params(master, dtype)
    s = text_train.decoder_saved_plain(tgt.detach(), mem.detach(),
                                       masks_at(masks, dtype), p, heads)
    dtgt, dmem, g = text_train.decoder_backward(cot.to(dtype), s, p, heads,
                                                (dtype, dtype))
    assert dtgt.dtype == dtype and dmem.dtype == dtype
    _grads_close([dtgt.reshape(b, t, d), dmem.reshape(b, l, d)]
                 + [g[k] for k in DEC_KEYS], want,
                 ["tgt", "memory", *DEC_KEYS], dtype)
