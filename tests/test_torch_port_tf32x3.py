"""The 3xTF32 arithmetic of the port's tensor-core GEMM, emulated in
plain PyTorch on the CPU, is accurate enough for the backward products
before it runs on the card.

The kernels (``csrc/gemm.cu``) split each f32 operand into ``hi =
tf32(x)`` and ``lo = tf32(x - hi)`` (``cvt.rna``: to nearest, ties away
from zero, a 10-bit mantissa) and sum ``a_lo b_hi + a_hi b_lo + a_hi
b_hi`` in f32; :func:`isubgvqa_tpu_torch.ops.gemm.tf32x3_mm` is the same
arithmetic.  Checks:

* the rounding itself, on values whose TF32 rounding is known;
* the emulated product against an f64 product at K = 300, 1200 and 8192,
  within 4e-6 of the f64 result's max abs (a plain f32 product lands near
  5e-7, a single TF32 pass near 3e-4);
* the training plain versions with every dgrad / wgrad product routed
  through the emulation (``gemm.backward_product``), against ``jax.grad``
  of the JAX package's references with the same comparison and the same
  ``GRAD_RTOL = 1e-4`` as ``test_torch_port_train_kernels.py``, the
  dst-only gate included.
"""

import numpy as np
import pytest
import torch

from isubgvqa_tpu_torch.ops import gemm

import test_torch_port_train_kernels as tk
from test_torch_port_model import one_torch_thread  # noqa: F401
from test_torch_port_model import quick_xla  # noqa: F401
from test_torch_port_train_kernels import gat_case, jit_grads  # noqa: F401


def test_split_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                     # TF32's mantissa step at [1, 2)
    x = torch.tensor([1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -20,
                      1 + 3 * ulp / 2, 3.0e-3, -7.77e5], dtype=torch.float32)
    hi, lo = gemm.split_tf32(x)
    want = torch.tensor([1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp],
                        dtype=torch.float32)
    torch.testing.assert_close(hi[:5], want, rtol=0, atol=0)
    bits = torch.cat([hi, lo]).view(torch.int32)
    assert torch.all(bits & 0x1FFF == 0)               # 10-bit mantissas
    # hi + lo carries all but the last two of f32's 24 mantissa bits
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert torch.all(err <= x.double().abs() * 2.0 ** -21)


@pytest.mark.parametrize("k", [300, 1200, 8192])
def test_tf32x3_product_keeps_f32_accuracy(k):
    rng = np.random.default_rng(k)
    a = rng.normal(size=(48, k)).astype(np.float32)
    b = rng.normal(size=(k, 40)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()
    got = gemm.tf32x3_mm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    err = np.abs(got - exact).max() / scale
    assert err <= 4e-6, err
    # a single TF32 pass would not do
    one = (gemm.split_tf32(torch.from_numpy(a))[0]
           @ gemm.split_tf32(torch.from_numpy(b))[0]).numpy()
    assert np.abs(one - exact).max() / scale > 2e-5


@pytest.fixture
def tf32x3_backward(monkeypatch):
    """Route the plain versions' dgrad / wgrad products through the
    emulation; yields the list of product shapes it saw."""
    seen = []

    def product(a, b):
        seen.append((tuple(a.shape), tuple(b.shape)))
        return gemm.tf32x3_mm(a, b)

    monkeypatch.setattr(gemm, "backward_product", product)
    return seen


@pytest.mark.parametrize("with_masks", [True, False], ids=["masks", "none"])
def test_encoder_tf32x3_grads_match_jax(jit_grads, tf32x3_backward,
                                        with_masks):
    tk.test_encoder_train_plain_grads_match_jax(jit_grads, with_masks)
    # QKV, output projection and the FFN's two products, dgrad and wgrad
    assert len(tf32x3_backward) >= 12


def test_gatconv_tf32x3_grads_match_jax(gat_case, tf32x3_backward):
    tk.test_gatconv_train_plain_grads_match_jax(gat_case)
    assert len(tf32x3_backward) == 6        # x_l, x_r, lin_edge: dgrad, wgrad


def test_gatconv_tf32x3_gate_gradient_is_dst_only(gat_case, tf32x3_backward):
    tk.test_gatconv_gate_gradient_is_dst_only(gat_case)
    assert tf32x3_backward
