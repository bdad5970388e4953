"""The graph-layer GEMM's plain twin (``ops/gemm.py:gemm_gather_plain``,
which the CPU runs in place of ``csrc/gemm_gather_sm90.cu``) against an
explicit composition and against the JAX Pallas kernels' product
arithmetic, on the same numpy inputs.

* Explicit composition: gather (a zero row for a negative index),
  concatenate, ``F.linear`` of the bf16-rounded operands in f32, then
  the epilogue.  The twin sums one product per segment, so the two
  differ in f32 summation order only: 1e-5 of the result's scale for an
  f32 output; a bf16 output may round one ulp (2^-8) apart, so 8e-3.
* JAX: the products as ``ops/pallas/metalayer_kernel.py:_kernel`` and
  ``gat_kernel.py:_kernel`` take them (``jnp.dot`` of bf16 operands with
  ``preferred_element_type=f32``, one dot per weight slice, the gathers
  as one-hot matmuls), 1e-5 as above.
* The stacked x_l | x_r product of ``ops/gat_kernel.py`` against the two
  products it replaces: each output column is the same sum, 1e-6.

The kernel itself is held against this twin on the card by
``test_torch_port_cuda.py`` (``gpu`` marker) and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from isubgvqa_tpu_torch.ops import gemm as G
from isubgvqa_tpu_torch.ops.gat_kernel import stacked_lr

from test_torch_port_model import one_torch_thread  # noqa: F401
from test_torch_port_model import quick_xla  # noqa: F401

BF = torch.bfloat16
TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}

# (segments as (rows, K, gathered), N, M, epilogue options)
CASES = {
    "one_dense": ([(24, 16, False)], 20, 24, dict(bias=True)),
    "one_gathered_gelu_bf16": ([(10, 12, True)], 8, 30,
                               dict(bias=True, act="gelu", out=BF)),
    "two_gathered_pre_rowscale": ([(9, 8, True), (21, 16, False)], 12, 21,
                                  dict(bias=True, act="gelu", pre=True,
                                       row_scale=True)),
    "three_metalayer_edge": ([(7, 12, True), (7, 12, True), (19, 12, False)],
                             12, 19, dict(bias=True, act="gelu", pre=True,
                                          out=BF)),
    "relu_emul": ([(17, 20, False)], 16, 17, dict(act="relu", emul=True)),
}


def _inputs(spec, n, m, opts, seed):
    rng = np.random.default_rng(seed)
    segs = []
    for rows, k, gathered in spec:
        a = rng.standard_normal((rows, k)).astype(np.float32)
        idx = (rng.integers(-1, rows, m).astype(np.int32) if gathered
               else None)
        if idx is not None:
            idx[:2] = -1                       # zero rows for certain
        segs.append((a, idx))
    ktot = sum(k for _, k, _ in spec)
    w = (rng.standard_normal((n, ktot)) / np.sqrt(ktot)).astype(np.float32)
    extra = dict(
        bias=rng.standard_normal(n).astype(np.float32) if opts.get("bias")
        else None,
        row_scale=rng.random(m).astype(np.float32)
        if opts.get("row_scale") else None,
        emul=rng.random((m, n)).astype(np.float32) if opts.get("emul")
        else None)
    return segs, w, extra


def _torch(segs, w, extra):
    t = lambda a: None if a is None else torch.from_numpy(a)
    return ([(t(a).to(BF), t(i)) for a, i in segs], t(w).to(BF),
            {k: t(v) for k, v in extra.items()})


def _close(got, want, tol):
    scale = max(1.0, want.abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_twin_matches_explicit_composition(name):
    spec, n, m, opts = CASES[name]
    segs, w, extra = _torch(*_inputs(spec, n, m, opts, len(name)))
    out = opts.get("out", torch.float32)
    act = opts.get("act")
    pre = torch.empty(m, n) if opts.get("pre") else None
    got = G.gemm_gather_plain(segs, w, extra["bias"], act, out,
                              extra["row_scale"], extra["emul"], pre)
    rows = []
    for a, idx in segs:
        if idx is not None:
            a = torch.stack([a[i] if i >= 0 else torch.zeros_like(a[0])
                             for i in idx.tolist()])
        rows.append(a.float())
    want_pre = F.linear(torch.cat(rows, 1), w.float(), extra["bias"])
    want = {"gelu": F.gelu, "relu": torch.relu,
            None: lambda y: y}[act](want_pre)
    if extra["emul"] is not None:
        want = want * extra["emul"]
    if extra["row_scale"] is not None:
        want = want * extra["row_scale"][:, None]
    assert got.dtype == out and got.shape == (m, n)
    _close(got, want.to(out), TOL[out])
    if pre is not None:
        _close(pre, want_pre, TOL[torch.float32])
    # the wrapper takes the twin for CPU tensors
    assert torch.equal(G.gemm_gather(segs, w, extra["bias"], act, out,
                                     extra["row_scale"], extra["emul"]), got)


def _jax_gather(x, idx):
    """x[idx] as the Pallas kernels take it: a one-hot matmul in f32, a
    zero row for a negative index."""
    oh = (idx[:, None] == np.arange(x.shape[0])[None]).astype(np.float32)
    return jnp.dot(oh, x, preferred_element_type=jnp.float32)


def test_plain_twin_matches_jax_edge_mlp_product():
    """The MetaLayer's first edge product, ``[x_src, x_dst, e] @ ew1 +
    eb1`` then GELU, three segments against one ``[C, 3C]`` weight."""
    spec = [(9, 16, True), (9, 16, True), (25, 16, False)]
    segs, w, extra = _inputs(spec, 16, 25, dict(bias=True), 3)
    (x, isrc), (_, idst), (e, _) = segs       # both gathers read x
    c = 16
    wk = jnp.asarray(w.T, jnp.bfloat16)                 # flax [in, out]
    f32 = jnp.float32
    h = (jnp.dot(_jax_gather(x, isrc).astype(jnp.bfloat16), wk[:c],
                 preferred_element_type=f32)
         + jnp.dot(_jax_gather(x, idst).astype(jnp.bfloat16), wk[c:2 * c],
                   preferred_element_type=f32)
         + jnp.dot(jnp.asarray(e).astype(jnp.bfloat16), wk[2 * c:],
                   preferred_element_type=f32)
         + extra["bias"])
    want = np.array(jax.nn.gelu(h, approximate=False))
    t = torch.from_numpy
    got = G.gemm_gather_plain(
        [(t(x).to(BF), t(isrc)), (t(x).to(BF), t(idst)), (t(e).to(BF), None)],
        t(w).to(BF), t(extra["bias"]), "gelu")
    _close(got, t(want), TOL[torch.float32])


def test_plain_twin_matches_jax_node_projection():
    """The GAT layer's x_l: ``xf`` at bf16 against the bf16 weight, f32
    accumulation, plus the bias (``gat_kernel.py:108-112``)."""
    ((xf, _),), w, extra = _inputs([(30, 20, False)], 24, 30,
                                   dict(bias=True), 5)
    want = (jnp.dot(jnp.asarray(xf, jnp.bfloat16),
                    jnp.asarray(w.T, jnp.bfloat16),
                    preferred_element_type=jnp.float32) + extra["bias"])
    t = torch.from_numpy
    got = G.gemm_gather_plain([(t(xf).to(BF), None)], t(w).to(BF),
                              t(extra["bias"]))
    _close(got, t(np.array(want)), TOL[torch.float32])


def test_stacked_xl_xr_product_matches_separate_products():
    rng = np.random.default_rng(7)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    p = {"wl": t(48, 16).to(BF), "wr": t(48, 16).to(BF), "bl": t(48),
         "br": t(48)}
    x = t(40, 16).to(BF)
    w_lr, b_lr = stacked_lr(p)
    both = G.gemm_gather_plain([(x, None)], w_lr, b_lr)
    x_l = G.gemm_gather_plain([(x, None)], p["wl"], p["bl"])
    x_r = G.gemm_gather_plain([(x, None)], p["wr"], p["br"])
    _close(both[:, :48], x_l, 1e-6)
    _close(both[:, 48:], x_r, 1e-6)
    # made once while the weights stand, made again after an update
    assert stacked_lr(p)[0] is w_lr
    p["wl"].mul_(2.0)
    w2, _ = stacked_lr(p)
    assert w2 is not w_lr and torch.equal(w2[:48], p["wl"])


def test_f32_gemm_refuses_a_bf16_weight():
    """bf16 products go to gemm_gather; the f32 GEMM has no bf16 form."""
    with pytest.raises(TypeError):
        G.gemm([(torch.zeros(4, 8, dtype=BF), None)],
               torch.zeros(4, 8, dtype=BF))
