"""The port's CUDA kernels against their plain versions on the card.

Small shapes with the edge cases of the CPU tests: padding nodes and
edges, a graph with no edges, a node with no incoming edge, a sampled
node gate, instruction fusion on and off, padded question tokens, the
final LayerNorm folded in.  The tests need a CUDA device and ``nvcc``
and skip without them.  This file imports neither JAX nor the JAX
package, so on a machine with the card it runs without the repository's
``conftest.py`` (which sets up JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py -q

Tolerances, as max abs error over the output's scale (its max abs, at
least 1): f32 1e-3 with TF32 off, where kernel and plain version differ
only in summation order; bf16 3e-2, where they round at the same points
but another summation order can flip one bf16 rounding (2^-8 relative)
that later products carry on.  The training layers' gradients: f32 to
1e-3 of each gradient's own max abs; bf16 by the RMS error over the
RMS, to 3e-2: the gradients are f32 on both sides, but a flipped bf16
rounding or ReLU sign moves whole rows of a weight's gradient (see
``chip_smoke.py:TRAIN_GRAD_TOL``).
"""

import numpy as np
import pytest
import torch

from isubgvqa_tpu_torch import ops
from isubgvqa_tpu_torch.ops import gat_train, metalayer_train, text_train
from isubgvqa_tpu_torch.models.layers import DecoderLayer, EncoderLayer
from isubgvqa_tpu_torch.models.mgat import MGAT
from isubgvqa_tpu_torch.models.scene_graph_encoder import SceneGraphEncoder

TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
C, HEADS, D, FF, TEXT_HEADS = 16, 4, 64, 128, 4
DEVICE = "cuda"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py covers the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def graphs(rng, b, n, e):
    """Graph 1 has no edges; in graph 0 the last valid node has no
    incoming edge; the rest is padding."""
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
    return [torch.from_numpy(a).to(DEVICE)
            for a in (node_mask, edge_mask, src, dst)]


def ship(params, dtype):
    """Weights at the model dtype, vectors and ``att`` f32, on the card."""
    return {k: (v.detach().to(DEVICE, dtype) if v.dim() == 2 and k != "att"
                else v.detach().float().to(DEVICE)) for k, v in params.items()}


def randn(*shape, dtype, scale=1.0):
    return (scale * torch.randn(*shape, device=DEVICE)).to(dtype)


def check(got, want, dtype):
    for g, w in zip(got, want):
        scale = max(1.0, w.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        assert torch.isfinite(g.float()).all()
        assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_kernels_match_plain_versions(card, dtype):
    torch.manual_seed(0)
    rng = np.random.default_rng(11)
    b, n, e = 3, 16, 48
    nm, em, src, dst = graphs(rng, b, n, e)
    h, ea = randn(b, n, C, dtype=dtype), randn(b, e, C, dtype=dtype)
    ins = randn(b, C, dtype=dtype, scale=0.5)

    gp = ship(MGAT(C, 1, HEADS, (1.0,)).layer_params(0), dtype)
    xf = torch.nn.functional.gelu(h.float() * ins.float()[:, None]).to(dtype)
    sampled = (torch.rand(b, n, 1, device=DEVICE) > 0.4).to(dtype)
    for gate, fuse in ((torch.ones_like(sampled), True), (sampled, False)):
        args = (h, xf, ins, gate, src, dst, em, nm, ea, gp)
        check(ops.fused_gat_layer(*args, fuse_instr=fuse),
              ops.fused_gat_layer_plain(*args, fuse_instr=fuse), dtype)

    mp = ship(SceneGraphEncoder(10, C).kernel_params(), dtype)
    margs = (h, ea, src, dst, em, nm, mp)
    check(ops.fused_metalayer(*margs), ops.fused_metalayer_plain(*margs),
          dtype)

    ep = ship(EncoderLayer(D, FF).kernel_params(), dtype)
    dp = ship(DecoderLayer(D, FF).kernel_params(), dtype)
    x = randn(b, 16, D, dtype=dtype)
    mask = torch.ones(b, 16, device=DEVICE)
    mask[0, 8:] = 0.0                       # padded question tokens
    fl = (1.0 + 0.1 * torch.randn(D, device=DEVICE),
          0.1 * torch.randn(D, device=DEVICE))
    tgt = randn(b, 4, D, dtype=dtype)
    for final in (None, fl):
        check((ops.fused_encoder_layer(x, mask, ep, TEXT_HEADS, final),),
              (ops.fused_encoder_layer_plain(x, mask, ep, TEXT_HEADS, final),),
              dtype)
        check((ops.fused_decoder_layer(tgt, x, dp, TEXT_HEADS, final),),
              (ops.fused_decoder_layer_plain(tgt, x, dp, TEXT_HEADS, final),),
              dtype)
    torch.cuda.synchronize()


def masters(params):
    """f32 master parameters on the card, as leaves with gradients."""
    return {k: v.detach().float().to(DEVICE).requires_grad_(True)
            for k, v in params.items()}


def run_both(fn, plain, args, diff, params, cot):
    """Forward and backward of ``fn`` and of ``plain`` (autograd) on the
    same inputs; returns both ``(outputs, input grads, param grads)``."""
    res = []
    for f in (fn, plain):
        xs = [a.detach().clone().requires_grad_(True) if i in diff else a
              for i, a in enumerate(args)]
        ps = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
        outs = f(*xs, ps)
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum((o.float() * c).sum() for o, c in zip(outs, cot)).backward()
        res.append((outs, [xs[i].grad for i in diff],
                    {k: v.grad for k, v in ps.items()}))
    return res


def check_grads(got, want, dtype, names):
    # f32: max abs error over max abs; bf16: RMS error over RMS.  A
    # gradient that is zero in exact arithmetic (a bias that GraphNorm's
    # mean subtraction cancels) holds only the rounding noise of terms at
    # the other gradients' scale: floor its scale at 1 % of theirs
    if dtype == torch.float32:
        size = lambda t: t.float().abs().max().item()
    else:
        size = lambda t: t.float().square().mean().sqrt().item()
    floor = 1e-2 * max(size(w) for w in want)
    for g, w, name in zip(got, want, names):
        assert g is not None and w is not None, name
        assert torch.isfinite(g.float()).all(), name
        err = size(g.float() - w.float()) / max(size(w), floor, 1e-12)
        assert err <= GRAD_TOL[dtype], (name, err)


def check_train(res, dtype, diff_names):
    (ok, ik, pk), (op, ip, pp) = res
    check(ok, op, dtype)
    for i, name in enumerate(diff_names):
        check_grads([ik[i]], [ip[i]], dtype, [name])
    check_grads([pk[k] for k in pp], [pp[k] for k in pp], dtype, list(pp))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_train_kernels_match_autograd_of_plain(card, dtype):
    """Each training layer's forward and backward kernels against autograd
    of its plain version: padding edges, a zero-edge graph, a node with
    no incoming edge, a sampled gate, padded question tokens, dropout
    masks on."""
    torch.manual_seed(1)
    rng = np.random.default_rng(12)
    b, n, e = 3, 16, 48
    nm, em, src, dst = graphs(rng, b, n, e)
    h, ea = randn(b, n, C, dtype=dtype), randn(b, e, C, dtype=dtype)
    gate = (torch.rand(b, n, 1, device=DEVICE) > 0.4).to(dtype)
    gp = MGAT(C, 1, HEADS, (1.0,)).layer_params(0)
    cp = masters({k: gp[k] for k in gat_train.CONV_KEYS})
    conv_cot = (torch.randn(b, n, HEADS * C, device=DEVICE),
                torch.randn(b, e, HEADS, device=DEVICE))
    wrap = lambda f: (lambda xf, g, ea, p: f(xf, g, src, dst, em, ea, p))
    res = run_both(wrap(gat_train.fused_gatconv),
                   wrap(gat_train.fused_gatconv_plain), (h, gate, ea),
                   (0, 1, 2), cp, conv_cot)
    check_train(res, dtype, ["xf", "gate", "e_attr"])
    assert gat_train.fused_gatconv.bwd_launches > 0

    mp = masters(SceneGraphEncoder(10, C).kernel_params())
    wrap = lambda f: (lambda x, ea, p: f(x, ea, src, dst, em, nm, p))
    res = run_both(wrap(metalayer_train.fused_metalayer_train),
                   wrap(metalayer_train.fused_metalayer_train_plain), (h, ea),
                   (0, 1), mp, (torch.randn(b, n, C, device=DEVICE),
                                torch.randn(b, e, C, device=DEVICE)))
    check_train(res, dtype, ["x", "e_attr"])

    l, t = 16, 4
    x = randn(b, l, D, dtype=dtype)
    mask = torch.ones(b, l, device=DEVICE)
    mask[0, 8:] = 0.0
    keep = lambda *s: (torch.rand(*s, device=DEVICE) > 0.1).float() / 0.9
    em_ = {"attn": keep(b, TEXT_HEADS, l, l), "post_attn": keep(b, l, D),
           "ffn": keep(b, l, FF), "post_ffn": keep(b, l, D)}
    ep = masters(EncoderLayer(D, FF).kernel_params())
    res = run_both(
        lambda x, p: text_train.fused_encoder_layer_train(x, mask, em_, p,
                                                          TEXT_HEADS),
        lambda x, p: text_train.fused_encoder_layer_train_plain(
            x, mask, em_, p, TEXT_HEADS), (x,), (0,), ep,
        (torch.randn(b, l, D, device=DEVICE),))
    check_train(res, dtype, ["x"])
    tgt = randn(b, t, D, dtype=dtype)
    dm = {"self_attn": keep(b, TEXT_HEADS, t, t), "post_sa": keep(b, t, D),
          "cross_attn": keep(b, TEXT_HEADS, t, l), "post_ca": keep(b, t, D),
          "ffn": keep(b, t, FF), "post_ffn": keep(b, t, D)}
    dp = masters(DecoderLayer(D, FF).kernel_params())
    res = run_both(
        lambda tg, m, p: text_train.fused_decoder_layer_train(tg, m, dm, p,
                                                              TEXT_HEADS),
        lambda tg, m, p: text_train.fused_decoder_layer_train_plain(
            tg, m, dm, p, TEXT_HEADS), (tgt, x), (0, 1), dp,
        (torch.randn(b, t, D, device=DEVICE),))
    check_train(res, dtype, ["tgt", "memory"])
    torch.cuda.synchronize()


# ------------------------------------------------------------ 3xTF32 GEMM
#
# The backward GEMM against its plain 3xTF32 emulation (the same split
# and products; only the order of the f32 sums differs) and against the
# f32 product with TF32 off, both to 2e-5 of the result's max abs: a
# single TF32 pass is ~3e-4 off at these K (tests/test_torch_port_tf32x3.py).

GEMM_TOL = 2e-5
GEMM_CASES = {
    # name: (m, n, k, a_trans, gathered, bf16 B, accumulate into a slice)
    "ragged_300x1200x300": (300, 1200, 300, False, False, False, False),
    "tiny_1x7x5": (1, 7, 5, False, False, False, False),
    "a_trans_split_k": (300, 300, 8192, True, False, False, False),
    "gathered_rows": (300, 200, 1500, True, True, False, False),
    "bf16_b": (300, 1200, 300, False, False, True, False),
    "bf16_b_gathered_split_k": (64, 300, 4000, True, True, True, False),
    "accumulate_column_slice": (200, 96, 700, False, False, False, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_gemm_any_matches_tf32x3_emulation_and_f32(card, case):
    from isubgvqa_tpu_torch.ops import gemm

    m, n, k, a_trans, gathered, bf16, acc = GEMM_CASES[case]
    g = torch.Generator(device=DEVICE).manual_seed(3)
    a = torch.randn((k, m) if a_trans else (m, k), device=DEVICE, generator=g)
    rows = k + 17 if gathered else k
    b = torch.randn(rows, n, device=DEVICE, generator=g)
    if bf16:
        b = b.to(torch.bfloat16)
    idx = None
    if gathered:
        idx = torch.randint(-1, rows, (k,), device=DEVICE, generator=g,
                            dtype=torch.int32)
        idx[:5] = -1                            # zero rows
    base = torch.randn(m, n + 40, device=DEVICE, generator=g)

    def run():
        out = base.clone()
        view = out[:, 20:20 + n] if acc else None
        res = gemm.gemm_any(a, b, m, n, k, a_trans=a_trans, b_idx=idx,
                            out=view, accumulate=acc)
        return out if acc else res

    got = run()
    torch.cuda.synchronize()
    a_mat = a.t() if a_trans else a
    b_mat = b.float()
    if idx is not None:
        b_mat = torch.where((idx >= 0)[:, None], b_mat[idx.clamp(min=0).long()],
                            torch.zeros_like(b_mat[:1]))
    for want_prod in (gemm.tf32x3_mm(a_mat, b_mat), a_mat @ b_mat):
        want = want_prod
        if acc:
            want = base.clone()
            want[:, 20:20 + n] += want_prod
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        assert err <= GEMM_TOL * scale, (case, err, scale)
    assert torch.equal(run(), got)              # deterministic, bit for bit
    assert int(gemm._tile_counters(torch.device(DEVICE)).abs().sum()) == 0


@pytest.mark.gpu
def test_gemm_f32_weight_runs_3xtf32(card):
    """The forward GEMM's f32 path (3xTF32): gathered rows with zero rows,
    two segments, bias and GELU, against the f32 product."""
    from isubgvqa_tpu_torch.ops import gemm

    g = torch.Generator(device=DEVICE).manual_seed(4)
    x = torch.randn(300, 300, device=DEVICE, generator=g)
    e = torch.randn(500, 300, device=DEVICE, generator=g)
    idx = torch.randint(-1, 300, (500,), device=DEVICE, generator=g,
                        dtype=torch.int32)
    w = 0.05 * torch.randn(1200, 600, device=DEVICE, generator=g)
    bias = torch.randn(1200, device=DEVICE, generator=g)
    got = gemm.gemm([(x, idx), (e, None)], w, bias, act="gelu")
    xg = torch.where((idx >= 0)[:, None], x[idx.clamp(min=0).long()],
                     torch.zeros_like(x[:1]))
    want = torch.nn.functional.gelu(torch.cat([xg, e], 1) @ w.t() + bias)
    err = (got - want).abs().max().item()
    assert err <= GEMM_TOL * max(1.0, want.abs().max().item()), err
    assert torch.equal(gemm.gemm([(x, idx), (e, None)], w, bias, act="gelu"),
                       got)


# ------------------------------------------------------------ GAT edge bwd

def _gat_graphs(b, n, e, rng):
    """Graph 0: no edges; graph 1: node n - 1 valid but never a
    destination; the rest random with padding edges."""
    nm = np.zeros((b, n), bool)
    em = np.zeros((b, e), bool)
    src = np.zeros((b, e), np.int32)
    dst = np.zeros((b, e), np.int32)
    for g in range(b):
        nm[g] = True
        ne = 0 if g == 0 else int(rng.integers(e // 2, e + 1))
        em[g, :ne] = True
        src[g, :ne] = rng.integers(0, n, ne)
        dst[g, :ne] = rng.integers(0, n - 1 if g == 1 else n, ne)
    return [torch.from_numpy(x).to(DEVICE) for x in (nm, em, src, dst)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,e", [(16, 48), (256, 1024)],
                         ids=["small", "N256_E1024"])
def test_gat_edge_bwd_cases(card, n, e):
    """``isg_gat_edge_bwd`` through the conv's autograd Function against
    autograd of the plain version (f32): a zero-edge graph, a node with no
    incoming edge, the largest graph the kernel takes, the dst-only gate
    (a node that is only ever a source gets no gate gradient), and the
    same gradients bit for bit on a second run.  At N = 256, E = 1024 a
    shifted lin_l bias keeps every message away from the leaky-ReLU's kink:
    among 2e5 random messages a few lie within f32 rounding of 0, where
    kernel and plain version (whose x_l and x_r come from other products)
    may take the other slope and move that edge's whole gradient row (seen:
    2e-3 of d xf's max abs); the small case covers both slopes."""
    torch.manual_seed(5)
    rng = np.random.default_rng(15)
    b = 3
    nm, em, src, dst = _gat_graphs(b, n, e, rng)
    h = randn(b, n, C, dtype=torch.float32)
    ea = randn(b, e, C, dtype=torch.float32)
    gate = torch.rand(b, n, 1, device=DEVICE) + 0.25
    gp = MGAT(C, 1, HEADS, (1.0,)).layer_params(0)
    conv = {k: gp[k] for k in gat_train.CONV_KEYS}
    if n == 256:
        conv["bl"] = conv["bl"] + 20.0
    cp = masters(conv)
    cot = (torch.randn(b, n, HEADS * C, device=DEVICE),
           torch.randn(b, e, HEADS, device=DEVICE))
    wrap = lambda f: (lambda xf, g, ea, p: f(xf, g, src, dst, em, ea, p))
    res = run_both(wrap(gat_train.fused_gatconv),
                   wrap(gat_train.fused_gatconv_plain), (h, gate, ea),
                   (0, 1, 2), cp, cot)
    check_train(res, torch.float32, ["xf", "gate", "e_attr"])
    (_, ik, pk), _ = res
    again = run_both(wrap(gat_train.fused_gatconv),
                     wrap(gat_train.fused_gatconv_plain), (h, gate, ea),
                     (0, 1, 2), cp, cot)[0]
    assert all(torch.equal(x, y) for x, y in zip(ik, again[1]))
    assert all(torch.equal(pk[key], again[2][key]) for key in pk)
    dgate = ik[1]
    assert torch.all(dgate[0] == 0)              # no edges, no gradient
    assert torch.all(dgate[1, n - 1] == 0)       # never a destination
    for g in range(1, b):
        valid = em[g]
        only_src = set(src[g][valid].tolist()) - set(dst[g][valid].tolist())
        for node in only_src:
            assert dgate[g, node, 0] == 0


# ------------------------------------------------------------ attention bwd

def _attention_core_plain(q, k, v, bias, keep, scale):
    s = (q @ k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    p = torch.softmax(s, -1)
    return (p if keep is None else p * keep) @ v


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk,keep_on", [(20, 20, True), (20, 20, False),
                                           (4, 9, True), (37, 64, False)],
                         ids=["L20_keep", "L20_nokeep", "cross_4x9_keep",
                              "cross_37x64"])
def test_attention_bwd_cases(card, lq, lk, keep_on):
    """``isg_attention_bwd`` against autograd of the plain attention core
    (f32): L not a multiple of 32, cross-attention with Lq != Lk, keep
    masks on and off, and bit-equal on a second run."""
    from isubgvqa_tpu_torch.ops.text_kernel import _attention

    torch.manual_seed(6)
    b, heads, dh = 3, TEXT_HEADS, D // TEXT_HEADS
    q = torch.randn(b * lq, D, device=DEVICE)
    kv = torch.randn(b * lk, 2 * D, device=DEVICE)
    bias = None
    if lq == lk:
        bias = torch.zeros(b, lk, device=DEVICE)
        bias[0, lk // 2:] = -1e9                  # padded keys
    keep = ((torch.rand(b, heads, lq, lk, device=DEVICE) > 0.2).float() / 0.8
            if keep_on else None)
    dout = torch.randn(b * lq, D, device=DEVICE)
    scale = 1.0 / np.sqrt(dh)

    def kernel():
        probs = torch.empty(b, heads, lq, lk, device=DEVICE)
        _attention(q, 0, D, kv, 0, D, 2 * D, bias, b, lq, lk, D, heads, keep,
                   probs)
        dq = torch.empty(b * lq, D, device=DEVICE)
        dkv = torch.empty(b * lk, 2 * D, device=DEVICE)
        text_train.attention_bwd(q, 0, D, kv, 0, D, 2 * D, probs, keep, dout,
                                 dq, 0, D, dkv, 0, D, 2 * D, b, lq, lk, D,
                                 heads)
        return dq, dkv[:, :D], dkv[:, D:]

    got = kernel()
    split = lambda t, l: t.view(b, l, heads, dh).transpose(1, 2)
    qs = split(q, lq).clone().requires_grad_(True)
    ks = split(kv[:, :D], lk).clone().requires_grad_(True)
    vs = split(kv[:, D:], lk).clone().requires_grad_(True)
    out = _attention_core_plain(qs, ks, vs, bias, keep, scale)
    out.backward(split(dout, lq))
    merge = lambda t: t.transpose(1, 2).reshape(-1, D)
    for name, g, w in zip(("dq", "dk", "dv"), got,
                          (merge(qs.grad), merge(ks.grad), merge(vs.grad))):
        check_grads([g], [w], torch.float32, [name])
    assert all(torch.equal(x, y) for x, y in zip(kernel(), got))


# ------------------------------------------------------------ Hopper GEMM
#
# The bf16 products of the question stack (csrc/gemm_sm90.cu: TMA and
# wgmma) against the f32 product of the same bf16 operands: f32 output to
# 2e-5 of the result's scale (summation order only), bf16 output to 8e-3
# (one rounding to bf16, 2^-9 of the value, plus the sums).

SM90_TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}
SM90_CASES = [(m, n, k) for m in (1, 63, 64, 65, 2048, 16384)
              for n, k in ((512, 512), (1024, 2048), (1536, 512),
                           (2048, 2048))]


def _sm90_operands(m, n, k, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    a = torch.randn(m, k, device=DEVICE, generator=g).to(torch.bfloat16)
    w = (torch.randn(n, k, device=DEVICE, generator=g) / k ** 0.5).to(
        torch.bfloat16)
    bias = torch.randn(n, device=DEVICE, generator=g)
    return g, a, w, bias


def _close(got, want, tol):
    scale = max(1.0, want.abs().max().item())
    err = (got.float() - want).abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= tol * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", SM90_CASES,
                         ids=[f"M{m}_N{n}_K{k}" for m, n, k in SM90_CASES])
def test_gemm_sm90_matches_plain_product(card, m, n, k):
    """Ragged M edges (1, 63, 65 rows), every N and K of the text layers,
    with and without bias, ReLU and ``emul``, to f32 and to bf16, and the
    same bits on a second run."""
    from isubgvqa_tpu_torch.ops import gemm

    g, a, w, bias = _sm90_operands(m, n, k, m + n + k)
    emul = torch.rand(m, n, device=DEVICE, generator=g)
    prod = a.float() @ w.float().t()
    for i, (use_bias, act, use_emul, out) in enumerate((
            (True, None, False, torch.bfloat16),
            (True, "relu", True, torch.float32),
            (False, None, False, torch.float32),
            (True, "relu", True, torch.bfloat16))):
        if i and m == 16384:
            break                     # the largest M: one form is enough
        args = (a, w, bias if use_bias else None, act, out,
                emul if use_emul else None)
        got = gemm.gemm_sm90(*args)
        want = prod + bias if use_bias else prod
        if act == "relu":
            want = torch.relu(want)
        if use_emul:
            want = want * emul
        assert got.dtype == out and got.shape == (m, n)
        _close(got, want, SM90_TOL[out])
        assert torch.equal(gemm.gemm_sm90(*args), got)


@pytest.mark.gpu
def test_gemm_sm90_rejects_what_tma_cannot_tile(card):
    """K or N not a multiple of 8, a start not 16-byte aligned, an f32
    operand: the wrapper raises instead of taking another path."""
    from isubgvqa_tpu_torch.ops import gemm

    _, a, w, bias = _sm90_operands(64, 512, 512, 0)
    with pytest.raises(ValueError):
        gemm.gemm_sm90(a[:, :300].contiguous(), w[:, :300].contiguous())
    with pytest.raises(ValueError):
        gemm.gemm_sm90(a, w[:300].contiguous())
    buf = torch.zeros(64 * 512 + 1, device=DEVICE, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gemm.gemm_sm90(buf[1:].view(64, 512), w)
    with pytest.raises(TypeError):
        gemm.gemm_sm90(a.float(), w)


LN_CASES = [(1, 512, 512), (65, 512, 2048), (2048, 512, 512), (50, 64, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", LN_CASES,
                         ids=[f"M{m}_N{n}_K{k}" for m, n, k in LN_CASES])
def test_gemm_ln_sm90_matches_plain(card, m, n, k):
    """The LayerNorm epilogue: an f32 and a bf16 residual, with and without
    ``ymask``, the final LayerNorm and ``z_out``, against the plain
    residual + LayerNorm of the f32 product; the same bits on a rerun."""
    from isubgvqa_tpu_torch.ops import gemm
    from isubgvqa_tpu_torch.ops.text_kernel import ln_plain

    g, a, w, bias = _sm90_operands(m, n, k, 7 * m + k)
    vec = lambda s, o: o + s * torch.randn(n, device=DEVICE, generator=g)
    g1, b1, g2, b2 = vec(0.1, 1.0), vec(0.1, 0.0), vec(0.1, 1.0), vec(0.1, 0.0)
    ymask = (torch.rand(m, n, device=DEVICE, generator=g) > 0.1).float() / 0.9
    y = a.float() @ w.float().t() + bias
    for x_dt, use_mask, final, use_z in ((torch.float32, True, True, True),
                                         (torch.bfloat16, False, False, False),
                                         (torch.float32, False, True, False)):
        x = torch.randn(m, n, device=DEVICE, generator=g).to(x_dt)
        z = torch.empty(m, n, device=DEVICE) if use_z else None
        args = (a, w, bias, x, g1, b1, (g2, b2) if final else None, True,
                torch.bfloat16, ymask if use_mask else None, z)
        of, ot = gemm.gemm_ln_sm90(*args)
        zz = x.float() + (y * ymask if use_mask else y)
        want = ln_plain(zz, g1, b1)
        if final:
            want = ln_plain(want, g2, b2)
        _close(of, want, 1e-4)
        _close(ot, want, SM90_TOL[torch.bfloat16])
        if use_z:
            _close(z, zz, 2e-5)
        of2, ot2 = gemm.gemm_ln_sm90(*args)
        assert torch.equal(of2, of) and torch.equal(ot2, ot)


# ------------------------------------------------------------ bf16 core

ATTN_CASES = [(lq, lk, bias, keep) for lq, lk in ((1, 1), (7, 7), (16, 16),
                                                  (32, 32), (33, 33),
                                                  (64, 64), (4, 32), (4, 64))
              for bias, keep in ((True, True), (False, False))]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "lq,lk,use_bias,use_keep", ATTN_CASES,
    ids=[f"Lq{a}_Lk{b}_{'bias' if c else 'nobias'}_{'keep' if d else 'nokeep'}"
         for a, b, c, d in ATTN_CASES])
def test_attention_mma_matches_plain_core(card, lq, lk, use_bias, use_keep):
    """``isg_attention_mma`` (bf16, tensor cores): self-attention over the
    QKV layout (Lq = Lk) and cross-attention (T = 4 queries), the added
    key bias, ``keep`` and the saved ``probs``, against the plain core
    with the probabilities rounded to bf16 before P.V; bit-equal reruns.
    Output to 3e-2 of its scale (bf16 roundings at the same points, f32
    sums in another order), probabilities to 1e-5."""
    from isubgvqa_tpu_torch.ops.text_kernel import _attention

    torch.manual_seed(8)
    b, heads, dh = 3, 8, 64
    d = heads * dh
    bias = None
    if use_bias:
        bias = torch.ones(b, lk, device=DEVICE)
        bias[0, lk // 2 + 1:] = 0.0             # the CLIP mask's padding
    keep = ((torch.rand(b, heads, lq, lk, device=DEVICE) > 0.2).float() / 0.8
            if use_keep else None)
    if lq == lk:
        src = torch.randn(b * lq, 3 * d, device=DEVICE).to(torch.bfloat16)
        q_args = (src, 0, 3 * d, src, d, 2 * d, 3 * d)
        q, k, v = src.view(b, lq, 3, heads, dh).permute(2, 0, 3, 1, 4)
    else:
        qr = torch.randn(b * lq, d, device=DEVICE).to(torch.bfloat16)
        kv = torch.randn(b * lk, 2 * d, device=DEVICE).to(torch.bfloat16)
        q_args = (qr, 0, d, kv, 0, d, 2 * d)
        q = qr.view(b, lq, heads, dh).transpose(1, 2)
        k, v = kv.view(b, lk, 2, heads, dh).permute(2, 0, 3, 1, 4)

    def run():
        probs = torch.empty(b, heads, lq, lk, device=DEVICE)
        o = _attention(*q_args, bias, b, lq, lk, d, heads, keep, probs)
        return o, probs

    o, probs = run()
    s = (q.float() @ k.float().transpose(-1, -2)) / dh ** 0.5
    if bias is not None:
        s = s + bias[:, None, None, :]
    p = torch.softmax(s, -1)
    pk = p if keep is None else p * keep
    want = (pk.to(torch.bfloat16).float() @ v.float()).transpose(1, 2)
    _close(o, want.reshape(b * lq, d), TOL[torch.bfloat16])
    assert (probs - p).abs().max().item() <= 1e-5
    o2, probs2 = run()
    assert torch.equal(o2, o) and torch.equal(probs2, probs)


RLN_CASES = [(1, 64), (300, 512), (4097, 512), (70, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", RLN_CASES,
                         ids=[f"M{m}_D{d}" for m, d in RLN_CASES])
def test_residual_ln_matches_plain(card, m, d):
    """The separate residual + LayerNorm pass (``isg_residual_ln``, 16-byte
    rows; D <= 512 and D <= 1024 take two tilings): f32 and bf16
    residuals, with and without ``ymask``, the final LayerNorm and
    ``z_out``, to 1e-5 of the scale (f32 sums in another order); the same
    bits on a rerun."""
    from isubgvqa_tpu_torch.ops.text_kernel import _residual_ln, ln_plain

    g = torch.Generator(device=DEVICE).manual_seed(m + d)
    rn = lambda *s: torch.randn(*s, device=DEVICE, generator=g)
    y = rn(m, d)
    g1, b1, g2, b2 = 1 + 0.1 * rn(d), 0.1 * rn(d), 1 + 0.1 * rn(d), 0.1 * rn(d)
    ymask = (torch.rand(m, d, device=DEVICE, generator=g) > 0.1).float() / 0.9
    for x_dt, use_mask, final, use_z in ((torch.float32, True, True, True),
                                         (torch.bfloat16, False, False, False)):
        x = rn(m, d).to(x_dt)
        z = torch.empty(m, d, device=DEVICE) if use_z else None
        args = (x, y, g1, b1, (g2, b2) if final else None, True,
                torch.bfloat16, ymask if use_mask else None, z)
        of, ot = _residual_ln(*args)
        zz = x.float() + (y * ymask if use_mask else y)
        want = ln_plain(zz, g1, b1)
        if final:
            want = ln_plain(want, g2, b2)
        _close(of, want, 1e-5)
        _close(ot, want, SM90_TOL[torch.bfloat16])
        if use_z:
            _close(z, zz, 1e-6)
        of2, ot2 = _residual_ln(*args)
        assert torch.equal(of2, of) and torch.equal(ot2, ot)
