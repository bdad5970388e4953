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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_gat_variants_match_plain_versions(card, dtype):
    """#1 with ``apply_mask_to_h`` and a 2C-wide input (``concat_instr``'s
    ``[h | instr]``); #5's conv forward and backward at a 2C-wide input
    against autograd of its plain version."""
    torch.manual_seed(2)
    rng = np.random.default_rng(13)
    b, n, e = 3, 16, 48
    nm, em, src, dst = graphs(rng, b, n, e)
    h, ea = randn(b, n, C, dtype=dtype), randn(b, e, C, dtype=dtype)
    ins = randn(b, C, dtype=dtype, scale=0.5)
    gate = (torch.rand(b, n, 1, device=DEVICE) > 0.4).to(dtype)
    layer = MGAT(C, 1, HEADS, (0.15,), sample_k=3, concat_instr=True)
    gp = ship(layer.layer_params(0), dtype)
    xf = torch.cat([h, ins[:, None].expand(h.shape)], -1)
    args = (h, xf, ins, gate, src, dst, em, nm, ea, gp)
    got = ops.fused_gat_layer(*args, apply_mask_to_h=True)
    check(got, ops.fused_gat_layer_plain(*args, apply_mask_to_h=True), dtype)
    assert (got[0][gate[..., 0] == 0] == 0).all()

    cp = masters({k: layer.layer_params(0)[k] for k in gat_train.CONV_KEYS})
    cot = (torch.randn(b, n, HEADS * C, device=DEVICE),
           torch.randn(b, e, HEADS, device=DEVICE))
    wrap = lambda f: (lambda x, g, a, p: f(x, g, src, dst, em, a, p))
    res = run_both(wrap(gat_train.fused_gatconv),
                   wrap(gat_train.fused_gatconv_plain), (xf, gate, ea),
                   (0, 1, 2), cp, cot)
    check_train(res, dtype, ["xf", "gate", "e_attr"])
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


# The graph layers' bf16 products (csrc/gemm_gather_sm90.cu: cp.async
# gathers into swizzled tiles, wgmma) against the plain twin, which sums
# the same bf16 products in f32: the tolerances of SM90_TOL.  Each case:
# segments as (rows, K, gathered), N, M, epilogue; the first eight are
# the GAT and MetaLayer products at a small M that is not a multiple of
# the 128-row tile.
GATHER_CASES = {
    "x_lr_K300_N2400": ([(1000, 300, False)], 2400, 1000,
                        dict(bias=True, out=torch.bfloat16)),
    "lin_edge_K300_N1200": ([(777, 300, False)], 1200, 777,
                            dict(out=torch.bfloat16)),
    "x_proj1_K1200_N600": ([(513, 1200, False)], 600, 513,
                           dict(bias=True, act="gelu", out=torch.bfloat16)),
    "x_proj2_K600_N300": ([(513, 600, False)], 300, 513,
                          dict(bias=True, act="gelu")),
    "edge_mlp_K900_3seg": ([(300, 300, True), (300, 300, True),
                            (1001, 300, False)], 300, 1001,
                           dict(bias=True, act="gelu", pre=True,
                                out=torch.bfloat16)),
    "node_mlp1_K600_2seg": ([(300, 300, True), (1001, 300, False)], 300,
                            1001, dict(bias=True, act="gelu", pre=True,
                                       out=torch.bfloat16)),
    "node_mlp1_out_rowscale": ([(1001, 300, False)], 300, 1001,
                               dict(bias=True, row_scale=True)),
    "node_mlp2_K600_2dense": ([(300, 300, False), (300, 300, False)], 300,
                              300, dict(bias=True, act="gelu", pre=True,
                                        out=torch.bfloat16)),
    "relu_emul_K64": ([(200, 64, False)], 64, 200,
                      dict(act="relu", emul=True)),
    "gathered_K16_N64": ([(50, 16, True)], 64, 70, dict(out=torch.bfloat16)),
    "wide_copies_K512": ([(129, 512, True), (129, 512, False)], 512, 129,
                         dict(bias=True, pre=True)),
    "strided_rows": ([(64, 300, False)], 300, 64, dict(strided=True)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GATHER_CASES))
def test_gemm_gather_matches_plain_twin(card, name):
    """1, 2 and 3 segments, gathered and not, with negative indices; K of
    16 to 1200 and N of 64 to 2400; each epilogue option (bias, GELU /
    ReLU, row_scale, emul, pre) and both output types; the same bits on
    a rerun."""
    from isubgvqa_tpu_torch.ops import gemm

    spec, n, m, opts = GATHER_CASES[name]
    g = torch.Generator(device=DEVICE).manual_seed(len(name))
    segs = []
    for rows, k, gathered in spec:
        a = torch.randn(rows, k + 4 if opts.get("strided") else k,
                        device=DEVICE, generator=g).to(torch.bfloat16)
        a = a[:, :k]                      # row pitch k + 4 where strided
        idx = None
        if gathered:
            idx = torch.randint(-1, rows, (m,), device=DEVICE, generator=g,
                                dtype=torch.int32)
            idx[:3] = -1
        segs.append((a, idx))
    ktot = sum(k for _, k, _ in spec)
    w = (torch.randn(n, ktot, device=DEVICE, generator=g) / ktot ** 0.5).to(
        torch.bfloat16)
    kw = dict(
        bias=torch.randn(n, device=DEVICE, generator=g)
        if opts.get("bias") else None,
        act=opts.get("act"), out_dtype=opts.get("out", torch.float32),
        row_scale=torch.rand(m, device=DEVICE, generator=g)
        if opts.get("row_scale") else None,
        emul=torch.rand(m, n, device=DEVICE, generator=g)
        if opts.get("emul") else None)
    pre, pre_want = ((torch.empty(m, n, device=DEVICE),
                      torch.empty(m, n, device=DEVICE)) if opts.get("pre")
                     else (None, None))
    got = gemm.gemm_gather(segs, w, pre=pre, **kw)
    torch.cuda.synchronize()
    want = gemm.gemm_gather_plain(segs, w, pre=pre_want, **kw)
    assert got.dtype == kw["out_dtype"] and got.shape == (m, n)
    _close(got, want.float(), SM90_TOL[kw["out_dtype"]])
    if pre is not None:
        _close(pre, pre_want, SM90_TOL[torch.float32])
    assert torch.equal(gemm.gemm_gather(segs, w, pre=pre, **kw), got)


@pytest.mark.gpu
def test_gemm_gather_rejects_what_it_cannot_take(card):
    """An f32 operand or weight, a K or N not a multiple of 4, a segment
    whose rows do not match: the wrapper raises, no other path runs."""
    from isubgvqa_tpu_torch.ops import gemm

    a = torch.randn(64, 300, device=DEVICE).to(torch.bfloat16)
    w = torch.randn(300, 300, device=DEVICE).to(torch.bfloat16)
    with pytest.raises(TypeError):
        gemm.gemm_gather([(a.float(), None)], w)
    with pytest.raises(TypeError):
        gemm.gemm_gather([(a, None)], w.float())
    with pytest.raises(ValueError):                 # K = 298
        gemm.gemm_gather([(a[:, :298].contiguous(), None)],
                         w[:, :298].contiguous())
    with pytest.raises(ValueError):                 # N = 298
        gemm.gemm_gather([(a, None)], w[:298].contiguous())
    with pytest.raises(ValueError):
        gemm.gemm_gather([(a, None), (a[:32], None)],
                         torch.cat([w, w], 1))


@pytest.mark.gpu
def test_graph_index_kernel_matches_plain(card):
    """The MetaLayer's gather indices in one launch: padding edges and an
    index outside the graph give -1, the f32 edge mask beside them."""
    from isubgvqa_tpu_torch.ops import metalayer_kernel as M

    rng = np.random.default_rng(3)
    nm, em, src, dst = graphs(rng, 5, 16, 40)
    src[2, 0], dst[3, 1] = 16, -2           # outside the graph
    gidx, emf = M.graph_index_launch(src, dst, em, 16)
    assert torch.equal(gidx, M.graph_index(src, dst, em, 16))
    assert torch.equal(emf, em.float())


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


# ------------------------------------------------------------ staged backward
#
# The staged backward GEMM (csrc/gemm_bwd.cu) against its plain twin
# (ops/gemm.py:bwd_stage_plain: the same split, bf16x3 for a bf16 S or
# 3xTF32 for an f32 one, and the same epilogue), through
# gemm.bwd_stage_checked: f32 outputs within 2e-5 of their scale (only the
# order of the f32 sums differs), bf16 outputs within 8e-3 (at most one
# rounding apart).  Each case runs with a bf16 S (the bf16x3 wgmma core)
# and an f32 S (the 3xTF32 mma.sync core).

STAGE_TOL = {"float32": 2e-5, "bfloat16": 8e-3}
STAGE_CASES = ("dgrad_gelu_300", "dgrad_three_outputs_900",
               "dgrad_relu_keep_add_512", "wgrad_gathered_bias_900",
               "wgrad_split_2048", "wgrad_two_segments_600",
               "four_problems", "ragged_small")


def _stage_problems(name, dt, g):
    """The problems of one case: ragged row counts (not multiples of the
    64-row tile), gathered rows with negative indices, 1-3 weight or
    output segments, K and N in {300, 512, 600, 900, 2048}."""
    from isubgvqa_tpu_torch.ops.gemm import Out, stage_dgrad, stage_wgrad

    rnd = lambda *s, k=1.0: k * torch.randn(*s, device=DEVICE, generator=g)
    new = lambda *s, dtype=torch.float32: torch.empty(*s, dtype=dtype,
                                                      device=DEVICE)
    idx = lambda rows, k: torch.randint(-1, rows, (k,), device=DEVICE,
                                        generator=g, dtype=torch.int32)
    if name == "dgrad_gelu_300":
        return [stage_dgrad(rnd(1000, 300), rnd(300, 300, k=0.05).to(dt),
                            [Out(new(1000, 300), act="gelu",
                                 pre=rnd(1000, 300))])]
    if name == "dgrad_three_outputs_900":
        acc = rnd(777, 300)
        return [stage_dgrad(rnd(777, 300), rnd(300, 900, k=0.05).to(dt),
                            [Out(acc, add=acc), Out(new(777, 300)),
                             Out(new(777, 300, dtype=torch.bfloat16))])]
    if name == "dgrad_relu_keep_add_512":
        hid = torch.relu(rnd(1000, 256)).to(dt)
        keep = (torch.rand(1000, 256, device=DEVICE, generator=g) > 0.1
                ).float() / 0.9
        return [stage_dgrad(rnd(1000, 2048), rnd(2048, 512, k=0.02).to(dt),
                            [Out(new(1000, 256), act="relu", pre=hid,
                                 keep=keep),
                             Out(new(1000, 256),
                                 add=rnd(1000, 256).to(torch.bfloat16))])]
    if name == "wgrad_gathered_bias_900":
        x, e = rnd(700, 300).to(dt), rnd(5000, 300).to(dt)
        return [stage_wgrad(rnd(5000, 300),
                            [(x, idx(700, 5000)), (x, idx(700, 5000)),
                             (e, None)], new(300, 900), new(300))]
    if name == "wgrad_split_2048":
        return [stage_wgrad(rnd(8192, 512), [(rnd(8192, 2048).to(dt), None)],
                            new(512, 2048), new(512))]
    if name == "wgrad_two_segments_600":
        return [stage_wgrad(rnd(3000, 600), [(rnd(3000, 300).to(dt), None),
                                             (rnd(3000, 300).to(dt), None)],
                            new(600, 600))]
    if name == "four_problems":        # the decoder's cross-attention input
        dq, dkv = rnd(1024, 512), rnd(2048, 1024)
        w = rnd(1536, 512, k=0.04).to(dt)
        dz = rnd(1024, 512)
        dw, db = new(1536, 512), new(1536)
        return [stage_wgrad(dq, [(rnd(1024, 512).to(dt), None)], dw[:512],
                            db[:512]),
                stage_wgrad(dkv, [(rnd(2048, 512).to(dt), None)], dw[512:],
                            db[512:]),
                stage_dgrad(dkv, w[512:], [Out(new(2048, 512,
                                                   dtype=torch.bfloat16))]),
                stage_dgrad(dq, w[:512], [Out(dz, add=dz)])]
    assert name == "ragged_small"
    return [stage_wgrad(rnd(37, 12), [(rnd(37, 16).to(dt), None)],
                        new(12, 16), new(12)),
            stage_dgrad(rnd(20, 12), rnd(12, 16).to(dt),
                        [Out(new(20, 8), act="gelu", pre=rnd(20, 8)),
                         Out(new(20, 8))])]


@pytest.mark.gpu
@pytest.mark.parametrize("s_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16x3", "tf32x3"])
@pytest.mark.parametrize("case", STAGE_CASES)
def test_gemm_bwd_matches_plain_twin(card, case, s_dtype):
    from isubgvqa_tpu_torch.ops import gemm

    g = torch.Generator(device=DEVICE).manual_seed(5)
    errs = gemm.bwd_stage_checked(*_stage_problems(case, s_dtype, g))
    torch.cuda.synchronize()
    for k, tol in STAGE_TOL.items():
        assert errs[k] <= tol, (case, errs)
    assert int(gemm._tile_counters(torch.device(DEVICE)).abs().sum()) == 0
    if case == "wgrad_split_2048":       # split-K: the same bits every run
        pr = _stage_problems(case, s_dtype,
                             torch.Generator(device=DEVICE).manual_seed(6))
        gemm.bwd_stage(*pr)
        first = pr[0].outs[0].out.clone(), pr[0].bias.clone()
        gemm.bwd_stage(*pr)
        assert torch.equal(pr[0].outs[0].out, first[0])
        assert torch.equal(pr[0].bias, first[1])


@pytest.mark.gpu
def test_gemm_bwd_rejects_what_it_cannot_take(card):
    from isubgvqa_tpu_torch.ops import gemm
    from isubgvqa_tpu_torch.ops.gemm import Out, stage_dgrad, stage_wgrad

    f32 = lambda *s: torch.randn(*s, device=DEVICE)
    bf = lambda *s: f32(*s).to(torch.bfloat16)
    # an f32 S beside a bf16 one: the bf16x3 core takes bf16 S only
    with pytest.raises(TypeError):
        gemm.bwd_stage(stage_wgrad(f32(64, 32), [(bf(64, 16), None)],
                                   f32(32, 16)),
                       stage_dgrad(f32(64, 32), f32(32, 16),
                                   [Out(f32(64, 16))]))
    with pytest.raises(TypeError):                      # a bf16 gradient
        gemm.bwd_stage(stage_dgrad(bf(64, 32), bf(32, 16),
                                   [Out(f32(64, 16))]))
    with pytest.raises(ValueError):                     # N = 18: not in 4s
        gemm.bwd_stage(stage_dgrad(f32(64, 32), bf(32, 18),
                                   [Out(f32(64, 18))]))
    with pytest.raises(ValueError):                     # outputs of 12 of 16
        gemm.bwd_stage(stage_dgrad(f32(64, 32), bf(32, 16),
                                   [Out(f32(64, 12))]))
    with pytest.raises(ValueError):                     # five problems
        gemm.bwd_stage(*[stage_dgrad(f32(64, 32), bf(32, 16),
                                     [Out(f32(64, 16))])] * 5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_staged_backward_launches_match_twins(card, dtype):
    """Each of the six staged launches of the MetaLayer's and of the
    decoder layer's backward against its plain twin, on the forward's
    saved tensors."""
    from isubgvqa_tpu_torch.ops import gemm
    from isubgvqa_tpu_torch.ops.metalayer_kernel import metalayer_launch
    from isubgvqa_tpu_torch.ops.text_kernel import decoder_launch, masks_at

    errs = []

    def stage(*problems):
        errs.append(gemm.bwd_stage_checked(*problems))

    torch.manual_seed(2)
    rng = np.random.default_rng(13)
    b, n, e = 3, 16, 48
    nm, em, src, dst = graphs(rng, b, n, e)
    h, ea = randn(b, n, C, dtype=dtype), randn(b, e, C, dtype=dtype)
    mp = text_train.ship_params(SceneGraphEncoder(10, C).kernel_params(),
                                dtype)
    mp = {k: v.to(DEVICE) for k, v in mp.items()}
    _, _, s = metalayer_launch(h, ea, src, dst, em, nm, mp, save=True)
    dx, de, _ = metalayer_train.metalayer_backward(
        randn(b, n, C, dtype=dtype), randn(b, e, C, dtype=dtype), s, mp,
        (dtype, dtype), stage=stage)
    assert dx.dtype == dtype and de.dtype == dtype
    l, t = 16, 4
    keep = lambda *s: (torch.rand(*s, device=DEVICE) > 0.1).float() / 0.9
    masks = masks_at({"self_attn": keep(b, TEXT_HEADS, t, t),
                      "post_sa": keep(b, t, D),
                      "cross_attn": keep(b, TEXT_HEADS, t, l),
                      "post_ca": keep(b, t, D), "ffn": keep(b, t, FF),
                      "post_ffn": keep(b, t, D)}, dtype)
    dp = text_train.ship_params(DecoderLayer(D, FF).kernel_params(), dtype)
    dp = {k: v.to(DEVICE) for k, v in dp.items()}
    _, s = decoder_launch(randn(b, t, D, dtype=dtype),
                          randn(b, l, D, dtype=dtype), dp, TEXT_HEADS, None,
                          masks, save=True)
    dtgt, dmem, _ = text_train.decoder_backward(
        randn(b, t, D, dtype=dtype), s, dp, TEXT_HEADS, (dtype, dtype),
        stage=stage)
    assert dtgt.dtype == dtype and dmem.dtype == dtype
    torch.cuda.synchronize()
    assert len(errs) == 12
    for err in errs:
        for k, tol in STAGE_TOL.items():
            assert err[k] <= tol, errs


def _bench_data(size, batch_size, cfg):
    from isubgvqa_tpu_torch import data as tdata

    vocab = tdata.SceneGraphVocab.build("", seed=cfg.seed)
    ds = tdata.SyntheticGQA(vocab, tdata.AnswerMap.build("", cfg.num_answers),
                            size=size, seed=0, shape_mix="gqa")
    tok = tdata.HashWordTokenizer(vocab_size=cfg.text_vocab_size,
                                  max_len=cfg.question_len)
    return vocab, ds, tdata.build_bucket_collators(cfg, tok, vocab,
                                                   batch_size=batch_size)


@pytest.mark.gpu
def test_prefetch_to_cuda_matches_synchronous_copy(card):
    """The side-stream copies from pinned memory give what a synchronous
    ``.to()`` gives, pairs and bare batches alike, and the consumer's
    stream can use them at once."""
    from isubgvqa_tpu_torch import bench
    from isubgvqa_tpu_torch import data as tdata

    cfg = bench._cfg("gumbel", 64, "bfloat16")
    _, ds, colls = _bench_data(512, 64, cfg)
    want = [b.to(DEVICE) for b, _ in tdata.iterate_batches_bucketed(ds, colls)]
    got = list(tdata.prefetch(tdata.iterate_batches_bucketed(ds, colls),
                              depth=3, device=DEVICE))
    bare = list(tdata.prefetch((b for b, _ in
                                tdata.iterate_batches_bucketed(ds, colls)),
                               depth=1, device=DEVICE))
    assert len(got) == len(bare) == len(want) >= 4
    for (g, _), h, w in zip(got, bare, want):
        for field in tdata.GraphBatch.__dataclass_fields__:
            a, b, c = (getattr(x, field) for x in (g, h, w))
            assert a.is_cuda and b.is_cuda
            assert torch.equal(a, c) and torch.equal(b, c)
        assert int(g.node_mask.sum()) == int(w.node_mask.sum())


@pytest.mark.gpu
def test_native_fill_feeds_prefetch_from_pinned_buffers(card, monkeypatch):
    """Collators over a pinned store (the native C++ fill) hand
    ``prefetch`` batches that already lie in pinned memory: it copies them
    to the card with no ``pin_memory()`` copy of its own, and the card gets
    what the Python fill's batches give (``ISUBGVQA_NATIVE=0``)."""
    from isubgvqa_tpu_torch import bench
    from isubgvqa_tpu_torch import data as tdata

    cfg = bench._cfg("gumbel", 64, "bfloat16")
    vocab, ds, colls = _bench_data(512, 64, cfg)
    tok = next(iter(colls.values())).tokenizer
    pinned = tdata.build_bucket_collators(cfg, tok, vocab, batch_size=64,
                                          pin_memory=True)
    assert all(c.native for c in pinned.values())
    host = [b for b, _ in tdata.iterate_batches_bucketed(ds, pinned)]
    assert len(host) >= 4 and all(b.is_pinned() for b in host)
    pins = []
    pin = tdata.GraphBatch.pin_memory
    monkeypatch.setattr(tdata.GraphBatch, "pin_memory",
                        lambda self: pins.append(1) or pin(self))
    got = list(tdata.prefetch(tdata.iterate_batches_bucketed(ds, pinned),
                              depth=3, device=DEVICE))
    torch.cuda.synchronize()
    assert pins == []
    monkeypatch.setenv("ISUBGVQA_NATIVE", "0")
    python = tdata.build_bucket_collators(cfg, tok, vocab, batch_size=64)
    assert not any(c.native for c in python.values())
    want = [b.to(DEVICE) for b, _ in
            tdata.iterate_batches_bucketed(ds, python)]
    assert len(got) == len(want)
    for (g, _), w in zip(got, want):
        for field in tdata.GraphBatch.__dataclass_fields__:
            a, b = getattr(g, field), getattr(w, field)
            assert a.is_cuda and torch.equal(a, b), field


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"],
                         ids=["f32", "bf16"])
def test_bench_batch_2048_kernels_match_plain(card, dtype):
    """The bench's batch, B = 2048 at the largest bucket (128, 32): the
    eval forward through the kernels against the plain path, same weights
    and noise.  f32 (TF32 off): logits within 1e-4 (they differ only in
    summation order) and the node mask identical.  bf16 (the bench's
    type, on the bf16 GEMMs): logits within a fixed 1e-2 (the paths round
    to bf16 at the same points; the logits' std is about 0.044) and the
    top-1 answer the same on at least 99.5 % of the real rows."""
    from isubgvqa_tpu_torch import bench
    from isubgvqa_tpu_torch.models import (mgat, question_decoder,
                                           question_encoder,
                                           scene_graph_encoder)
    from isubgvqa_tpu_torch.models.build import build_model

    b = 2048
    cfg = bench._cfg("gumbel", b, dtype)
    vocab, ds, colls = _bench_data(4096, b, cfg)
    members = bench.route_to_buckets(ds, colls)[(128, 32)]
    idx = np.random.default_rng(0).integers(0, len(members), size=b)
    batch, _ = colls[(128, 32)].collate([ds[members[j]] for j in idx])
    batch = batch.to(DEVICE)
    model = build_model(cfg, vocab, DEVICE)
    noise = -torch.log(-torch.log(torch.rand(
        batch.node_mask.shape, device=DEVICE).clamp_min(1e-30)))
    with torch.no_grad():
        kern = model(batch, noise=noise)
    sites = [(question_encoder, "fused_encoder_layer"),
             (question_decoder, "fused_decoder_layer"),
             (scene_graph_encoder, "fused_metalayer"),
             (mgat, "fused_gat_layer")]
    saved = [getattr(m, n) for m, n in sites]
    try:
        for m, n in sites:
            setattr(m, n, getattr(ops, n + "_plain"))
        with torch.no_grad():
            plain = model(batch, noise=noise)
    finally:
        for (m, n), fn in zip(sites, saved):
            setattr(m, n, fn)
    err = (kern.logits.float() - plain.logits.float()).abs().max().item()
    if dtype == "float32":
        assert err <= 1e-4, err
        assert torch.equal(kern.node_mask.round(), plain.node_mask.round())
    else:
        real = batch.sample_mask > 0
        same = kern.logits.argmax(-1) == plain.logits.argmax(-1)
        assert err <= 1e-2, err
        assert same[real].float().mean().item() >= 0.995


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["imle", "aimle", "simple"])
def test_samplers_on_cuda_match_cpu(card, sampler):
    """Each sampler's forward and backward on CUDA tensors against the same
    call on the CPU (same scores with zero padding slots, noise and
    cotangent, N = 128, two samples), with the card in sync-debug mode so
    that a host wait in the sampler raises; aimle's state after the
    backward within 1e-6.  Masks exactly; gradients within 1e-5 of their
    scale (the norms and the marginals' log-sum-exps are summed in
    another order on the card)."""
    from isubgvqa_tpu_torch import sampling as smp

    rng = np.random.default_rng(31)
    b, n, s, k = 6, 128, 2, 3
    scores = rng.normal(size=(b, n)).astype(np.float32)
    scores[:, 100:] = 0.0
    shape = (s, b, n) if sampler == "simple" else (b, s, n)
    noise = rng.gumbel(size=shape).astype(np.float32)
    dy = rng.normal(size=(s, b, n)).astype(np.float32)

    def run(dev):
        x = torch.from_numpy(scores).to(dev).requires_grad_()
        z, d = torch.from_numpy(noise).to(dev), torch.from_numpy(dy).to(dev)
        st = smp.init_aimle_state(dev, initial_beta=5.0)
        if dev == DEVICE:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            if sampler == "imle":
                out = smp.imle_topk(x, smp.IMLEConfig(k=k, nb_samples=s,
                                                      beta=1000.0), noise=z)
            elif sampler == "aimle":
                out = smp.aimle_topk(x, st, smp.AIMLEConfig(k=k, nb_samples=s),
                                     noise=z)
            else:
                out = smp.simple_sample(
                    x, smp.SimpleConfig(k=k, train_ensemble=s), True,
                    noise=z)[0]
            (g,) = torch.autograd.grad(out, x, d)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return (out.detach().cpu().numpy(), g.cpu().numpy(),
                [float(getattr(st, f)) for f in
                 ("beta", "grad_norm", "prev_update")])

    out_c, g_c, st_c = run("cpu")
    out_g, g_g, st_g = run(DEVICE)
    np.testing.assert_array_equal(np.round(out_g), np.round(out_c))
    np.testing.assert_allclose(out_g, out_c, rtol=0, atol=1e-5)
    assert np.any(g_c != 0)
    np.testing.assert_allclose(g_g, g_c, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(g_c).max()))
    np.testing.assert_allclose(st_g, st_c, rtol=0, atol=1e-6)
