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
