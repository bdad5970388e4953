"""The config variants (``text_sampling``, ``use_all_instrs``,
``concat_instr``, ``use_global_mask``, ``interpretable_mode``,
``node_classification``, ``use_topk`` or ``use_instruction`` off, several
masked layers, the explainer bypass) against the JAX package, in float32
on the CPU: the whole eval forward, the fused GAT layer (#1) with
``apply_mask_to_h`` and a 2C-wide input, the weights bridge, the FLOP
count and the entry checks.

The models are ``small_cfg`` cut to one encoder layer, one decoder layer
and two GAT layers (the second masked, gumbel k = 3; four layers for the
case of three masked ones), built as a seeded port init with BatchNorm
statistics at the data's scale and crossed to flax by the port's own
``state_dict_to_jax`` (the JAX converter covers neither the node head
nor the ``use_all_instrs`` mask head).  Noise is shared for each
sampling site: ``jax.random.gumbel`` is patched to return the sites'
numpy draws in the order the JAX forward asks for them (text sampling,
then the masked layers in order), and the port gets the same draws
through ``noise={site: draw}``.  Each JAX forward is jitted once, in a
module-scoped fixture that overlaps the compiles with the tracing.

Tolerances: logits and the node head's logits within 1e-4 (the stated
GELU bound: the Pallas kernels' polynomial erf against ``erff``, f32 in
both packages); the node mask and ``mask_text`` rounded equal and within
1e-6 (their straight-through values); before asserting equal masks, the
margin rule: the smallest gap between the k-th and (k+1)-th perturbed
score of any row exceeds twice the largest difference of the scores
between the packages.  #1: ``out`` within 1e-4 and ``alpha`` within
1e-5 of Pallas interpret and of ``gat_layer_reference``.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from isubgvqa_tpu.data import (AnswerMap, BucketSpec, Collator,
                               HashWordTokenizer, SceneGraphVocab,
                               SyntheticGQA)
from isubgvqa_tpu.models import isubgvqa as jisubgvqa
from isubgvqa_tpu.models import masking as jmasking
from isubgvqa_tpu.models.build import build_model, init_model
from isubgvqa_tpu.ops.pallas.gat_kernel import (fused_gat_layer,
                                                gat_layer_reference,
                                                pack_gat_params)
from isubgvqa_tpu_torch import cli
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch import ops as tops
from isubgvqa_tpu_torch.convert import (load_upstream_state_dict,
                                        state_dict_from_jax,
                                        state_dict_to_jax)
from isubgvqa_tpu_torch.models import isubgvqa as tisubgvqa
from isubgvqa_tpu_torch.models import masking as tmasking
from isubgvqa_tpu_torch.models.build import build_model as tbuild
from isubgvqa_tpu_torch.models.build import check_supported
from isubgvqa_tpu_torch.ops import flops
from isubgvqa_tpu_torch.ops.gat_kernel import concat_instr_features

from test_model import small_cfg
from test_torch_port_bench import _no_incidence
from test_torch_port_kernels import (ALPHA_ATOL, OUT_ATOL, _gat_case,
                                     _port_gat_params, _t)
from test_torch_port_model import (one_torch_thread,  # noqa: F401
                                   port_cfg, set_bn_stats, to_port_batch)
from test_torch_port_model import quick_xla  # noqa: F401

ATOL = 1e-4
K = 3

VARIANTS = {
    "use_all_instrs": dict(use_all_instrs=True),
    "concat_instr": dict(concat_instr=True),
    "use_global_mask": dict(use_global_mask=True),
    "interpretable_mode": dict(interpretable_mode=True),
    "node_classification": dict(node_classification=True),
    "no_topk": dict(use_topk=False),
    "three_masked": dict(mgat_layers=4, mgat_masks=(0.3, 1.0, 0.5, 0.15)),
    "text_sampling": dict(text_sampling=True),
    "no_instruction": dict(use_instruction=False),
}
# the explainer bypass: (variant, stage)
CASES = [(v, None) for v in VARIANTS] + [("base", 0), ("base", 2)]


def variant_cfg(name, **kw):
    base = dict(encoder_layers=1, decoder_layers=1, mgat_layers=2,
                mgat_masks=(1.0, 0.15))
    base.update(VARIANTS.get(name, {}))
    base.update(kw)
    return small_cfg(**base)


def masked_layers(cfg):
    return [i for i, t in enumerate(cfg.mgat_masks) if float(t) != 1.0]


@pytest.fixture(scope="module")
def data():
    cfg = small_cfg()
    vocab = SceneGraphVocab.synthetic()
    ds = SyntheticGQA(vocab, AnswerMap.synthetic(cfg.num_answers), size=8,
                      seed=0)
    spec = BucketSpec(batch_size=4, max_nodes_per_graph=cfg.max_nodes_per_graph,
                      max_edges_per_graph=cfg.max_edges_per_graph,
                      question_len=cfg.question_len)
    tok = HashWordTokenizer(vocab_size=cfg.text_vocab_size,
                            max_len=cfg.question_len)
    batch, _ = Collator(tok, spec, vocab=vocab).collate(
        [ds[i] for i in range(4)])
    return vocab, batch, to_port_batch(batch)


def port_model(cfg, seed=0):
    """A seeded port eval model and its weights as flax trees."""
    tm = tbuild(port_cfg(cfg), tdata.SceneGraphVocab.synthetic(),
                device="cpu", seed=seed)
    set_bn_stats(tm)
    params, stats = state_dict_to_jax(tm.state_dict())
    return tm, params, stats


def site_draws(cfg, b, n, l, seed):
    """A standard Gumbel draw for each sampling site, in the JAX
    forward's order: text sampling ``[1, B, L]``, then each masked
    layer's ``[B, N]`` (gumbel: ``[S * B, N]`` with S = 1; none without
    ``use_topk``, whose hard threshold draws nothing)."""
    rng = np.random.default_rng(seed)
    draws = {}
    if cfg.text_sampling:
        draws["text"] = rng.gumbel(size=(1, b, l)).astype(np.float32)
    for i in masked_layers(cfg) if cfg.use_topk else ():
        draws[i] = rng.gumbel(size=(b, n)).astype(np.float32)
    return draws


class SiteTaps:
    """Records each sampler's input scores, in call order, in both
    packages (``jax.debug.callback`` under ``jit``), and hands JAX the
    sites' draws in the order its trace asks for them.  With ``mp`` both
    packages are patched at once; else :meth:`patch_jax` (while the JAX
    forward is traced) and :meth:`patch_port` (while the port runs)."""

    def __init__(self, mp, draws):
        self.draws = draws
        self.jax_theta, self.port_theta = [], []
        if mp is not None:
            self.patch_jax(mp)
            self.patch_port(mp)

    def patch_jax(self, mp):
        queue = list(self.draws.values())
        mp.setattr(jax.random, "gumbel",
                   lambda key, shape, dtype=jnp.float32:
                   jnp.asarray(queue.pop(0), dtype).reshape(shape))
        rec = self

        def jax_tap(fn):
            def wrapped(scores, *a, **kw):
                jax.debug.callback(
                    lambda v: rec.jax_theta.append(np.asarray(v)), scores)
                return fn(scores, *a, **kw)
            return wrapped

        mp.setattr(jisubgvqa, "simple_sample",
                   jax_tap(jisubgvqa.simple_sample))
        mp.setattr(jmasking, "gumbel_topk_sample",
                   jax_tap(jmasking.gumbel_topk_sample))

    def patch_port(self, mp):
        rec = self

        def port_tap(fn):
            def wrapped(scores, *a, **kw):
                rec.port_theta.append(scores.detach().numpy().copy())
                return fn(scores, *a, **kw)
            return wrapped

        mp.setattr(tisubgvqa, "simple_sample",
                   port_tap(tisubgvqa.simple_sample))
        mp.setattr(tmasking, "gumbel_topk_sample",
                   port_tap(tmasking.gumbel_topk_sample))


def smallest_margin(perturbed, k):
    srt = -np.sort(-perturbed, axis=-1)
    return float((srt[..., k - 1] - srt[..., k]).min())


def assert_margins(taps, draws, cfg, capsys):
    """The margin rule at every top-k the forward took."""
    assert len(taps.port_theta) == len(taps.jax_theta) == len(draws)
    for (site, g), t, j in zip(draws.items(), taps.port_theta,
                               taps.jax_theta):
        k = cfg.mgat_layers if site == "text" else K
        margin = smallest_margin(t + g.reshape(t.shape), k)
        bound = 2.0 * float(np.abs(t - j).max())
        with capsys.disabled():
            print(f"\n[site {site}] smallest top-k margin {margin:.3g}, "
                  f"bound {bound:.3g}")
        assert margin > bound, (site, margin, bound)


@pytest.fixture(scope="module")
def jax_forwards(data):
    """Each case's port model, draws, explainer arguments and site taps,
    and its JAX forward: traced here in turn (the sites' draws are
    constants of the trace) and compiled by a pool of threads while the
    next case is traced, so that XLA's compiles overlap the tracing."""
    vocab, batch, tb = data
    b, n = batch.node_mask.shape
    cases = {}
    with ThreadPoolExecutor(3) as pool:
        for variant, stage in CASES:
            cfg = variant_cfg(variant)
            tm, params, stats = port_model(cfg)
            draws = site_draws(cfg, b, n, batch.qst_tokens.shape[1], seed=11)
            kw, jkw = {}, {}
            if stage is not None:
                emb = tm.scene_graph_encoder.sg_vocab_embedding.weight.detach()
                bypass = (emb[tb.node_tokens.long()].sum(-2) if stage == 0
                          else torch.from_numpy(np.random.default_rng(3).normal(
                              size=(b, n, cfg.general_hidden_dim))
                              .astype(np.float32)))
                kw = dict(explainer=True, explainer_stage=stage,
                          expl_bypass_x=bypass)
                jkw = dict(kw, expl_bypass_x=jnp.asarray(bypass.numpy()))
            taps = SiteTaps(None, draws)
            module = build_model(cfg, vocab)
            variables = {"params": params, "batch_stats": stats}
            with pytest.MonkeyPatch.context() as mp:
                taps.patch_jax(mp)
                lowered = jax.jit(lambda v, a: module.apply(
                    v, *a, train=False, rngs={"sampler": jax.random.PRNGKey(0)},
                    **jkw)).lower(variables, (batch,))
            cases[(variant, stage)] = (cfg, tm, draws, kw, taps, variables,
                                       pool.submit(lowered.compile))
    return {k: v[:-1] + (v[-1].result(),) for k, v in cases.items()}


@pytest.mark.parametrize("variant,stage", CASES,
                         ids=[v if s is None else f"explainer_stage{s}"
                              for v, s in CASES])
def test_variant_eval_forward_matches_jax(data, jax_forwards, variant, stage,
                                          monkeypatch, capsys):
    vocab, batch, tb = data
    cfg, tm, draws, kw, taps, variables, forward = jax_forwards[
        (variant, stage)]
    b, n = batch.node_mask.shape
    taps.patch_port(monkeypatch)
    noise = {k: torch.from_numpy(v) for k, v in draws.items()}
    with torch.no_grad():
        out_t = tm(tb, noise=noise, **kw)
    out_j = forward(variables, (batch,))
    jax.effects_barrier()                   # the taps' callbacks have run
    assert_margins(taps, draws, cfg, capsys)
    if stage is not None:                       # the bare logits
        assert isinstance(out_t, torch.Tensor)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                                   atol=ATOL)
        if stage == 0:          # the token sum itself gives the plain forward
            with torch.no_grad():
                plain = tm(tb, noise=noise)
            np.testing.assert_allclose(out_t.numpy(), plain.logits.numpy(),
                                       rtol=0, atol=1e-6)
        return
    np.testing.assert_allclose(out_t.logits.numpy(), np.asarray(out_j.logits),
                               rtol=0, atol=ATOL)
    nm_t, nm_j = out_t.node_mask.numpy(), np.asarray(out_j.node_mask)
    np.testing.assert_array_equal(np.round(nm_t), np.round(nm_j))
    np.testing.assert_allclose(nm_t, nm_j, rtol=0, atol=1e-6)
    assert len(out_t.node_logits_layers) == len(out_j.node_logits_layers)
    for a, j in zip(out_t.node_logits_layers, out_j.node_logits_layers):
        assert a.shape == (b, n, 2577)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL)
    if cfg.text_sampling:
        mt, mj = out_t.mask_text.numpy(), np.asarray(out_j.mask_text)
        np.testing.assert_array_equal(np.round(mt), np.round(mj))
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-6)
        np.testing.assert_allclose(mt.sum(-1), cfg.mgat_layers, rtol=1e-5)
    else:
        assert out_t.mask_text is None and out_j.mask_text is None
    if not cfg.use_topk:
        assert set(np.unique(nm_t)) <= {0.0, 1.0}


# ------------------------------------------------------------ #1 kernel

@pytest.fixture(scope="module")
def gat_variant_case():
    """#1 with ``apply_mask_to_h`` and ``xf = [h | instr]``, twice as wide
    as ``h`` (``concat_instr``): Pallas interpret and the reference."""
    rng = np.random.default_rng(41)
    b, n, e, c = 3, 16, 48, 12
    a, w, we = _gat_case(rng, b, n, e, c=c)
    f = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)
    w["wl"], w["wr"] = f(2 * c, 4 * c), f(2 * c, 4 * c)
    xf = np.concatenate([a["h"], np.broadcast_to(
        a["instr"][:, None, :], a["h"].shape)], -1)
    jp = pack_gat_params(4, c, **w)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    j["xf"] = jnp.asarray(xf)
    kernel = fused_gat_layer(**j, params={**jp, "we": jnp.asarray(we)},
                             apply_mask_to_h=True, interpret=True)
    ref_args = {k: v for k, v in j.items() if k != "e_attr"}
    ref = jax.jit(gat_layer_reference, static_argnames=(
        "apply_mask_to_h",))(**ref_args, eproj=jnp.asarray(a["e_attr"] @ we),
                             params=jp, apply_mask_to_h=True)
    return a, w, we, xf, (kernel, ref)


@pytest.mark.parametrize("built", [True, False],
                         ids=["concat_instr_features", "wide_xf"])
def test_gat_layer_variant_plain_matches_pallas_and_reference(
        gat_variant_case, built):
    """The port takes ``[h | instr]`` as one 2C-wide ``xf``, built by
    ``concat_instr_features`` (as a ``concat_instr`` layer builds it) or
    given."""
    a, w, we, xf, refs = gat_variant_case
    t = {k: _t(v) for k, v in a.items()}
    t["xf"] = concat_instr_features(t["h"], t["instr"]) if built else _t(xf)
    out_t, alpha_t = tops.fused_gat_layer(
        **t, params=_port_gat_params(w, we), apply_mask_to_h=True)
    for ref_out, ref_alpha in refs:
        np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_out),
                                   rtol=0, atol=OUT_ATOL)
        np.testing.assert_allclose(alpha_t.numpy(), np.asarray(ref_alpha),
                                   rtol=0, atol=ALPHA_ATOL)
    # the gate zeroes its nodes' rows after the residual
    off = a["gate"][..., 0] == 0
    assert off.any() and np.all(out_t.numpy()[off] == 0)


# ------------------------------------------------------------ weights

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_jax_init_round_trips_through_the_port(data, variant):
    """A JAX ``init_model`` of the variant (its tree from a trace, filled
    with seeded values) loads strictly into the port and comes back the
    same: every leaf, dtype and path."""
    vocab, batch, _ = data
    cfg = variant_cfg(variant)
    shapes = jax.eval_shape(lambda bt: init_model(build_model(cfg, vocab),
                                                  bt), batch)
    rng = np.random.default_rng(0)
    params, stats = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)
    sd = state_dict_from_jax(params, stats)
    tm = tbuild(port_cfg(cfg), tdata.SceneGraphVocab.synthetic(),
                device="cpu", state_dict=sd)
    assert set(tm.state_dict()) == set(sd)
    for tree, back in zip((params, stats), state_dict_to_jax(sd)):
        a = jax.tree_util.tree_flatten_with_path(tree)[0]
        b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype, path
            assert np.array_equal(np.asarray(x), np.asarray(y)), path


def test_upstream_state_dict_keeps_the_variants_weights():
    """Text sampling's MLPs load under either upstream spelling, and the
    node head is kept under ``node_classification`` (dropped without)."""
    cfg = port_cfg(variant_cfg("text_sampling", node_classification=True))
    tm = tbuild(cfg, tdata.SceneGraphVocab.synthetic(), device="cpu")
    sd = {("text_sampling." + k if k.startswith("qsts_att_keys") else k): v
          for k, v in tm.state_dict().items()}
    out = load_upstream_state_dict({"model": sd}, node_classification=True)
    assert set(out) == set(tm.state_dict())
    tm.load_state_dict(out, strict=True)
    dropped = load_upstream_state_dict(sd)
    assert not any("node_logits" in k for k in dropped)
    assert set(out) - set(dropped) == {k for k in out if "node_logits" in k}


# ------------------------------------------------------------ entry checks

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_check_supported_accepts_every_variant(variant, tmp_path):
    cfg = port_cfg(variant_cfg(variant))
    check_supported(cfg)
    check_supported(cfg, "cpu")
    cli.check_cli_supported(cfg)
    with pytest.raises(ValueError, match="use_pallas"):
        check_supported(dataclasses.replace(cfg, use_pallas=False), "cuda")


@pytest.mark.parametrize("variant", ["concat_instr", "text_sampling",
                                     "use_all_instrs", "node_classification",
                                     "three_masked"])
def test_forward_flops_count_the_variants_products(data, variant):
    """``ops/flops.py`` equals the matrix products that
    ``FlopCounterMode`` sees over the variant's plain eval forward (the
    one-hot incidence products counted as nothing)."""
    _, _, tb = data
    cfg = port_cfg(variant_cfg(variant))
    model = tbuild(cfg, tdata.SceneGraphVocab.synthetic(), device="cpu")
    aten = torch.ops.aten
    mapping = {op: _no_incidence(op)
               for op in (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)}
    with torch.no_grad(), FlopCounterMode(display=False,
                                          custom_mapping=mapping) as fc:
        model(tb, generator=torch.Generator().manual_seed(0))
    assert fc.get_total_flops() == flops.forward_flops(
        cfg, *flops.batch_shape(tb))


def test_bf16_stage0_bypass_stays_f32_to_the_batchnorm(data):
    """The explainer's stage-0 bypass in a bf16 model: as in the JAX
    package (``scene_graph_encoder.py:97-112``) the f32 token sum, the
    bbox input and their concatenation stay f32 up to the reduction's
    BatchNorm (running statistics, eval).  Its output over the token sum
    agrees with the JAX encoder's within f32 rounding (1e-5; a bf16
    rounding of the bypass moves it by ~1e-2); over the 32 bbox features,
    which both packages compute through bf16 Dense layers, within 1e-2
    (a bf16 rounding of their order 1 values is 4e-3)."""
    from isubgvqa_tpu.models.scene_graph_encoder import SceneGraphEncoder

    vocab, batch, tb = data
    cfg = variant_cfg("base")
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    tm, params, stats = port_model(cfg)
    tm16 = tbuild(port_cfg(cfg16), tdata.SceneGraphVocab.synthetic(),
                  device="cpu", state_dict=tm.state_dict())
    sge = tm16.scene_graph_encoder
    emb = sge.sg_vocab_embedding.weight.detach()
    bypass = emb[tb.node_tokens.long()].float().sum(-2)          # f32
    got = {}
    hook = sge.feat_reduc[0].register_forward_hook(
        lambda mod, args, out: got.update(x=args[0], out=out))
    try:
        with torch.no_grad():
            sge(tb, torch.bfloat16, expl_x_embed_sum=bypass)
    finally:
        hook.remove()

    sg = params["scene_graph_encoder"]
    enc = SceneGraphEncoder(
        sg_vocab_size=sg["sg_vocab_embedding"]["embedding"].shape[0],
        hidden_dim=cfg.general_hidden_dim, sg_emb_dim=cfg.general_hidden_dim,
        use_pallas=False, dtype=jnp.bfloat16)
    _, inter = jax.jit(lambda v, b, x: enc.apply(
        v, b, deterministic=True, expl_x_embed_sum=x,
        capture_intermediates=True, mutable=["intermediates"]))(
        {"params": sg, "batch_stats": stats["scene_graph_encoder"]}, batch,
        jnp.asarray(bypass.numpy()))
    want = np.asarray(inter["intermediates"]["reduc_bn"]["__call__"][0])
    assert want.dtype == np.float32
    assert got["x"].dtype == got["out"].dtype == torch.float32
    c = cfg.general_hidden_dim
    out = got["out"].numpy()
    np.testing.assert_allclose(out[..., :c], want[..., :c], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out[..., c:], want[..., c:], rtol=0,
                               atol=1e-2)
