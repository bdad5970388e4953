"""The port's eval modules and whole eval forward against the JAX
package on the same weights, in float32 on the CPU.

Weights start as a seeded port init, cross to flax through
``isubgvqa_tpu.convert.convert_state_dict`` (the JAX package's own
converter), and both packages get the same numpy batch.  The JAX side
runs its CPU path (the ``*_reference`` compositions); the port runs its
kernels' plain versions.  Gumbel noise is shared: ``jax.random.gumbel``
is monkeypatched to return the numpy draw that the port gets through
``noise=``.

Tolerances: 1e-4 abs on module outputs and 1e-3 abs on logits (f32 in
both packages, summation order differs; observed ~1e-6); the sampled
0/1 node mask must match exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from isubgvqa_tpu.convert import convert_state_dict
from isubgvqa_tpu.data import (AnswerMap, BucketSpec, Collator,
                               HashWordTokenizer, SceneGraphVocab,
                               SyntheticGQA)
from isubgvqa_tpu.models.build import build_model
from isubgvqa_tpu.models.mgat import MGAT
from isubgvqa_tpu.models.question_decoder import QuestionDecoder
from isubgvqa_tpu.models.question_encoder import QuestionEncoder
from isubgvqa_tpu.models.scene_graph_encoder import SceneGraphEncoder
from isubgvqa_tpu.sampling.gumbel import (GumbelSamplerConfig,
                                          gumbel_topk_sample)
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch.config import Config as TConfig
from isubgvqa_tpu_torch.models.build import build_model as tbuild
from isubgvqa_tpu_torch.sampling import gumbel as tgumbel

from test_model import small_cfg

ATOL = 1e-4
LOGITS_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's tiny shapes.  With the default
    of one per core, test processes running side by side oversubscribe
    the cores and each small op waits on descheduled threads: under load
    the serve tests took 50 s instead of 12.  The other port test files
    import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(cfg):
    return TConfig.from_json(cfg.to_json())


def to_port_batch(batch) -> tdata.GraphBatch:
    return tdata.GraphBatch(**{
        f: torch.from_numpy(np.array(getattr(batch, f)))
        for f in tdata.GraphBatch.__dataclass_fields__})


def set_bn_stats(model, seed=1):
    """Running statistics at the data's scale (pixel-coordinate bboxes),
    so BatchNorm is exercised away from the identity."""
    g = torch.Generator().manual_seed(seed)
    seq = model.scene_graph_encoder.bbox_encoding
    with torch.no_grad():
        seq[0].running_mean.copy_(230.0 + 20.0 * torch.randn(4, generator=g))
        seq[0].running_var.copy_(180.0 ** 2 * (1 + 0.2 * torch.rand(4, generator=g)))
        for bn in (seq[3], model.scene_graph_encoder.feat_reduc[0]):
            n = bn.running_mean.shape[0]
            bn.running_mean.copy_(0.1 * torch.randn(n, generator=g))
            bn.running_var.copy_(1.0 + 0.3 * torch.rand(n, generator=g))


def jax_weights(cfg, sd):
    return convert_state_dict({k: v.numpy() for k, v in sd.items()},
                              encoder_layers=cfg.encoder_layers,
                              decoder_layers=cfg.decoder_layers,
                              mgat_layers=cfg.mgat_layers)


def port_and_jax(cfg, vocab, seed=0):
    """A seeded port model and the same weights as flax trees."""
    tm = tbuild(port_cfg(cfg), tdata.SceneGraphVocab.synthetic(),
                device="cpu", seed=seed)
    set_bn_stats(tm)
    sd = {k: v.float() for k, v in tm.state_dict().items()}
    params, stats = jax_weights(cfg, sd)
    return tm, sd, params, stats


def jit_apply(module, variables, *args, **kw):
    """``module.apply`` jitted: one compile instead of op-by-op dispatch,
    which costs several times as much on the CPU."""
    return jax.jit(lambda v, a: module.apply(v, *a, **kw))(variables, args)


class shared_gumbel:
    """Make ``jax.random.gumbel`` return a fixed numpy draw."""

    def __init__(self, monkeypatch, noise):
        monkeypatch.setattr(
            jax.random, "gumbel",
            lambda key, shape, dtype=jnp.float32:
            jnp.asarray(noise, dtype).reshape(shape))


@pytest.fixture(scope="module")
def setup():
    cfg = small_cfg()
    vocab = SceneGraphVocab.synthetic()
    answers = AnswerMap.synthetic(cfg.num_answers)
    ds = SyntheticGQA(vocab, answers, size=16, seed=0)
    spec = BucketSpec(batch_size=4, max_nodes_per_graph=cfg.max_nodes_per_graph,
                      max_edges_per_graph=cfg.max_edges_per_graph,
                      question_len=cfg.question_len)
    tok = HashWordTokenizer(vocab_size=cfg.text_vocab_size,
                            max_len=cfg.question_len)
    batch, _ = Collator(tok, spec, vocab=vocab).collate(
        [ds[i] for i in range(4)])
    tm, sd, params, stats = port_and_jax(cfg, vocab)
    noise = np.random.default_rng(5).gumbel(
        size=(4, cfg.max_nodes_per_graph)).astype(np.float32)
    return cfg, vocab, batch, to_port_batch(batch), tm, params, stats, noise


@pytest.fixture(scope="module")
def port_intermediates(setup):
    cfg, vocab, batch, tb, tm, params, stats, noise = setup
    with torch.no_grad():
        emb = tm.text_vocab_embedding(tb.qst_tokens)
        enc = tm.question_encoder(emb, tb.qst_mask)
        dec = tm.program_decoder(enc)
        lang = tm.qsts_reduction(dec.reshape(dec.shape[0], -1))
        instr = tm.instr_reduction(dec)
        x_enc, e_enc = tm.scene_graph_encoder(tb, torch.float32)
    return dict(enc=enc, dec=dec, lang=lang, instr=instr, x_enc=x_enc,
                e_enc=e_enc)


def test_question_encoder_matches_jax(setup, port_intermediates):
    cfg, vocab, batch, tb, tm, params, stats, noise = setup
    qe = QuestionEncoder(dim=512, num_heads=cfg.num_heads,
                         num_layers=cfg.encoder_layers,
                         vocab_size=cfg.text_vocab_size)
    ref = jit_apply(qe, {"params": params["question_encoder"]},
                    batch.qst_tokens, batch.qst_mask, deterministic=True)
    np.testing.assert_allclose(port_intermediates["enc"].numpy(),
                               np.asarray(ref), rtol=0, atol=ATOL)


def test_question_decoder_matches_jax(setup, port_intermediates):
    cfg, vocab, batch, tb, tm, params, stats, noise = setup
    qd = QuestionDecoder(n_instructions=cfg.mgat_layers, dim=512,
                         num_heads=cfg.num_heads,
                         num_layers=cfg.decoder_layers)
    ref = jit_apply(qd, {"params": params["program_decoder"]},
                    jnp.asarray(port_intermediates["enc"].numpy()),
                    deterministic=True)
    np.testing.assert_allclose(port_intermediates["dec"].numpy(),
                               np.asarray(ref), rtol=0, atol=ATOL)


def test_scene_graph_encoder_matches_jax(setup, port_intermediates):
    cfg, vocab, batch, tb, tm, params, stats, noise = setup
    sge = SceneGraphEncoder(sg_vocab_size=len(vocab))
    x_j, e_j = jit_apply(sge, {"params": params["scene_graph_encoder"],
                               "batch_stats": stats["scene_graph_encoder"]},
                         batch, deterministic=True)
    np.testing.assert_allclose(port_intermediates["x_enc"].numpy(),
                               np.asarray(x_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(port_intermediates["e_enc"].numpy(),
                               np.asarray(e_j), rtol=0, atol=ATOL)


def test_gumbel_sampler_matches_jax_with_injected_noise(monkeypatch):
    rng = np.random.default_rng(2)
    scores = rng.normal(size=(5, 12)).astype(np.float32)
    scores[:, -3:] = 0.0                    # zero-filled padding slots
    noise = rng.gumbel(size=(5, 12)).astype(np.float32)
    shared_gumbel(monkeypatch, noise)
    ref = gumbel_topk_sample(jnp.asarray(scores), jax.random.PRNGKey(0),
                             GumbelSamplerConfig(k=3), train=False)
    out = tgumbel.gumbel_topk_sample(torch.from_numpy(scores),
                                     tgumbel.GumbelSamplerConfig(k=3),
                                     noise=torch.from_numpy(noise))
    assert out.shape == (1, 5, 12)
    np.testing.assert_array_equal(np.round(out.numpy()),
                                  np.round(np.asarray(ref)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    assert np.all(np.round(out.numpy()).sum(-1) == 3)


def test_mgat_stack_matches_jax(setup, port_intermediates, monkeypatch):
    """The masked GAT stack on the port's encoder outputs; its last
    layer's gate comes from the shared-noise sampler."""
    cfg, vocab, batch, tb, tm, params, stats, noise = setup
    pi = port_intermediates
    with torch.no_grad():
        h_t, mask_t, alphas_t, _ = tm.gat_seq(
            pi["x_enc"], tb, pi["e_enc"], pi["instr"], pi["lang"],
            noise=torch.from_numpy(noise))
    shared_gumbel(monkeypatch, noise)
    mgat = MGAT(channels=cfg.general_hidden_dim, num_ins=cfg.mgat_layers,
                heads=cfg.gat_heads, masking_thresholds=cfg.mgat_masks,
                sampler_type="gumbel", sample_k=cfg.sample_k)
    j = lambda t: jnp.asarray(t.numpy())
    h_j, mask_j, _, alphas_j, _ = jit_apply(
        mgat, {"params": params["gat_seq"]}, j(pi["x_enc"]), batch,
        j(pi["e_enc"]), j(pi["instr"]), j(pi["lang"]), train=False,
        rngs={"sampler": jax.random.PRNGKey(0)})
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0,
                               atol=ATOL)
    for a_t, a_j in zip(alphas_t, alphas_j):
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0,
                                   atol=1e-5)


def test_whole_eval_forward_matches_jax(setup, monkeypatch):
    cfg, vocab, batch, tb, tm, params, stats, noise = setup
    with torch.no_grad():
        out_t = tm(tb, noise=torch.from_numpy(noise))
    shared_gumbel(monkeypatch, noise)
    model = build_model(cfg, vocab)
    out_j = jit_apply(model, {"params": params, "batch_stats": stats}, batch,
                      train=False, rngs={"sampler": jax.random.PRNGKey(0)})
    np.testing.assert_allclose(out_t.logits.numpy(), np.asarray(out_j.logits),
                               rtol=0, atol=LOGITS_ATOL)
    np.testing.assert_array_equal(out_t.node_mask.numpy(),
                                  np.asarray(out_j.node_mask))
    np.testing.assert_allclose(out_t.gate.numpy(), np.asarray(out_j.gate),
                               rtol=0, atol=ATOL)
    nm = out_t.node_mask.numpy()[..., 0]
    valid = batch.node_mask
    for g in range(4):
        assert np.round(nm[g][valid[g]]).sum() <= cfg.sample_k
        assert np.all(nm[g][~valid[g]] == 0)


def test_bf16_forward_tracks_jax_cpu(setup, monkeypatch):
    """bf16 on both sides.  They round at different points by design:
    the JAX CPU path runs the graph layers' ``*_reference`` in f32 even
    for a bf16 model, while the port follows the TPU kernels, which round
    every product's operands to bf16.  So the bound is the bf16 rounding
    level of the logits (|logits| ~ 0.1 here), not the f32 1e-3."""
    cfg, vocab, batch, tb, tm, params, stats, noise = setup
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    tm16 = tbuild(port_cfg(cfg16), tdata.SceneGraphVocab.synthetic(),
                  device="cpu", state_dict=tm.state_dict())
    with torch.no_grad():
        out_t = tm16(tb, noise=torch.from_numpy(noise))
    shared_gumbel(monkeypatch, noise)
    model16 = build_model(cfg16, vocab)
    out_j = jit_apply(model16, {"params": params, "batch_stats": stats},
                      batch, train=False,
                      rngs={"sampler": jax.random.PRNGKey(0)})
    lt, lj = out_t.logits.numpy(), np.asarray(out_j.logits)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=5e-3)
    assert (lt.argmax(-1) == lj.argmax(-1)).all()
    np.testing.assert_array_equal(
        np.round(out_t.node_mask.float().numpy()),
        np.round(np.asarray(out_j.node_mask, np.float32)))


def test_use_pallas_false_is_refused_on_cuda_only(setup):
    """On the CPU ``use_pallas=False`` runs the plain path like any other
    config; the CUDA-side refusal needs a card."""
    cfg, vocab, batch, tb, tm, params, stats, noise = setup
    cfg2 = dataclasses.replace(port_cfg(cfg), use_pallas=False)
    m2 = tbuild(cfg2, tdata.SceneGraphVocab.synthetic(), device="cpu",
                state_dict={k: v for k, v in tm.state_dict().items()})
    with torch.no_grad():
        a = m2(tb, noise=torch.from_numpy(noise)).logits
        b = tm(tb, noise=torch.from_numpy(noise)).logits
    assert torch.equal(a, b)
