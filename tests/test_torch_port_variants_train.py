"""The config variants' training and entry points against the JAX
package, in float32 on the CPU: #5's plain GAT conv at a 2C-wide input
and the node head with ``apply_mask_to_h``, each against ``jax.grad`` of
the JAX reference; one whole train step against ``make_train_step`` for
``concat_instr``, ``interpretable_mode`` and ``text_sampling``; one CLI
epoch under ``--concat_instr 1 --interpretable_mode 1``; and
``run_token_coo_exp`` under ``text_sampling`` against the JAX runner.
The train step runs the three variants in one config, one compile of the
JAX step.

The models are ``small_cfg`` cut to one encoder layer, one decoder layer
and two GAT layers (the second masked, gumbel k = 3) with every dropout
at 0, on the same weights (a seeded port init crossed to flax by the
port's ``state_dict_to_jax``) and the same batch; the sampling sites'
standard Gumbel draws are shared by shape (``jax.random.gumbel`` and the
port's ``draw_gumbel`` patched to return them).  Each JAX step or
forward is jitted once.

Tolerances: the layers' gradients within 1e-4 of each gradient's RMS
(1e-4 abs on the forward outputs, 1e-5 on ``alpha``); the train step's
loss and grad norm 1e-4 relative, each gradient leaf within 2e-3 of its
own max abs floored at 1e-4 of the largest gradient (the rule of
``test_torch_port_train.py``), the sampled masks equal after the margin
rule; explain's counts exact and its ratios within 1e-9.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.flatten_util
import jax.numpy as jnp

from isubgvqa_tpu.data.build import build_datasets as jbuild_datasets
from isubgvqa_tpu.data.gqa import AnswerMap as JAnswerMap
from isubgvqa_tpu.data.synthetic import SyntheticGQA as JSyntheticGQA
from isubgvqa_tpu.explain import run_token_coo_exp as jrun_token_coo_exp
from isubgvqa_tpu.models.build import build_model
from isubgvqa_tpu.ops.pallas.gat_kernel import (gat_conv_reference,
                                                gat_head_reference)
from isubgvqa_tpu.train.schedule import make_optimizer
from isubgvqa_tpu.train.state import TrainState
from isubgvqa_tpu.train.steps import make_train_step
from isubgvqa_tpu_torch import data as tdata
from isubgvqa_tpu_torch.config import Config
from isubgvqa_tpu_torch.convert import state_dict_to_jax
from isubgvqa_tpu_torch.explain import run_token_coo_exp
from isubgvqa_tpu_torch.models.build import build_model as tbuild
from isubgvqa_tpu_torch.ops import gat_train
from isubgvqa_tpu_torch.sampling import gumbel as tgumbel
from isubgvqa_tpu_torch.sampling import simple as tsimple
from isubgvqa_tpu_torch.train import create_train_state
from isubgvqa_tpu_torch.train import make_train_step as t_train_step

from test_torch_port_explain import DEV, bundle, dev_logits
from test_torch_port_kernels import _graphs, _t
from test_torch_port_model import one_torch_thread  # noqa: F401
from test_torch_port_model import port_cfg, set_bn_stats
from test_torch_port_train import _adam_mu, _flat
from test_torch_port_train_kernels import _jax_attb, leaves
from test_torch_port_trainer import run_cli, tiny_argv
from test_torch_port_variants import (SiteTaps, assert_margins, data,  # noqa: F401
                                      site_draws, variant_cfg)

STEPS_PER_EPOCH = 4
GRAD_RMS_TOL = 1e-4


def assert_grad_rms(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    rms = max(float(np.sqrt(np.mean(want ** 2))), 1e-12)
    err = float(np.sqrt(np.mean((got - want) ** 2)))
    assert err <= GRAD_RMS_TOL * rms, f"{name}: RMS err {err:.3g}, RMS {rms:.3g}"


# ------------------------------------------------------------ #5 layers

C, HEADS = 12, 4


@pytest.fixture(scope="module")
def layer_case():
    """One training GAT layer at a 2C-wide input (``[h | instr]``) with a
    sampled gate and cotangents for ``out`` and ``alpha``."""
    rng = np.random.default_rng(29)
    b, n, e, hc = 3, 10, 36, C * HEADS
    nm, em, src, dst = _graphs(rng, b, n, e)
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    w = dict(wl=f(2 * C, hc, k=0.2), bl=f(hc, k=0.1), wr=f(2 * C, hc, k=0.2),
             br=f(hc, k=0.1), att=f(HEADS, C, k=0.3), cbias=f(hc, k=0.1),
             we=f(C, hc, k=0.2), w1=f(hc, hc // 2, k=0.1),
             b1=f(hc // 2, k=0.1), w2=f(hc // 2, C, k=0.1), b2=f(C, k=0.1),
             gn_w=np.abs(f(C)) + 0.5, gn_b=f(C, k=0.1),
             gn_a=np.abs(f(C)) + 0.5)
    gate = rng.choice([0.0, 1.0, 0.5, 0.8], size=(b, n, 1)).astype(np.float32)
    a = dict(h=f(b, n, C), instr=f(b, C), gate=gate, e_attr=f(b, e, C))
    cot = (f(b, n, C), f(b, e, HEADS))

    def loss(h, instr, gate, e_attr, params):
        attb, expand = _jax_attb(params["att"])
        p = {**params, "attb": attb, "expand": expand}
        xf = jnp.concatenate([h, jnp.broadcast_to(instr[:, None, :],
                                                  h.shape)], -1)
        conv, alpha = gat_conv_reference(xf, gate, src, dst, em,
                                         e_attr @ params["we"], p)
        out = gat_head_reference(h, conv, instr, gate, nm, p,
                                 apply_mask_to_h=True)
        return (jnp.sum(out * cot[0]) + jnp.sum(alpha * cot[1]),
                (out, alpha))

    grad = jax.jit(jax.value_and_grad(loss, (0, 1, 2, 3, 4), has_aux=True))
    (_, ref), grads = grad(*(jnp.asarray(a[k]) for k in
                             ("h", "instr", "gate", "e_attr")),
                           {k: jnp.asarray(v) for k, v in w.items()})
    return dict(a=a, w=w, graph=(nm, em, src, dst), cot=cot, ref=ref,
                grads=grads)


def test_gat_layer_train_at_2c_with_mask_matches_jax_grad(layer_case):
    """The plain conv (#5's twin) at ``ci = 2C`` and the head with
    ``apply_mask_to_h``: the gate's gradient takes both the edge gate's
    destination-only share and the output multiply's."""
    a, w, (nm, em, src, dst) = (layer_case["a"], layer_case["w"],
                                layer_case["graph"])
    pw = leaves({k: _t(w[k].T if k in ("wl", "wr", "we", "w1", "w2")
                       else w[k]) for k in w})
    h, instr, gate, ea = (_t(a[k]).requires_grad_(True)
                          for k in ("h", "instr", "gate", "e_attr"))
    xf = torch.cat([h, instr[:, None, :].expand(h.shape)], -1)
    out, alpha = gat_train.fused_gat_layer_train(
        h, xf, instr, gate, _t(src), _t(dst), _t(em), _t(nm), ea, pw,
        apply_mask_to_h=True)
    cot = layer_case["cot"]
    ((out * _t(cot[0])).sum() + (alpha * _t(cot[1])).sum()).backward()
    out_j, alpha_j = layer_case["ref"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(alpha_j),
                               rtol=0, atol=1e-5)
    dh, dinstr, dgate, dea, dw = layer_case["grads"]
    for name, got, want in (("h", h.grad, dh), ("instr", instr.grad, dinstr),
                            ("gate", gate.grad, dgate),
                            ("e_attr", ea.grad, dea)):
        assert_grad_rms(got, want, name)
    for k, v in dw.items():
        v = np.asarray(v)
        assert_grad_rms(pw[k].grad, v.T if k in ("wl", "wr", "we", "w1", "w2")
                        else v, k)
    # the multiply's share: a gated-off node's output and the rows of h
    # that only reach the output through it get no gradient
    assert np.all(out.detach().numpy()[a["gate"][..., 0] == 0] == 0)


def test_gatconv_plain_at_2c_matches_jax_grad(layer_case):
    """#5's conv alone at ``ci = 2C``: ``xf [B, N, 2C]`` and the 2C-wide
    lin_l / lin_r gradients."""
    a, w, (nm, em, src, dst) = (layer_case["a"], layer_case["w"],
                                layer_case["graph"])
    rng = np.random.default_rng(5)
    xf_np = rng.normal(size=a["h"].shape[:2] + (2 * C,)).astype(np.float32)
    cot = rng.normal(size=(xf_np.shape[0], xf_np.shape[1], HEADS * C)
                     ).astype(np.float32)
    keys = gat_train.CONV_KEYS

    def loss(xf, gate, e_attr, params):
        attb, expand = _jax_attb(params["att"])
        conv, _ = gat_conv_reference(xf, gate, src, dst, em,
                                     e_attr @ params["we"],
                                     {**params, "attb": attb,
                                      "expand": expand})
        return jnp.sum(conv * cot)

    gj = jax.jit(jax.grad(loss, (0, 1, 2, 3)))(
        jnp.asarray(xf_np), jnp.asarray(a["gate"]), jnp.asarray(a["e_attr"]),
        {k: jnp.asarray(w[k]) for k in keys})
    pw = leaves({k: _t(w[k].T if k in ("wl", "wr", "we") else w[k])
                 for k in keys})
    xf, gate, ea = (_t(v).requires_grad_(True)
                    for v in (xf_np, a["gate"], a["e_attr"]))
    conv, _ = gat_train.fused_gatconv(xf, gate, _t(src), _t(dst), _t(em), ea,
                                      pw)
    (conv * _t(cot)).sum().backward()
    assert_grad_rms(xf.grad, gj[0], "xf")
    assert_grad_rms(gate.grad, gj[1], "gate")
    assert_grad_rms(ea.grad, gj[2], "e_attr")
    for k, v in gj[3].items():
        v = np.asarray(v)
        assert_grad_rms(pw[k].grad, v.T if k in ("wl", "wr", "we") else v, k)


# ------------------------------------------------------------ train step

def train_cfg():
    """``concat_instr``, ``interpretable_mode`` and ``text_sampling`` in
    one config: one JAX train-step compile covers the three (none of them
    changes another's path: text sampling acts before the decoder, the
    other two inside the GAT layers)."""
    return variant_cfg("concat_instr", interpretable_mode=True,
                       text_sampling=True, dropout=0.0, head_dropout=0.0,
                       mask_dropout=0.0)


def jax_step(cfg, vocab, batch, params, stats):
    """One jitted ``make_train_step`` from ``params``: loss, grad norm and
    the gradients (Adam's first moment after one update from zero)."""
    model = build_model(cfg, vocab)
    optimizer = make_optimizer(cfg.lr, STEPS_PER_EPOCH)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       opt_state=optimizer.init(params), batch_stats=stats,
                       aimle_states=None)
    state, m = jax.jit(make_train_step(model, optimizer, cfg))(
        state, batch, jax.random.PRNGKey(0))
    norm = float(m["grad_norm"])
    clip = min(1.0, cfg.grad_clip_norm / norm)
    g = _adam_mu(state) / (1.0 - 0.9) / clip
    return (float(m["loss_sum"] / m["count"]), norm,
            jax.flatten_util.ravel_pytree(params)[1](g))


def test_train_step_matches_jax(data, monkeypatch, capsys):
    vocab, batch, tb = data
    cfg = train_cfg()
    st = create_train_state(port_cfg(cfg), tdata.SceneGraphVocab.synthetic(),
                            STEPS_PER_EPOCH, device="cpu", seed=0)
    set_bn_stats(st.model)
    sd = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    params, stats = state_dict_to_jax(sd)
    b, n = batch.node_mask.shape
    draws = site_draws(cfg, b, n, batch.qst_tokens.shape[1], seed=23)
    taps = SiteTaps(monkeypatch, draws)
    # the sites' draws differ in shape: text [1, B, L], the layer [B, N]
    by_shape = {v.shape: torch.from_numpy(v) for v in draws.values()}
    for mod in (tgumbel, tsimple):
        monkeypatch.setattr(mod, "draw_gumbel", lambda shape, generator,
                            device: by_shape[tuple(shape)])
    loss_j, norm_j, grads_j = jax_step(cfg, vocab, batch, params, stats)
    jax.effects_barrier()
    step = t_train_step(st.model, st.optimizer, st.model.cfg)
    model = st.model
    grads = {}
    orig_step = st.optimizer.step

    def recording_step():                  # the raw gradients, before Adam
        grads.update({k: p.grad.detach().clone()
                      for k, p in model.named_parameters()})
        return orig_step()

    monkeypatch.setattr(st.optimizer, "step", recording_step)
    st, m = step(st, tb)
    assert_margins(taps, draws, cfg, capsys)
    np.testing.assert_allclose(float(m["loss_sum"] / m["count"]), loss_j,
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), norm_j, rtol=1e-4)
    got = _flat(state_dict_to_jax({**sd, **grads})[0])
    want = _flat(grads_j)
    assert set(got) == set(want)
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(got[k] - w).max()) / scale
        assert err <= 2e-3, f"{k}: {err:.3g} of scale {scale:.3g}"


# ------------------------------------------------------------ entry points

def test_cli_epoch_under_concat_instr_and_interpretable_mode(tmp_path):
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(Config(
        encoder_layers=1, decoder_layers=1, text_emb_dim=64, num_heads=4,
        text_vocab_size=512, max_nodes_per_graph=32,
        max_edges_per_graph=128).to_json())
    trainer, text = run_cli(tiny_argv(
        cfg_path, tmp_path / "out", "--epochs", "1", "--concat_instr", "1",
        "--interpretable_mode", "1"))
    cfg = trainer.state.model.cfg
    assert cfg.concat_instr and cfg.interpretable_mode
    assert trainer.state.model.gat_seq.convs[0].lin_l.weight.shape[1] == 64
    assert "Val epoch [0] dev: Acc@Short" in text
    assert trainer.state.step == trainer.state.optimizer.count > 0
    assert all(np.isfinite(float(p.detach().abs().max()))
               for p in trainer.state.model.parameters())


def explain_cfgs():
    jcfg = variant_cfg("text_sampling", sampler_type="imle", synthetic=True,
                       synthetic_size=32, eval_batch_factor=2, meta_dir="",
                       epochs=0, num_data_shards=1, bucket_node_caps=(),
                       bucket_question_lens=())
    return jcfg, Config.from_json(jcfg.to_json())


def word_table(data):
    """Token id -> word over the dev questions (the hash tokenizer has
    no inverse), so that the text explanation decodes to words that the
    scene graphs' labels can match."""
    tok = data.tokenizer
    return {tok._token_id(w): w for s in data.datasets["dev"].samples
            for w in tok.tokenize(s[2])}


def test_run_token_coo_exp_text_sampling_matches_jax(monkeypatch):
    """imle (deterministic eval) with ``text_sampling``, whose eval draws
    text noise: one ``[1, B, L]`` draw serves every batch in both
    packages.  Counts exact, ratios within 1e-9, the text co-occurrence
    counted (no longer NaN); the vectorized pass equals the oracle."""
    jcfg, tcfg = explain_cfgs()
    tdata_ = bundle(tdata.build_datasets, tdata.AnswerMap, tdata.SyntheticGQA,
                    tcfg)
    jdata = bundle(jbuild_datasets, JAnswerMap, JSyntheticGQA, jcfg)
    for d in (tdata_, jdata):
        table = word_table(d)
        monkeypatch.setattr(d.tokenizer, "decode_token",
                            lambda i, t=table: t.get(i, f"<tok{i}>"))
    model = tbuild(tcfg, tdata_.vocab, device="cpu", seed=0)
    set_bn_stats(model)
    text = np.random.default_rng(4).gumbel(
        size=(1, tcfg.batch_size * tcfg.eval_batch_factor,
              tcfg.question_len)).astype(np.float32)
    monkeypatch.setattr(tsimple, "draw_gumbel", lambda shape, generator,
                        device: torch.from_numpy(text).reshape(shape))
    # lift the two commonest dev answers so that some answers are right
    dev = tdata_.datasets["dev"]
    common = np.argsort(-np.bincount([dev[i].label for i in range(DEV)]))[:2]
    mean = dev_logits(model, tdata_).mean(0)
    with torch.no_grad():
        model.logit_fc.bias[torch.as_tensor(common)] += torch.as_tensor(
            0.2 + mean.max() - mean[common])
    tres = run_token_coo_exp(model, tdata_, tcfg, split="dev")
    slow = run_token_coo_exp(model, tdata_, tcfg, split="dev",
                             fast_metrics=False)

    params, stats = state_dict_to_jax(model.state_dict())
    real_gumbel = jax.random.gumbel

    def gumbel(key, shape, dtype=jnp.float32):
        if tuple(shape) == text.shape:
            return jnp.asarray(text, dtype)
        return real_gumbel(key, shape, dtype)

    monkeypatch.setattr(jax.random, "gumbel", gumbel)
    jstate = TrainState(step=0, params=params, opt_state=(),
                        batch_stats=stats, aimle_states=None)
    jres = jrun_token_coo_exp(model=build_model(jcfg, jdata.vocab),
                              state=jstate, data=jdata, cfg=jcfg,
                              split="dev")
    t, j = tres.sums, jres.sums
    assert t.keys() == j.keys()
    for k in ("acc_n", "acc_at_n", "ans_n", "qst_n", "text_n", "n_seen",
              "acc_sum", "acc_at_sum", "ans_sum"):
        assert t[k] == j[k], k
    for k in t:
        assert t[k] == pytest.approx(j[k], abs=1e-9), k
        assert slow.sums[k] == pytest.approx(t[k], abs=1e-9), k
    assert t["text_n"] > 0 and not np.isnan(tres.text_token_coo)
    assert t["acc_n"] == DEV
