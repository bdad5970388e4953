"""Weights across the two packages and from upstream checkpoints.

:func:`state_dict_from_jax` turns the JAX package's flax trees (as
numpy arrays) into a port ``state_dict`` under the upstream repo's
names: the inverse of ``isubgvqa_tpu/convert.py:convert_state_dict``,
written here so the port never imports the JAX package.
:func:`state_dict_to_jax` goes the other way, for every model variant:
the text-sampling MLPs, the node head, the 2C-wide ``lin_l`` / ``lin_r``
and mask head of ``concat_instr`` and the ``use_all_instrs`` mask head
without ``ques_nn`` (which the JAX converter does not cover).  Layouts:

* flax Dense kernels ``[in, out]`` become torch Linear weights
  ``[out, in]``;
* the MHA q/k/v kernels stack into ``in_proj_weight [3D, D]``;
* the stacked ``lin_edge_all`` kernel ``[C, L*H*C]`` splits into one
  ``lin_edge.weight [H*C, C]`` per conv;
* ``att [H, C]`` becomes ``[1, H, C]``; the ``attb``/``expand``
  prepacking of the TPU kernel is derived from ``att`` and never stored;
* BatchNorm running statistics come from ``batch_stats``.

:func:`aimle_states_from_jax` carries the aimle sampler's adaptive
states (the JAX train state's ``aimle_states``) across, and
:func:`train_payload_from_jax` a whole JAX train state: the weights,
Adam's moments (through the same re-layout as the weights), its count,
the non-finite count, the step, the AIMLE states and the epoch, as the
port's checkpoint payload (``tools/export_torch_checkpoint.py`` reads an
orbax directory into it).  :func:`load_upstream_state_dict` reads an
upstream ``.pth`` payload, :func:`config_from_reference_args` derives the
config from its ``args`` as the JAX converter does, and
:func:`load_clip_text_tables` the pretrained CLIP text tables that
``cfg.clip_weights`` names (the port's copy of
``isubgvqa_tpu/convert.py:load_clip_text_tables``, same formats and key
spellings).
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import Config
from .sampling.aimle import AIMLE_FIELDS, AIMLEState


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a, np.float32).T, order="C"))


def _a(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _lin(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["kernel"])
    out[f"{prefix}.bias"] = _a(p["bias"])


def _ln(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _a(p["scale"])
    out[f"{prefix}.bias"] = _a(p["bias"])


def _attn(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.in_proj_weight"] = torch.cat(
        [_t(p[k]["kernel"]) for k in ("q", "k", "v")])
    out[f"{prefix}.in_proj_bias"] = torch.cat(
        [_a(p[k]["bias"]) for k in ("q", "k", "v")])
    _lin(out, f"{prefix}.out_proj", p["out"])


def _bn(out: dict, prefix: str, p: Mapping, s: Mapping) -> None:
    _ln(out, prefix, p)
    out[f"{prefix}.running_mean"] = _a(s["mean"])
    out[f"{prefix}.running_var"] = _a(s["var"])


def _layers(tree: Mapping) -> int:
    return sum(1 for k in tree if k.startswith("layer"))


def state_dict_from_jax(params: Mapping, batch_stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """flax ``(params, batch_stats)`` -> port ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    qe = params["question_encoder"]
    emb = qe["text_vocab_embedding"]
    for name in ("token_embedding", "position_embedding"):
        sd[f"text_vocab_embedding.{name}.weight"] = _a(emb[name]["embedding"])
    for i in range(_layers(qe)):
        lp, pre = qe[f"layer{i}"], f"question_encoder.transformer_encoder.layers.{i}"
        _attn(sd, f"{pre}.self_attn", lp["self_attn"])
        _lin(sd, f"{pre}.linear1", lp["ffn1"])
        _lin(sd, f"{pre}.linear2", lp["ffn2"])
        _ln(sd, f"{pre}.norm1", lp["norm1"])
        _ln(sd, f"{pre}.norm2", lp["norm2"])
    _ln(sd, "question_encoder.transformer_encoder.norm", qe["final_norm"])

    pd = params["program_decoder"]
    sd["program_decoder.query_embed.weight"] = _a(pd["query_embed"])
    for i in range(_layers(pd)):
        lp, pre = pd[f"layer{i}"], f"program_decoder.coarse_decoder.layers.{i}"
        _attn(sd, f"{pre}.self_attn", lp["self_attn"])
        _attn(sd, f"{pre}.multihead_attn", lp["cross_attn"])
        _lin(sd, f"{pre}.linear1", lp["ffn1"])
        _lin(sd, f"{pre}.linear2", lp["ffn2"])
        for j in (1, 2, 3):
            _ln(sd, f"{pre}.norm{j}", lp[f"norm{j}"])
    _ln(sd, "program_decoder.coarse_decoder.norm", pd["final_norm"])

    sg, st = params["scene_graph_encoder"], batch_stats["scene_graph_encoder"]
    pre = "scene_graph_encoder"
    sd[f"{pre}.sg_vocab_embedding.weight"] = _a(
        sg["sg_vocab_embedding"]["embedding"])
    _bn(sd, f"{pre}.bbox_encoding.0", sg["bbox_bn0"], st["bbox_bn0"])
    _lin(sd, f"{pre}.bbox_encoding.1", sg["bbox_lin0"])
    _bn(sd, f"{pre}.bbox_encoding.3", sg["bbox_bn1"], st["bbox_bn1"])
    _lin(sd, f"{pre}.bbox_encoding.4", sg["bbox_lin1"])
    _bn(sd, f"{pre}.feat_reduc.0", sg["reduc_bn"], st["reduc_bn"])
    _lin(sd, f"{pre}.feat_reduc.1", sg["reduc_lin"])
    meta = f"{pre}.scene_graph_encoding_layer"
    for mod, name in (("edge_model.edge_mlp", "edge_mlp"),
                      ("node_model.node_mlp_1", "node_mlp1"),
                      ("node_model.node_mlp_2", "node_mlp2")):
        for j, idx in ((1, 0), (2, 2)):
            sd[f"{meta}.{mod}.{idx}.weight"] = _t(sg[f"{name}_w{j}"])
            sd[f"{meta}.{mod}.{idx}.bias"] = _a(sg[f"{name}_b{j}"])
    sd[f"{pre}.graph_layer_norm.weight"] = _a(sg["gn_weight"])
    sd[f"{pre}.graph_layer_norm.bias"] = _a(sg["gn_bias"])
    sd[f"{pre}.graph_layer_norm.mean_scale"] = _a(sg["gn_mean_scale"])

    gat = params["gat_seq"]
    n_conv = sum(1 for k in gat if k.startswith("conv"))
    lin_edge = np.asarray(gat["lin_edge_all"]["kernel"], np.float32)
    width = lin_edge.shape[1] // n_conv
    for i in range(n_conv):
        c, pre = gat[f"conv{i}"], f"gat_seq.convs.{i}"
        for side in ("l", "r"):
            sd[f"{pre}.lin_{side}.weight"] = _t(c[f"lin_{side}_kernel"])
            sd[f"{pre}.lin_{side}.bias"] = _a(c[f"lin_{side}_bias"])
        sd[f"{pre}.lin_edge.weight"] = _t(lin_edge[:, i * width:(i + 1) * width])
        sd[f"{pre}.att"] = _a(c["att"])[None]
        sd[f"{pre}.bias"] = _a(c["bias"])
        for part in ("node_nn", "ques_nn"):     # no ques_nn: use_all_instrs
            if part in c.get("mask", {}):
                _lin(sd, f"{pre}.mask.{part}.0", c["mask"][part]["lin0"])
        for j, idx in ((1, 0), (2, 2)):
            sd[f"gat_seq.x_proj.{i}.{idx}.weight"] = _t(c[f"x_proj_w{j}"])
            sd[f"gat_seq.x_proj.{i}.{idx}.bias"] = _a(c[f"x_proj_b{j}"])
        sd[f"gat_seq.bns.{i}.weight"] = _a(c["gn_weight"])
        sd[f"gat_seq.bns.{i}.bias"] = _a(c["gn_bias"])
        sd[f"gat_seq.bns.{i}.mean_scale"] = _a(c["gn_mean_scale"])

    pool = params["graph_global_attention_pooling"]
    for part in ("node_nn", "ques_nn"):
        _lin(sd, f"graph_global_attention_pooling.{part}.0", pool[part]["lin0"])
        _lin(sd, f"graph_global_attention_pooling.{part}.2", pool[part]["lin1"])
    _lin(sd, "qsts_reduction.0", params["qsts_reduction"]["lin0"])
    _lin(sd, "instr_reduction.0", params["instr_reduction"]["lin0"])
    _lin(sd, "embedding.0", params["embedding"])
    _lin(sd, "logit_fc", params["logit_fc"])
    if "node_logits" in gat:                     # node_classification
        _lin(sd, "gat_seq.node_logits.0", gat["node_logits"]["lin0"])
        _lin(sd, "gat_seq.node_logits.2", gat["node_logits"]["lin1"])
    for name in ("qsts_att_keys", "qsts_att_query"):    # text_sampling
        if name in params:
            _lin(sd, f"{name}.0", params[name]["lin0"])
    return sd


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().float().cpu().numpy() if isinstance(
        t, torch.Tensor) else t, np.float32)


def _dense(sd: Mapping, prefix: str) -> dict:
    return {"kernel": _np(sd[f"{prefix}.weight"]).T.copy(),
            "bias": _np(sd[f"{prefix}.bias"])}


def _count(sd: Mapping, prefix: str) -> int:
    """How many ``<prefix><i>.`` blocks ``sd`` holds."""
    idx = {int(k[len(prefix):].split(".")[0]) for k in sd
           if k.startswith(prefix)}
    return max(idx) + 1 if idx else 0


def state_dict_to_jax(sd: Mapping) -> tuple:
    """A port ``state_dict`` -> the JAX package's ``(params,
    batch_stats)`` trees as numpy f32 arrays, of the structure that its
    ``init_model`` makes for the same config (every variant); the layer
    counts come from the keys.  The inverse of :func:`state_dict_from_jax`."""
    def ln(prefix):
        return {"scale": _np(sd[f"{prefix}.weight"]),
                "bias": _np(sd[f"{prefix}.bias"])}

    def attn(prefix):
        w, b = _np(sd[f"{prefix}.in_proj_weight"]), _np(
            sd[f"{prefix}.in_proj_bias"])
        d = w.shape[1]
        out = {k: {"kernel": w[i * d:(i + 1) * d].T.copy(),
                   "bias": b[i * d:(i + 1) * d]}
               for i, k in enumerate(("q", "k", "v"))}
        out["out"] = _dense(sd, f"{prefix}.out_proj")
        return out

    params: Dict = {}
    stats: Dict = {}
    qe_pre = "question_encoder.transformer_encoder"
    qe: Dict = {"text_vocab_embedding": {
        name: {"embedding": _np(sd[f"text_vocab_embedding.{name}.weight"])}
        for name in ("token_embedding", "position_embedding")},
        "final_norm": ln(f"{qe_pre}.norm")}
    for i in range(_count(sd, f"{qe_pre}.layers.")):
        pre = f"{qe_pre}.layers.{i}"
        qe[f"layer{i}"] = {
            "self_attn": attn(f"{pre}.self_attn"),
            "ffn1": _dense(sd, f"{pre}.linear1"),
            "ffn2": _dense(sd, f"{pre}.linear2"),
            "norm1": ln(f"{pre}.norm1"), "norm2": ln(f"{pre}.norm2")}
    params["question_encoder"] = qe
    pd_pre = "program_decoder.coarse_decoder"
    pd: Dict = {"query_embed": _np(sd["program_decoder.query_embed.weight"]),
                "final_norm": ln(f"{pd_pre}.norm")}
    for i in range(_count(sd, f"{pd_pre}.layers.")):
        pre = f"{pd_pre}.layers.{i}"
        pd[f"layer{i}"] = {
            "self_attn": attn(f"{pre}.self_attn"),
            "cross_attn": attn(f"{pre}.multihead_attn"),
            "ffn1": _dense(sd, f"{pre}.linear1"),
            "ffn2": _dense(sd, f"{pre}.linear2"),
            **{f"norm{j}": ln(f"{pre}.norm{j}") for j in (1, 2, 3)}}
    params["program_decoder"] = pd

    pre = "scene_graph_encoder"
    meta = f"{pre}.scene_graph_encoding_layer"
    sg = {"sg_vocab_embedding": {"embedding": _np(
              sd[f"{pre}.sg_vocab_embedding.weight"])},
          "bbox_bn0": ln(f"{pre}.bbox_encoding.0"),
          "bbox_lin0": _dense(sd, f"{pre}.bbox_encoding.1"),
          "bbox_bn1": ln(f"{pre}.bbox_encoding.3"),
          "bbox_lin1": _dense(sd, f"{pre}.bbox_encoding.4"),
          "reduc_bn": ln(f"{pre}.feat_reduc.0"),
          "reduc_lin": _dense(sd, f"{pre}.feat_reduc.1")}
    for mod, name in (("edge_model.edge_mlp", "edge_mlp"),
                      ("node_model.node_mlp_1", "node_mlp1"),
                      ("node_model.node_mlp_2", "node_mlp2")):
        for j, idx in ((1, 0), (2, 2)):
            d = _dense(sd, f"{meta}.{mod}.{idx}")
            sg[f"{name}_w{j}"], sg[f"{name}_b{j}"] = d["kernel"], d["bias"]
    for k, n in (("weight", "gn_weight"), ("bias", "gn_bias"),
                 ("mean_scale", "gn_mean_scale")):
        sg[n] = _np(sd[f"{pre}.graph_layer_norm.{k}"])
    params["scene_graph_encoder"] = sg
    stats["scene_graph_encoder"] = {
        name: {"mean": _np(sd[f"{pre}.{mod}.running_mean"]),
               "var": _np(sd[f"{pre}.{mod}.running_var"])}
        for name, mod in (("bbox_bn0", "bbox_encoding.0"),
                          ("bbox_bn1", "bbox_encoding.3"),
                          ("reduc_bn", "feat_reduc.0"))}

    gat: Dict = {}
    lin_edges = []
    for i in range(_count(sd, "gat_seq.convs.")):
        conv = f"gat_seq.convs.{i}"
        layer = {"att": _np(sd[f"{conv}.att"])[0],
                 "bias": _np(sd[f"{conv}.bias"])}
        for side in ("l", "r"):
            d = _dense(sd, f"{conv}.lin_{side}")
            layer[f"lin_{side}_kernel"] = d["kernel"]
            layer[f"lin_{side}_bias"] = d["bias"]
        for j, idx in ((1, 0), (2, 2)):
            d = _dense(sd, f"gat_seq.x_proj.{i}.{idx}")
            layer[f"x_proj_w{j}"], layer[f"x_proj_b{j}"] = (d["kernel"],
                                                            d["bias"])
        for k, n in (("weight", "gn_weight"), ("bias", "gn_bias"),
                     ("mean_scale", "gn_mean_scale")):
            layer[n] = _np(sd[f"gat_seq.bns.{i}.{k}"])
        mask = {part: {"lin0": _dense(sd, f"{conv}.mask.{part}.0")}
                for part in ("node_nn", "ques_nn")
                if f"{conv}.mask.{part}.0.weight" in sd}
        if mask:
            layer["mask"] = mask
        gat[f"conv{i}"] = layer
        lin_edges.append(_np(sd[f"{conv}.lin_edge.weight"]).T)
    gat["lin_edge_all"] = {"kernel": np.concatenate(lin_edges, axis=1)}
    if "gat_seq.node_logits.0.weight" in sd:
        gat["node_logits"] = {"lin0": _dense(sd, "gat_seq.node_logits.0"),
                              "lin1": _dense(sd, "gat_seq.node_logits.2")}
    params["gat_seq"] = gat

    pool = "graph_global_attention_pooling"
    params[pool] = {part: {"lin0": _dense(sd, f"{pool}.{part}.0"),
                           "lin1": _dense(sd, f"{pool}.{part}.2")}
                    for part in ("node_nn", "ques_nn")}
    for name in ("qsts_reduction", "instr_reduction", "qsts_att_keys",
                 "qsts_att_query"):
        if f"{name}.0.weight" in sd:
            params[name] = {"lin0": _dense(sd, f"{name}.0")}
    params["embedding"] = _dense(sd, "embedding.0")
    params["logit_fc"] = _dense(sd, "logit_fc")
    return params, stats


# upstream modules that its forward never uses (see the JAX converter);
# the node head only without node_classification
_UNUSED = ("gate_nn", "emb_proj", "pos_encoder", "num_batches_tracked")


def aimle_states_from_jax(states: Optional[Mapping],
                          device=None) -> Optional[Dict[int, AIMLEState]]:
    """The JAX package's ``{layer: AIMLEState}`` (its ``beta``,
    ``grad_norm`` and ``prev_update`` as arrays) -> the port's AIMLE
    states, 0-d f32 tensors on ``device`` (``cpu`` by default); ``None``
    stays ``None``."""
    if states is None:
        return None
    return {int(i): AIMLEState(*(torch.tensor(_aimle_field(st, f),
                                              device=device)
                                 for f in AIMLE_FIELDS))
            for i, st in states.items()}


def _aimle_field(st, name: str) -> np.ndarray:
    """One field of a JAX ``AIMLEState``, or of the dict that orbax
    restores it as, as a 0-d f32 array."""
    v = st[name] if isinstance(st, Mapping) else getattr(st, name)
    return np.array(v, np.float32).reshape(())


def _leaves(tree, path: str = "") -> List[Tuple[str, np.ndarray]]:
    """A nested dict's leaves in JAX's flatten order (sorted keys)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree)
                for leaf in _leaves(tree[k], f"{path}/{k}")]
    return [(path, np.asarray(tree))]


def _like(tree, fill):
    """``tree`` with its i-th leaf replaced by ``fill(i, leaf)``."""
    counter = itertools.count()

    def walk(t):
        if isinstance(t, Mapping):
            return {k: walk(t[k]) for k in sorted(t)}
        return fill(next(counter), np.asarray(t))
    return walk(tree)


def _check_relayout(params: Mapping, names: List[str]) -> None:
    """Raise unless :func:`state_dict_from_jax` moves every element of
    every flax parameter, unchanged, into exactly one place of the port's
    parameters ``names``: only such a re-layout can carry Adam's moments
    (which it maps like the weights).  Each flax leaf is filled with its
    own index + 1; a parameter holding any other value (an arithmetic
    mapping) is named, and so is a leaf whose elements land elsewhere
    than once each."""
    leaves = _leaves(params)
    probe = _like(params, lambda i, a: np.full(a.shape, i + 1, np.float32))
    stats = {"scene_graph_encoder": {
        n: {"mean": np.zeros(1, np.float32), "var": np.zeros(1, np.float32)}
        for n in ("bbox_bn0", "bbox_bn1", "reduc_bn")}}
    mapped = state_dict_from_jax(probe, stats)
    counts = np.zeros(len(leaves) + 1, np.int64)
    readers: Dict[int, List[str]] = {}
    for name in names:
        v = mapped[name].numpy().reshape(-1)
        ids = v.astype(np.int64)
        if not (np.array_equal(ids, v) and ids.min() >= 1
                and ids.max() <= len(leaves)):
            raise ValueError(f"{name}: its mapping from the flax parameters "
                             f"is not a re-layout, so Adam's moments cannot "
                             f"be carried to it")
        here = np.bincount(ids, minlength=len(leaves) + 1)
        counts += here
        for i in np.flatnonzero(here):
            readers.setdefault(int(i), []).append(name)
    for i, (path, a) in enumerate(leaves, start=1):
        if counts[i] != a.size:
            raise ValueError(f"flax parameter {path}: {counts[i]} of its "
                             f"{a.size} elements reach the port's parameters "
                             f"{readers.get(i, [])}: not a re-layout, so its "
                             f"moments cannot be carried")


def _cpu_train_state(cfg: Config, sd: Mapping[str, torch.Tensor]):
    """A port train state on the CPU holding ``sd``: the model built as
    ``build_model(..., train=True)`` builds it (the caller's random
    stream untouched) and the port's own ``make_optimizer`` over it."""
    from .models.isubgvqa import ISubGVQA
    from .train.schedule import make_optimizer
    from .train.state import TrainState

    vocab = sd["scene_graph_encoder.sg_vocab_embedding.weight"].shape[0]
    with torch.random.fork_rng(devices=[]):
        model = ISubGVQA(cfg, sg_vocab_size=vocab)
    model.load_state_dict(sd, strict=True)   # names keys the config lacks
    # the schedule is not stored: a resuming Trainer builds its own, and
    # sets Adam's rate from it at the restored count before each update
    opt = make_optimizer(model.train().parameters(), cfg.lr, 1,
                         cfg.warmup_epochs, cfg.warmup_start_lr, cfg.lr_gamma,
                         cfg.grad_clip_norm)
    return TrainState(step=0, model=model, optimizer=opt)


def train_payload_from_jax(params: Mapping, batch_stats: Mapping,
                           config: str, mu: Optional[Mapping] = None,
                           nu: Optional[Mapping] = None, count: int = 0,
                           notfinite_count: int = 0, step: int = 0,
                           aimle_states: Optional[Mapping] = None,
                           epoch: int = -1) -> dict:
    """A JAX train state (numpy trees) -> the port's checkpoint payload,
    written by :func:`~.train.checkpoint.state_payload` from a port train
    state filled on the CPU, so ``CheckpointManager.restore`` and
    ``Predictor.from_checkpoint`` load it with ``weights_only=True``.

    ``params`` / ``batch_stats`` are the flax trees; ``mu`` / ``nu``
    Adam's moments as params-shaped trees, ``count`` optax Adam's count
    (the schedule's step), ``notfinite_count`` the skip wrapper's,
    ``step`` the train state's; ``aimle_states`` ``{layer: AIMLEState}``
    (or orbax's dicts of it); ``config`` the config's JSON.  The moments
    go through :func:`state_dict_from_jax` as the weights do (checked to
    be a pure re-layout, :func:`_check_relayout`) into torch Adam's state
    of each parameter, its ``step`` the Adam count, under the parameter
    group the port's ``Optimizer`` builds.  Without ``mu`` and ``nu``
    the payload holds the model only (weights, buffers, AIMLE states,
    epoch): it can be validated, served and explained, and a training
    resume refuses it."""
    from .train.checkpoint import TRAINING_KEYS, state_payload

    if (mu is None) != (nu is None):
        raise ValueError("Adam's moments come in pairs: give mu and nu")
    cfg = Config.from_json(config)
    state = _cpu_train_state(cfg, state_dict_from_jax(params, batch_stats))
    state.aimle_states = aimle_states_from_jax(aimle_states or None)
    if mu is not None:
        names = [n for n, _ in state.model.named_parameters()]
        _check_relayout(params, names)
        mu_sd = state_dict_from_jax(mu, batch_stats)
        nu_sd = state_dict_from_jax(nu, batch_stats)
        adam = state.optimizer.adam
        adam.load_state_dict({
            "state": {i: {"step": torch.tensor(float(count)),
                          "exp_avg": mu_sd[n], "exp_avg_sq": nu_sd[n]}
                      for i, n in enumerate(names)},
            "param_groups": adam.state_dict()["param_groups"]})
        state.optimizer.count = int(count)
        state.optimizer.notfinite_count = int(notfinite_count)
        state.step = int(step)
    payload = state_payload(state, int(epoch), cfg)
    if mu is None:
        for k in TRAINING_KEYS:
            del payload[k]
    return payload


# Config fields recoverable from an upstream checkpoint's ``args`` (the
# reference persists ``args`` whole, ``training/train_loop.py:88-94``,
# and rebuilds the model from them, ``run_token_coo.py:29-45``): the
# JAX converter's ``_ARGS_CONFIG_FIELDS``.
ARGS_CONFIG_FIELDS = (
    "mgat_layers", "sampler_type", "sample_k", "nb_samples", "alpha",
    "beta", "tau", "use_topk", "interpretable_mode", "concat_instr",
    "use_all_instrs", "use_global_mask", "text_sampling",
    "general_hidden_dim",
)


def config_from_reference_args(args) -> Config:
    """The config of an upstream checkpoint from its ``args`` (an
    ``argparse.Namespace`` or any object with those attributes), by the
    JAX converter's rule (``isubgvqa_tpu/convert.py:354-361``): each of
    :data:`ARGS_CONFIG_FIELDS` and ``mgat_masks`` that ``args`` has and
    that is not ``None``, the rest the defaults."""
    kw = {name: getattr(args, name) for name in ARGS_CONFIG_FIELDS
          if args is not None and hasattr(args, name)}
    if getattr(args, "mgat_masks", None) is not None:
        kw["mgat_masks"] = tuple(args.mgat_masks)
    return Config(**{k: v for k, v in kw.items() if v is not None})


def load_upstream_state_dict(sd: Mapping, node_classification: bool = False
                             ) -> Dict[str, torch.Tensor]:
    """An upstream ``model.state_dict()`` (or the ``{"model": ...}``
    training payload) -> a port ``state_dict``: DDP ``module.`` prefixes
    stripped, weights the upstream forward never uses dropped (the node
    head ``gat_seq.node_logits`` unless ``node_classification``), the
    pretrained CLIP tables accepted under HuggingFace's names too, and
    the text-sampling MLPs under either upstream spelling
    (``text_sampling.qsts_att_keys`` or ``qsts_att_keys``, as the JAX
    converter accepts them, ``convert.py:238-244``)."""
    if "model" in sd and isinstance(sd["model"], Mapping):
        sd = sd["model"]
    unused = _UNUSED if node_classification else _UNUSED + ("node_logits",)
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if any(u in k for u in unused):
            continue
        k = k.replace("text_model.embeddings.", "text_vocab_embedding.")
        if k.startswith("text_sampling.qsts_att_"):
            k = k[len("text_sampling."):]
        out[k] = torch.as_tensor(np.asarray(v, np.float32)) \
            if not isinstance(v, torch.Tensor) else v.float()
    return out


# Accepted key spellings for the pretrained CLIP text tables, in lookup
# order: the upstream state-dict names, the HuggingFace CLIPModel names
# upstream copies from, and bare npz-style keys (the JAX package's
# ``CLIP_TEXT_TABLE_KEYS``).
CLIP_TEXT_TABLE_KEYS = (
    ("text_vocab_embedding.token_embedding.weight",
     "text_vocab_embedding.position_embedding.weight"),
    ("text_model.embeddings.token_embedding.weight",
     "text_model.embeddings.position_embedding.weight"),
    ("token_embedding", "position_embedding"),
)


def load_clip_text_tables(path: str) -> Dict[str, torch.Tensor]:
    """The pretrained CLIP token and position tables from ``path``:
    ``.npz``; ``.safetensors`` (where the ``safetensors`` package is
    installed); or a torch file holding a raw state dict, an upstream
    training payload (``{"model": state_dict}``, DDP ``module.`` prefixes
    stripped) or a HuggingFace CLIPModel state dict.  Returns
    ``{"token_embedding": [V, D], "position_embedding": [P, D]}`` as f32
    tensors."""
    lower = path.lower()
    if lower.endswith(".npz"):
        with np.load(path) as z:
            blob = {k: z[k] for k in z.files}
    elif lower.endswith(".safetensors"):
        try:
            from safetensors.numpy import load_file
        except ImportError:
            raise ImportError(f"reading {os.path.basename(path)!r} needs the "
                              f"safetensors package; save the tables as .npz "
                              f"or a torch file instead") from None
        blob = load_file(path)
    else:
        blob = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(blob, Mapping) and isinstance(blob.get("model"),
                                                    Mapping):
            blob = blob["model"]
    blob = {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in blob.items()}
    for tok, pos in CLIP_TEXT_TABLE_KEYS:
        if tok in blob and pos in blob:
            return {"token_embedding": torch.as_tensor(
                        np.asarray(blob[tok], np.float32)),
                    "position_embedding": torch.as_tensor(
                        np.asarray(blob[pos], np.float32))}
    raise KeyError(f"no CLIP text-embedding tables found in {path!r}; "
                   f"expected one of the key pairs {CLIP_TEXT_TABLE_KEYS} "
                   f"(got keys {sorted(blob)[:8]}...)")
