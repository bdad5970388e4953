"""Weights across the two packages and from upstream checkpoints.

:func:`state_dict_from_jax` turns the JAX package's flax trees (as
numpy arrays) into a port ``state_dict`` under the upstream repo's
names: the inverse of ``isubgvqa_tpu/convert.py:convert_state_dict``,
written here so the port never imports the JAX package.  Layouts:

* flax Dense kernels ``[in, out]`` become torch Linear weights
  ``[out, in]``;
* the MHA q/k/v kernels stack into ``in_proj_weight [3D, D]``;
* the stacked ``lin_edge_all`` kernel ``[C, L*H*C]`` splits into one
  ``lin_edge.weight [H*C, C]`` per conv;
* ``att [H, C]`` becomes ``[1, H, C]``; the ``attb``/``expand``
  prepacking of the TPU kernel is derived from ``att`` and never stored;
* BatchNorm running statistics come from ``batch_stats``.

:func:`aimle_states_from_jax` carries the aimle sampler's adaptive
states (the JAX train state's ``aimle_states``) across.
:func:`load_upstream_state_dict` reads an upstream ``.pth`` payload, and
:func:`load_clip_text_tables` the pretrained CLIP text tables that
``cfg.clip_weights`` names (the port's copy of
``isubgvqa_tpu/convert.py:load_clip_text_tables``, same formats and key
spellings).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .sampling.aimle import AIMLEState


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
        if "mask" in c:
            _lin(sd, f"{pre}.mask.node_nn.0", c["mask"]["node_nn"]["lin0"])
            _lin(sd, f"{pre}.mask.ques_nn.0", c["mask"]["ques_nn"]["lin0"])
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
    return sd


# upstream modules that its forward never uses (see the JAX converter)
_UNUSED = ("gate_nn", "emb_proj", "pos_encoder", "node_logits",
           "num_batches_tracked")


def aimle_states_from_jax(states: Optional[Mapping],
                          device=None) -> Optional[Dict[int, AIMLEState]]:
    """The JAX package's ``{layer: AIMLEState}`` (its ``beta``,
    ``grad_norm`` and ``prev_update`` as arrays) -> the port's AIMLE
    states, 0-d f32 tensors on ``device`` (``cpu`` by default); ``None``
    stays ``None``."""
    if states is None:
        return None

    def field(st, name):
        return torch.tensor(float(np.asarray(getattr(st, name), np.float32)),
                            dtype=torch.float32, device=device)

    return {int(i): AIMLEState(*(field(st, f) for f in
                                 ("beta", "grad_norm", "prev_update")))
            for i, st in states.items()}


def load_upstream_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """An upstream ``model.state_dict()`` (or the ``{"model": ...}``
    training payload) -> a port ``state_dict``: DDP ``module.`` prefixes
    stripped, weights the upstream forward never uses dropped, the
    pretrained CLIP tables accepted under HuggingFace's names too."""
    if "model" in sd and isinstance(sd["model"], Mapping):
        sd = sd["model"]
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if any(u in k for u in _UNUSED):
            continue
        k = k.replace("text_model.embeddings.", "text_vocab_embedding.")
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
