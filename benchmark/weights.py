"""The model's weights, made on the device from the seed.

One ``torch.randn`` call on a generator of the device seeded from the
run's seed fills every parameter, which is then cut into the tensors of
:func:`param_spec` and scaled by kind: a matrix by one over the root of
its input width, a bias by 0.02, a norm's scale by ``1 + 0.02 N`` and its
shift by 0.02, embedding tables and the GAT attention vectors as the
upstream initialisers scale them.  The running statistics of the
BatchNorms are fixed: the bounding boxes' by the generator's uniform
coordinates, the others 0 and 1.  A served model's matrices and tables
are rounded to the compute dtype once, as they are served; the plain
reference reads the same values at f32.  Names are the upstream
``state_dict``'s, so the program loads the dict as a checkpoint.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# the bounding boxes' means and variances: x1, y1 ~ U(0, 400), U(0, 300),
# x2, y2 ~ U(400, 800), U(300, 600)
BBOX_MEAN = (200.0, 150.0, 600.0, 450.0)
BBOX_VAR = (400.0 ** 2 / 12, 300.0 ** 2 / 12, 400.0 ** 2 / 12,
            300.0 ** 2 / 12)


def param_spec(cfg: dict, sg_vocab: int) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every tensor of the model's state."""
    c, d, ffn = cfg["general_hidden_dim"], cfg["text_emb_dim"], 4 * 512
    t, heads = cfg["mgat_layers"], cfg["gat_heads"]
    out: List[Tuple[str, tuple, str]] = []

    def linear(name, n_in, n_out, bias=True):
        out.append((name + ".weight", (n_out, n_in), "w"))
        if bias:
            out.append((name + ".bias", (n_out,), "b"))

    def norm(name, n, kind="ln"):
        out.append((name + ".weight", (n,), kind + "_w"))
        out.append((name + ".bias", (n,), kind + "_b"))

    def attn(name):
        out.append((name + ".in_proj_weight", (3 * d, d), "w"))
        out.append((name + ".in_proj_bias", (3 * d,), "b"))
        linear(name + ".out_proj", d, d)

    def bn(name, n, mean=None):
        norm(name, n)
        out.append((name + ".running_mean", (n,), mean or "zeros"))
        out.append((name + ".running_var", (n,), "var_" + (mean or "ones")))

    out.append(("text_vocab_embedding.token_embedding.weight",
                (cfg["text_vocab_size"], d), "emb"))
    out.append(("text_vocab_embedding.position_embedding.weight", (77, d),
                "emb"))
    for i in range(cfg["encoder_layers"]):
        p = f"question_encoder.transformer_encoder.layers.{i}"
        attn(p + ".self_attn")
        linear(p + ".linear1", d, ffn)
        linear(p + ".linear2", ffn, d)
        norm(p + ".norm1", d)
        norm(p + ".norm2", d)
    norm("question_encoder.transformer_encoder.norm", d)
    out.append(("program_decoder.query_embed.weight", (t, d), "emb"))
    for i in range(cfg["decoder_layers"]):
        p = f"program_decoder.coarse_decoder.layers.{i}"
        attn(p + ".self_attn")
        attn(p + ".multihead_attn")
        linear(p + ".linear1", d, ffn)
        linear(p + ".linear2", ffn, d)
        for j in (1, 2, 3):
            norm(p + f".norm{j}", d)
    norm("program_decoder.coarse_decoder.norm", d)
    s = "scene_graph_encoder"
    out.append((s + ".sg_vocab_embedding.weight", (sg_vocab, c), "sg_emb"))
    bn(s + ".bbox_encoding.0", 4, "bbox")
    linear(s + ".bbox_encoding.1", 4, 16)
    bn(s + ".bbox_encoding.3", 16)
    linear(s + ".bbox_encoding.4", 16, 32)
    bn(s + ".feat_reduc.0", c + 32)
    linear(s + ".feat_reduc.1", c + 32, c)
    lay = s + ".scene_graph_encoding_layer"
    linear(lay + ".edge_model.edge_mlp.0", 3 * c, c)
    linear(lay + ".edge_model.edge_mlp.2", c, c)
    for m in ("node_mlp_1", "node_mlp_2"):
        linear(f"{lay}.node_model.{m}.0", 2 * c, c)
        linear(f"{lay}.node_model.{m}.2", c, c)
    norm(s + ".graph_layer_norm", c)
    out.append((s + ".graph_layer_norm.mean_scale", (c,), "ln_w"))
    for i, thr in enumerate(cfg["mgat_masks"]):
        p = f"gat_seq.convs.{i}"
        out.append((p + ".att", (1, heads, c), "att"))
        out.append((p + ".bias", (heads * c,), "b"))
        linear(p + ".lin_l", c, heads * c)
        linear(p + ".lin_r", c, heads * c)
        linear(p + ".lin_edge", c, heads * c, bias=False)
        if float(thr) != 1.0:
            linear(p + ".mask.node_nn.0", c, c)
            linear(p + ".mask.ques_nn.0", c, c)
    for i in range(t):
        linear(f"gat_seq.x_proj.{i}.0", heads * c, heads * c // 2)
        linear(f"gat_seq.x_proj.{i}.2", heads * c // 2, c)
    for i in range(t):
        norm(f"gat_seq.bns.{i}", c)
        out.append((f"gat_seq.bns.{i}.mean_scale", (c,), "ln_w"))
    p = "graph_global_attention_pooling"
    for m in ("node_nn", "ques_nn"):
        linear(f"{p}.{m}.0", c, c)
        linear(f"{p}.{m}.2", c, c)
    linear("qsts_reduction.0", d * t, c)
    linear("instr_reduction.0", d, c)
    linear("embedding.0", 3 * c, 512)
    linear("logit_fc", 512, cfg["num_answers"])
    return out


_RANDOM = ("w", "b", "ln_w", "ln_b", "emb", "sg_emb", "att")


def make_weights(cfg: dict, sg_vocab: int, seed: int, device,
                 served_dtype=None) -> Dict[str, torch.Tensor]:
    """The model's state as f32 tensors on ``device`` from ``seed``; with
    ``served_dtype`` every matrix and table holds values of that dtype
    (rounded once), as a served model ships them."""
    spec = param_spec(cfg, sg_vocab)
    sizes = [math.prod(s) for _, s, k in spec if k in _RANDOM]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    parts = iter(flat.split(sizes))
    out = {}
    for name, shape, kind in spec:
        if kind in _RANDOM:
            x = next(parts).view(shape)
            if kind == "w":
                x = x / shape[1] ** 0.5
            elif kind in ("b", "ln_b"):
                x = x * 0.02
            elif kind == "ln_w":
                x = 1.0 + 0.02 * x
            elif kind == "att":
                x = x / shape[-1] ** 0.5
            elif kind == "sg_emb":
                x = x.clone()
                x[1] = 0.0                 # the <pad> row
        elif kind == "bbox":
            x = torch.tensor(BBOX_MEAN, device=device)
        elif kind == "var_bbox":
            x = torch.tensor(BBOX_VAR, device=device)
        elif kind == "zeros":
            x = torch.zeros(shape, device=device)
        else:
            x = torch.ones(shape, device=device)
        if served_dtype is not None and (kind in ("w", "emb", "sg_emb")):
            x = x.to(served_dtype).float()
        out[name] = x.contiguous()
    return out

